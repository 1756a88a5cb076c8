"""Carry trained `salsa_tpu` (flax) weights into the port.

`flax_to_torch_state_dict` maps flax (params, batch_stats) trees (nested dicts of
arrays) onto the reference's torch names, which are the port's module names
(`encoder.conv_block1.*`, `encoder.resnet.layer{L}.{i}.*`,
`decoder.gru.weight_ih_l0[_reverse]`, `decoder.event_fc_1`, ...). It is a numpy
copy of `salsa_tpu.interop.torch_export` (and `torch_ckpt`'s walk of the
encoder): the PannResNet22 / PannResNet22TPU encoder (one tree), the recurrent
decoders (`decoder.gru.*` or `decoder.lstm.*`, the module named by the gate count:
3 GRU, 4 LSTM), the transformer decoder (`decoder.pe.pe`, the positional table
salsa_tpu recomputes, and `decoder.decoder_layer.layers.{i}.*`: flax's per-head
q/k/v kernels (d, heads, head_dim) packed into `in_proj_weight` rows [q; k; v])
and the heads.

`torch_state_dict_to_flax` is its inverse (the port's counterpart of
`salsa_tpu.interop.torch_ckpt.torch_state_dict_to_flax`, without a flax template):
with `train.checkpoint.save_checkpoint` it writes a port model as a checkpoint
that `salsa_tpu` restores. A model that `salsa_tpu` does not have (EINV2, whose
encoder holds cross-stitch units) has no flax tree: its checkpoint keeps the
torch names, split at the dots into nested dicts under the key `torch`, the
parameters in `params` and the running statistics in `batch_stats`, and the
port alone restores it.

Reference (PyTorch / Lightning) checkpoints, both ways (the counterparts of
`salsa_tpu.interop.torch_ckpt.load_torch_state_dict` and
`torch_export.save_torch_checkpoint`): `load_torch_state_dict` reads a raw or
Lightning `.ckpt` with `weights_only=True` (a leading `model.` stripped), and
`save_torch_checkpoint` writes the Lightning layout. The port's modules carry
the reference's names, so importing one into a port model is a strict key and
shape check (`load_reference_state_dict`), not a mapping.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from salsa_tpu_torch.models.layers import sinusoid_position_encoding

_HEAD_MAP = {
    "event_fc1": "event_fc_1", "event_fc2": "event_fc_2",
    "x_fc1": "x_fc_1", "x_fc2": "x_fc_2",
    "y_fc1": "y_fc_1", "y_fc2": "y_fc_2",
    "z_fc1": "z_fc_1", "z_fc2": "z_fc_2",
}


def _get(tree: dict, path: tuple[str, ...]) -> np.ndarray:
    node = tree
    for p in path:
        node = node[p]
    return np.asarray(node, dtype=np.float32)


def _n_blocks(enc: dict) -> int:
    return len([k for k in enc["ResNetTrunk_0"] if k.startswith("ResNetBasicBlock_")])


def _flax_encoder_paths(enc: dict) -> list[tuple[tuple[str, ...], str]]:
    """(path, 'conv' | 'bn') in flax trace order for PannResNet22: the stem's two
    conv/bn pairs, then each basic block's two pairs and its shortcut pair."""
    paths = []
    for i in range(2):
        paths.append((("DoubleConvBlock_0", f"ConvBnRelu_{i}", "Conv_0"), "conv"))
        paths.append((("DoubleConvBlock_0", f"ConvBnRelu_{i}", "BatchNorm_0"), "bn"))
    trunk = enc["ResNetTrunk_0"]
    for b in range(_n_blocks(enc)):
        base = ("ResNetTrunk_0", f"ResNetBasicBlock_{b}")
        parts = (0, 1, 2) if "Conv_2" in trunk[f"ResNetBasicBlock_{b}"] else (0, 1)
        for n in parts:
            paths.append((base + (f"Conv_{n}",), "conv"))
            paths.append((base + (f"BatchNorm_{n}",), "bn"))
    return paths


def _torch_encoder_names(enc: dict, layers: tuple[int, ...] = (2, 2, 2, 2)) -> list[str]:
    """Reference module names in the order `_flax_encoder_paths` walks the tree.
    Stride-2 stages (all but layer1) hold AvgPool2d at downsample.0, so their
    shortcut conv/bn sit at downsample.1/.2."""
    names = ["conv_block1.conv1", "conv_block1.bn1", "conv_block1.conv2", "conv_block1.bn2"]
    trunk = enc["ResNetTrunk_0"]
    if _n_blocks(enc) != sum(layers):
        raise ValueError(f"trunk has {_n_blocks(enc)} basic blocks, expected {sum(layers)} "
                         f"for PannResNet22 layers={list(layers)}")
    b = 0
    for stage, stage_blocks in enumerate(layers):
        for i in range(stage_blocks):
            base = f"resnet.layer{stage + 1}.{i}"
            names += [f"{base}.{part}" for part in ("conv1", "bn1", "conv2", "bn2")]
            if "Conv_2" in trunk[f"ResNetBasicBlock_{b}"]:
                off = 1 if stage > 0 else 0
                names += [f"{base}.downsample.{off}", f"{base}.downsample.{off + 1}"]
            b += 1
    return names


def _export_encoder(params: dict, stats: dict, out: dict) -> None:
    enc = params["encoder"]
    for (path, kind), name in zip(_flax_encoder_paths(enc), _torch_encoder_names(enc),
                                  strict=True):
        key = f"encoder.{name}"
        if kind == "conv":
            out[f"{key}.weight"] = np.transpose(_get(enc, path + ("kernel",)), (3, 2, 0, 1))
        else:
            out[f"{key}.weight"] = _get(enc, path + ("scale",))
            out[f"{key}.bias"] = _get(enc, path + ("bias",))
            out[f"{key}.running_mean"] = _get(stats["encoder"], path + ("mean",))
            out[f"{key}.running_var"] = _get(stats["encoder"], path + ("var",))
            out[f"{key}.num_batches_tracked"] = np.zeros((), np.int64)


N_HEADS = 8  # the transformer's heads (reference nhead=8)
_RNN_MODULES = {3: "gru", 4: "lstm"}  # gates per cell -> the reference's module name
_TF_LINEAR = (("LayerNorm_0", "norm1", "scale"), ("LayerNorm_1", "norm2", "scale"),
              ("Dense_0", "linear1", "kernel"), ("Dense_1", "linear2", "kernel"))


def _export_rnn(stack: dict, out: dict) -> None:
    for layer_name, p in stack.items():
        gates = np.shape(p["wi"])[1] // np.shape(p["wh"])[0]
        if gates not in _RNN_MODULES:
            raise ValueError(f"RNN layer {layer_name} has {gates} gates per cell: neither "
                             "GRU (3) nor LSTM (4)")
        layer, direction = layer_name.split("_")
        sfx = "" if direction == "fwd" else "_reverse"
        key = f"decoder.{_RNN_MODULES[gates]}.{{}}_l{layer[1:]}{sfx}"
        out[key.format("weight_ih")] = _get(p, ("wi",)).T
        out[key.format("weight_hh")] = _get(p, ("wh",)).T
        out[key.format("bias_ih")] = _get(p, ("bi",))
        out[key.format("bias_hh")] = _get(p, ("bh",))


def _export_transformer(dec: dict, tf_layers: list[str], out: dict) -> None:
    d_model = np.shape(dec[tf_layers[0]]["MultiHeadDotProductAttention_0"]["query"]["kernel"])[0]
    out["decoder.pe.pe"] = sinusoid_position_encoding(2000, d_model).T[None]
    for li, lname in enumerate(tf_layers):
        lp, prefix = dec[lname], f"decoder.decoder_layer.layers.{li}."
        att = lp["MultiHeadDotProductAttention_0"]
        d = np.shape(att["query"]["kernel"])[0]
        out[prefix + "self_attn.in_proj_weight"] = np.concatenate(
            [_get(att[nm], ("kernel",)).reshape(d, d).T for nm in ("query", "key", "value")],
            axis=0)
        out[prefix + "self_attn.in_proj_bias"] = np.concatenate(
            [_get(att[nm], ("bias",)).reshape(d) for nm in ("query", "key", "value")], axis=0)
        out[prefix + "self_attn.out_proj.weight"] = _get(att["out"], ("kernel",)).reshape(d, d).T
        out[prefix + "self_attn.out_proj.bias"] = _get(att["out"], ("bias",))
        for flax_name, name, weight in _TF_LINEAR:
            w = _get(lp[flax_name], (weight,))
            out[prefix + f"{name}.weight"] = w.T if weight == "kernel" else w
            out[prefix + f"{name}.bias"] = _get(lp[flax_name], ("bias",))


def _export_decoder(params: dict, out: dict) -> None:
    dec = params["decoder"]
    tf_layers = sorted((k for k in dec if k.startswith("TransformerEncoderLayer_")),
                       key=lambda k: int(k.rsplit("_", 1)[1]))
    unmapped = set(dec) - {"RNNStack_0"} - set(_HEAD_MAP) - set(tf_layers)
    if unmapped:
        raise ValueError(f"cannot map decoder modules {sorted(unmapped)}")
    if "RNNStack_0" not in dec and not tf_layers:
        raise ValueError("decoder has neither RNNStack_0 nor transformer layers")
    if "RNNStack_0" in dec:
        _export_rnn(dec["RNNStack_0"], out)
    if tf_layers:
        _export_transformer(dec, tf_layers, out)
    for ours, theirs in _HEAD_MAP.items():
        if ours in dec:
            out[f"decoder.{theirs}.weight"] = _get(dec[ours], ("kernel",)).T
            out[f"decoder.{theirs}.bias"] = _get(dec[ours], ("bias",))


TORCH_TREE = "torch"  # the checkpoint key of a model with no flax counterpart
_STATS = ("running_mean", "running_var")


def _nest(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        _set(tree, tuple(key.split(".")), value)
    return tree


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, dtype=np.float32)
    return out


def flax_to_torch_state_dict(params: dict, batch_stats: dict) -> dict[str, np.ndarray]:
    """Flax SeldNet (params, batch_stats) -> reference-named state_dict of numpy
    arrays (float32; `num_batches_tracked` int64 zeros), key for key and array
    for array `salsa_tpu.interop.torch_export.flax_to_torch_state_dict`'s; a
    `torch` tree (a model with no flax counterpart) is flattened back to its
    names."""
    if TORCH_TREE in params:
        out = {**_flatten(params[TORCH_TREE]), **_flatten(batch_stats.get(TORCH_TREE, {}))}
        for key in [k for k in out if k.endswith(".running_mean")]:
            out[key.removesuffix("running_mean") + "num_batches_tracked"] = np.zeros((), np.int64)
        return out
    out: dict[str, np.ndarray] = {}
    _export_encoder(params, batch_stats, out)
    _export_decoder(params, out)
    return out


def _set(tree: dict, path: tuple[str, ...], value: np.ndarray) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def _encoder_layers(sd: dict) -> tuple[int, ...]:
    """Basic blocks per ResNet stage, read from the state_dict's names."""
    layers = []
    while any(k.startswith(f"encoder.resnet.layer{len(layers) + 1}.") for k in sd):
        stage = len(layers) + 1
        n = 0
        while f"encoder.resnet.layer{stage}.{n}.conv1.weight" in sd:
            n += 1
        layers.append(n)
    return tuple(layers)


def torch_state_dict_to_flax(state_dict, torch_tree: bool = False) -> tuple[dict, dict]:
    """Reference-named state_dict (the PannResNet22 tree, a gru/bigru/lstm/bilstm
    or transformer decoder and the heads) -> flax SeldNet (params, batch_stats) as
    nested dicts of float32 numpy arrays: the inverse of
    `flax_to_torch_state_dict` (the transformer's as `salsa_tpu.interop.
    torch_ckpt.transformer_layer_params`, 8 heads). The tree is built from the
    names alone, with no flax template; `num_batches_tracked` and the
    positional table `decoder.pe.pe` (which salsa_tpu recomputes) are dropped.
    Raises ValueError on a name it cannot place. With `torch_tree` (a model with
    no flax counterpart, `SeldNet.flax_counterpart` false) it gives the `torch`
    tree instead (the module's docstring)."""
    sd = {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)
          for k, v in state_dict.items()}
    if torch_tree:
        kept = {k: np.ascontiguousarray(v, dtype=np.float32) for k, v in sd.items()
                if not k.endswith(".num_batches_tracked")}
        return ({TORCH_TREE: _nest({k: v for k, v in kept.items() if not k.endswith(_STATS)})},
                {TORCH_TREE: _nest({k: v for k, v in kept.items() if k.endswith(_STATS)})})
    params: dict = {}
    stats: dict = {}
    used = {k for k in sd if k.endswith(".num_batches_tracked") or k == "decoder.pe.pe"}

    def take(key: str) -> np.ndarray:
        if key not in sd:
            raise ValueError(f"state_dict lacks {key}")
        used.add(key)
        return np.ascontiguousarray(sd[key], dtype=np.float32)

    # the encoder: the walk of `_export_encoder`, backwards; whether a block has a
    # shortcut projection is read from the names
    layers = _encoder_layers(sd)
    paths = [(("DoubleConvBlock_0", f"ConvBnRelu_{i}", kind), f"conv_block1.{part}{i + 1}")
             for i in range(2) for kind, part in (("Conv_0", "conv"), ("BatchNorm_0", "bn"))]
    b = 0
    for stage, n_blocks in enumerate(layers):
        for i in range(n_blocks):
            base, flax_base = (f"resnet.layer{stage + 1}.{i}",
                               ("ResNetTrunk_0", f"ResNetBasicBlock_{b}"))
            parts = [("Conv_0", "conv1"), ("BatchNorm_0", "bn1"), ("Conv_1", "conv2"),
                     ("BatchNorm_1", "bn2")]
            off = 1 if stage > 0 else 0
            if f"encoder.{base}.downsample.{off}.weight" in sd:
                parts += [("Conv_2", f"downsample.{off}"), ("BatchNorm_2", f"downsample.{off + 1}")]
            paths += [(flax_base + (kind,), f"{base}.{part}") for kind, part in parts]
            b += 1
    for path, name in paths:
        key = f"encoder.{name}"
        if path[-1].startswith("Conv"):
            _set(params, ("encoder",) + path + ("kernel",),
                 np.ascontiguousarray(np.transpose(take(f"{key}.weight"), (2, 3, 1, 0))))
        else:
            _set(params, ("encoder",) + path + ("scale",), take(f"{key}.weight"))
            _set(params, ("encoder",) + path + ("bias",), take(f"{key}.bias"))
            _set(stats, ("encoder",) + path + ("mean",), take(f"{key}.running_mean"))
            _set(stats, ("encoder",) + path + ("var",), take(f"{key}.running_var"))

    # the decoder: recurrent layers and directions or transformer layers, then
    # the heads
    found = [m for m in (*_RNN_MODULES.values(), "decoder_layer")
             if any(k.startswith(f"decoder.{m}.") for k in sd)]
    if len(found) > 1:
        raise ValueError(f"cannot place decoder.{found[0]} and decoder.{found[1]} in one "
                         "SeldNet tree: a decoder has one sequence model")
    for mod in _RNN_MODULES.values():
        layer = 0
        while f"decoder.{mod}.weight_ih_l{layer}" in sd:
            for sfx, direction in (("", "fwd"), ("_reverse", "bwd")):
                if sfx and f"decoder.{mod}.weight_ih_l{layer}{sfx}" not in sd:
                    continue
                key = f"decoder.{mod}.{{}}_l{layer}{sfx}"
                _set(params, ("decoder", "RNNStack_0", f"l{layer}_{direction}"), {
                    "wi": np.ascontiguousarray(take(key.format("weight_ih")).T),
                    "wh": np.ascontiguousarray(take(key.format("weight_hh")).T),
                    "bi": take(key.format("bias_ih")), "bh": take(key.format("bias_hh"))})
            layer += 1
    layer = 0
    while f"decoder.decoder_layer.layers.{layer}.self_attn.in_proj_weight" in sd:
        prefix = f"decoder.decoder_layer.layers.{layer}."
        _set(params, ("decoder", f"TransformerEncoderLayer_{layer}"),
             _transformer_layer(lambda name, _p=prefix: take(_p + name)))
        layer += 1
    for ours, theirs in _HEAD_MAP.items():
        if f"decoder.{theirs}.weight" in sd:
            _set(params, ("decoder", ours), {
                "kernel": np.ascontiguousarray(take(f"decoder.{theirs}.weight").T),
                "bias": take(f"decoder.{theirs}.bias")})
    left = sorted(set(sd) - used)
    if left:
        raise ValueError(f"cannot place {left[:4]} in a PannResNet22 SeldNet tree")
    return params, stats


def _transformer_layer(get) -> dict:
    """One reference transformer layer's tensors (`get(name)`) -> salsa_tpu's flax
    TransformerEncoderLayer tree: the packed q/k/v rows unpacked into kernels
    (d, heads, head_dim) and biases (heads, head_dim), the output kernel
    (heads, head_dim, d)."""
    in_w, in_b = get("self_attn.in_proj_weight"), get("self_attn.in_proj_bias")
    d = in_w.shape[1]
    hd = d // N_HEADS
    tree = {"MultiHeadDotProductAttention_0": {
        name: {"kernel": np.ascontiguousarray(in_w[i * d:(i + 1) * d].T.reshape(d, N_HEADS, hd)),
               "bias": np.ascontiguousarray(in_b[i * d:(i + 1) * d].reshape(N_HEADS, hd))}
        for i, name in enumerate(("query", "key", "value"))}}
    tree["MultiHeadDotProductAttention_0"]["out"] = {
        "kernel": np.ascontiguousarray(get("self_attn.out_proj.weight").T.reshape(N_HEADS, hd, d)),
        "bias": get("self_attn.out_proj.bias")}
    for flax_name, name, weight in _TF_LINEAR:
        w = get(f"{name}.weight")
        tree[flax_name] = {weight: np.ascontiguousarray(w.T) if weight == "kernel" else w,
                           "bias": get(f"{name}.bias")}
    return tree


def load_flax_variables(model: nn.Module, params: dict, batch_stats: dict) -> nn.Module:
    """Load flax trees (nested dicts of arrays) into a port model, strictly."""
    sd = flax_to_torch_state_dict(params, batch_stats)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                          strict=True)
    return model


def load_torch_state_dict(path: str, *, trust_checkpoint: bool = False) -> dict[str, np.ndarray]:
    """A reference checkpoint as {key: numpy array}: a raw state_dict or a
    Lightning checkpoint's `state_dict`, a leading `model.` stripped from every
    key, non-tensor entries dropped. Loaded with `weights_only=True` (no code runs
    while unpickling); a file that needs full unpickling raises ValueError unless
    `trust_checkpoint` (CLI: --trust-checkpoint), for files from a trusted
    producer only."""
    try:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # noqa: BLE001 - any refusal of the safe loader
        if not trust_checkpoint:
            raise ValueError(f"{path} needs full (unsafe) unpickling to load. If you trust its "
                             "producer, retry with trust_checkpoint=True "
                             "(CLI: --trust-checkpoint).") from e
        blob = torch.load(path, map_location="cpu", weights_only=False)
    state = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    out = {}
    for k, v in state.items():
        if k.startswith("model."):
            k = k[len("model."):]
        if hasattr(v, "detach"):
            out[k] = v.detach().cpu().numpy()
    return out


def load_reference_state_dict(model: nn.Module, state: dict[str, np.ndarray]) -> nn.Module:
    """Load a reference-named state_dict into a port model: the keys and shapes
    must be the model's (a missing `num_batches_tracked`, a counter, reads as 0);
    anything else raises ValueError naming the missing, unexpected and misshapen
    keys."""
    own = model.state_dict()
    missing = sorted(k for k in own if k not in state and not k.endswith("num_batches_tracked"))
    unexpected = sorted(k for k in state if k not in own)
    misshapen = sorted(f"{k} {tuple(np.shape(state[k]))} != {tuple(v.shape)}"
                       for k, v in own.items()
                       if k in state and tuple(np.shape(state[k])) != tuple(v.shape))
    if missing or unexpected or misshapen:
        raise ValueError(f"the checkpoint does not map onto the config's model: missing "
                         f"{missing[:6]}, unexpected {unexpected[:6]}, misshapen {misshapen[:6]} "
                         f"({len(missing)}, {len(unexpected)}, {len(misshapen)} keys) - same "
                         "encoder and decoder config?")
    model.load_state_dict({k: torch.from_numpy(np.array(state[k])).to(v.dtype)
                           if k in state else torch.zeros_like(v) for k, v in own.items()},
                          strict=True)
    return model


def save_torch_checkpoint(path: str, state_dict: dict[str, np.ndarray],
                          metadata: dict | None = None) -> str:
    """Write a Lightning-style checkpoint, `{"state_dict": {"model.<key>": tensor}}`
    (with `metadata` under `salsa_tpu_export`), which `torch.load(...,
    weights_only=True)` reads back; returns `path`."""
    blob = {"state_dict": {f"model.{k}": torch.from_numpy(np.array(v, copy=True))
                           for k, v in state_dict.items()}}
    if metadata:
        blob["salsa_tpu_export"] = dict(metadata)
    torch.save(blob, path)
    return path
