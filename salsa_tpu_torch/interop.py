"""Carry trained `salsa_tpu` (flax) weights into the port.

`flax_to_torch_state_dict` maps flax (params, batch_stats) trees (nested dicts of
arrays) onto the reference's torch names, which are the port's module names
(`encoder.conv_block1.*`, `encoder.resnet.layer{L}.{i}.*`,
`decoder.gru.weight_ih_l0[_reverse]`, `decoder.event_fc_1`, ...). It is a numpy
copy of the part of `salsa_tpu.interop.torch_export` (and `torch_ckpt`'s walk of
the encoder) that the port's models need: the PannResNet22 encoder and the
`gru` / `bigru` decoder with its heads. LSTM and transformer decoders are refused:
the port has no module to load them into yet.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

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


def _export_decoder(params: dict, out: dict) -> None:
    dec = params["decoder"]
    unported = sorted(k for k in dec if k.startswith("TransformerEncoderLayer_"))
    if unported:
        raise NotImplementedError(f"transformer decoder ({unported[0]}, ...): the port has "
                                  "no transformer decoder yet")
    unmapped = set(dec) - {"RNNStack_0"} - set(_HEAD_MAP)
    if unmapped:
        raise ValueError(f"cannot map decoder modules {sorted(unmapped)}")
    if "RNNStack_0" not in dec:
        raise ValueError("decoder has no RNNStack_0: not a gru/bigru SeldDecoder")
    for layer_name, p in dec["RNNStack_0"].items():
        gates = np.shape(p["wi"])[1] // np.shape(p["wh"])[0]
        if gates != 3:
            raise NotImplementedError(f"RNN layer {layer_name} has {gates} gates per cell: "
                                      "the port loads GRU (3) stacks only")
        layer, direction = layer_name.split("_")
        sfx = "" if direction == "fwd" else "_reverse"
        key = f"decoder.gru.{{}}_l{layer[1:]}{sfx}"
        out[key.format("weight_ih")] = _get(p, ("wi",)).T
        out[key.format("weight_hh")] = _get(p, ("wh",)).T
        out[key.format("bias_ih")] = _get(p, ("bi",))
        out[key.format("bias_hh")] = _get(p, ("bh",))
    for ours, theirs in _HEAD_MAP.items():
        if ours in dec:
            out[f"decoder.{theirs}.weight"] = _get(dec[ours], ("kernel",)).T
            out[f"decoder.{theirs}.bias"] = _get(dec[ours], ("bias",))


def flax_to_torch_state_dict(params: dict, batch_stats: dict) -> dict[str, np.ndarray]:
    """Flax SeldNet (params, batch_stats) -> reference-named state_dict of numpy
    arrays (float32; `num_batches_tracked` int64 zeros). PannResNet22 + gru/bigru
    only; raises NotImplementedError on an LSTM or transformer decoder."""
    out: dict[str, np.ndarray] = {}
    _export_encoder(params, batch_stats, out)
    _export_decoder(params, out)
    return out


def load_flax_variables(model: nn.Module, params: dict, batch_stats: dict) -> nn.Module:
    """Load flax trees (nested dicts of arrays) into a port model, strictly."""
    sd = flax_to_torch_state_dict(params, batch_stats)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                          strict=True)
    return model
