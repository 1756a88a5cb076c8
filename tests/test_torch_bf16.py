"""compute_dtype 'bfloat16' in the port against salsa_tpu's on the CPU.

The port mirrors flax's per-op casts (`salsa_tpu_torch.models.layers`): convs and
head Dense layers in bf16 with float32 sums, BatchNorm in float32 on the bf16
input and rounded back, relu, pooling (the average's window summed one rounded
bf16 add at a time, as XLA's reduce_window sums it), residual adds and dropout
in bf16, the recurrences and the transformer in float32.

Two bounds, both on the same weights and inputs:
  * per stage (the stem, each of the eight residual blocks, the decoder), each fed
    salsa_tpu's own bf16 input to it: the port's distance from salsa_tpu's bf16
    output is at most 0.25 x salsa_tpu's own bf16-versus-fp32 distance on that
    input (RMS over the output). This is what shows the casts are flax's: the
    port's stages read 0-0.2 of it, while a stage that rounds elsewhere (autocast's
    bf16 recurrence, a pool rounded once) reads 0.5 or more;
  * the whole network, from the same input: max |port - salsa_tpu bf16| within
    WHOLE_ATOL over 4 seeds, and the RMS ratio above at most WHOLE_RATIO. Not 0.25
    there: the stages differ from salsa_tpu's in about 1e-4 of their bf16
    roundings (a conv's float32 sums taken in another order), and each later conv
    spreads a 1-ulp difference over all its outputs, so after the 17 convs of the
    encoder the two bf16 networks part about as far as one of them parts from fp32
    (the ratio read 0.49-1.32 over 24 networks here).
bf16 training is held against salsa_tpu's in tests/test_torch_trainer_bf16.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from salsa_tpu.models import decoders as jdecoders  # noqa: E402
from salsa_tpu.models import layers as jlayers  # noqa: E402
from salsa_tpu.models import seld as jseld  # noqa: E402
from salsa_tpu_torch.interop import load_flax_variables  # noqa: E402
from salsa_tpu_torch.models import seld as tseld  # noqa: E402
from tests.test_torch_models import flax_init  # noqa: E402

N_CLASSES = 5
BF16 = "bfloat16"
STAGE_RATIO = 0.25  # per stage: the port's distance over salsa_tpu's bf16-vs-fp32
WHOLE_RATIO = 2.0  # whole network, read 0.49-1.32
WHOLE_ATOL = 5e-2  # whole network, max abs difference; read 3.1e-2 at most over the 48
# output tensors below (event logits of std ~1.4: two bf16 steps of a value in [2, 4))


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for this file, beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rms(a, b) -> float:
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)))


def _configs(encoder, decoder_type, dtype=None):
    return ({"name": encoder, "n_input_channels": 7, "compute_dtype": dtype},
            {"name": "SeldDecoder", "decoder_type": decoder_type, "decoder_size": 32,
             "freq_pool": "avg", "compute_dtype": dtype})


def _nchw(a) -> torch.Tensor:
    """A flax NHWC bf16 array as the port's NCHW bf16 tensor (exact)."""
    return torch.from_numpy(np.asarray(a, np.float32)).permute(0, 3, 1, 2).to(torch.bfloat16)


def _stages(encoder, decoder_type, params, stats, inter, t_model):
    """(name, port output, salsa_tpu bf16 output, salsa_tpu fp32 output) of every
    stage on salsa_tpu's bf16 input to it; outputs as float64 numpy, NCHW."""
    enc_p, enc_s = params["encoder"], stats["encoder"]
    cap = {k: v[0] for k, v in _flat(inter["intermediates"])}

    def flax_pair(make, p, s, x):
        """The flax stage in bf16 and in fp32 on the same (bf16-valued) input."""
        v = {"params": p, "batch_stats": s} if s is not None else {"params": p}
        kw = {} if s is None else {"train": False}
        return (make(jnp.bfloat16).apply(v, x, **kw),
                make(None).apply(v, x.astype(jnp.float32), **kw))

    def out(a):
        return np.asarray(a, np.float64).transpose(0, 3, 1, 2)

    stem_in = cap[("encoder", "input")]
    pool = "avg"
    if encoder == "PannResNet22TPU":
        stem_in, pool = jlayers.avg_pool_2x2(stem_in), "none"
    j16, j32 = flax_pair(lambda d: jlayers.DoubleConvBlock(64, pool_type=pool, dtype=d),
                         enc_p["DoubleConvBlock_0"], enc_s["DoubleConvBlock_0"], stem_in)
    with torch.no_grad():
        got = t_model.encoder.conv_block1(_nchw(stem_in)).double().numpy()
    yield "stem", got, out(j16), out(j32)

    prev = cap[("encoder", "DoubleConvBlock_0", "__call__")]
    blocks = [blk for stage in range(4) for blk in getattr(t_model.encoder.resnet,
                                                           f"layer{stage + 1}")]
    for b, blk in enumerate(blocks):
        stage, first = b // 2, b % 2 == 0
        name = f"ResNetBasicBlock_{b}"
        j16, j32 = flax_pair(lambda d, st=stage, fi=first: jlayers.ResNetBasicBlock(
            features=64 * 2 ** st, stride=2 if st > 0 and fi else 1,
            use_shortcut_proj=st > 0 and fi, dtype=d),
            enc_p["ResNetTrunk_0"][name], enc_s["ResNetTrunk_0"][name], prev)
        with torch.no_grad():
            got = blk(_nchw(prev)).double().numpy()
        yield f"block {b}", got, out(j16), out(j32)
        prev = cap[("encoder", "ResNetTrunk_0", name, "__call__")]

    kw = dict(n_output_channels=512, n_classes=N_CLASSES, decoder_type=decoder_type,
              decoder_size=32, freq_pool="avg")
    j16, j32 = flax_pair(lambda d: jdecoders.SeldDecoder(
        **kw, compute_dtype=None if d is None else BF16), params["decoder"], None, prev)
    with torch.no_grad():
        got = t_model.decoder(_nchw(prev))
    cat = lambda o: np.concatenate([np.asarray(o[k], np.float64).ravel()  # noqa: E731
                                    for k in ("event_frame_logit", "doa_frame_output")])
    yield "decoder", cat({k: v.double().numpy() for k, v in got.items()}), cat(j16), cat(j32)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _encoder_input(x):
    """salsa_tpu's encoder input in bf16, NHWC."""
    return jnp.transpose(jnp.asarray(x), (0, 2, 3, 1)).astype(jnp.bfloat16)


@pytest.mark.parametrize("decoder_type", ["gru", "lstm", "transformer"])
@pytest.mark.parametrize("encoder", ["PannResNet22", "PannResNet22TPU"])
def test_bf16_mirrors_salsa_tpu(encoder, decoder_type):
    """Per stage on salsa_tpu's own bf16 inputs: the port within STAGE_RATIO of
    salsa_tpu's bf16-versus-fp32 distance; the whole network over 4 seeds: within
    WHOLE_ATOL and WHOLE_RATIO (module docstring). BatchNorm perturbed."""
    enc32, dec32 = _configs(encoder, decoder_type)
    enc16, dec16 = _configs(encoder, decoder_type, BF16)
    ratios = []
    for seed in range(4):
        rng = np.random.default_rng(20261017 + seed)
        x = rng.standard_normal((2, 7, 64, 32)).astype(np.float32)
        j32 = jseld.build_model(encoder=enc32, decoder=dec32, n_classes=N_CLASSES)
        params, stats = flax_init(rng, j32, x)
        v = {"params": params, "batch_stats": stats}
        want32 = j32.apply(v, jnp.asarray(x), train=False)
        want16, inter = jseld.build_model(encoder=enc16, decoder=dec16, n_classes=N_CLASSES
                                          ).apply(v, jnp.asarray(x), train=False,
                                                  capture_intermediates=True)
        t_model = load_flax_variables(tseld.build_model(encoder=enc16, decoder=dec16,
                                                        n_classes=N_CLASSES), params, stats)
        with torch.no_grad():
            got = t_model.eval()(torch.from_numpy(x))
        for k in ("event_frame_logit", "doa_frame_output"):
            g, w16, w32 = got[k].numpy(), np.asarray(want16[k]), np.asarray(want32[k])
            assert got[k].dtype == torch.float32 and w16.dtype == np.float32
            assert np.abs(g - w16).max() <= WHOLE_ATOL, (seed, k, np.abs(g - w16).max())
            ratios.append(rms(g, w16) / rms(w16, w32))
        if seed == 0:
            inter["intermediates"].setdefault("encoder", {})["input"] = (_encoder_input(x),)
            for name, port, j16, j32 in _stages(encoder, decoder_type, params, stats, inter,
                                                t_model):
                own = rms(j16, j32)
                assert own > 0, name
                assert rms(port, j16) <= STAGE_RATIO * own, (name, rms(port, j16), own)
    assert max(ratios) <= WHOLE_RATIO, ratios


def test_a_stage_rounding_elsewhere_fails_the_stage_bound():
    """The stage bound tells casts apart: the decoder with its GRU run in bf16 (as
    autocast runs cuDNN's recurrences) reads well above STAGE_RATIO on the same
    input where the port's decoder reads below it."""
    enc16, dec16 = _configs("PannResNet22", "gru", BF16)
    rng = np.random.default_rng(20261017)
    x = rng.standard_normal((2, 7, 64, 32)).astype(np.float32)
    params, stats = flax_init(rng, jseld.build_model(encoder=enc16, decoder=dec16,
                                                     n_classes=N_CLASSES), x)
    j16 = jseld.build_model(encoder=enc16, decoder=dec16, n_classes=N_CLASSES)
    h = j16.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                  method=lambda m, x: m.encoder(jnp.transpose(x, (0, 2, 3, 1)), train=False))
    kw = dict(n_output_channels=512, n_classes=N_CLASSES, decoder_type="gru",
              decoder_size=32, freq_pool="avg")
    want = {d: jdecoders.SeldDecoder(**kw, compute_dtype=d).apply(
        {"params": params["decoder"]}, h if d else h.astype(jnp.float32))
        for d in (BF16, None)}
    own = rms(want[BF16]["doa_frame_output"], want[None]["doa_frame_output"])
    t_dec = load_flax_variables(tseld.build_model(encoder=enc16, decoder=dec16,
                                                  n_classes=N_CLASSES), params, stats).decoder
    t_dec.eval()
    with torch.no_grad():
        mirrored = t_dec(_nchw(h))["doa_frame_output"].double().numpy()
        t_dec.rnn.to(torch.bfloat16)
        t_dec._recur = lambda x: t_dec.rnn(x)[0]  # the bf16 pooled input, as autocast
        elsewhere = t_dec(_nchw(h))["doa_frame_output"].double().numpy()
    w = np.asarray(want[BF16]["doa_frame_output"], np.float64)
    assert rms(mirrored, w) <= STAGE_RATIO * own < rms(elsewhere, w), (
        rms(mirrored, w), own, rms(elsewhere, w))


def test_bf16_runs_bf16_arithmetic_on_the_cpu():
    """On CPU tensors a bf16 model computes in bf16 (never quietly in fp32): every
    conv, BatchNorm and pool output is bf16, the recurrence reads float32, the
    head Linears compute in bf16, and the outputs are float32."""
    model = tseld.build_model(*_configs("PannResNet22TPU", "bigru", BF16), n_classes=3).eval()
    seen = {}

    def hook(name):
        def record(module, inputs, output):
            seen[name] = (inputs[0].dtype, output[0].dtype if isinstance(output, tuple)
                          else output.dtype if torch.is_tensor(output) else None)
        return record

    for name, m in model.named_modules():
        if name and not name.endswith("dropout"):
            m.register_forward_hook(hook(name))
    with torch.no_grad():
        out = model(torch.randn(1, 7, 64, 32))
    assert seen["encoder.conv_block1.conv1"] == (torch.bfloat16, torch.bfloat16)
    for name, (_, dtype) in seen.items():
        if name.startswith("encoder."):
            assert dtype == torch.bfloat16, name
    assert seen["decoder.gru"][0] == torch.float32
    assert seen["decoder.event_fc_1"][1] == torch.bfloat16
    assert all(v.dtype == torch.float32 for v in out.values())


def test_float32_compute_dtype_is_the_float32_network():
    """compute_dtype 'float32' gives the same outputs bit for bit as none; an
    unknown name raises ValueError."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 7, 64, 32)).astype(np.float32))
    outs = []
    for dtype in (None, "float32"):
        model = tseld.init_random_(tseld.build_model(*_configs("PannResNet22", "lstm", dtype),
                                                     n_classes=3),
                                   torch.Generator().manual_seed(0)).eval()
        with torch.no_grad():
            outs.append(model(x))
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k
    for bad in ("float16", "bf16", "fp32"):
        with pytest.raises(ValueError, match="compute_dtype"):
            tseld.build_model(*_configs("PannResNet22", "gru", bad))

