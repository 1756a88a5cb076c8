"""salsa_tpu_torch.models against salsa_tpu.models: one flax init carried across
with `interop.load_flax_variables` (strict), eval-mode outputs compared."""
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import yaml

torch = pytest.importorskip("torch")

from salsa_tpu.interop.torch_export import (  # noqa: E402
    flax_to_torch_state_dict as j_flax_to_torch_state_dict,
)
from salsa_tpu.models import seld as jseld  # noqa: E402
from salsa_tpu_torch import configs  # noqa: E402
from salsa_tpu_torch.interop import flax_to_torch_state_dict, load_flax_variables  # noqa: E402
from salsa_tpu_torch.models import seld as tseld  # noqa: E402

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "seld.yml")


def flax_init(rng, model, x, seed=3):
    """Flax variables as numpy trees, made non-trivial: BN scales uniform(0.5, 1.5)
    (the flax init zeroes each block's second one), biases N(0, 0.1), running
    means N(0, 0.1) and variances uniform(0.5, 1.5). With the plain init and stats
    near 1, every activation dies at a ReLU and both frameworks output exactly 0."""
    variables = model.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False)

    def params_leaf(path, a):
        name = path[-1].key
        if name == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name in ("bias", "bi", "bh"):
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return np.asarray(a)

    def stats_leaf(path, a):
        if path[-1].key == "mean":
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)

    return (jax.tree_util.tree_map_with_path(params_leaf, variables["params"]),
            jax.tree_util.tree_map_with_path(stats_leaf, variables["batch_stats"]))


@pytest.mark.parametrize("decoder_type", ["gru", "bigru"])
def test_seldnet_matches_flax(rng, decoder_type):
    enc = {"name": "PannResNet22", "n_input_channels": 7}
    dec = {"name": "SeldDecoder", "decoder_type": decoder_type, "decoder_size": 32,
           "freq_pool": "avg"}
    x = rng.standard_normal((2, 7, 64, 32)).astype(np.float32)
    j_model = jseld.build_model(encoder=enc, decoder=dec, n_classes=5)
    params, stats = flax_init(rng, j_model, x)
    want = j_model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                         train=False)

    t_model = load_flax_variables(tseld.build_model(encoder=enc, decoder=dec, n_classes=5),
                                  params, stats).eval()
    assert t_model.time_downsample_ratio == 16
    with torch.no_grad():
        got = t_model(torch.from_numpy(x))
    for k in ("event_frame_logit", "doa_frame_output"):
        assert got[k].shape == want[k].shape
        assert np.asarray(want[k]).std() > 0.05  # the comparison is not vacuous
        # test_interop.py's bound for a flax -> torch weight transplant
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("enc_extra,dec_extra", [
    ({"p_dropout": 0.0}, {}),
    ({"p_dropout": 0.25}, {"head_dropout": 0.5, "rnn_dropout": 0.4}),
    ({}, {"head_dropout": 0.0, "rnn_dropout": 0.0}),
])
def test_dropout_keys_match_flax_in_eval(rng, enc_extra, dec_extra):
    """salsa_tpu's p_dropout, head_dropout and rnn_dropout keys build the port's
    model with those rates as its Dropout modules (the rnn rate between the GRU's
    layers, drawn from the dropout generator, so nn.GRU's own dropout stays 0); in
    eval mode the outputs match SeldNet.apply(train=False) at
    test_seldnet_matches_flax's tolerance."""
    enc = {"name": "PannResNet22", "n_input_channels": 7, **enc_extra}
    dec = {"name": "SeldDecoder", "decoder_type": "bigru", "decoder_size": 16,
           "freq_pool": "avg", **dec_extra}
    x = rng.standard_normal((2, 7, 64, 32)).astype(np.float32)
    j_model = jseld.build_model(encoder=enc, decoder=dec, n_classes=3)
    params, stats = flax_init(rng, j_model, x)
    want = j_model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                         train=False)
    t_model = load_flax_variables(tseld.build_model(encoder=enc, decoder=dec, n_classes=3),
                                  params, stats).eval()
    assert t_model.encoder.dropout.p == enc_extra.get("p_dropout", 0.0)
    assert t_model.decoder.head_dropout.p == dec_extra.get("head_dropout", 0.2)
    assert t_model.decoder.rnn_dropout.p == dec_extra.get("rnn_dropout", 0.3)
    assert t_model.decoder.gru.dropout == 0.0
    with torch.no_grad():
        got = t_model(torch.from_numpy(x))
    for k in ("event_frame_logit", "doa_frame_output"):
        assert np.asarray(want[k]).std() > 0.05
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=5e-4, rtol=1e-3)


def _flax_tree(rng, decoder_type, size=16):
    enc = {"name": "PannResNet22", "n_input_channels": 7}
    dec = {"name": "SeldDecoder", "decoder_type": decoder_type, "decoder_size": size,
           "freq_pool": "avg"}
    model = jseld.build_model(encoder=enc, decoder=dec, n_classes=3)
    return flax_init(rng, model, np.zeros((1, 7, 64, 32), np.float32))


@pytest.mark.parametrize("decoder_type", ["gru", "bigru", "lstm", "bilstm", "transformer"])
def test_converter_equals_salsa_tpu_export(rng, decoder_type):
    """The port's numpy converter gives salsa_tpu's state_dict key for key (in
    order) and array for array."""
    params, stats = _flax_tree(rng, decoder_type)
    want = j_flax_to_torch_state_dict(params, stats)
    got = flax_to_torch_state_dict(params, stats)
    assert list(got) == list(want) and len(got) > 100
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("ratio,n_in", [(2, 8), (3, 5), (0.5, 8), (0.25, 12), (1.5, 6),
                                        (0.6, 10), (1, 4)])
def test_interpolate_index_repeat_equal(rng, ratio, n_in):
    x = rng.standard_normal((2, n_in, 3)).astype(np.float32)
    want = np.asarray(jseld.interpolate_index_repeat(jnp.asarray(x), ratio))
    got = tseld.interpolate_index_repeat(torch.from_numpy(x), ratio).numpy()
    np.testing.assert_array_equal(got, want)


def test_configs_equal_seld_yml():
    with open(CONFIG) as f:
        cfg = yaml.safe_load(f)
    assert configs.MODEL == cfg["model"]
    assert configs.DATA == cfg["data"]
    assert configs.SELD_FOA["n_classes"] == 12
    model = tseld.build_model(**configs.SELD_FOA)
    assert model.decoder.gru.bidirectional and model.decoder.gru.hidden_size == 256
    assert model.decoder.event_fc_2.out_features == 12


def test_unknown_variants_raise():
    """Every network salsa_tpu builds is built; a name it does not know raises."""
    enc = {"name": "PannResNet22", "n_input_channels": 7}
    for kw in ({"decoder_type": "rnn"}, {"freq_pool": "mean"}, {"compute_dtype": "float8"}):
        with pytest.raises(ValueError):
            tseld.build_model(encoder=enc, decoder=kw)
    for name in ("PannResNet22TPU", "PannResNet22"):
        for dtype in (None, "float32", "bfloat16"):
            tseld.build_model(encoder={"name": name, "compute_dtype": dtype}, decoder={})
    with pytest.raises(ValueError):
        tseld.build_model(encoder={"name": "PannResNet38"}, decoder={})
    with pytest.raises(ValueError):
        tseld.build_model(encoder={**enc, "compute_dtype": "half"}, decoder={})


def test_init_random_is_seeded_and_nontrivial():
    def make(seed):
        m = tseld.build_model(encoder={"n_input_channels": 7},
                              decoder={"decoder_type": "gru", "decoder_size": 16})
        return tseld.init_random_(m, torch.Generator().manual_seed(seed)).state_dict()

    a, b, c = make(0), make(0), make(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.conv_block1.conv1.weight"],
                           c["encoder.conv_block1.conv1.weight"])
    rv = a["encoder.resnet.layer2.0.bn2.running_var"]
    assert not torch.allclose(rv, torch.ones_like(rv))
