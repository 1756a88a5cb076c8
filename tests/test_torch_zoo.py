"""The rest of salsa_tpu's model zoo in the port, fp32: every encoder (PannResNet22,
PannResNet22TPU) with every sequence decoder (gru, bigru, lstm, bilstm,
transformer) against `SeldNet.apply(train=False)` on one perturbed flax init,
the bottleneck trunk, the positional table, the weight converter both ways and
through both packages' checkpoints (Adam's moments included), the training
initializers, and `cli.train --resume` with an LSTM and a transformer decoder."""
import os
import pathlib
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import yaml  # noqa: E402

from salsa_tpu.interop.torch_export import (  # noqa: E402
    flax_to_torch_state_dict as j_flax_to_torch_state_dict,
)
from salsa_tpu.models import layers as jlayers  # noqa: E402
from salsa_tpu.models import seld as jseld  # noqa: E402
from salsa_tpu.train import checkpoint as jckpt  # noqa: E402
from salsa_tpu.train.state import create_train_state  # noqa: E402
from salsa_tpu.train.state import make_optimizer as j_make_optimizer  # noqa: E402
from salsa_tpu_torch.cli import train as cli_train  # noqa: E402
from salsa_tpu_torch.interop import (  # noqa: E402
    flax_to_torch_state_dict,
    load_flax_variables,
    torch_state_dict_to_flax,
)
from salsa_tpu_torch.models import layers as tlayers  # noqa: E402
from salsa_tpu_torch.models import seld as tseld  # noqa: E402
from salsa_tpu_torch.models.decoders import SeldDecoder  # noqa: E402
from salsa_tpu_torch.train import checkpoint as tckpt  # noqa: E402
from salsa_tpu_torch.train.state import make_optimizer  # noqa: E402
from tests.test_torch_models import flax_init  # noqa: E402

ENCODERS = ("PannResNet22", "PannResNet22TPU")
DECODERS = ("gru", "bigru", "lstm", "bilstm", "transformer")
N_CLASSES = 5


@pytest.fixture
def scratch():
    """A temporary directory removed after the test: its full-width checkpoints
    (135 MB each with Adam's moments) would otherwise stay in the temp trees that
    pytest keeps from its last runs, and fill the disk."""
    with tempfile.TemporaryDirectory() as d:
        yield pathlib.Path(d)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for this file, beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _configs(encoder, decoder_type, size=32):
    return ({"name": encoder, "n_input_channels": 7},
            {"name": "SeldDecoder", "decoder_type": decoder_type, "decoder_size": size,
             "freq_pool": "avg"})


@pytest.mark.parametrize("decoder_type", DECODERS)
@pytest.mark.parametrize("encoder", ENCODERS)
def test_every_network_matches_flax(rng, encoder, decoder_type):
    """One perturbed flax init carried across strictly; eval-mode outputs at
    test_seldnet_matches_flax's atol 5e-4 / rtol 1e-3, the outputs' std > 0.05.
    The heads' last kernels are scaled by 4: an LSTM's outputs read std 0.044-0.049
    on this seed without it."""
    enc, dec = _configs(encoder, decoder_type)
    x = rng.standard_normal((2, 7, 64, 32)).astype(np.float32)
    j_model = jseld.build_model(encoder=enc, decoder=dec, n_classes=N_CLASSES)
    params, stats = flax_init(rng, j_model, x)
    for head in ("event", "x", "y", "z"):
        params["decoder"][f"{head}_fc2"]["kernel"] = 4 * params["decoder"][f"{head}_fc2"]["kernel"]
    want = j_model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), train=False)
    t_model = load_flax_variables(tseld.build_model(encoder=enc, decoder=dec,
                                                    n_classes=N_CLASSES), params, stats).eval()
    assert type(t_model.encoder).__name__ == encoder and t_model.time_downsample_ratio == 16
    with torch.no_grad():
        got = t_model(torch.from_numpy(x))
    for k in ("event_frame_logit", "doa_frame_output"):
        assert got[k].shape == want[k].shape and got[k].dtype == torch.float32
        assert np.asarray(want[k]).std() > 0.05  # the comparison is not vacuous
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=5e-4, rtol=1e-3)


def test_tpu_encoder_is_another_network_on_the_same_weights(rng):
    """A PannResNet22TPU tree loads strictly into PannResNet22 (same names and
    shapes), and the two networks give different outputs on it: the encoder has to
    come from the config."""
    enc, dec = _configs("PannResNet22TPU", "bigru", 16)
    x = rng.standard_normal((2, 7, 64, 32)).astype(np.float32)
    params, stats = flax_init(rng, jseld.build_model(encoder=enc, decoder=dec,
                                                     n_classes=N_CLASSES), x)
    outs = {}
    for name in ENCODERS:
        model = load_flax_variables(tseld.build_model(
            encoder={**enc, "name": name}, decoder=dec, n_classes=N_CLASSES), params, stats)
        with torch.no_grad():
            outs[name] = model.eval()(torch.from_numpy(x))["doa_frame_output"].numpy()
    assert outs["PannResNet22"].shape == outs["PannResNet22TPU"].shape
    # 20x the parity bound of test_every_network_matches_flax (read 0.032)
    assert np.abs(outs["PannResNet22"] - outs["PannResNet22TPU"]).max() > 1e-2


def _bottleneck_sd(params, stats, layers):
    """salsa_tpu's bottleneck trunk tree -> the port's ResNetTrunk names."""
    sd, b = {}, 0
    for stage, n_blocks in enumerate(layers):
        for i in range(n_blocks):
            blk, st = params[f"ResNetBottleneckBlock_{b}"], stats[f"ResNetBottleneckBlock_{b}"]
            parts = [("Conv_0", "BatchNorm_0", "conv1", "bn1"), ("Conv_1", "BatchNorm_1",
                                                                  "conv2", "bn2"),
                     ("Conv_2", "BatchNorm_2", "conv3", "bn3")]
            if "Conv_3" in blk:
                off = 1 if stage > 0 else 0
                parts.append(("Conv_3", "BatchNorm_3", f"downsample.{off}",
                              f"downsample.{off + 1}"))
            for conv, bn, tconv, tbn in parts:
                base = f"layer{stage + 1}.{i}."
                sd[base + tconv + ".weight"] = np.transpose(blk[conv]["kernel"], (3, 2, 0, 1))
                sd[base + tbn + ".weight"] = blk[bn]["scale"]
                sd[base + tbn + ".bias"] = blk[bn]["bias"]
                sd[base + tbn + ".running_mean"] = st[bn]["mean"]
                sd[base + tbn + ".running_var"] = st[bn]["var"]
            b += 1
    return sd


@pytest.mark.parametrize("layers", [(1, 1, 1, 1), (2, 1, 2, 1)])
def test_bottleneck_trunk_matches_flax(rng, layers):
    """ResNetTrunk(block='bottleneck') against salsa_tpu's on one perturbed init:
    (1, 64, 32, 16) -> (1, 2048, 4, 2) at atol 5e-4 / rtol 1e-3; the reference
    names (conv1..3, bn1..3, downsample) load strictly."""
    x = rng.standard_normal((1, 64, 32, 16)).astype(np.float32)
    j_trunk = jlayers.ResNetTrunk(layers=layers, block="bottleneck")
    params, stats = flax_init(rng, j_trunk, np.transpose(x, (0, 2, 3, 1)))
    want = np.transpose(np.asarray(j_trunk.apply({"params": params, "batch_stats": stats},
                                                 jnp.asarray(np.transpose(x, (0, 2, 3, 1))),
                                                 train=False)), (0, 3, 1, 2))
    trunk = tlayers.ResNetTrunk(layers=layers, block="bottleneck")
    sd = {k: torch.from_numpy(np.array(v)) for k, v in _bottleneck_sd(params, stats,
                                                                        layers).items()}
    missing, unexpected = trunk.load_state_dict(sd, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    with torch.no_grad():
        got = trunk.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 2048, 4, 2) and want.std() > 0.05
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-3)
    init = tseld.init_train_(tlayers.ResNetTrunk(layers=layers, block="bottleneck"),
                             torch.Generator().manual_seed(0))
    assert not init.layer1[0].bn3.weight.any() and init.layer1[0].bn2.weight.all()


@pytest.mark.parametrize("pos_len,d_model", [(2000, 512), (2000, 64), (37, 6)])
def test_sinusoid_position_encoding_bit_equal(pos_len, d_model):
    got = tlayers.sinusoid_position_encoding(pos_len, d_model)
    want = jlayers.sinusoid_position_encoding(pos_len, d_model)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_transformer_pe_buffer_and_length_limit():
    """The reference's `decoder.pe.pe` (1, d_model, 2000) is in the state dict; a
    sequence longer than the table raises, as salsa_tpu's slice would fail."""
    dec = SeldDecoder(n_output_channels=64, n_classes=3, decoder_type="transformer").eval()
    pe = dec.state_dict()["pe.pe"]
    assert pe.shape == (1, 64, 2000)
    np.testing.assert_array_equal(pe[0].numpy().T, jlayers.sinusoid_position_encoding(2000, 64))
    with torch.no_grad():
        assert dec(torch.zeros(1, 64, 2000, 2))["event_frame_logit"].shape == (1, 2000, 3)
        with pytest.raises(ValueError, match="longer than"):
            dec(torch.zeros(1, 64, 2001, 2))


@pytest.mark.parametrize("encoder", ENCODERS)
@pytest.mark.parametrize("decoder_type", ["lstm", "bilstm", "transformer"])
def test_converter_both_ways(rng, encoder, decoder_type):
    """The port's converter gives salsa_tpu's state_dict key for key (in order) and
    array for array; its inverse gives back the flax tree (names, shapes, values)."""
    enc, dec = _configs(encoder, decoder_type, 16)
    model = jseld.build_model(encoder=enc, decoder=dec, n_classes=3)
    params, stats = flax_init(rng, model, np.zeros((1, 7, 64, 32), np.float32))
    want = j_flax_to_torch_state_dict(params, stats)
    got = flax_to_torch_state_dict(params, stats)
    assert list(got) == list(want) and len(got) > 100
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back_params, back_stats = torch_state_dict_to_flax(got)
    for tree, back in ((params, back_params), (stats, back_stats)):
        flat = jax.tree_util.tree_leaves_with_path(tree)
        back_flat = dict(jax.tree_util.tree_leaves_with_path(back))
        assert len(flat) == len(back_flat)
        for path, leaf in flat:
            np.testing.assert_array_equal(back_flat[path], np.asarray(leaf),
                                          err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("decoder_type", ["lstm", "transformer"])
def test_checkpoints_cross_both_ways(scratch, rng, decoder_type):
    """A port checkpoint after two Adam updates restores in salsa_tpu's TrainState
    (weights and Adam's moments), and a salsa_tpu checkpoint with moments loads
    strictly into the port and into its optimizer."""
    enc, dec = _configs("PannResNet22TPU", decoder_type, 8)
    jmodel = jseld.build_model(encoder=enc, decoder=dec, n_classes=3)
    jstate = create_train_state(jmodel, jnp.zeros((1, 7, 32, 16)), j_make_optimizer(10))
    model = tseld.init_train_(tseld.build_model(encoder=enc, decoder=dec, n_classes=3),
                              torch.Generator().manual_seed(0))
    opt = make_optimizer(model.parameters(), 10)
    x = torch.from_numpy(rng.standard_normal((2, 7, 32, 16)).astype(np.float32))
    for _ in range(2):
        out = model(x)
        (out["event_frame_logit"].square().mean() + out["doa_frame_output"].mean()).backward()
        opt.step()
        opt.zero_grad()
    params, stats = torch_state_dict_to_flax(model.state_dict())
    path = tckpt.save_checkpoint(str(scratch / "port"), "epoch001", params, stats, opt.count,
                                 {"epoch": 1}, opt_state=opt.optax_state(model))
    restored = jckpt.restore_checkpoint(path, jstate)
    assert int(restored.step) == 2 and int(restored.opt_state.count) == 2
    sd = flax_to_torch_state_dict(*jax.device_get((restored.params, restored.batch_stats)))
    mu = flax_to_torch_state_dict(jax.device_get(restored.opt_state.inner_state[0].mu),
                                  jax.device_get(restored.batch_stats))
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(sd[k], v.numpy(), err_msg=k)
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(mu[name], opt.optimizer.state[p]["exp_avg"].numpy())

    # salsa_tpu -> port: moments made non-zero, then restored
    noisy = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32)), t)
    inner = restored.opt_state.inner_state[0]
    inner = inner._replace(mu=noisy(inner.mu), nu=jax.tree_util.tree_map(jnp.abs,
                                                                          noisy(inner.nu)))
    opt_state = restored.opt_state._replace(
        inner_state=(inner,) + tuple(restored.opt_state.inner_state[1:]))
    jpath = jckpt.save_checkpoint(str(scratch / "jax"), "epoch002",
                                  restored.replace(opt_state=opt_state), {"epoch": 2})
    p2, s2, o2 = tckpt.restore_train_state(jpath)
    fresh = tseld.build_model(encoder=enc, decoder=dec, n_classes=3)
    load_flax_variables(fresh, p2, s2)  # strict
    opt2 = make_optimizer(fresh.parameters(), 10)
    opt2.load_optax_state(fresh, o2)
    want_mu = flax_to_torch_state_dict(jax.device_get(inner.mu),
                                       jax.device_get(restored.batch_stats))
    for name, p in fresh.named_parameters():
        np.testing.assert_array_equal(opt2.optimizer.state[p]["exp_avg"].numpy(),
                                      want_mu[name], err_msg=name)
    assert opt2.count == 2


def test_init_train_follows_salsa_tpu_initializers():
    """init_train_ of an LSTM and a transformer decoder against salsa_tpu's flax
    init: the LSTM's gate blocks uniform(+-sqrt(3 / fan_in)), the recurrent weight's
    last (o) block orthogonal, biases 0; the transformer's attention and
    feed-forward kernels lecun-normal (std within 10 % of the flax init's), biases
    0, LayerNorm 1 and 0; every key of salsa_tpu's tree present."""
    h = 16
    for decoder_type in ("bilstm", "transformer"):
        enc, dec = _configs("PannResNet22", decoder_type, h)
        jvars = jseld.build_model(encoder=enc, decoder=dec, n_classes=3).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 7, 32, 16)), train=False)
        want = flax_to_torch_state_dict(*jax.device_get((jvars["params"],
                                                         jvars["batch_stats"])))
        model = tseld.init_train_(tseld.build_model(encoder=enc, decoder=dec, n_classes=3),
                                  torch.Generator().manual_seed(1))
        sd = model.state_dict()
        assert set(sd) == set(want)
        for k, v in sd.items():
            v, w = v.numpy(), want[k]
            if k == "decoder.pe.pe" or v.ndim <= 1:
                np.testing.assert_array_equal(v, w, err_msg=k)
            elif k.startswith("decoder.lstm."):
                lim = np.sqrt(3.0 / v.shape[1])
                part = v[:3 * h] if "weight_hh" in k else v
                assert 0.9 * lim < np.abs(part).max() <= lim * (1 + 1e-6), k
                if "weight_hh" in k:
                    o = v[3 * h:]
                    np.testing.assert_allclose(o @ o.T, np.eye(h), atol=1e-5, err_msg=k)
            elif "decoder_layer" in k:
                np.testing.assert_allclose(v.std(), w.std(), rtol=0.1, err_msg=k)
                fan_in = v.shape[1]
                assert np.abs(v).max() <= 2 * np.sqrt(1 / fan_in) / 0.8796 * (1 + 1e-6), k


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """2 s clips at 8 kHz with DCASE metadata and train/val splits
    (test_torch_resume.py's corpus)."""
    from salsa_tpu.utils.audio_io import write_wav
    from tests.test_from_wav import _synth_wave_8k
    from tests.test_torch_cli_train import FS, TRAIN, VAL

    root = str(tmp_path_factory.mktemp("torch_zoo"))
    rng = np.random.default_rng(20261021)
    for sub in ("foa_dev", "metadata_dev", "meta"):
        os.makedirs(os.path.join(root, sub))
    for i, name in enumerate(TRAIN + VAL):
        write_wav(os.path.join(root, "foa_dev", name + ".wav"), _synth_wave_8k(rng, 2.0), FS,
                  bits=16)
        rows = [f"{f},{(f + i) % 3},0,{(f * 11) % 360 - 180},{(f * 5) % 60 - 30}"
                for f in range(4, 16)]
        with open(os.path.join(root, "metadata_dev", name + ".csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
    for split, names in (("train", TRAIN), ("val", VAL)):
        with open(os.path.join(root, "meta", f"{split}.csv"), "w") as f:
            f.write("filename\n" + "\n".join(names))
    return root


def _resume_config(root, decoder_type):
    from tests.test_torch_cli_train import _config

    cfg = _config(root, max_epochs=1, device_augment=True)
    cfg["data"]["train_fraction"] = 0.7
    cfg["model"]["decoder"].update(decoder_type=decoder_type, head_dropout=0.2,
                                   rnn_dropout=0.3)
    path = os.path.join(root, f"resume_{decoder_type}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return path


@pytest.mark.parametrize("decoder_type", ["lstm", "transformer"])
def test_cli_resume_with_the_new_decoders(corpus, scratch, decoder_type):
    """cli.train for 1 epoch, then --resume to 3, equals a fresh 3-epoch run bit for
    bit (dropout and augmentation on, constant lr): the weights and Adam's state of
    every new parameter go through the checkpoint."""
    config = _resume_config(corpus, decoder_type)
    group = str(scratch / "outputs")
    cli_train.train(config, group, device="cpu")
    tr = cli_train.train(config, group, device="cpu", resume=True,
                         overrides=["training.max_epochs=3"])
    fresh = cli_train.train(config, str(scratch / "fresh"), device="cpu",
                            overrides=["training.max_epochs=3"])
    assert tr.optimizer.count == fresh.optimizer.count == 6
    assert tr.step_losses == fresh.step_losses
    want = fresh.model.state_dict()
    for k, v in tr.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, want[k]), k
