"""salsa_tpu_torch.train (losses, schedules, the scheduled optimizer, the
optimizer state in optax's layout) and the models' training mode (BatchNorm's
running statistics, dropout from a generator, the fresh init) against
salsa_tpu, optax and flax on seeded inputs; and the trainer's options."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax import linen as fnn  # noqa: E402

from salsa_tpu.models.seld import build_model as j_build_model  # noqa: E402
from salsa_tpu.train import checkpoint as jckpt  # noqa: E402
from salsa_tpu.train import losses as jlosses  # noqa: E402
from salsa_tpu.train import submission as jsubmission  # noqa: E402
from salsa_tpu.train.schedules import make_lr_momentum_schedules as j_schedules  # noqa: E402
from salsa_tpu.train.state import create_train_state  # noqa: E402
from salsa_tpu.train.state import make_optimizer as j_make_optimizer  # noqa: E402
from salsa_tpu_torch import submission  # noqa: E402
from salsa_tpu_torch.interop import flax_to_torch_state_dict, torch_state_dict_to_flax  # noqa: E402
from salsa_tpu_torch.models.layers import BatchNorm2d, Dropout  # noqa: E402
from salsa_tpu_torch.models.decoders import SeldDecoder  # noqa: E402
from salsa_tpu_torch.models.seld import build_model, init_train_  # noqa: E402
from salsa_tpu_torch.train import losses  # noqa: E402
from salsa_tpu_torch.train.checkpoint import save_checkpoint  # noqa: E402
from salsa_tpu_torch.train.schedules import make_lr_momentum_schedules  # noqa: E402
from salsa_tpu_torch.train.state import make_optimizer  # noqa: E402
from salsa_tpu_torch.train.trainer import SeldTrainer, resolve_device  # noqa: E402
from salsa_tpu_torch.utils.config import AttrDict  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs test files side by side, several workers on a few cores: two
    intra-op threads for this file keep torch's pools from thrashing against the
    other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


C = 3  # classes


def _pred_target(rng, b=2, t=10, sparse=0.4):
    pred = {"event_frame_logit": rng.normal(0, 2, (b, t + 2, C)).astype(np.float32),
            "doa_frame_output": np.tanh(rng.normal(0, 1, (b, t + 2, 3 * C))).astype(np.float32)}
    sed = (rng.random((b, t, C)) < sparse).astype(np.float32)
    target = {"event_frame_gt": sed,
              "doa_frame_gt": (rng.normal(0, 0.5, (b, t, 3 * C)) * np.tile(sed, 3)).astype(
                  np.float32)}
    return pred, target


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def test_losses_match_salsa_tpu(rng):
    pred, target = _pred_target(rng)
    # training losses see equal frame counts
    pred = {k: v[:, :10] for k, v in pred.items()}
    got = losses.seld_loss(_torch(pred), _torch(target), C, (0.3, 0.7))
    want = jlosses.seld_loss(_jax(pred), _jax(target), C, (0.3, 0.7))
    np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want], rtol=1e-6)
    for silent in (0.0, 0.5):
        got = losses.accdoa_loss(_torch(pred), _torch(target), C, silent_weight=silent)
        want = jlosses.accdoa_loss(_jax(pred), _jax(target), C, silent_weight=silent)
        np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want],
                                   rtol=1e-6, err_msg=f"silent_weight {silent}")
        assert (float(got[1]) > 0) == (silent > 0)
    logit, tgt = pred["event_frame_logit"], target["event_frame_gt"]
    row = np.array([1.0, 0.0], np.float32)
    for w in (None, row):
        got = losses.bce_with_logits(torch.from_numpy(logit), torch.from_numpy(tgt),
                                     None if w is None else torch.from_numpy(w))
        want = jlosses.bce_with_logits(jnp.asarray(logit), jnp.asarray(tgt),
                                       None if w is None else jnp.asarray(w))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    doa_p, doa_g = pred["doa_frame_output"], target["doa_frame_gt"]
    for kind in ("MAE", "MSE"):
        got = losses.masked_reg_loss(torch.from_numpy(doa_p[..., :C]),
                                     torch.from_numpy(doa_g[..., :C]), torch.from_numpy(tgt), kind)
        want = jlosses.masked_reg_loss(jnp.asarray(doa_p[..., :C]), jnp.asarray(doa_g[..., :C]),
                                       jnp.asarray(tgt), kind)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    got = losses.accdoa_mse(torch.from_numpy(doa_p), torch.from_numpy(doa_g),
                            torch.from_numpy(tgt), C, 17)
    want = jlosses.accdoa_mse(jnp.asarray(doa_p), jnp.asarray(doa_g), jnp.asarray(tgt), C, 17)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    with pytest.raises(ValueError):
        losses.masked_reg_loss(torch.ones(1, 2, 1), torch.ones(1, 2, 1), torch.ones(1, 2, 1),
                               "huber")


@pytest.mark.parametrize("total,milestones,lrs,moms", [
    (137, (0.0, 0.1, 0.7, 1.0), (3e-4, 3e-4, 3e-4, 1e-4), (0.9, 0.85, 0.9, 0.95)),
    (20, (0.0, 1.0), (1e-3, 1e-4), (0.9, 0.8)),
    (1000, (0.0, 0.1, 0.7, 1.0), (3e-4, 3e-4, 3e-4, 1e-4), (0.9, 0.9, 0.9, 0.9)),
])
def test_schedules_equal_salsa_tpu(total, milestones, lrs, moms):
    """Equal float32 values at every step, before the first milestone and past
    the last."""
    jl, jm = j_schedules(total, milestones, lrs, moms)
    tl, tm = make_lr_momentum_schedules(total, milestones, lrs, moms)
    for step in range(-2, total + 5):
        assert tl(step) == np.float32(jl(step)), step
        assert tm(step) == np.float32(jm(step)), step


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_optimizer_matches_optax_inject_hyperparams(rng, name):
    """50 steps with scheduled lr and beta1 on the same gradients: the parameters
    within rtol 1e-5 of salsa_tpu's optax.inject_hyperparams(optax.adam[w]), the
    injected hyperparameters equal, and the state in optax's layout restorable by
    flax against salsa_tpu's optimizer state."""
    kw = dict(milestones=(0.0, 0.3, 0.7, 1.0), lrs=(1e-3, 3e-3, 3e-3, 1e-4),
              moms=(0.95, 0.8, 0.9, 0.85))
    w0 = rng.standard_normal((5, 7)).astype(np.float32)
    tx = j_make_optimizer(50, name, **kw)
    params = {"w": jnp.asarray(w0)}
    state = tx.init(params)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = make_optimizer([p], 50, name, **kw)
    for k in range(50):
        g = rng.standard_normal(w0.shape).astype(np.float32)
        updates, state = tx.update({"w": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, updates)
        p.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params["w"]), rtol=1e-5,
                                   atol=1e-7, err_msg=f"step {k}")
        assert opt.lr == np.float32(state.hyperparams["learning_rate"])
        assert opt.b1 == np.float32(state.hyperparams["b1"])
    assert opt.count == int(state.count) == 50


def test_optimizer_state_restores_in_salsa_tpu(tmp_path, rng):
    """A port checkpoint after two updates carries the optimizer state in optax's
    layout: salsa_tpu's restore_checkpoint reads it into its own TrainState
    (params, batch_stats, Adam's count and moments)."""
    enc = {"name": "PannResNet22", "n_input_channels": 7}
    dec = {"name": "SeldDecoder", "decoder_type": "gru", "decoder_size": 8}
    jmodel = j_build_model(encoder=enc, decoder=dec, n_classes=C)
    jstate = create_train_state(jmodel, jnp.zeros((1, 7, 32, 16)), j_make_optimizer(10))
    model = init_train_(build_model(encoder=enc, decoder=dec, n_classes=C),
                        torch.Generator().manual_seed(0))
    opt = make_optimizer(model.parameters(), 10)
    x = torch.from_numpy(rng.standard_normal((2, 7, 32, 16)).astype(np.float32))
    for _ in range(2):
        out = model(x)
        (out["event_frame_logit"].square().mean() + out["doa_frame_output"].mean()).backward()
        opt.step()
        opt.zero_grad()
    params, stats = torch_state_dict_to_flax(model.state_dict())
    path = save_checkpoint(str(tmp_path), "epoch001", params, stats, opt.count, {"epoch": 1},
                           opt_state=opt.optax_state(model))
    restored = jckpt.restore_checkpoint(path, jstate)
    assert int(restored.step) == 2 and int(restored.opt_state.count) == 2
    sd = flax_to_torch_state_dict(jax.device_get(restored.params),
                                  jax.device_get(restored.batch_stats))
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):  # a torch counter flax does not keep
            np.testing.assert_array_equal(sd[k], v.numpy(), err_msg=k)
    mu = flax_to_torch_state_dict(jax.device_get(restored.opt_state.inner_state[0].mu),
                                  jax.device_get(restored.batch_stats))
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(mu[name], opt.optimizer.state[p]["exp_avg"].numpy())


def test_batchnorm_training_mode_matches_flax(rng):
    """Four training-mode calls: outputs within atol 1e-5 of flax's BatchNorm and
    the running statistics within rtol 1e-6, flax's momentum 0.9 with the biased
    batch variance (torch's own update would be off by n / (n - 1) = 1.008 here)."""
    n_ch = 5
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    x0 = jnp.zeros((3, 6, 7, n_ch))
    variables = bn.init(jax.random.PRNGKey(0), x0)
    scale = rng.uniform(0.5, 1.5, n_ch).astype(np.float32)
    bias = rng.normal(0, 0.1, n_ch).astype(np.float32)
    stats = {"mean": rng.normal(0, 0.1, n_ch).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, n_ch).astype(np.float32)}
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    jstats = {k: jnp.asarray(v) for k, v in stats.items()}
    assert set(variables["batch_stats"]) == set(jstats)
    tbn = BatchNorm2d(n_ch, eps=1e-5, momentum=0.1).train()
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(scale))
        tbn.bias.copy_(torch.from_numpy(bias))
        tbn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        tbn.running_var.copy_(torch.from_numpy(stats["var"]))
    for _ in range(4):
        x = (rng.standard_normal((3, 6, 7, n_ch)) * 2 + 1).astype(np.float32)
        want, upd = bn.apply({"params": params, "batch_stats": jstats}, jnp.asarray(x),
                             mutable=["batch_stats"])
        jstats = upd["batch_stats"]
        got = tbn(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                                   atol=1e-5)
        np.testing.assert_allclose(tbn.running_mean.numpy(), np.asarray(jstats["mean"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(tbn.running_var.numpy(), np.asarray(jstats["var"]), rtol=1e-6)
    assert int(tbn.num_batches_tracked) == 4
    tbn.eval()  # eval mode normalizes by the running statistics, as torch's does
    x = torch.from_numpy(rng.standard_normal((2, n_ch, 3, 3)).astype(np.float32))
    ref = torch.nn.functional.batch_norm(x, tbn.running_mean, tbn.running_var, tbn.weight,
                                         tbn.bias, False, 0.0, 1e-5)
    assert torch.equal(tbn(x), ref)


def test_dropout_draws_from_its_generator():
    d = Dropout(0.25).train()
    x = torch.ones(200, 300)
    d.generator = torch.Generator().manual_seed(3)
    a = d(x)
    d.generator = torch.Generator().manual_seed(3)
    assert torch.equal(a, d(x))  # the same generator state, the same mask
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / 0.75))
    assert torch.equal(d.eval()(x), x) and torch.equal(Dropout(0.0).train()(x), x)


def test_gru_layers_one_at_a_time_equal_the_stack(rng):
    """With rnn_dropout in training mode the decoder runs its GRU layer by layer on
    the stack's own weights: with every unit kept that equals nn.GRU's 2-layer call,
    the gradients reach the stack's weights, and the dropout acts between the
    layers; in eval mode or at p = 0 the stack runs as one call."""
    dec = SeldDecoder(64, C, decoder_size=16, head_dropout=0.0, rnn_dropout=0.0).train()
    x = torch.from_numpy(rng.standard_normal((2, 7, 64)).astype(np.float32))
    want = dec.gru(x)[0]
    assert torch.equal(dec._per_layer(x), want) and torch.equal(dec._recur(x), want)
    dec._per_layer(x).square().sum().backward()
    for name, p in dec.gru.named_parameters():
        assert p.grad is not None and p.grad.abs().sum() > 0, name
    dec.rnn_dropout.p = 0.5
    dec.rnn_dropout.generator = torch.Generator().manual_seed(0)
    assert not torch.equal(dec._recur(x), want)
    assert torch.equal(dec.eval()._recur(x), want)  # no dropout in eval mode


def test_fresh_init_follows_salsa_tpu_initializers():
    """init_train_: the same BatchNorm scales zeroed as flax's init (each residual
    block's last), zero biases, running statistics (0, 1), Xavier-uniform convs
    and dense layers, GRU gates uniform(+-sqrt(3 / fan_in)) with an orthogonal
    recurrent candidate block."""
    enc = {"name": "PannResNet22", "n_input_channels": 7}
    dec = {"name": "SeldDecoder", "decoder_type": "bigru", "decoder_size": 16}
    jvars = j_build_model(encoder=enc, decoder=dec, n_classes=C).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 7, 32, 16)), train=False)
    want = flax_to_torch_state_dict(jax.device_get(jvars["params"]),
                                    jax.device_get(jvars["batch_stats"]))
    model = init_train_(build_model(encoder=enc, decoder=dec, n_classes=C),
                        torch.Generator().manual_seed(1))
    sd = model.state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        v, w = v.numpy(), want[k]
        if v.ndim <= 1:  # BN scales (1, or 0 as flax's), shifts and stats, biases
            np.testing.assert_array_equal(v, w, err_msg=k)
            continue
        if k.startswith("decoder.gru."):
            lim = np.sqrt(3.0 / v.shape[1])  # per gate, fan_in = the gate's inputs
            if "weight_hh" in k:
                v = v[:2 * v.shape[1]]  # r and z; the candidate block is orthogonal
        else:
            fan_in, fan_out = v.shape[1] * v[0, 0].size, v.shape[0] * v[0, 0].size
            lim = np.sqrt(6.0 / (fan_in + fan_out))
        assert 0.9 * lim < np.abs(v).max() <= lim * (1 + 1e-6), k
    h = 16
    for name, p in model.decoder.gru.named_parameters():
        if name.startswith("weight_hh"):
            cand = p[2 * h:].detach()
            assert torch.allclose(cand @ cand.T, torch.eye(h), atol=1e-5), name
        if name.startswith("bias"):
            assert not p.any(), name
    assert not model.encoder.resnet.layer1[0].bn2.weight.any()


def test_combine_chunks_and_sed_from_accdoa_equal_salsa_tpu(rng):
    chunks = rng.uniform(0.05, 1.0, (5, 16, 2 * C)).astype(np.float32)
    np.testing.assert_array_equal(submission.combine_chunks(chunks, 16, 8, 48),
                                  jsubmission.combine_chunks(chunks, 16, 8, 48, "mean"))
    with pytest.raises(ValueError):
        submission.combine_chunks(chunks[:2], 16, 8, 48)  # 2 chunks where 5 are expected
    doa = rng.normal(0, 0.5, (10, 3 * C)).astype(np.float32)
    want = jsubmission.sed_from_accdoa(doa, C)
    np.testing.assert_array_equal(submission.sed_from_accdoa(doa, C), want)
    np.testing.assert_array_equal(submission.sed_from_accdoa(torch.from_numpy(doa), C).numpy(),
                                  want)


# the store-fed options train: device_data, remat and precompute
PORTED = [
    {"training": {"from_wav": False, "device_data": True}},
    {"training": {"remat": True}},
    {"training": {"from_wav": True, "from_wav_mode": "precompute"}},
    {"training": {"device_data": True, "device_data_dtype": "bfloat16", "remat": True}},
]


@pytest.mark.parametrize("cfg", PORTED)
def test_trainer_takes_the_store_fed_options(cfg, tmp_path):
    """Each option builds a trainer on a feature-store split and takes a step:
    device_data keeps the split on the device (in its dtype), remat wraps the
    encoder's blocks, precompute (which cli.train turns into device_data) on a
    store split is the host path."""
    from salsa_tpu_torch.data.database import SplitData
    from tests.torch_parallel_worker import DEC, ENC, N_CLASSES, feature_arrays, feature_config

    conf = feature_config("host", epochs=1, train_fraction=0.125)
    conf["training"].update(cfg["training"])
    tr = SeldTrainer(model=build_model(encoder=ENC, decoder=DEC, n_classes=N_CLASSES),
                     cfg=AttrDict(conf), train_data=SplitData(**feature_arrays()),
                     val_data=None, gt_meta_dir=None, submission_dir=str(tmp_path), seed=3,
                     device="cpu")
    t = cfg["training"]
    assert tr.device_data == bool(t.get("device_data")) and not tr.from_wav
    assert (tr.remat_blocks > 0) == bool(t.get("remat"))
    if tr.device_data:
        assert tr._feats.dtype == (torch.bfloat16 if t.get("device_data_dtype") == "bfloat16"
                                   else torch.float32)
    assert np.isfinite(tr.train_epoch(0)["loss"])


@pytest.mark.parametrize("part", ["encoder", "decoder"])
def test_trainer_takes_the_compute_dtype(part):
    """compute_dtype is no refusal: bfloat16 builds a model that computes in it,
    and a name the port does not run raises ValueError."""
    enc, dec = {"n_input_channels": 7}, {"decoder_type": "gru", "decoder_size": 8}
    model = build_model(encoder={**enc, **({"compute_dtype": "bfloat16"} if part == "encoder"
                                           else {})},
                        decoder={**dec, **({"compute_dtype": "bfloat16"} if part == "decoder"
                                           else {})})
    assert getattr(model, part).compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="compute_dtype 'float8'"):
        build_model(encoder={**enc, "compute_dtype": "float8"} if part == "encoder" else enc,
                    decoder={**dec, "compute_dtype": "float8"} if part == "decoder" else dec)


def test_trainer_defaults_to_the_card():
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device("cuda")
