"""The port's fused raw-wav trainer against salsa_tpu's, the slice as a whole.

One synthetic from-wav corpus (8 kHz FOA, n_fft 256, 0.8 s chunks), one flax
init converted by `salsa_tpu_torch.interop`, fp32, dropout 0 in both (salsa_tpu's
FastDropout is patched to the identity for these tests, the port's dropouts set to
p = 0), the same scaler and the same epoch order: `salsa_tpu.train.trainer.
SeldTrainer` (spatial stage eig_method='pallas', in interpret mode here, which is
K1's arithmetic) and `salsa_tpu_torch.train.trainer.SeldTrainer(device="cpu")`
(plain K1 and K2) train 20 steps, one step an epoch. Step 1's loss agrees within
rtol 1e-4 and every step's within 2e-3, salsa_tpu's own cross-path bound
(tests/test_from_wav.py), and each trained parameter and BatchNorm statistic has
moved from the init as salsa_tpu's has. Then validate() on equal weights writes
the same CSV rows and gives the same scores.
"""
import importlib
import logging
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402

# the module (salsa_tpu.ops re-exports its function under the same name)
jdropout = importlib.import_module("salsa_tpu.ops.dropout")
from salsa_tpu.data import wav_database as jwav  # noqa: E402
from salsa_tpu.data.database import SeldDatabase as JDatabase  # noqa: E402
from salsa_tpu.features.registry import make_extractor as j_make_extractor  # noqa: E402
from salsa_tpu.models.seld import build_model as j_build_model  # noqa: E402
from salsa_tpu.parallel.mesh import replicate  # noqa: E402
from salsa_tpu.train.trainer import SeldTrainer as JTrainer  # noqa: E402
from salsa_tpu.utils.config import AttrDict as JAttrDict  # noqa: E402
from salsa_tpu_torch.data import wav_database as twav  # noqa: E402
from salsa_tpu_torch.data.database import SeldDatabase as TDatabase  # noqa: E402
from salsa_tpu_torch.interop import flax_to_torch_state_dict, load_flax_variables  # noqa: E402
from salsa_tpu_torch.features.registry import make_extractor  # noqa: E402
from salsa_tpu_torch.models.layers import Dropout  # noqa: E402
from salsa_tpu_torch.models.seld import build_model  # noqa: E402
from salsa_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from salsa_tpu_torch.train.trainer import SeldTrainer  # noqa: E402
from salsa_tpu_torch.utils.config import AttrDict  # noqa: E402
from tests.test_from_wav import E2E_FS, E2E_HOP, E2E_NFFT, _write_synth_corpus  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs test files side by side, several workers on a few cores: two
    intra-op threads for this file keep torch's pools from thrashing against the
    other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


N_CLASSES, N_STEPS, SEED = 3, 20, 7
# the worst tensor's relative change difference: read 0.044 (a residual block's last
# BatchNorm shift; the median tensor 7.8e-4), bound with room above it
WORST = 0.1
GEOMETRY = dict(audio_format="foa", n_classes=N_CLASSES, fs=E2E_FS, hop_len=E2E_HOP,
                train_chunk_len_s=0.8, train_chunk_hop_len_s=0.4, test_chunk_len_s=4.0,
                test_chunk_hop_len_s=4.1, scaler_channels=4, max_file_len_s=4.0)
ENC = {"name": "PannResNet22", "n_input_channels": 7}
DEC = {"name": "SeldDecoder", "decoder_type": "bigru", "decoder_size": 32, "freq_pool": "avg",
       "head_dropout": 0.0, "rnn_dropout": 0.0}


def trainer_config(feature_type="salsa", audio_format="foa", n_steps=N_STEPS):
    """27 train chunks at batch 2 and train_fraction 0.1: one step an epoch, so
    each epoch's mean loss is that step's. lr 1e-4: at 1e-3 both runs stay within
    2e-3 for 3 steps only (Adam turns float32 rounding of small gradients into
    whole-lr steps, and the batch of 2 amplifies it)."""
    data = {"fs": E2E_FS, "n_fft": E2E_NFFT, "hop_len": E2E_HOP, "n_classes": N_CLASSES,
            "audio_format": audio_format, "label_rate": 10, "output_format": "reg_xyz",
            "max_file_len_s": 4.0, "train_fraction": 0.1}
    if feature_type == "salsa":
        data["fmax_doa"] = 3000.0
    return {
        "feature_type": feature_type,
        "data": data,
        "training": {"train_batch_size": 2, "max_epochs": n_steps, "from_wav": True,
                     "eig_method": "pallas", "steps_per_dispatch": 1,
                     "lr_scheduler": {"milestones": [0.0, 0.5, 1.0], "lrs": [1e-4, 1e-4, 2e-5],
                                      "moms": [0.9, 0.85, 0.9]}},
        "eval_version": "2021", "sed_threshold": 0.3, "doa_threshold": 20,
    }


def train_both(root, feature_type="salsa", audio_format="foa", n_steps=N_STEPS, enc=ENC,
               dec=DEC, experiment_dirs: bool = False):
    """Both trainers after n_steps steps from one flax init of the model (enc, dec),
    their per-step losses and the weights (a generator: salsa_tpu's dropout stays
    patched off until it is closed). With `experiment_dirs` each trainer's config
    has a `dir` tree of its own under root (`<root>/{jax,torch}/`: tensorboard,
    checkpoints, best), as `manage_experiments` makes it."""
    rng = np.random.default_rng(20261018)
    names, meta_dir = _write_synth_corpus(root, rng, n_clips=4, seconds=4.0)
    with open(os.path.join(meta_dir, "train.csv"), "w") as f:
        f.write("filename\n" + "\n".join(names[:3]))
    with open(os.path.join(meta_dir, "val.csv"), "w") as f:
        f.write("filename\n" + names[3])
    audio_dir = os.path.join(root, "foa_dev")
    kw = dict(fs=E2E_FS, n_fft=E2E_NFFT, hop_length=E2E_HOP)
    if feature_type == "salsa":
        kw["fmax_doa"] = 3000.0
    j_ex = j_make_extractor(feature_type, audio_format, eig_method="pallas", **kw)
    t_ex = make_extractor(feature_type, audio_format, **kw)
    geometry = dict(GEOMETRY, audio_format=audio_format)

    jdb = JDatabase(feature_root_dir=os.path.join(root, "features"), gt_meta_root_dir=root,
                    **geometry)
    jdb.n_fft = E2E_NFFT
    j_split = jwav.load_wav_split(jdb, "train", audio_dir, split_meta_dir=meta_dir,
                                  n_channels=7, n_features=j_ex.n_features)
    scaler = jwav.fit_scaler_from_waves(j_ex, j_split.clip_wavs, 4)
    j_val = JDatabase(feature_root_dir=None, gt_meta_root_dir=root, **geometry,
                      store=jwav.extract_split_to_store(j_ex, names[3:], audio_dir, E2E_FS,
                                                        scaler)
                      ).load_split("val", split_meta_dir=meta_dir, stage="inference")

    tdb = TDatabase(store=twav.MemoryFeatureStore({}, None), gt_meta_root_dir=root, **geometry)
    tdb.n_fft = E2E_NFFT
    t_split = twav.load_wav_split(tdb, "train", audio_dir, split_meta_dir=meta_dir,
                                  n_channels=7, n_features=t_ex.n_features)
    t_val = TDatabase(store=twav.extract_split_to_store(t_ex, names[3:], audio_dir, E2E_FS,
                                                        scaler, device="cpu"),
                      gt_meta_root_dir=root, **geometry
                      ).load_split("val", split_meta_dir=meta_dir, stage="inference")

    gt_dir = os.path.join(root, "metadata_dev")
    cfg = trainer_config(feature_type, audio_format, n_steps)
    cfgs = {}
    for pkg in ("jax", "torch"):
        top = os.path.join(root, pkg)
        cfgs[pkg] = dict(cfg, dir={"tb_dir": os.path.join(top, "tensorboard"), "model": {
            "checkpoint": os.path.join(top, "checkpoint"), "best": os.path.join(top, "best")}}
                         ) if experiment_dirs else cfg
    patch = pytest.MonkeyPatch()
    patch.setattr(jdropout, "dropout", lambda x, key, rate: x)  # salsa_tpu's dropout off
    try:
        jt = JTrainer(model=j_build_model(encoder=enc, decoder=dec, n_classes=N_CLASSES),
                      cfg=JAttrDict(cfgs["jax"]), train_data=j_split, val_data=j_val,
                      gt_meta_dir=gt_dir, submission_dir=os.path.join(root, "jax_subs"),
                      seed=SEED, scaler=scaler)
        # the step counter as the step leaves it (int32, replicated): one compile
        jt.state = jt.state.replace(step=replicate(jt.mesh, jnp.asarray(0, jnp.int32)))
        init = jax.device_get((jt.state.params, jt.state.batch_stats))
        tt = SeldTrainer(model=build_model(encoder=enc, decoder=dec, n_classes=N_CLASSES),
                         cfg=AttrDict(cfgs["torch"]), train_data=t_split, val_data=t_val,
                         gt_meta_dir=gt_dir, submission_dir=os.path.join(root, "torch_subs"),
                         seed=SEED, scaler=scaler, device="cpu")
        load_flax_variables(tt.model, *init)
        for m in tt.model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
        losses = {"jax": [], "torch": []}
        for epoch in range(n_steps):
            losses["jax"].append(jt.train_epoch(epoch)["loss"])
            losses["torch"].append(tt.train_epoch(epoch)["loss"])
        # the trained weights and statistics, torch-named, before a test reloads any
        weights = {"init": flax_to_torch_state_dict(*init),
                   "jax": flax_to_torch_state_dict(
                       *jax.device_get((jt.state.params, jt.state.batch_stats))),
                   "torch": {k: v.detach().numpy().copy()
                             for k, v in tt.model.state_dict().items()}}
        yield {"jax": jt, "torch": tt, "losses": losses, "j_split": j_split,
               "t_split": t_split, "weights": weights}
    finally:
        patch.undo()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both SALSA trainers after N_STEPS steps, their per-step losses, and the flax
    init they started from."""
    yield from train_both(str(tmp_path_factory.mktemp("torch_trainer")), experiment_dirs=True)


def test_trainer_tables_match_salsa_tpu(trained):
    """The resident chunk tables are salsa_tpu's; the tracker checkpoints (K2 with
    collect_states from the dequantized resident samples) agree with its
    lax.scan ones (salsa_tpu's clip-start floor, a jnp.mean, may be 1 ulp off the
    frame-order sum; ROADMAP queue 3)."""
    jt, tt = trained["jax"], trained["torch"]
    clip, f0, n_full, n_valid, l_start, floor_ck, cd_ck = (np.asarray(a) for a in jt._wav_tables)
    for want, got in ((clip, tt._clip), (f0, tt._f0), (n_full, tt._n_full),
                      (n_valid, tt._n_valid), (l_start, tt._l_start)):
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(tt._floor_ck.numpy(), floor_ck, rtol=1e-5)
    assert np.mean(tt._cd_ck.numpy() == cd_ck) > 0.999
    assert tt.steps_per_epoch == jt.steps_per_epoch == 1
    assert float(tt.interp_ratio) == float(jt.interp_ratio)


def assert_loss_traces_match(trained, n_steps):
    jl, tl = np.array(trained["losses"]["jax"]), np.array(trained["losses"]["torch"])
    assert len(tl) == n_steps and np.isfinite(tl).all()
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-4, err_msg=f"{jl} vs {tl}")
    np.testing.assert_allclose(tl, jl, rtol=2e-3, err_msg=f"{jl} vs {tl}")
    assert np.std(tl) > 0.01  # the steps see different batches and weights


def test_slice_loss_trace_matches_salsa_tpu(trained):
    assert_loss_traces_match(trained, N_STEPS)
    # the optimizer's count and the schedule's last values
    tt, jt = trained["torch"], trained["jax"]
    assert tt.optimizer.count == int(jt.state.step) == N_STEPS
    hp = jt.state.opt_state.hyperparams
    assert np.float32(tt.optimizer.lr) == np.float32(hp["learning_rate"])
    assert np.float32(tt.optimizer.b1) == np.float32(hp["b1"])


def test_slice_trained_weights_match_salsa_tpu(trained):
    """Every parameter and running statistic after the 20 steps: the port's change
    from the init against salsa_tpu's, |port change - salsa_tpu change| / |salsa_tpu
    change| per tensor. A tensor the port left unchanged, or changed by another
    update, reads about 1 or more; WORST is set from this slice's readings."""
    w = trained["weights"]
    ratios = {}
    for k, init in w["init"].items():
        if k.endswith("num_batches_tracked"):  # a torch counter flax does not keep
            continue
        want, got = w["jax"][k] - init, w["torch"][k] - init
        assert np.linalg.norm(want) > 0, k  # every tensor moves in salsa_tpu
        ratios[k] = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    worst = max(ratios, key=ratios.get)
    assert len(ratios) > 100 and any(".running_var" in k for k in ratios)
    assert ratios[worst] < WORST, (worst, ratios[worst])


def _threshold_in_a_gap(probs: np.ndarray) -> float:
    """A threshold near the median probability, midway across the widest gap
    between neighbouring probabilities there: no probability lies within half
    that gap of it, so rounding cannot move a row across."""
    p = np.sort(probs.ravel())
    lo, hi = len(p) // 4, 3 * len(p) // 4
    gaps = np.diff(p[lo:hi + 1])
    k = lo + int(np.argmax(gaps))
    return float((p[k] + p[k + 1]) / 2)


def test_validate_matches_salsa_tpu_on_equal_weights(trained):
    """salsa_tpu's trained weights loaded into the port: validate() writes the
    same CSV rows and gives the same scores and validation losses."""
    jt, tt = trained["jax"], trained["torch"]
    load_flax_variables(tt.model, *jax.device_get((jt.state.params, jt.state.batch_stats)))
    x = torch.from_numpy(tt.val_data.get_feature_chunk(0)[None].copy())
    probs = tt.eval_step(x)[0].numpy()
    jt.sed_threshold = tt.sed_threshold = _threshold_in_a_gap(probs)
    j_scores, t_scores = jt.validate(), tt.validate()
    rows = {}
    for name, tr in (("jax", jt), ("torch", tt)):
        sub = os.path.join(tr.submission_dir, "_temp")
        rows[name] = {f: open(os.path.join(sub, f)).read() for f in sorted(os.listdir(sub))}
    assert rows["jax"] == rows["torch"]
    n_rows = sum(text.count("\n") for text in rows["torch"].values())
    assert 0 < n_rows < probs.size, n_rows  # rows on both sides of the threshold
    assert set(t_scores) == set(j_scores)
    for k in j_scores:
        np.testing.assert_allclose(t_scores[k], j_scores[k], rtol=1e-9, err_msg=k)
    for k, v in jt.last_val_losses.items():
        np.testing.assert_allclose(tt.last_val_losses[k], v, rtol=1e-4, err_msg=k)



def test_tensorboard_scalars_match_salsa_tpu(trained):
    """With tensorboardX (2.6.4 here) each trainer writes one event file under its
    `dir.tb_dir`: after the N_STEPS steps, `validate()` of the test above and one
    more epoch of `fit()` (a step, validation, checkpoints), the two files hold the
    same tags at the same steps (`train/<k>` of each epoch's averages with lr and
    momentum, `val/<k>` of the validation losses and scores). The port's values are
    its own: the losses it logged for each step, and the last epoch's averages in
    its checkpoint sidecar."""
    jt, tt = trained["jax"], trained["torch"]
    for t in (jt, tt):
        t.max_epochs = 1
        t.fit()
    jt.tb.flush()
    got = chip_smoke.read_event_scalars(tt.cfg.dir.tb_dir)
    want = chip_smoke.read_event_scalars(jt.cfg.dir.tb_dir)
    assert {k: [s for s, _ in v] for k, v in got.items()} == {
        k: [s for s, _ in v] for k, v in want.items()}
    steps = list(range(1, N_STEPS + 2))
    for k in ("loss", "sed_loss", "doa_loss", "lr", "momentum"):
        assert [s for s, _ in got[f"train/{k}"]] == steps, k
    for k in ("val_loss", "seld_error", "ER", "F1", "LE", "LR"):
        assert f"val/{k}" in got, k
    np.testing.assert_array_equal([v for _, v in got["train/loss"][:N_STEPS]],
                                  np.float32(trained["losses"]["torch"]))
    meta = ckpt.load_metadata(os.path.join(tt.cfg.dir.model.checkpoint, "epoch000.msgpack"))
    for k in ("loss", "sed_loss", "doa_loss", "lr", "momentum"):
        assert got[f"train/{k}"][-1][1] == np.float32(meta[k]), k
    assert got["val/seld_error"][-1] == (N_STEPS + 1, np.float32(meta["valSeld"]))


def test_summary_writer_needs_tensorboardx_and_a_tb_dir(tmp_path, monkeypatch):
    """As salsa_tpu's trainer: a writer on `dir.tb_dir` where tensorboardX imports;
    without the package, none, which the log says; without a tb_dir, none."""
    from salsa_tpu_torch.train.trainer import summary_writer

    cfg = AttrDict({"dir": {"tb_dir": str(tmp_path / "tb")}})
    writer = summary_writer(cfg)
    assert writer is not None and os.path.isdir(tmp_path / "tb")
    writer.close()
    assert summary_writer(AttrDict({"dir": {}})) is None
    monkeypatch.setitem(__import__("sys").modules, "tensorboardX", None)
    said = []
    handler = logging.Handler(logging.DEBUG)
    handler.emit = lambda record: said.append(record.getMessage())
    port_logger = logging.getLogger("salsa_tpu_torch")
    port_logger.addHandler(handler)
    level = port_logger.level
    port_logger.setLevel(logging.INFO)
    try:
        assert summary_writer(cfg) is None
    finally:
        port_logger.removeHandler(handler)
        port_logger.setLevel(level)
    assert said == [
        f"tensorboardX does not import: no TensorBoard scalars are written to {tmp_path / 'tb'}"]
