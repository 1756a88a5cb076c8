"""The port's store-fed trainer against `salsa_tpu`'s, and its remat, precompute
and resume.

One `.h5` feature store, written by `salsa_tpu.cli.extract` from a synthetic 8 kHz
FOA corpus, feeds both packages' trainers from one flax init (fp32, dropout 0:
`salsa_tpu`'s FastDropout patched to the identity, the port's dropouts p = 0):
  * the host path, the host transforms on (each package's `build_train_transforms`
    on a generator of the same seed), one step an epoch for 20 epochs; `salsa_tpu`'s
    prefetch thread is replaced by the identity, since it builds a timing-dependent
    number of batches past an epoch's last step and so draws a timing-dependent
    number of transforms;
  * `training.device_data`, the split resident on the device.
Step 1's loss agrees within rtol 1e-4 and every step's within 2e-3, the bounds of
`tests/test_torch_trainer.py`. Then, the port alone: `training.remat` equals the
plain step within 1e-6 with dropout on (losses, weights and BatchNorm statistics),
and a block's recompute replays its dropout draws and moves its statistics once;
`from_wav_mode: precompute` trains on the resident path from features extracted at
startup, with no extraction in its steps; `--resume` on the store path, host
transforms and dropout on, equals an uninterrupted run bit for bit; and a lazy
split read on 2 threads trains the preloaded split's steps bit for bit.
"""
import copy
import importlib
import os
import shutil

import numpy as np
import pytest
import yaml

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
pytest.importorskip("h5py")

import jax.numpy as jnp  # noqa: E402

jdropout = importlib.import_module("salsa_tpu.ops.dropout")
jtrainer_mod = importlib.import_module("salsa_tpu.train.trainer")
from salsa_tpu.cli import extract as jextract  # noqa: E402
from salsa_tpu.data import transforms as jtransforms  # noqa: E402
from salsa_tpu.data.database import SeldDatabase as JDatabase  # noqa: E402
from salsa_tpu.models.seld import build_model as j_build_model  # noqa: E402
from salsa_tpu.parallel.mesh import replicate  # noqa: E402
from salsa_tpu.train.trainer import SeldTrainer as JTrainer  # noqa: E402
from salsa_tpu.utils.config import AttrDict as JAttrDict  # noqa: E402
from salsa_tpu_torch.cli import train as cli_train  # noqa: E402
from salsa_tpu_torch.data import transforms as ttransforms  # noqa: E402
from salsa_tpu_torch.data.database import SeldDatabase as TDatabase  # noqa: E402
from salsa_tpu_torch.interop import load_flax_variables  # noqa: E402
from salsa_tpu_torch.models.layers import BatchNorm2d, Dropout  # noqa: E402
from salsa_tpu_torch.models.seld import build_model  # noqa: E402
from salsa_tpu_torch.train import trainer as trainer_mod  # noqa: E402
from salsa_tpu_torch.train.trainer import SeldTrainer  # noqa: E402
from salsa_tpu_torch.utils.config import AttrDict  # noqa: E402
from tests.test_from_wav import E2E_FS, E2E_HOP, E2E_NFFT, _write_synth_corpus  # noqa: E402
from tests.test_torch_trainer import DEC, ENC, GEOMETRY, N_CLASSES, trainer_config  # noqa: E402

N_STEPS, SEED = 20, 7


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs test files side by side, several workers on a few cores: two
    intra-op threads for this file keep torch's pools from thrashing against the
    other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A synthetic corpus (4 clips x 4 s, 3 train and 1 val) and salsa_tpu's .h5
    store of it."""
    root = str(tmp_path_factory.mktemp("torch_trainer_store"))
    names, meta_dir = _write_synth_corpus(root, np.random.default_rng(20261018), n_clips=4,
                                          seconds=4.0, n_classes=N_CLASSES)
    with open(os.path.join(meta_dir, "train.csv"), "w") as f:
        f.write("filename\n" + "\n".join(names[:3]))
    with open(os.path.join(meta_dir, "val.csv"), "w") as f:
        f.write("filename\n" + names[3])
    data = os.path.join(root, "data.yml")
    with open(data, "w") as f:
        yaml.safe_dump({"data_dir": root, "feature_dir": os.path.join(root, "features"),
                        "data": {"format": "foa", "fs": E2E_FS, "n_fft": E2E_NFFT,
                                 "hop_len": E2E_HOP, "fmax_doa": 3000}}, f)
    feature_dir = jextract.extract_features(data, "salsa", splits=["foa_dev"])
    yield {"root": root, "meta": meta_dir, "features": feature_dir}
    shutil.rmtree(root)


def _store_config(extra: dict) -> dict:
    cfg = trainer_config()
    cfg["training"].update(from_wav=False, **extra)
    return cfg


def train_both_from_store(store, extra: dict, n_steps: int = N_STEPS):
    """Both trainers after n_steps one-step epochs on the store, and their losses."""
    geometry = dict(GEOMETRY, scaler_channels=4)
    kw = dict(feature_root_dir=store["features"], gt_meta_root_dir=store["root"], **geometry)
    j_split = JDatabase(**kw).load_split("train", store["meta"], "fit")
    j_val = JDatabase(**kw).load_split("val", store["meta"], "inference")
    t_split = TDatabase(**kw).load_split("train", store["meta"], "fit")
    t_val = TDatabase(**kw).load_split("val", store["meta"], "inference")
    np.testing.assert_array_equal(t_split.features, j_split.features)
    args = ("salsa", "foa", N_CLASSES, t_split.feature_chunk_len, t_split.features.shape[2])
    j_joint, j_feat = jtransforms.build_train_transforms(*args, rng=np.random.default_rng(SEED))
    t_joint, t_feat = ttransforms.build_train_transforms(*args, rng=np.random.default_rng(SEED))
    cfg = _store_config({**extra, "max_epochs": n_steps})
    gt_dir = os.path.join(store["root"], "metadata_dev")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdropout, "dropout", lambda x, key, rate: x)  # salsa_tpu's dropout off
        mp.setattr(jtrainer_mod, "prefetch", lambda it: it)
        jt = JTrainer(model=j_build_model(encoder=ENC, decoder=DEC, n_classes=N_CLASSES),
                      cfg=JAttrDict(copy.deepcopy(cfg)), train_data=j_split, val_data=j_val,
                      gt_meta_dir=gt_dir, submission_dir=os.path.join(store["root"], "js"),
                      joint_transform=j_joint, feature_transform=j_feat, seed=SEED)
        jt.state = jt.state.replace(step=replicate(jt.mesh, jnp.asarray(0, jnp.int32)))
        init = jax.device_get((jt.state.params, jt.state.batch_stats))
        tt = SeldTrainer(model=build_model(encoder=ENC, decoder=DEC, n_classes=N_CLASSES),
                         cfg=AttrDict(copy.deepcopy(cfg)), train_data=t_split, val_data=t_val,
                         gt_meta_dir=gt_dir, submission_dir=os.path.join(store["root"], "ts"),
                         seed=SEED, device="cpu", joint_transform=t_joint,
                         feature_transform=t_feat)
        load_flax_variables(tt.model, *init)
        for m in tt.model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
        losses = {"jax": [], "torch": []}
        for epoch in range(n_steps):
            losses["jax"].append(jt.train_epoch(epoch)["loss"])
            losses["torch"].append(tt.train_epoch(epoch)["loss"])
    return jt, tt, losses


@pytest.mark.parametrize("path", ["host", "device_data"])
def test_store_fed_trainer_matches_salsa_tpu(store, path):
    extra = {"device_data": True} if path == "device_data" else {}
    jt, tt, losses = train_both_from_store(store, extra)
    assert tt.steps_per_epoch == jt.steps_per_epoch == 1
    assert tt.device_data == (path == "device_data") and not tt.from_wav
    jl, tl = np.array(losses["jax"]), np.array(losses["torch"])
    assert np.isfinite(tl).all() and np.std(tl) > 0.01
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-4, err_msg=f"{jl} vs {tl}")
    np.testing.assert_allclose(tl, jl, rtol=2e-3, err_msg=f"{jl} vs {tl}")
    assert tt.optimizer.count == int(jt.state.step) == N_STEPS


def test_device_data_batch_equals_the_host_batch(store):
    """The resident gather's batch equals the host path's batch for the same chunks,
    transforms off, bit for bit; bfloat16 storage rounds the features once."""
    kw = dict(feature_root_dir=store["features"], gt_meta_root_dir=store["root"],
              **dict(GEOMETRY, scaler_channels=4))
    split = TDatabase(**kw).load_split("train", store["meta"], "fit")
    model = lambda: build_model(encoder=ENC, decoder=DEC, n_classes=N_CLASSES)  # noqa: E731
    host = SeldTrainer(model(), AttrDict(_store_config({})), split, None, None, "", seed=SEED,
                       device="cpu")
    resident = SeldTrainer(model(), AttrDict(_store_config({"device_data": True})), split, None,
                           None, "", seed=SEED, device="cpu")
    half = SeldTrainer(model(), AttrDict(_store_config({"device_data": True,
                                                        "device_data_dtype": "bfloat16"})),
                       split, None, None, "", seed=SEED, device="cpu")
    ids = host._epoch_order(0)[:5]
    for a, b in zip(host.batch(ids), resident.batch(ids)):
        assert torch.equal(a, b)
    x_half = half.batch(ids)[0]
    assert x_half.dtype == torch.float32
    assert torch.equal(x_half, host.batch(ids)[0].to(torch.bfloat16).float())
    assert resident.resident_bytes == split.features.nbytes + split.sed_targets.nbytes + \
        split.doa_targets.nbytes
    assert half.resident_bytes < resident.resident_bytes


class _Block(torch.nn.Module):
    """A conv, a BatchNorm and a dropout drawn from an explicit generator."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 4, 3, padding=1)
        self.bn = BatchNorm2d(4)
        self.drop = Dropout(0.5)

    def forward(self, x):
        return self.drop(torch.relu(self.bn(self.conv(x))))


def test_remat_block_replays_its_draws_and_moves_statistics_once():
    """A block under `_remat_forward` against the same block run plainly: the same
    output, gradients and running statistics (moved once), with dropout on."""
    torch.manual_seed(0)
    plain = _Block()
    remat = copy.deepcopy(plain)
    remat.forward = trainer_mod.functools.partial(trainer_mod._remat_forward, remat,
                                                  remat.forward)
    x = torch.randn(2, 3, 5, 6)
    outs, grads = [], []
    for block in (plain, remat):
        block.drop.generator = torch.Generator().manual_seed(3)
        y = block(x)
        y.square().sum().backward()
        outs.append(y.detach())
        grads.append([p.grad for p in block.parameters()])
    assert torch.equal(outs[0], outs[1]) and (outs[0] == 0).any()
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    for a, b in zip(plain.bn.buffers(), remat.bn.buffers()):
        assert torch.equal(a, b)
    assert int(remat.bn.num_batches_tracked) == 1


def test_remat_equals_plain_with_dropout_on(store):
    """`training.remat` on the store path: 3 steps with the encoder's and the
    decoder's dropouts on equal the plain steps within 1e-6 (losses, weights and
    BatchNorm statistics); every conv block of the encoder is rematerialized."""
    kw = dict(feature_root_dir=store["features"], gt_meta_root_dir=store["root"],
              **dict(GEOMETRY, scaler_channels=4))
    split = TDatabase(**kw).load_split("train", store["meta"], "fit")
    enc = {**ENC, "p_dropout": 0.2}
    dec = {**DEC, "head_dropout": 0.3, "rnn_dropout": 0.2}
    runs = {}
    for remat in (False, True):
        tr = SeldTrainer(build_model(encoder=enc, decoder=dec, n_classes=N_CLASSES),
                         AttrDict(_store_config({"remat": remat, "max_epochs": 3})), split, None,
                         None, "", seed=SEED, device="cpu")
        losses = [tr.train_epoch(e)["loss"] for e in range(3)]
        runs[remat] = (tr, losses)
    tr, losses = runs[True]
    assert tr.remat_blocks == 1 + 8 and runs[False][0].remat_blocks == 0
    np.testing.assert_allclose(losses, runs[False][1], rtol=1e-6, atol=0)
    want = runs[False][0].model.state_dict()
    for k, v in tr.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-6, atol=1e-6, err_msg=k)


def _cli_config(root: str, store: dict, name: str, **training) -> str:
    cfg = {
        "name": name, "feature_root_dir": store["features"], "feature_type": "salsa",
        "gt_meta_root_dir": store["root"], "split_meta_dir": store["meta"], "seed": 5,
        "mode": "crossval",
        "data": {"fs": E2E_FS, "n_fft": E2E_NFFT, "hop_len": E2E_HOP, "audio_format": "foa",
                 "label_rate": 10, "train_chunk_len_s": 0.8, "train_chunk_hop_len_s": 0.8,
                 "test_chunk_len_s": 4.0, "test_chunk_hop_len_s": 4.1, "n_classes": N_CLASSES,
                 "fmax_doa": 3000.0, "max_file_len_s": 4.0, "output_format": "reg_xyz",
                 "preload": training.pop("preload", True)},
        "model": {"encoder": {"name": "PannResNet22", "n_input_channels": 7, "p_dropout": 0.1},
                  "decoder": {"name": "SeldDecoder", "decoder_type": "bigru", "decoder_size": 8,
                              "head_dropout": 0.2}},
        "training": {"train_batch_size": 4, "max_epochs": 1, "val_interval": 1,
                     "lr_scheduler": {"milestones": [0.0, 1.0], "lrs": [1.0e-3, 1.0e-3],
                                      "moms": [0.9, 0.9]}, **training},
        "sed_threshold": 0.5, "doa_threshold": 20, "eval_version": "2021",
    }
    path = os.path.join(root, name + ".yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)
    return path


def test_cli_resume_on_the_store_path_bit_equal(store, tmp_path):
    """cli.train from the store with host transforms and dropout on, 1 epoch then
    --resume to 3, equals a fresh 3-epoch run bit for bit: the sidecar keeps the
    host transforms' generator state, which the resumed run restores."""
    config = _cli_config(str(tmp_path), store, "resume")
    group = str(tmp_path / "outputs")
    first = cli_train.train(config, group, device="cpu")
    assert first.train_dataset.transform is not None and first.steps_per_epoch == 3
    tr = cli_train.train(config, group, device="cpu", resume=True,
                         overrides=["training.max_epochs=3"])
    fresh = cli_train.train(config, str(tmp_path / "fresh"), device="cpu",
                            overrides=["training.max_epochs=3"])
    assert tr.optimizer.count == fresh.optimizer.count == 9
    assert tr.step_losses == fresh.step_losses
    want = fresh.model.state_dict()
    for k, v in tr.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):  # not in flax's checkpoints
            assert torch.equal(v, want[k]), k
    exp = os.path.join(group, "crossval", "foa", "salsa", "resume")
    meta = yaml.safe_load(open(os.path.join(exp, "models", "checkpoint", "epoch000.json")))
    assert meta["host_transform_rng"][0]["bit_generator"] == "PCG64"
    shutil.rmtree(str(tmp_path))  # full-width checkpoints: pytest keeps its temp trees


def test_lazy_split_on_two_workers_trains_the_same_steps(store, tmp_path):
    """data.preload: false with training.data_workers: 2 takes the preloaded
    split's steps, host transforms on, bit for bit; validation reads lazily too."""
    runs = {}
    for name, extra in (("pre", {}), ("lazy", {"preload": False, "data_workers": 2})):
        tr = cli_train.build_trainer(_cli_config(str(tmp_path), store, name, **extra),
                                     str(tmp_path / "outputs"), device="cpu")
        runs[name] = [tr.train_epoch(e)["loss"] for e in range(2)] + [tr.step_losses]
        if name == "lazy":
            assert type(tr.train_data).__name__ == type(tr.val_data).__name__ == "LazySplitData"
            assert np.isfinite(tr.validate()["seld_error"])
    assert runs["lazy"] == runs["pre"]


def test_precompute_trains_on_the_resident_path(store, tmp_path):
    """from_wav_mode: precompute extracts the train split once at startup (the
    scaler fit, the train split and the val split are the extractor's only calls)
    and trains on the device_data path: its resident features are the extracted
    split, normalized, and no step extracts."""
    config = _cli_config(str(tmp_path), store, "pre", from_wav=True,
                         from_wav_mode="precompute", max_epochs=2)
    calls = []
    real = cli_train.make_extractor

    def counting(*a, **kw):
        ex = real(*a, **kw)
        fn = ex.fn
        ex.fn = lambda w: calls.append(w.shape[0]) or fn(w)
        return ex

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli_train, "make_extractor", counting)
        tr = cli_train.build_trainer(config, str(tmp_path / "outputs"), device="cpu")
        n_setup = len(calls)
        assert tr.device_data and not tr.from_wav and tr.cfg.training.device_data
        assert not hasattr(tr, "chunk_fn") and "precompute" in tr.setup_seconds
        tr.fit()
    assert n_setup == len(calls) == 3  # 3 equal-length train clips a call, x2, val
    scaler = np.load(os.path.join(os.path.dirname(tr.cfg.dir.model.best), "feature_scaler.npz"))
    from salsa_tpu_torch.data import wav_database as twav
    from salsa_tpu_torch.features.registry import make_extractor

    ex = make_extractor("salsa", "foa", fs=E2E_FS, n_fft=E2E_NFFT, hop_length=E2E_HOP,
                        fmax_doa=3000.0)
    names = tr.train_data.unique_clip_names
    extracted = twav.extract_split_to_store(ex, names, os.path.join(store["root"], "foa_dev"),
                                            E2E_FS, (scaler["mean"], scaler["std"]),
                                            device="cpu")
    db = cli_train.build_database_from_cfg(tr.cfg, extracted)
    want = db.load_split("train", store["meta"], "fit")
    np.testing.assert_array_equal(tr._feats.numpy(), want.features)
    assert len(tr.step_losses) == tr.steps_per_epoch and np.isfinite(tr.step_losses).all()
    shutil.rmtree(str(tmp_path))
