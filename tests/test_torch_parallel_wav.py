"""The port's fused raw-wav trainer on 2 gloo ranks against `salsa_tpu`'s on a
2-device data mesh: tests/test_torch_trainer.py's synthetic corpus (8 kHz FOA,
0.8 s chunks, 3 train clips), one flax init, the same scaler, batch 4 = 2 rows a
rank, one step an epoch; K1 and K2 as their plain versions in the port and
eig_method 'pallas' (interpret mode) in salsa_tpu. Each rank extracts its own
rows' chunks. Without and with `training.device_data_shard`, where each rank's
device holds its block of the clips' waveforms and the epoch order is
stratified (`salsa_tpu`'s clip_sharded step). Step 1's loss within rtol 1e-4,
every step's within 2e-3 (tests/test_multihost.py's bounds)."""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from salsa_tpu.data import wav_database as jwav  # noqa: E402
from salsa_tpu.data.database import SeldDatabase as JDatabase  # noqa: E402
from salsa_tpu.features.registry import make_extractor as j_make_extractor  # noqa: E402
from salsa_tpu.models.seld import build_model as j_build_model  # noqa: E402
from salsa_tpu.parallel.mesh import make_mesh, replicate  # noqa: E402
from salsa_tpu.train.trainer import SeldTrainer as JTrainer  # noqa: E402
from salsa_tpu.utils.config import AttrDict as JAttrDict  # noqa: E402
from salsa_tpu_torch.interop import flax_to_torch_state_dict  # noqa: E402
from tests.test_from_wav import E2E_FS, E2E_HOP, E2E_NFFT, _write_synth_corpus  # noqa: E402
from tests.torch_parallel_worker import DEC, ENC, N_CLASSES, launch  # noqa: E402
from tests.test_torch_parallel_feeds import assert_traces_match  # noqa: E402

SEED, N_STEPS = 7, 4
GEOMETRY = dict(audio_format="foa", n_classes=N_CLASSES, fs=E2E_FS, hop_len=E2E_HOP,
                train_chunk_len_s=0.8, train_chunk_hop_len_s=0.4, test_chunk_len_s=4.0,
                test_chunk_hop_len_s=4.1, scaler_channels=4, max_file_len_s=4.0)


def wav_config(shard: bool) -> dict:
    """27 train chunks at batch 4 and train_fraction 0.2: one step an epoch."""
    return {"feature_type": "salsa",
            "data": {"fs": E2E_FS, "n_fft": E2E_NFFT, "hop_len": E2E_HOP,
                     "n_classes": N_CLASSES, "audio_format": "foa", "label_rate": 10,
                     "output_format": "reg_xyz", "max_file_len_s": 4.0, "train_fraction": 0.2,
                     "fmax_doa": 3000.0},
            "training": {"train_batch_size": 4, "max_epochs": N_STEPS, "from_wav": True,
                         "device_data_shard": shard, "eig_method": "pallas",
                         "steps_per_dispatch": 1,
                         "lr_scheduler": {"milestones": [0.0, 1.0], "lrs": [1e-4, 1e-4],
                                          "moms": [0.9, 0.9]}}}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The corpus, its 3-clip train split and the scaler salsa_tpu fits on it."""
    root = str(tmp_path_factory.mktemp("parallel_wav"))
    _write_synth_corpus(root, np.random.default_rng(20261018), n_clips=3, seconds=4.0)
    ex = j_make_extractor("salsa", "foa", eig_method="pallas", fs=E2E_FS, n_fft=E2E_NFFT,
                          hop_length=E2E_HOP, fmax_doa=3000.0)
    jdb = JDatabase(feature_root_dir=os.path.join(root, "features"), gt_meta_root_dir=root,
                    **GEOMETRY)
    jdb.n_fft = E2E_NFFT
    split = jwav.load_wav_split(jdb, "train", os.path.join(root, "foa_dev"),
                               split_meta_dir=os.path.join(root, "meta"), n_channels=7,
                               n_features=ex.n_features)
    scaler = jwav.fit_scaler_from_waves(ex, split.clip_wavs, 4)
    np.savez(os.path.join(root, "scaler.npz"), mean=scaler[0], std=scaler[1])
    return {"root": root, "split": split, "scaler": scaler}


@pytest.mark.parametrize("shard", [False, True], ids=["replicated", "device_data_shard"])
def test_from_wav_matches_salsa_tpu(corpus, tmp_path, shard):
    cfg = wav_config(shard)
    jt = JTrainer(model=j_build_model(encoder=ENC, decoder=DEC, n_classes=N_CLASSES),
                  cfg=JAttrDict(cfg), train_data=corpus["split"], val_data=None,
                  gt_meta_dir=None, submission_dir=str(tmp_path), mesh=make_mesh(n_data=2),
                  seed=SEED, scaler=corpus["scaler"])
    assert jt.from_wav and (getattr(jt, "_shard_chunk_ids", None) is not None) == shard
    jt.state = jt.state.replace(step=replicate(jt.mesh, jnp.asarray(0, jnp.int32)))
    init = str(tmp_path / "init.npz")
    np.savez(init, **flax_to_torch_state_dict(
        *jax.device_get((jt.state.params, jt.state.batch_stats))))
    want = [float(jt.train_epoch(e)["loss"]) for e in range(N_STEPS)]
    outs = launch(dict(mode="from_wav", seed=SEED, epochs=N_STEPS, workdir=str(tmp_path),
                       init=init, corpus=corpus["root"], geometry=GEOMETRY, n_fft=E2E_NFFT,
                       scaler=os.path.join(corpus["root"], "scaler.npz"), config=cfg),
                  2, str(tmp_path))
    assert outs[0]["step_losses"] == outs[1]["step_losses"]
    assert outs[0]["steps_per_epoch"] == jt.steps_per_epoch == 1
    assert_traces_match(outs[0]["step_losses"], want)
