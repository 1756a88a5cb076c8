"""configs/seld_tpu.yml (PannResNet22TPU, bf16 compute on both parts) through
`salsa_tpu.cli.predict.predict` and `salsa_tpu_torch.cli.predict.predict
(device="cpu")` on one salsa_tpu experiment made without training (the config
verbatim but for its paths and a narrow decoder, a perturbed flax init saved by
salsa_tpu's save_checkpoint), then through the port's streaming and pool paths;
and the same checkpoint served as PannResNet22 gives another network's outputs."""
import os

import numpy as np
import pytest
import yaml

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

import salsa_tpu.cli.predict as jpredict_mod  # noqa: E402
import salsa_tpu_torch.cli.predict as tpredict_mod  # noqa: E402
from salsa_tpu.models.seld import build_model as j_build_model  # noqa: E402
from salsa_tpu.train import checkpoint as jckpt  # noqa: E402
from salsa_tpu.train.state import create_train_state, make_optimizer  # noqa: E402
from salsa_tpu.utils.audio_io import write_wav  # noqa: E402
from tests.test_torch_cli import SCENES, _csv_rows, _recording  # noqa: E402
from tests.test_torch_models import flax_init  # noqa: E402

TPU_YML = os.path.join(os.path.dirname(__file__), "..", "configs", "seld_tpu.yml")
DECODER_SIZE = 16
# salsa_tpu on the CPU serves through its XLA power iteration, the port through
# K1's plain version; in bf16 the two networks part further (tests/test_torch_bf16.py):
# event probabilities and DOA within PROB_ATOL / DOA_ATOL (read 1.1e-3 / 3.9e-3),
# a CSV row in one package's only where its probability lies within PROB_ATOL of the
# threshold, angles of the rows in both within ANGLE_DEG (read 3 degrees: a DOA
# vector of small norm turns further for the same difference)
PROB_ATOL, DOA_ATOL, ANGLE_DEG = 5e-3, 1e-2, 4


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for this file, beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tpu_config(tmp, **decoder):
    with open(TPU_YML) as f:
        cfg = yaml.safe_load(f)
    cfg["gt_meta_root_dir"] = str(tmp / "task3")
    cfg["model"]["decoder"].update(decoder_size=DECODER_SIZE, **decoder)
    return cfg


def _write(tmp, sub, cfg):
    d = tmp / sub
    d.mkdir(exist_ok=True)
    (d / "seld_tpu.yml").write_text(yaml.safe_dump(cfg, sort_keys=False))
    return str(d / "seld_tpu.yml")


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """The experiment as salsa_tpu training leaves it: seld_tpu.yml's model (narrow
    decoder), a perturbed flax init saved from a TrainState, the scaler, the wavs."""
    tmp = tmp_path_factory.mktemp("torch_cli_tpu")
    rng = np.random.default_rng(20261019)
    wav_dir, gt_dir = tmp / "wavs", tmp / "task3" / "metadata_dev"
    wav_dir.mkdir()
    gt_dir.mkdir(parents=True)
    for name, seconds, fs in SCENES:
        n = int(round(seconds * fs))
        t = np.arange(n) / fs
        azi, ele = rng.uniform(-np.pi, np.pi), rng.uniform(-0.5, 0.5)
        gains = np.array([1.0, np.sin(azi) * np.cos(ele), np.sin(ele), np.cos(azi) * np.cos(ele)])
        burst = (t > 0.2 * seconds) & (t < 0.8 * seconds)
        audio = 0.05 * rng.standard_normal((4, n)) + 0.5 * gains[:, None] * (
            np.sin(2 * np.pi * rng.uniform(300, 3000) * t) * burst)[None]
        write_wav(str(wav_dir / f"{name}.wav"), audio.astype(np.float32), fs, bits=16)
        (gt_dir / f"{name}.csv").write_text("")
    cfg = _tpu_config(tmp)
    model = j_build_model(encoder=cfg["model"]["encoder"], decoder=cfg["model"]["decoder"],
                          n_classes=cfg["data"]["n_classes"])
    x = np.zeros((1, 7, 129, 200), np.float32)
    params, stats = flax_init(rng, model, x, seed=9)
    state = create_train_state(model, jnp.asarray(x), make_optimizer(1))
    state = state.replace(step=3, params=params, batch_stats=stats)
    models = tmp / "outputs" / "crossval" / "foa" / "salsa" / "seld_tpu" / "models"
    jckpt.save_checkpoint(str(models / "best"), "epoch003", state, {"valSeld": 0.5})
    np.savez(str(models / "feature_scaler.npz"),
             mean=rng.normal(-5.0, 1.0, (4, 1, 200)).astype(np.float32),
             std=rng.uniform(5.0, 8.0, (4, 1, 200)).astype(np.float32))
    return tmp


def _serve(workspace, config, side, out, **kw):
    module = jpredict_mod if side == "jax" else tpredict_mod
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "SeldInferencePipeline", _recording(module, calls))
        out_dir = module.predict(config, str(workspace / "wavs"), str(workspace / out),
                                 exp_group_dir=str(workspace / "outputs"),
                                 **({} if side == "jax" else {"device": "cpu"}), **kw)
    return out_dir, calls


def test_seld_tpu_yml_predict_matches_salsa_tpu(workspace):
    """Both packages' batch predict of seld_tpu.yml: the same groups, outputs
    within the bf16 bounds, CSV rows the same but near the threshold."""
    config = _write(workspace, "tpu", _tpu_config(workspace))
    j_dir, j_calls = _serve(workspace, config, "jax", "preds_jax")
    t_dir, t_calls = _serve(workspace, config, "port", "preds_port")
    names = sorted(os.listdir(j_dir))
    assert names == sorted(os.listdir(t_dir)) == sorted(f"{n}.csv" for n, _, _ in SCENES)
    assert [ev.shape for ev, _ in j_calls] == [ev.shape for ev, _ in t_calls] == [
        (3, 16, 12), (1, 20, 12)]
    for (ev_j, doa_j), (ev_t, doa_t) in zip(j_calls, t_calls):
        assert np.abs(ev_t - ev_j).max() <= PROB_ATOL, np.abs(ev_t - ev_j).max()
        assert np.abs(doa_t - doa_j).max() <= DOA_ATOL, np.abs(doa_t - doa_j).max()
        assert ev_t.std() > 0.05 and doa_t.std() > 0.05  # not vacuous
    j_prob = {n[:-4]: ev for n, ev in zip(
        ["clip_a.csv", "clip_b.csv", "clip_d.csv", "clip_c.csv"],
        [e for ev, _ in j_calls for e in ev])}
    threshold = yaml.safe_load(open(config))["sed_threshold"]
    compared = 0
    for name in names:
        got, want = _csv_rows(os.path.join(t_dir, name)), _csv_rows(os.path.join(j_dir, name))
        prob = j_prob[name[:-4]]
        for key in set(got) ^ set(want):
            assert abs(prob[key] - threshold) <= PROB_ATOL, (name, key, prob[key])
        for key in set(got) & set(want):
            (ga, ge), (wa, we) = got[key], want[key]
            da = min(abs(ga - wa), 360 - abs(ga - wa))
            assert da <= ANGLE_DEG and abs(ge - we) <= ANGLE_DEG, (name, key, got[key],
                                                                   want[key])
            compared += 1
    assert compared >= 100, compared


def test_seld_tpu_yml_streams_and_pools(workspace):
    """The port's --streaming --streams 2 and --pool on seld_tpu.yml: one CSV per
    wav, the streamed outputs near the batch path's (bf16, another context)."""
    config = _write(workspace, "tpu", _tpu_config(workspace))
    for kw in ({"streams": 2}, {"streams": 2, "pool": True}):
        out = tpredict_mod.predict(config, str(workspace / "wavs"),
                                   str(workspace / f"stream_{len(kw)}"),
                                   str(workspace / "outputs"), device="cpu", streaming=True,
                                   block_frames=16, context_frames=16, push_ms=100.0, **kw)
        assert sorted(os.listdir(out)) == sorted(f"{n}.csv" for n, _, _ in SCENES)


def test_the_tpu_checkpoint_served_as_pannresnet22_is_another_network(workspace):
    """The same checkpoint under encoder PannResNet22 loads (same tree) and gives
    other outputs: the served network is the config's, never the weights'."""
    config = _write(workspace, "tpu", _tpu_config(workspace))
    other = _tpu_config(workspace)
    other["model"]["encoder"]["name"] = "PannResNet22"
    _, tpu_calls = _serve(workspace, config, "port", "preds_tpu")
    _, pann_calls = _serve(workspace, _write(workspace, "pann", other), "port", "preds_pann")
    # more than the cross-package bf16 bound on DOA (the two networks read 8.1e-2 apart)
    assert np.abs(tpu_calls[0][1] - pann_calls[0][1]).max() > DOA_ATOL
