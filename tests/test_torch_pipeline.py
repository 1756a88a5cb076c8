"""The port's serving slice against salsa_tpu's: waves -> SALSA-FOA -> scaler ->
CRNN -> label-rate (event_prob, doa) for reg_xyz and accdoa, the CSV writer,
batching, and a check that the port imports nothing of jax, flax, yaml, h5py,
msgpack or salsa_tpu."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from salsa_tpu.features.registry import make_extractor as j_make_extractor  # noqa: E402
from salsa_tpu.models.seld import build_model as j_build_model  # noqa: E402
from salsa_tpu.pipeline import SeldInferencePipeline as JPipeline  # noqa: E402
from salsa_tpu.train.submission import write_classwise_csv as j_write_csv  # noqa: E402
from salsa_tpu_torch.features.registry import make_extractor  # noqa: E402
from salsa_tpu_torch.models.seld import build_model  # noqa: E402
from salsa_tpu_torch.pipeline import SeldInferencePipeline  # noqa: E402
from salsa_tpu_torch.submission import write_classwise_csv  # noqa: E402
from tests.test_torch_models import flax_init  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS, N_FFT, HOP = 24000, 512, 300
N_CLASSES = 3
ENC = {"name": "PannResNet22", "n_input_channels": 7}
DEC = {"name": "SeldDecoder", "decoder_type": "gru", "decoder_size": 32, "freq_pool": "avg"}
INTERP = 16 * 10 / (FS / HOP)  # encoder rate -> 10 Hz label rate: 2


def foa_clips(rng, n_clips, seconds):
    """Noise plus a directional tone per clip, so the spatial mask is non-empty."""
    n = int(seconds * FS)
    t = np.arange(n) / FS
    out = 0.05 * rng.standard_normal((n_clips, 4, n))
    for b in range(n_clips):
        azi, ele = rng.uniform(-np.pi, np.pi), rng.uniform(-0.5, 0.5)
        gains = np.array([1.0, np.sin(azi) * np.cos(ele), np.sin(ele), np.cos(azi) * np.cos(ele)])
        f0 = rng.uniform(300, 3000)
        burst = (t > seconds * 0.2) & (t < seconds * 0.8)
        out[b] += gains[:, None] * (np.sin(2 * np.pi * f0 * t) * burst)[None]
    return out.astype(np.float32)


@pytest.fixture(scope="module")
def slice_setup():
    rng = np.random.default_rng(20261016)
    waves = foa_clips(rng, 2, 1.6)
    n_frames = 1 + waves.shape[-1] // HOP
    j_model = j_build_model(encoder=ENC, decoder=DEC, n_classes=N_CLASSES)
    params, stats = flax_init(rng, j_model, np.zeros((1, 7, n_frames, 200), np.float32), seed=7)
    scaler = (rng.normal(-5.0, 1.0, (4, 1, 200)).astype(np.float32),
              rng.uniform(5.0, 8.0, (4, 1, 200)).astype(np.float32))
    j_pipe = JPipeline(j_make_extractor("salsa", "foa", eig_method="pallas", jit=False),
                       j_model, {"params": params, "batch_stats": stats}, scaler, INTERP,
                       N_CLASSES)
    t_pipe = SeldInferencePipeline(make_extractor("salsa", "foa"),
                                   build_model(encoder=ENC, decoder=DEC, n_classes=N_CLASSES),
                                   {"params": params, "batch_stats": stats}, scaler, INTERP,
                                   N_CLASSES, device="cpu")
    return waves, j_pipe, t_pipe


def test_slice_matches_jax_pipeline(slice_setup):
    waves, j_pipe, t_pipe = slice_setup
    ev_j, doa_j = j_pipe(waves)
    ev_t, doa_t = t_pipe(waves)
    assert ev_t.shape == ev_j.shape == (2, 16, N_CLASSES)
    assert doa_t.shape == doa_j.shape == (2, 16, 3 * N_CLASSES)
    assert ev_j.std() > 0.01 and doa_j.std() > 0.01  # the comparison is not vacuous
    for got, want in ((ev_t, ev_j), (doa_t, doa_j)):
        err = np.abs(got - want)
        # spatial cells whose coherence test flips move a few outputs a little;
        # the bulk must agree tightly (measured max on this input: see CHANGES.md)
        assert np.mean(err <= 2e-3) >= 0.999, np.sort(err.ravel())[-10:]
        assert err.max() <= 2e-2, err.max()
    assert np.all((ev_t >= 0) & (ev_t <= 1)) and np.all(np.abs(doa_t) <= 1)


def test_batch_equals_solo_runs(slice_setup):
    waves, _, t_pipe = slice_setup
    ev, doa = t_pipe(waves)
    for b in range(len(waves)):
        ev1, doa1 = t_pipe(waves[b])  # (n_ch, n_samples) input is squeezed back
        np.testing.assert_allclose(ev1, ev[b], atol=1e-5, rtol=0)
        np.testing.assert_allclose(doa1, doa[b], atol=1e-5, rtol=0)


@pytest.mark.parametrize("version", ["2021", "2020"])
def test_classwise_csv_byte_identical(rng, tmp_path, version):
    n_frames, n = 600, 12
    ev = rng.uniform(0, 1, (n_frames, n)).astype(np.float32)
    doa = rng.uniform(-1, 1, (n_frames, 3 * n)).astype(np.float32)
    doa[5, 0], doa[5, n], doa[5, 2 * n] = -1.0, 0.0, 0.0  # azimuth exactly 180 -> -180
    ev[5, 0] = 0.9
    a, b = tmp_path / "port.csv", tmp_path / "jax.csv"
    write_classwise_csv(str(a), ev, doa, n, sed_threshold=0.3, version=version)
    j_write_csv(str(b), ev, doa, n, sed_threshold=0.3, version=version)
    assert a.read_bytes() == b.read_bytes() and len(a.read_bytes()) > 1000


def test_pipeline_loads_torch_state_dict(slice_setup):
    """A torch state_dict (strict) serves the same as the flax variables it came from."""
    waves, _, t_pipe = slice_setup
    sd = {k: v.clone() for k, v in t_pipe.model.state_dict().items()}
    pipe = SeldInferencePipeline(t_pipe.extractor,
                                 build_model(encoder=ENC, decoder=DEC, n_classes=N_CLASSES),
                                 sd, (t_pipe.mean.numpy(), t_pipe.std.numpy()), INTERP,
                                 N_CLASSES, device="cpu")
    for got, want in zip(pipe(waves), t_pipe(waves)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(RuntimeError):
        SeldInferencePipeline(t_pipe.extractor, build_model(encoder=ENC, decoder=DEC),
                              sd, (t_pipe.mean.numpy(), t_pipe.std.numpy()), INTERP, 12,
                              device="cpu")


def test_pipeline_accdoa_output(slice_setup):
    waves, _, t_pipe = slice_setup
    acc = SeldInferencePipeline(t_pipe.extractor, t_pipe.model, None,
                                (t_pipe.mean.numpy(), t_pipe.std.numpy()), INTERP, N_CLASSES,
                                output_format="accdoa", device="cpu")
    ev, doa = acc(waves)
    n = N_CLASSES
    want = np.sqrt(doa[..., :n] ** 2 + doa[..., n:2 * n] ** 2 + doa[..., 2 * n:] ** 2)
    np.testing.assert_allclose(ev, want, rtol=1e-6)


def test_accdoa_matches_jax_pipeline(slice_setup):
    """output_format="accdoa" (event_prob = the norm of each class's DOA vector)
    against salsa_tpu's pipeline, at test_slice_matches_jax_pipeline's bound."""
    waves, j_pipe, t_pipe = slice_setup
    scaler = (t_pipe.mean.numpy(), t_pipe.std.numpy())
    j_acc = JPipeline(j_pipe.extractor, j_build_model(encoder=ENC, decoder=DEC,
                                                      n_classes=N_CLASSES,
                                                      output_format="accdoa"),
                      j_pipe.variables, scaler, INTERP, N_CLASSES, output_format="accdoa")
    t_acc = SeldInferencePipeline(t_pipe.extractor, t_pipe.model, None, scaler, INTERP,
                                  N_CLASSES, output_format="accdoa", device="cpu")
    (ev_j, doa_j), (ev_t, doa_t) = j_acc(waves), t_acc(waves)
    assert ev_t.shape == ev_j.shape == (2, 16, N_CLASSES) and ev_j.std() > 0.01
    for got, want in ((ev_t, ev_j), (doa_t, doa_j)):
        err = np.abs(got - want)
        assert np.mean(err <= 2e-3) >= 0.999, np.sort(err.ravel())[-10:]
        assert err.max() <= 2e-2, err.max()


def test_pipeline_defaults_to_the_card():
    """With no `device` the pipeline serves on the first CUDA card: on a host
    without one it raises at its first move to CUDA instead of serving on the
    CPU (which error is torch's own)."""
    model = build_model(encoder=ENC, decoder=DEC, n_classes=N_CLASSES)
    scaler = (np.zeros((4, 1, 200), np.float32), np.ones((4, 1, 200), np.float32))
    args = (make_extractor("salsa", "foa"), model, None, scaler, INTERP, N_CLASSES)
    if torch.cuda.is_available():
        pipe = SeldInferencePipeline(*args)
        assert pipe.device.type == "cuda" and next(pipe.model.parameters()).is_cuda
    else:
        with pytest.raises(Exception) as err:
            SeldInferencePipeline(*args)
        assert "cuda" in str(err.value).lower() or "nvidia" in str(err.value).lower()
        assert next(model.parameters()).device.type == "cpu"  # nothing moved


HYGIENE = textwrap.dedent("""
    import importlib.abc
    import sys

    BLOCKED = ("jax", "flax", "yaml", "h5py", "msgpack", "salsa_tpu")

    def blocked(name):
        top = name.split(".")[0]
        return top in BLOCKED

    for mod in [m for m in sys.modules if blocked(m)]:
        del sys.modules[mod]

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ModuleNotFoundError(f"blocked on the GPU host: {name}", name=name)
            return None

    sys.meta_path.insert(0, Refuse())

    import numpy as np
    import torch
    import salsa_tpu_torch.features.registry as registry
    import salsa_tpu_torch.models.seld as seld
    import salsa_tpu_torch.pipeline as pipeline
    from salsa_tpu_torch import configs
    from salsa_tpu_torch.submission import write_classwise_csv

    model = seld.init_random_(
        seld.build_model(encoder=configs.MODEL["encoder"],
                         decoder={"decoder_type": "bigru", "decoder_size": 8}, n_classes=2),
        torch.Generator().manual_seed(0))
    pipe = pipeline.SeldInferencePipeline(
        registry.make_extractor("salsa", "foa"), model, None,
        (np.zeros((4, 1, 200), np.float32), np.ones((4, 1, 200), np.float32)),
        2.0, 2, device="cpu")
    ev, doa = pipe(np.random.default_rng(0).standard_normal((4, 9600)).astype(np.float32))
    assert ev.shape == (4, 2) and doa.shape == (4, 6), (ev.shape, doa.shape)
    assert np.isfinite(ev).all() and np.isfinite(doa).all()

    import salsa_tpu_torch.interop as interop
    import salsa_tpu_torch.scripts.bench_noise_floor as bench_k2
    import salsa_tpu_torch.scripts.bench_salsa_spatial as bench_k1
    import salsa_tpu_torch.scripts.probe_pallas_conv as probe_conv
    import salsa_tpu_torch.scripts.probe_salsa_kernel as probe_k3

    assert callable(interop.flax_to_torch_state_dict) and callable(bench_k2.main)
    assert callable(bench_k1.main)

    z = torch.zeros(1, 4, 3, 16)
    k3 = probe_k3.salsa_spatial_variant(z, z, torch.ones(1, 3, 10, dtype=torch.bool),
                                        variant="realdiag", n_sq=2)
    assert k3.shape == (1, 3, 3, 10), k3.shape
    k4 = probe_conv.conv3x3_64(torch.ones(1, 3, 5, 7), torch.ones(3, 3, 7, 64))
    assert k4.shape == (1, 3, 5, 64), k4.shape

    # the serving and scoring CLIs on a two-clip experiment written from seeds
    import os
    import tempfile

    import chip_smoke
    import salsa_tpu_torch.cli._errors
    import salsa_tpu_torch.metrics.seld_metrics
    import salsa_tpu_torch.scripts.bench_extract as bench_extract
    import salsa_tpu_torch.train.threshold
    import salsa_tpu_torch.utils.experiments
    from salsa_tpu_torch.cli.evaluate import evaluate_seld
    from salsa_tpu_torch.cli.predict import predict
    from salsa_tpu_torch.train import checkpoint

    assert callable(bench_extract.main)
    with tempfile.TemporaryDirectory() as tmp:
        path = checkpoint.save_checkpoint(tmp, "tiny", {"w": np.arange(3.0)},
                                          {"m": np.ones(2, np.float32)}, 5, {"valSeld": 0.1})
        params, stats, step = checkpoint.restore_variables(path)
        assert step == 5 and params["w"].tolist() == [0.0, 1.0, 2.0], (params, step)
        assert checkpoint.best_checkpoint(tmp) == path

        exp = chip_smoke.write_experiment(tmp, scenes=(("one", 1.2, 24000), ("two", 1.0, 48000)))
        out = predict(exp["config"], exp["wav_dir"], os.path.join(tmp, "preds"), exp["group"],
                      device="cpu")
        assert sorted(os.listdir(out)) == ["one.csv", "two.csv"]
        scores = evaluate_seld(out, exp["gt_root"])
        assert set(scores) == {"ER", "F1", "LE", "LR", "seld_error"}, scores

    leaked = sorted(m for m in sys.modules if blocked(m))
    assert not leaked, leaked
    print("HYGIENE_OK")
""")


def test_port_imports_nothing_of_jax_or_salsa_tpu():
    """Simulates the GPU host, which has no jax/flax/yaml/h5py/msgpack: a fresh
    process refuses those imports (and salsa_tpu, but not salsa_tpu_torch) and
    still builds and runs the serving path on CPU, reads and writes a checkpoint,
    and serves and scores an experiment from disk through the CLIs."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", HYGIENE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "HYGIENE_OK" in proc.stdout
