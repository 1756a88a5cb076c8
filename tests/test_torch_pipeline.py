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

    BLOCKED = ("jax", "flax", "yaml", "h5py", "msgpack", "orbax", "tensorstore", "zstandard",
               "salsa_tpu")

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

    # the rest of the zoo: PannResNet22TPU in bf16, the LSTM and transformer decoders
    for enc_name, dec_type, dtype in (("PannResNet22TPU", "bilstm", "bfloat16"),
                                      ("PannResNet22", "transformer", None)):
        zoo = seld.init_random_(seld.build_model(
            encoder={**configs.MODEL["encoder"], "name": enc_name, "compute_dtype": dtype},
            decoder={"decoder_type": dec_type, "decoder_size": 8, "compute_dtype": dtype},
            n_classes=2), torch.Generator().manual_seed(0))
        interop.load_flax_variables(zoo, *interop.torch_state_dict_to_flax(zoo.state_dict()))
        zoo_pipe = pipeline.SeldInferencePipeline(
            registry.make_extractor("salsa", "foa"), zoo, None,
            (np.zeros((4, 1, 200), np.float32), np.ones((4, 1, 200), np.float32)),
            2.0, 2, device="cpu")
        ev, doa = zoo_pipe(np.random.default_rng(1).standard_normal((4, 9600)).astype(np.float32))
        assert ev.dtype == np.float32 and np.isfinite(ev).all() and np.isfinite(doa).all()
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
    import salsa_tpu_torch.scripts.bench_restore as bench_restore
    import salsa_tpu_torch.train.threshold
    import salsa_tpu_torch.utils.experiments
    from salsa_tpu_torch.cli.evaluate import evaluate_seld
    from salsa_tpu_torch.cli.predict import predict
    from salsa_tpu_torch.train import checkpoint

    assert callable(bench_extract.main) and callable(bench_restore.main)
    with tempfile.TemporaryDirectory() as tmp:
        path = checkpoint.save_checkpoint(tmp, "tiny", {"w": np.arange(3.0)},
                                          {"m": np.ones(2, np.float32)}, 5, {"valSeld": 0.1})
        params, stats, step = checkpoint.restore_variables(path)
        assert step == 5 and params["w"].tolist() == [0.0, 1.0, 2.0], (params, step)
        assert checkpoint.best_checkpoint(tmp) == path
        # .orbax: salsa_tpu's fixture (real zstd, through the C++ decoder) and the
        # port's own writer
        fixture = os.path.join("tests", "golden", "orbax_small", "orbax_small")
        params, stats, step = checkpoint.restore_variables(fixture + ".orbax")
        want = checkpoint.restore_variables(fixture + ".msgpack")
        assert step == want[2] == 7 and np.array_equal(
            params["encoder"]["Conv_1"]["kernel"], want[0]["encoder"]["Conv_1"]["kernel"])
        path = checkpoint.save_checkpoint(tmp, "tiny_orbax", {"w": np.arange(3.0)}, {}, 6,
                                          backend="orbax")
        assert checkpoint.restore_variables(path)[2] == 6

        exp = chip_smoke.write_experiment(tmp, scenes=(("one", 1.2, 24000), ("two", 1.0, 48000)))
        out = predict(exp["config"], exp["wav_dir"], os.path.join(tmp, "preds"), exp["group"],
                      device="cpu")
        assert sorted(os.listdir(out)) == ["one.csv", "two.csv"]
        scores = evaluate_seld(out, exp["gt_root"])
        assert set(scores) == {"ER", "F1", "LE", "LR", "seld_error"}, scores

    # the training path: every module of cli.train, and one batch of chunks
    import salsa_tpu_torch.cli.train as cli_train
    import salsa_tpu_torch.data.database as database
    import salsa_tpu_torch.data.dataset
    import salsa_tpu_torch.data.feature_store
    import salsa_tpu_torch.data.meta
    import salsa_tpu_torch.data.wav_database
    import salsa_tpu_torch.train.losses
    import salsa_tpu_torch.train.schedules
    import salsa_tpu_torch.train.state
    import salsa_tpu_torch.train.trainer as trainer
    from salsa_tpu_torch.features import chunked

    assert callable(cli_train.main) and callable(trainer.SeldTrainer)
    fn, p = chunked.make_chunk_extractor("salsa", "foa", 16, fs=24000, n_fft=512, hop_length=300)
    wave = torch.from_numpy(chunked.pad_waveform(
        np.random.default_rng(1).standard_normal((4, 9600)).astype(np.float32), 512))
    state = chunked.salsa_tracker_checkpoints(wave, np.array([0, 9]), p)
    x = fn(wave[None], torch.zeros(2, dtype=torch.long), torch.tensor([0, 9]),
           torch.full((2,), 33), *state)
    assert x.shape == (2, 7, 16, 200) and torch.isfinite(x).all(), x.shape

    # streaming serving: the extractor, the pipeline and the pool
    import salsa_tpu_torch.stream_pool as stream_pool
    import salsa_tpu_torch.streaming as streaming

    se = streaming.StreamingExtractor("salsa", "foa", block_frames=16, device="cpu")
    blocks = se.push(np.random.default_rng(2).standard_normal((4, 9600)).astype(np.float32))
    assert len(blocks) == 1 and blocks[0].shape == (7, 16, 200), [b.shape for b in blocks]
    assert callable(stream_pool.SeldStreamPool) and callable(streaming.StreamingSeldPipeline)

    # the rest of the feature bank, every type on every entry point's function
    import salsa_tpu_torch.features.salsa_lite as salsa_lite
    import salsa_tpu_torch.features.specs as specs
    from salsa_tpu_torch.features.registry import FEATURE_REGISTRY, make_extractor

    assert callable(specs.gcc_phat_all_pairs) and callable(salsa_lite.extract_salsa_lite)
    short = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 4, 4800)).astype(
        np.float32))
    for ft in FEATURE_REGISTRY:
        ex = make_extractor(ft, "mic" if ft.startswith("salsa") else "foa")
        assert ex(short).shape == (1, ex.n_channels, 17, ex.n_features), ft
    se = streaming.StreamingExtractor("salsa_lite", "mic", block_frames=16, device="cpu")
    assert se.push(short[0].numpy())[0].shape == (7, 16, 191)

    # augmented, resumable training and the synthetic-corpus scripts
    import salsa_tpu_torch.scripts.aug_ablation as aug_ablation
    import salsa_tpu_torch.scripts.synthetic_sanity as synthetic_sanity
    from salsa_tpu_torch.train.device_augment import make_device_augment

    aug = make_device_augment("salsa_lite", "mic", 2, 16, 191)
    xa, sa, da = aug(torch.Generator().manual_seed(0), torch.ones(2, 7, 16, 191),
                     torch.zeros(2, 16, 2), torch.ones(2, 16, 6))
    assert xa.shape == (2, 7, 16, 191) and callable(trainer.SeldTrainer.restore)
    assert callable(checkpoint.restore_train_state) and callable(aug_ablation.main)
    with tempfile.TemporaryDirectory() as tmp:
        synthetic_sanity.write_corpus(tmp, 2, 0, "mic")
        assert len(os.listdir(os.path.join(tmp, "task3", "mic_dev"))) == 2

    # inference with TTA, the threshold sweep and the ensemble
    import salsa_tpu_torch.cli.ensemble as cli_ensemble
    import salsa_tpu_torch.cli.infer as cli_infer
    import salsa_tpu_torch.scripts.quality_evidence as quality_evidence
    from salsa_tpu_torch.train import ensemble, threshold, tta

    assert callable(cli_infer.main) and callable(quality_evidence.main)
    swap = tta.ChannelSwapTTA("foa", 2, n_input_channels=7)
    xs = swap.transform_group(torch.ones(2, 7, 3, 4), range(len(swap)))
    back = swap.inverse_doa(torch.ones(2, 3, 6), 5)
    assert xs.shape == (32, 7, 3, 4) and back.shape == (2, 3, 6), (xs.shape, back.shape)
    with tempfile.TemporaryDirectory() as tmp:
        for m in (0, 1):
            os.makedirs(os.path.join(tmp, f"m{m}"))
            np.savez(os.path.join(tmp, f"m{m}", "clip.npz"),
                     event_frame_pred=np.full((1, 4, 2), 0.5 + 0.1 * m, np.float32),
                     doa_frame_pred=np.ones((1, 4, 6), np.float32))
        fused = ensemble.ensemble_predictions([os.path.join(tmp, "m0"), os.path.join(tmp, "m1")])
        assert np.allclose(fused["clip"][0], 0.55), fused
        assert threshold.DEFAULT_THRESHOLDS[0] == 0.1
        ck = [checkpoint.save_checkpoint(tmp, f"e{i}", {"w": np.full(3, float(i), np.float32)},
                                         {}, i) for i in (1, 3)]
        avg = cli_ensemble.main(["--ckpts", *ck, "--out-ckpt", os.path.join(tmp, "avg.msgpack")])
        assert checkpoint.restore_variables(avg)[0]["w"].tolist() == [2.0, 2.0, 2.0]

    # the feature-store path: configs/seld.yml from its store (chip_smoke's phase 15,
    # cut down): cli.extract, cli.train with the host transforms, device_data,
    # precompute and remat, cli.predict with the store's scaler, cli.infer and
    # cli.evaluate; then a lazy read
    import salsa_tpu_torch.cli.extract as cli_extract
    import salsa_tpu_torch.data.transforms as transforms
    from salsa_tpu_torch.data.database import LazySplitData

    torch.set_num_threads(2)
    out = chip_smoke.phase15(torch.device("cpu"), seconds=2.0, timed=3, overrides=(
        "data.train_chunk_len_s=0.4", "data.train_chunk_hop_len_s=0.2",
        "training.train_batch_size=2", "model.decoder.decoder_size=8",
        "data.test_chunk_len_s=2.0", "data.test_chunk_hop_len_s=2.1",
        "data.max_file_len_s=2.0"))
    assert out["n_steps"] > 0 and np.isfinite(out["scores"]["seld_error"]), out
    assert callable(cli_extract.main) and callable(transforms.build_train_transforms)
    with tempfile.TemporaryDirectory() as tmp:
        store = cli_extract.feature_dir_of(tmp, "salsa", "foa", "x")
        from salsa_tpu_torch.data.feature_store import FeatureStore

        fs = FeatureStore(store, "foa")
        fs.write_clip("dev", "clip", np.arange(7 * 16 * 3, dtype=np.float32).reshape(7, 16, 3))
        fs.write_scaler(np.zeros((4, 1, 3)), np.ones((4, 1, 3)))
        os.makedirs(os.path.join(tmp, "meta"))
        with open(os.path.join(tmp, "meta", "train.csv"), "w") as f:
            f.write("filename\\nclip\\n")
        db = database.SeldDatabase(feature_root_dir=store, n_classes=2, fs=800, hop_len=10,
                                   train_chunk_len_s=0.1, train_chunk_hop_len_s=0.1,
                                   max_file_len_s=0.2)
        lazy = db.load_split("train", os.path.join(tmp, "meta"), preload=False)
        pre = db.load_split("train", os.path.join(tmp, "meta"))
        assert isinstance(lazy, LazySplitData) and len(lazy) == len(pre) > 1
        for i in range(len(pre)):
            assert np.array_equal(lazy.get_feature_chunk(i), pre.get_feature_chunk(i))

    # data parallelism, the checkpoint interop CLIs, profiling, SALSA at 6 channels
    import salsa_tpu_torch.cli.export_ckpt as export_ckpt
    import salsa_tpu_torch.cli.import_ckpt as import_ckpt
    import salsa_tpu_torch.parallel.distributed as distributed
    import salsa_tpu_torch.parallel.mesh as mesh
    import salsa_tpu_torch.utils.profiling as profiling

    assert callable(distributed.initialize) and mesh.data_width(4, 2) == 2
    assert profiling.device_timer(lambda: torch.ones(2) * 2, iters=1) >= 0.0
    six = make_extractor("salsa", "mic", n_mics=6)(torch.zeros((1, 6, 4800)))
    assert six.shape == (1, 11, 17, 200), six.shape
    with tempfile.TemporaryDirectory() as tmp:
        exp = chip_smoke.write_experiment(tmp, scenes=(("one", 1.2, 24000),))
        ck = export_ckpt.main(["--exp-config", exp["config"], "--exp-group-dir", exp["group"],
                               "--out", os.path.join(tmp, "x.ckpt")])
        back = import_ckpt.main(["--exp-config", exp["config"], "--torch-ckpt", ck,
                                 "--exp-group-dir", os.path.join(tmp, "imported")])
        a, b = checkpoint.restore_variables(exp["served"])[0], checkpoint.restore_variables(back)[0]
        assert np.array_equal(a["decoder"]["event_fc1"]["kernel"],
                              b["decoder"]["event_fc1"]["kernel"])

    # SALSA at any channel count (jax.random's draws in numpy), the measurement
    # scripts, the checkpoint backend's refusal
    import salsa_tpu_torch.scripts.bench_streaming as bench_streaming
    import salsa_tpu_torch.scripts.bench_train as bench_train
    import salsa_tpu_torch.scripts.probe_extract_stages as probe_extract_stages
    import salsa_tpu_torch.scripts.probe_stft_split as probe_stft_split
    import salsa_tpu_torch.scripts.profile_step as profile_step
    import salsa_tpu_torch.scripts.quality_seeds as quality_seeds
    import salsa_tpu_torch.utils.threefry as threefry

    many = make_extractor("salsa", "mic", n_mics=32)(torch.zeros((1, 32, 4800)))
    assert many.shape == (1, 63, 17, 200), many.shape
    assert threefry.normal(20211021, (2, 2, 4)).dtype == np.float32
    for script in (bench_streaming, bench_train, probe_extract_stages, probe_stft_split,
                   profile_step, quality_seeds):
        assert callable(script.main)
    checkpoint.check_backend("orbax")
    try:
        checkpoint.check_backend("zarr")
    except ValueError as e:
        assert str(e) == "unknown checkpoint backend 'zarr'", e
    else:
        raise AssertionError("checkpoint_backend zarr was not refused")

    leaked = sorted(m for m in sys.modules if blocked(m))
    assert not leaked, leaked
    print("HYGIENE_OK")
""")


def test_port_imports_nothing_of_jax_or_salsa_tpu():
    """Simulates the GPU host, which has no jax/flax/yaml/h5py/msgpack: a fresh
    process refuses those imports (and salsa_tpu, but not salsa_tpu_torch) and
    still builds and runs the serving path on CPU, reads and writes a checkpoint,
    serves and scores an experiment from disk through the CLIs, and runs
    configs/seld.yml's feature-store workflow (cli.extract -> cli.train ->
    cli.predict, cli.infer, cli.evaluate) and a lazy read, imports
    `salsa_tpu_torch.parallel`, the profiling module and the two checkpoint
    CLIs, round-trips a checkpoint through them and extracts 6-channel SALSA,
    imports the numpy threefry and extracts 32-channel SALSA, imports the
    measurement scripts, reads and writes `.orbax` checkpoints with orbax,
    tensorstore and zstandard blocked, and refuses an unknown checkpoint_backend."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", HYGIENE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "HYGIENE_OK" in proc.stdout
