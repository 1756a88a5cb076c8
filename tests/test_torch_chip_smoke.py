"""chip_smoke.py's CPU-side pieces: the K1 comparison that phase 2 holds the
kernel to (validity masks, feature tolerance, MIC phases read on the circle), the
SASS instruction mix it prints, phase 13's helpers (extraction batches and the
launch check, the TTA fold, the byte comparison of CSVs), and phases 8-12 cut down
to run on the CPU (phase 13's in test_torch_chip_smoke_infer.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs test files side by side, several workers on a few cores: two
    intra-op threads for this file keep torch's pools from thrashing against the
    other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _mic_pair(rng):
    """(got, want) MIC feature planes (1, 3, 5, 40), valid everywhere, and the
    per-bin period; want holds one phase at the branch cut, +pi over delta * bin."""
    period = chip_smoke.mic_period(chip_smoke.MIC, 5)
    want = rng.uniform(-0.1, 0.1, (1, 3, 5, 40)).astype(np.float32)
    want[0, 1, 2, 7] = np.float32(period[2] / 2)
    got = want + rng.uniform(-1e-6, 1e-6, want.shape).astype(np.float32)
    return got, want, period


def test_compare_spatial_reads_mic_phases_on_the_circle(rng):
    got, want, period = _mic_pair(rng)
    got[0, 1, 2, 7] = -want[0, 1, 2, 7]  # the same direction, a period below
    t = torch.from_numpy
    assert chip_smoke.compare_spatial(t(got), t(want), "mic", period=period) <= 2e-6
    with pytest.raises(AssertionError):  # as plain numbers they are a period apart
        chip_smoke.compare_spatial(t(got), t(want), "mic")


def test_compare_spatial_still_holds_mic_features_to_the_bound(rng):
    got, want, period = _mic_pair(rng)
    got[0, 0, 1, 3] += 0.01  # off by 1e-2 inside a period
    with pytest.raises(AssertionError):
        chip_smoke.compare_spatial(torch.from_numpy(got), torch.from_numpy(want), "mic",
                                   period=period)
    got, want, period = _mic_pair(rng)
    got[0, :, 4, ::2] = 0  # half a bin's cells turned invalid: 5 % of cells
    with pytest.raises(AssertionError, match="disagree"):
        chip_smoke.compare_spatial(torch.from_numpy(got), torch.from_numpy(want), "mic",
                                   period=period)


def test_sass_mix_sorts_opcodes():
    mix = chip_smoke.sass_mix({"FFMA": 10, "FMUL": 4, "FADD": 2, "MUFU": 1, "LDG": 7,
                               "STG": 3, "IMAD": 5, "LEA": 1, "ISETP": 2, "BRA": 2, "EXIT": 1})
    assert mix == {"FFMA": 10, "FMUL": 4, "FADD": 2, "MUFU": 1, "LDG": 7, "STG": 3,
                   "integer": 8, "other": 3, "total": 38}


SHORT_SCENES = tuple((n, 1.6, chip_smoke.FS) for n in ("foa_a", "foa_b", "foa_c", "foa_d")) + (
    ("foa_short", 1.2, chip_smoke.FS), ("foa_48k", 1.0, 48000))


def test_phase8_serves_an_experiment_from_disk_on_the_cpu(capsys):
    """Phase 8 at short clips on the CPU: the CLI restores the valSeld 0.4
    checkpoint, writes CSVs byte-identical to the in-memory pipeline's in 3 groups,
    and evaluate scores the ground truth against itself as 0 / 1 / 0 / 1. On CPU
    tensors the kernels' wrappers run their plain versions and count nothing."""
    result = chip_smoke.phase8(torch.device("cpu"), scenes=SHORT_SCENES)
    assert result["launches"] == {"salsa_spatial": 0, "noise_floor": 0}
    assert result["served"].startswith("served 9 audio-s") and "realtime" in result["served"]
    out = capsys.readouterr().out
    assert "3 groups [4, 1, 1] from epoch010.msgpack" in out and "byte-identical" in out


def test_phase8_fails_when_the_cli_serves_another_checkpoint(monkeypatch):
    monkeypatch.setattr(chip_smoke.cli_predict.ckpt, "best_checkpoint",
                        lambda d: chip_smoke.cli_predict.ckpt.latest_checkpoint(d))
    with pytest.raises(AssertionError, match="restored"):
        chip_smoke.phase8(torch.device("cpu"), scenes=SHORT_SCENES[4:])


def test_foa_scene_ground_truth_follows_its_source(rng):
    audio, rows = chip_smoke.foa_scene(rng, 20.7, 24000, 10)
    assert audio.shape == (4, 496800) and audio.dtype == np.float32
    assert np.abs(audio).max() < 1.0  # 16-bit wavs hold it unclipped
    frames = [int(r.split(",")[0]) for r in rows]
    assert frames[0] == 0 and max(frames) < 207 and len({r.split(",", 1)[1] for r in rows}) == 1
    on = np.array([f in set(frames) for f in range(207)])
    active = np.abs(audio[1:]).max(axis=0).reshape(-1, 2400)[:207].mean(axis=1)
    assert active[on].mean() > 5 * active[~on].mean()  # the source sounds where rows say


@pytest.mark.parametrize("rows,upload,want", [
    ([("conv", 40_000.0), ("Memcpy HtoD (Pageable -> Device)", 13_000.0)], 92_160_000,
     {"busy_ms": 53.0, "copy_ms": 13.0, "idle": 0.47}),
    ([("conv", 40_000.0)], 92_160_000, {"busy_ms": 40.0, "copy_ms": None, "idle": None}),
    ([("conv", 40_000.0), ("Memcpy HtoD (Pageable -> Device)", 4.0)], 92_160_000,
     {"busy_ms": 40.004, "copy_ms": None, "idle": None}),
    ([("conv", 40_000.0)], 0, {"busy_ms": 40.0, "copy_ms": 0.0, "idle": 0.6}),
])
def test_device_share_reads_a_missing_copy_row_as_not_measured(rows, upload, want):
    """A profiled request uploads 92 MB: without a Memcpy HtoD row, or with rows
    too short for the bytes (a small copy's row kept, the upload's dropped), the
    copy and the idle share are not measured (None), never a short copy and a
    high idle share. A call that uploads nothing reads its idle share without a
    row."""
    got = chip_smoke.device_share(rows, 100.0, upload)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v) if v is not None else got[k] is None, k


def test_phase9_trains_from_wav_on_the_cpu(capsys):
    """Phase 9 cut down on the CPU (2 s clips, 0.4 s chunks, batch 2, a narrow
    decoder): the chunk and first-step checks, cli.train with its checkpoints,
    timed steps, validation and the trained experiment served through
    cli.predict. On CPU tensors the kernels' wrappers count nothing."""
    out = chip_smoke.phase9(torch.device("cpu"), seconds=2.0, overrides=(
        "data.train_chunk_len_s=0.4", "data.train_chunk_hop_len_s=0.2",
        "training.train_batch_size=2", "model.decoder.decoder_size=16",
        "data.test_chunk_len_s=2.0", "data.test_chunk_hop_len_s=2.1",
        "data.max_file_len_s=2.0"))
    assert out["launches"] == {"salsa_spatial": 0, "noise_floor": 0, "noise_floor_collect": 0}
    assert set(out["setup"]) == {"read", "scaler_fit", "tracker_checkpoints", "val_extract"}
    assert out["step"]["step"] > 0 and all(np.isfinite(v) for v in out["scores"].values())
    text = capsys.readouterr().out
    assert "first step's loss" in text and "cli.predict served the trained best.msgpack" in text


def test_phase10_streams_on_the_cpu(capsys):
    """Phase 10 cut down on the CPU (one 1.2 s wav, 2 streams a dispatch and 2 pool
    slots, 2.5 s streams for the checks, 8.5 s for the latencies): the extraction
    and tracker checks, the four streaming CLI runs with their block dispatches
    counted and their outputs held against each other, the latency split into
    the pushes that ran the CRNN, those that only extracted and the flush. On CPU
    tensors the kernels' wrappers run their plain versions and count nothing."""
    out = chip_smoke.phase10(torch.device("cpu"), scenes=(("foa_one", 1.2, chip_smoke.FS),),
                             n_streams=2, check_seconds=2.5, timing=((2, 8.5),),
                             cpu_clip_s=1.0)
    assert out["launches"]["salsa_spatial"] == out["launches"]["noise_floor"] == 0
    assert out["launches"]["dispatches"] == 4  # one block a run, its flush on pad blocks
    assert set(out["cli"]) == {"solo", "streams", "pcm16", "pool"}
    lat = out["latency"][2]
    # 681 frames: blocks 0-3 dispatch in the pushes, 2 and 3 predict, 4 in the flush
    assert lat["blocks"] == 2 and len(lat["extract_only_ms"]) == 2
    assert lat["flush_ms"] > 0 and lat["steady_x_realtime"] > 0 and "kernels" not in out
    text = capsys.readouterr().out
    assert "bit-equal to K2 collect_states over the whole stream" in text
    assert "--pcm16 bit-equal to the float push" in text


def test_phase11_runs_the_feature_bank_on_the_cpu(capsys):
    """Phase 11 cut down on the CPU (every BANK case on 2 x 1 s clips, the golden,
    configs/seld_salsa_lite.yml's three requests at 1 s, one 1.2 s wav served from
    disk and streamed at N = 2, 2 s training clips at 0.4 s chunks, batch 2 and a
    narrow decoder): every comparison, the CSVs byte-identical to the in-memory
    pipeline's, and the trained experiment validated. On CPU tensors the kernels'
    wrappers run their plain versions and count nothing."""
    out = chip_smoke.phase11(
        torch.device("cpu"), seconds=1.0, n_clips=2, scenes=(("mic_one", 1.2, chip_smoke.FS),),
        request_seconds=(1.0, 1.0, 0.7), train_seconds=2.0, stream_seconds=6.0, n_streams=2,
        train_overrides=("data.train_chunk_len_s=0.4", "data.train_chunk_hop_len_s=0.2",
                         "training.train_batch_size=2", "model.decoder.decoder_size=16",
                         "data.test_chunk_len_s=2.0", "data.test_chunk_hop_len_s=2.1",
                         "data.max_file_len_s=2.0"))
    assert set(out["bank"]) == {"-".join([ft, fmt] + [f"{k}={v}" for k, v in o.items()])
                                for ft, fmt, o in chip_smoke.BANK}
    assert out["lite_launches"] == {"salsa_spatial": 0, "noise_floor": 0} and "bench" not in out
    assert out["stream_cli"]["counts"]["dispatches"] == 1 and out["stream"]["blocks"] >= 1
    assert out["train"]["n_steps"] >= 1 and all(np.isfinite(v)
                                                for v in out["train"]["scores"].values())
    text = capsys.readouterr().out
    assert "golden melspecgcc" in text and "golden salsa_mic" in text
    assert "byte-identical to the in-memory pipeline's" in text
    assert "seld_salsa_lite: 4 chunks" in text and "first step's loss" in text


def test_phase12_trains_augmented_and_resumes_on_the_cpu(capsys):
    """Phase 12 cut down on the CPU (2 s clips, 0.4 s chunks, batch 4, a narrow
    decoder): the augmented first step against the CPU's plain versions on the
    same draws, augmented cli.train with the step split, the resumed run's step
    losses against a fresh run's, the salsa_lite cutouts' spatial channels 0. On
    CPU tensors the kernels' wrappers count nothing."""
    out = chip_smoke.phase12(torch.device("cpu"), seconds=2.0, timed=4, overrides=(
        "data.train_chunk_len_s=0.4", "data.train_chunk_hop_len_s=0.2",
        "training.train_batch_size=4", "model.decoder.decoder_size=16",
        "data.test_chunk_len_s=2.0", "data.test_chunk_hop_len_s=2.1",
        "data.max_file_len_s=2.0"))
    assert out["launches"] == {"salsa_spatial": 0, "noise_floor": 0, "noise_floor_collect": 0}
    assert out["first_step_rel"] == 0.0 and out["resume_rel"] == 0.0
    assert out["step"]["augment"] > 0 and out["n_steps"] >= 2
    assert out["lite"]["n_cut"] >= 1 and not any(out["lite"]["launches"].values())
    text = capsys.readouterr().out
    assert "augmented (" in text and "cells changed" in text
    assert "step losses within" in text and "trailing 3 spatial channels 0" in text


def test_extraction_batches_and_the_launch_check():
    """extract_split_to_store's calls: equal lengths batch, 8 a call."""
    assert chip_smoke.extraction_batches([4800] * 2) == 1
    assert chip_smoke.extraction_batches([4800] * 9 + [100, 100, 7]) == 4
    assert chip_smoke.extraction_batches([]) == 0
    chip_smoke.check_infer_launches({"salsa_spatial": 2, "noise_floor": 2}, 2, "x")
    for launches in ({"salsa_spatial": 3, "noise_floor": 2}, {"salsa_spatial": 2},
                     {"salsa_spatial": 2, "noise_floor": 2, "extra": 1}):
        with pytest.raises(AssertionError, match="one K1 and one K2 launch"):
            chip_smoke.check_infer_launches(launches, 2, "x")


def test_tta_fold_printed_at_the_test_chunk():
    """The fold phase 13 prints: 16 FOA variants, 2e8 elements a dispatch."""
    assert chip_smoke.tta_fold(16, (2, 7, 4800, 200)) == 8
    assert chip_smoke.tta_fold(16, (8, 7, 4800, 200)) == 2
    assert chip_smoke.tta_fold(16, (2, 7, 10, 200)) == 16
    assert chip_smoke.tta_fold(16, (2, 7, 4800, 200), 1.0) == 1


def test_differing_files_compares_bytes(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    for d in (a, b):
        (d / "one.csv").write_bytes(b"0,1,0,10,20\n")
        (d / "two.csv").write_bytes(b"3,0,0,-180,0\n")
    assert chip_smoke.differing_files(str(a), str(b)) == []
    (b / "two.csv").write_bytes(b"3,0,0,-180,0\r\n")  # one byte more
    (a / "three.csv").write_text("")
    assert chip_smoke.differing_files(str(a), str(b)) == ["three.csv", "two.csv"]


def test_main_runs_every_phase_and_imports_nothing_of_salsa_tpu():
    """main() calls phases 0-17 in order; the script imports neither jax nor
    salsa_tpu (only salsa_tpu_torch), at the top or inside a function."""
    import ast
    import inspect
    import re

    calls = re.findall(r"\bphase(\d+)\(", inspect.getsource(chip_smoke.main))
    assert [int(c) for c in calls] == list(range(18))
    tree = ast.parse(inspect.getsource(chip_smoke))
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert names and not [m for m in names
                          if m.split(".")[0] in ("jax", "flax", "salsa_tpu")], names
