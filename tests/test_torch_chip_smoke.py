"""chip_smoke.py's CPU-side pieces: the K1 comparison that phase 2 holds the
kernel to (validity masks, feature tolerance, MIC phases read on the circle) and
the SASS instruction mix it prints."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402


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
