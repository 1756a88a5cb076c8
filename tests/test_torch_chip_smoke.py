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
