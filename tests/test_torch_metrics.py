"""salsa_tpu_torch.metrics and cli.evaluate against salsa_tpu's: on seeded DCASE
CSV directories the 2021 and 2020 scorers give exactly the same ER / F1 / LE / LR,
and the CSV reader, segmenter and angle helper return the same values."""
import os

import numpy as np
import pytest

from salsa_tpu.cli.evaluate import evaluate_seld as j_evaluate_seld
from salsa_tpu.metrics import dcase_io as jio
from salsa_tpu.metrics import seld_metrics as jm
from salsa_tpu.metrics.scorer import evaluate_submissions as j_evaluate_submissions
from salsa_tpu_torch.cli import evaluate as tcli
from salsa_tpu_torch.metrics import dcase_io as tio
from salsa_tpu_torch.metrics import seld_metrics as tm
from salsa_tpu_torch.metrics.scorer import evaluate_submissions

N_CLASSES = 5


def _rows(rng, n_frames, layout):
    """Seeded event rows: a few classes, 1-2 simultaneous tracks, contiguous runs."""
    rows = []
    for cls in rng.choice(N_CLASSES, size=3, replace=False):
        for track in range(int(rng.integers(1, 3))):
            start = int(rng.integers(0, n_frames - 20))
            azi, ele = int(rng.integers(-180, 180)), int(rng.integers(-45, 46))
            for f in range(start, start + int(rng.integers(5, 60))):
                if f >= n_frames:
                    break
                a, e = azi + int(rng.integers(-15, 16)), ele + int(rng.integers(-8, 9))
                if layout == "submission":
                    rows.append(f"{f},{cls},{a},{e}")
                elif layout == "polar":
                    rows.append(f"{f},{cls},{track},{a},{e}")
                else:
                    x, y, z = jio.polar_deg_to_xyz(a, e)
                    rows.append(f"{f},{cls},{track},{x:.6f},{y:.6f},{z:.6f}")
    return sorted(rows, key=lambda r: int(r.split(",")[0]))


@pytest.fixture
def csv_dirs(tmp_path, rng):
    """{layout: (prediction dir, ground-truth dir)} of 4 clips each."""
    out = {}
    for pred_layout, gt_layout in (("submission", "polar"), ("polar", "polar"),
                                   ("xyz", "xyz")):
        pred, gt = tmp_path / f"pred_{pred_layout}", tmp_path / f"gt_{pred_layout}"
        pred.mkdir()
        gt.mkdir()
        for i in range(4):
            (pred / f"clip{i}.csv").write_text("\n".join(_rows(rng, 600, pred_layout)) + "\n")
            (gt / f"clip{i}.csv").write_text("\n".join(_rows(rng, 600, gt_layout)) + "\n")
        # a perfect clip, so the scores mix hits and misses
        (gt / "clip4.csv").write_text((pred / "clip0.csv").read_text())
        (pred / "clip4.csv").write_text((pred / "clip0.csv").read_text())
        out[pred_layout] = (str(pred), str(gt))
    return out


# salsa_tpu's 2020 scorer reads polar rows only
@pytest.mark.parametrize("layout,version", [("submission", "2021"), ("polar", "2021"),
                                            ("xyz", "2021"), ("submission", "2020"),
                                            ("polar", "2020")])
def test_scores_exactly_equal(csv_dirs, layout, version):
    pred, gt = csv_dirs[layout]
    kw = dict(version=version, n_classes=N_CLASSES)
    got, want = evaluate_submissions(pred, gt, **kw), j_evaluate_submissions(pred, gt, **kw)
    assert got == want
    assert 0 < want["ER"] and 0 < want["F1"] < 1 and 0 < want["LE"] < 180, want
    names = ["clip1.csv", "clip4.csv"]
    assert (evaluate_submissions(pred, gt, filenames=names, **kw)
            == j_evaluate_submissions(pred, gt, filenames=names, **kw))
    assert evaluate_submissions(gt, gt, **kw)["ER"] == 0.0


@pytest.mark.parametrize("version", ["2021", "2020"])
def test_scorer_classes_equal_on_blocks(rng, version):
    """The scorer classes fed the same segmented blocks give the same counts."""
    def blocks(layout):
        frames = {}
        for r in _rows(rng, 300, layout):
            p = r.split(",")
            frames.setdefault(int(p[0]), []).append(
                [int(p[1]), float(p[3]), float(p[4]), int(p[2])] if version == "2021"
                else [int(p[1]), float(p[3]), float(p[4])])
        return tio.segment_events(frames, max_frames=300)

    pairs = [(blocks("polar"), blocks("polar")) for _ in range(3)]
    if version == "2021":
        got, want = tm.SeldMetrics2021(N_CLASSES), jm.SeldMetrics2021(N_CLASSES)
    else:
        got, want = tm.SeldMetrics2020(N_CLASSES), jm.SeldMetrics2020(N_CLASSES)
    for p, g in pairs:
        got.update(p, g)
        want.update(p, g)
    assert got.compute() == want.compute() and vars(got) == vars(want)


def test_dcase_io_equal(tmp_path, rng):
    for layout in ("submission", "polar", "xyz"):
        path = tmp_path / f"{layout}.csv"
        path.write_text("\n".join(_rows(rng, 200, layout)) + "\n\n")
        for version in ("2021", "2020"):
            got = tio.load_output_csv(str(path), version)
            assert got == jio.load_output_csv(str(path), version) and got
            assert (tio.segment_events(got, max_frames=200, frames_per_block=10)
                    == jio.segment_events(got, max_frames=200, frames_per_block=10))
    xyz = rng.standard_normal((3, 50))
    for g, w in zip(tio.xyz_to_polar_deg(*xyz), jio.xyz_to_polar_deg(*xyz)):
        np.testing.assert_array_equal(g, w)
    bad = tmp_path / "bad.csv"
    bad.write_text("1,2,3\n")
    with pytest.raises(ValueError, match="unparseable"):
        tio.load_output_csv(str(bad))
    with pytest.raises(ValueError, match="version"):
        tio.load_output_csv(str(tmp_path / "polar.csv"), "2019")


def test_metric_helpers_equal(rng):
    a, b = rng.standard_normal((7, 3)), rng.standard_normal((5, 3))
    for got, want in zip(tm.hungarian_match(a, b), jm.hungarian_match(a, b)):
        np.testing.assert_array_equal(got, want)
    p, q = rng.uniform(-1, 1, (7, 2)), rng.uniform(-1, 1, (7, 2))
    np.testing.assert_array_equal(tm.great_circle_deg_polar_rad(p, q),
                                  jm.great_circle_deg_polar_rad(p, q))
    assert tm.seld_error_from_scores(0.4, 0.7, 12.5, 0.7) == jm.seld_error_from_scores(
        0.4, 0.7, 12.5, 0.7)


def test_evaluate_cli_equals_salsa_tpu(tmp_path, csv_dirs):
    pred, gt = csv_dirs["submission"]
    root = tmp_path / "task3"
    os.makedirs(root)
    os.symlink(gt, root / "metadata_dev")
    os.symlink(gt, root / "metadata_eval")
    for split in (False, True):
        want = j_evaluate_seld(pred, str(root), n_classes=N_CLASSES, is_eval_split=split)
        assert tcli.evaluate_seld(pred, str(root), n_classes=N_CLASSES,
                                  is_eval_split=split) == want
    argv = ["--output-dir", pred, "--gt-meta-root-dir", str(root), "--n-classes",
            str(N_CLASSES), "--metric-version", "2020"]
    assert tcli.main(argv) == j_evaluate_seld(pred, str(root), "2020", N_CLASSES)
    with pytest.raises(SystemExit):  # a missing directory: one line, exit code 2
        tcli.main(["--output-dir", str(tmp_path / "none"), "--gt-meta-root-dir", str(root)])
