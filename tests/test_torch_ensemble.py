"""`salsa_tpu_torch.train.{ensemble,threshold}` and `cli.ensemble` against
`salsa_tpu`'s on the same prediction dumps, fed as `.h5` to both and as `.npz` to the
port: the fused predictions, the CSVs, the scores and the threshold sweep equal
`salsa_tpu`'s exactly; the averaged checkpoint's leaves are `salsa_tpu`'s to the
bit and flax reads the file; the refusals match."""
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
h5py = pytest.importorskip("h5py")

import jax  # noqa: E402
from flax import serialization  # noqa: E402
from salsa_tpu.cli import ensemble as jcli  # noqa: E402
from salsa_tpu.train import ensemble as jens  # noqa: E402
from salsa_tpu.train import threshold as jthr  # noqa: E402
from salsa_tpu_torch.cli import ensemble as tcli  # noqa: E402
from salsa_tpu_torch.train import ensemble as tens  # noqa: E402
from salsa_tpu_torch.train import threshold as tthr  # noqa: E402
from salsa_tpu_torch.train.checkpoint import save_checkpoint  # noqa: E402

N_CLASSES = 3
CLIPS = {"clip_a": 20, "clip_b": 20, "clip_c": 30}  # label frames
N_MEMBERS = 3


def _member_arrays(rng):
    """{clip: (event_prob (1, T, n), doa (1, T, 3n))} with events that pass some
    thresholds and not others, and DOAs near a clip's source direction."""
    out = {}
    for i, (name, t) in enumerate(CLIPS.items()):
        ev = rng.uniform(0.0, 1.0, (1, t, N_CLASSES)).astype(np.float32)
        azi, ele = np.radians(40.0 * i - 60.0), np.radians(10.0 * i)
        direction = np.array([np.cos(azi) * np.cos(ele), np.sin(azi) * np.cos(ele),
                              np.sin(ele)])
        doa = np.repeat(direction, N_CLASSES)[None, None] + rng.normal(
            0.0, 0.2, (1, t, 3 * N_CLASSES))
        out[name] = (ev, doa.astype(np.float32))
    return out


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """N_MEMBERS members' dumps as .h5 (salsa_tpu's) and .npz (the port's), and
    DCASE ground truth for the clips."""
    root = tmp_path_factory.mktemp("torch_ensemble")
    rng = np.random.default_rng(20261017)
    dirs = {"h5": [], "npz": []}
    for m in range(N_MEMBERS):
        arrays = _member_arrays(rng)
        for fmt in dirs:
            d = root / fmt / f"m{m}"
            d.mkdir(parents=True)
            dirs[fmt].append(str(d))
            for name, (ev, doa) in arrays.items():
                blobs = {"event_frame_pred": ev, "doa_frame_pred": doa,
                         "event_frame_gt": np.zeros_like(ev), "doa_frame_gt": np.zeros_like(doa)}
                if fmt == "npz":
                    np.savez(str(d / f"{name}.npz"), **blobs)
                else:
                    with h5py.File(str(d / f"{name}.h5"), "w") as hf:
                        for k, v in blobs.items():
                            hf.create_dataset(k, data=v, dtype=np.float32)
    gt = root / "gt"
    gt.mkdir()
    for i, (name, t) in enumerate(CLIPS.items()):
        rows = [f"{f},{(f + i) % N_CLASSES},0,{40 * i - 60},{10 * i}" for f in range(2, t - 3)]
        (gt / f"{name}.csv").write_text("\n".join(rows) + "\n")
    return {"root": root, "h5": dirs["h5"], "npz": dirs["npz"], "gt": str(gt)}


def _assert_fused_equal(got, want):
    assert list(got) == sorted(want)
    for name in want:
        for g, w in zip(got[name], want[name]):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("weights", [None, [1.0, 2.0, 0.5]])
@pytest.mark.parametrize("fmt", ["h5", "npz"])
def test_ensemble_predictions_equal_salsa_tpu(dumps, fmt, weights):
    want = jens.ensemble_predictions(dumps["h5"], weights)
    _assert_fused_equal(tens.ensemble_predictions(dumps[fmt], weights), want)


@pytest.mark.parametrize("weights", [None, [1.0, 2.0, 0.5]])
def test_weighted_mean_is_exact(dumps, weights):
    """The fused arrays are (sum_k w_k x_k) / sum_k w_k in member order, to the bit."""
    w = weights or [1.0] * N_MEMBERS
    members = [tens.load_prediction_dir(d) for d in dumps["npz"]]
    fused = tens.ensemble_predictions(dumps["npz"], weights)
    for name in CLIPS:
        for k in (0, 1):
            acc = w[0] * members[0][name][k]
            for wm, mem in zip(w[1:], members[1:]):
                acc = acc + wm * mem[name][k]
            np.testing.assert_array_equal(fused[name][k], acc / float(sum(w)))


def test_write_ensemble_csvs_byte_equal(dumps, tmp_path):
    fused = tens.ensemble_predictions(dumps["npz"])
    got = tens.write_ensemble(fused, str(tmp_path / "port"), N_CLASSES, sed_threshold=0.4)
    want = jens.write_ensemble(jens.ensemble_predictions(dumps["h5"]), str(tmp_path / "jax"),
                               N_CLASSES, sed_threshold=0.4)
    assert got == want == [f"{n}.csv" for n in sorted(CLIPS)]
    n_rows = 0
    for fn in got:
        text = (tmp_path / "port" / fn).read_bytes()
        assert text == (tmp_path / "jax" / fn).read_bytes(), fn
        n_rows += text.count(b"\n")
    assert n_rows > 0


@pytest.mark.parametrize("tune", [False, True])
def test_cli_ensemble_scores_equal_salsa_tpu(dumps, tmp_path, tune):
    """`cli.ensemble` scores the fusion as salsa_tpu's does, tuned or not (the
    sweep's rows and argmin included)."""
    want = jcli.ensemble(dumps["h5"], str(tmp_path / "jax"), n_classes=N_CLASSES,
                         gt_meta_dir=dumps["gt"], tune_threshold=tune)
    got = tcli.ensemble(dumps["npz"], str(tmp_path / "port"), n_classes=N_CLASSES,
                        gt_meta_dir=dumps["gt"], tune_threshold=tune)
    assert got == want and np.isfinite(got["seld_error"])
    assert ("tuned_threshold" in got) == tune
    for fn in os.listdir(tmp_path / "jax"):
        assert (tmp_path / "port" / fn).read_bytes() == (tmp_path / "jax" / fn).read_bytes()
    assert tcli.ensemble(dumps["npz"], str(tmp_path / "no_gt"), n_classes=N_CLASSES) == {}


def test_sweep_fused_rows_equal_salsa_tpu(dumps):
    fused = tens.ensemble_predictions(dumps["npz"])
    want = jthr.sweep_fused(jens.ensemble_predictions(dumps["h5"]), dumps["gt"], N_CLASSES)
    got = tthr.sweep_fused(fused, dumps["gt"], N_CLASSES)
    assert got == want
    assert [r["threshold"] for r in got["rows"]] == list(tthr.DEFAULT_THRESHOLDS) == list(
        jthr.DEFAULT_THRESHOLDS)
    assert len({r["seld"] for r in got["rows"]}) > 1  # the threshold moves the score
    assert tthr.sweep_pred_dirs(dumps["npz"], dumps["gt"], N_CLASSES, weights=[1, 2, 1]) == \
        jthr.sweep_pred_dirs(dumps["h5"], dumps["gt"], N_CLASSES, weights=[1, 2, 1])


def test_tuned_json_read_by_both_packages(dumps, tmp_path):
    sweep = tthr.sweep_fused(tens.ensemble_predictions(dumps["npz"]), dumps["gt"], N_CLASSES)
    best_dir = tmp_path / "models" / "best"
    best_dir.mkdir(parents=True)
    path = tthr.save_tuned_threshold(str(best_dir), sweep)
    assert path == jthr.tuned_threshold_path(str(best_dir))
    assert tthr.load_tuned_threshold(str(best_dir)) == jthr.load_tuned_threshold(
        str(best_dir)) == sweep["best"]["threshold"]
    port_json = json.load(open(path))
    jthr.save_tuned_threshold(str(best_dir), sweep)
    assert json.load(open(path)) == port_json


def test_mismatched_members_raise(dumps, tmp_path):
    short = tmp_path / "short"
    short.mkdir()
    for name in sorted(CLIPS)[:2]:
        os.link(os.path.join(dumps["npz"][0], f"{name}.npz"), short / f"{name}.npz")
    with pytest.raises(ValueError, match="different clip sets"):
        tens.ensemble_predictions([dumps["npz"][0], str(short)])
    other = tmp_path / "other_len"
    other.mkdir()
    for name, t in CLIPS.items():
        np.savez(str(other / f"{name}.npz"), event_frame_pred=np.zeros((1, t + 1, N_CLASSES)),
                 doa_frame_pred=np.zeros((1, t + 1, 3 * N_CLASSES)))
    with pytest.raises(ValueError, match="shapes differ"):
        tens.ensemble_predictions([dumps["npz"][0], str(other)])
    with pytest.raises(ValueError, match="3 prediction dirs but 2 weights"):
        tens.ensemble_predictions(dumps["npz"], [1.0, 1.0])
    with pytest.raises(ValueError, match="positive"):
        tens.ensemble_predictions(dumps["npz"][:2], [1.0, -1.0])
    with pytest.raises(FileNotFoundError, match="no prediction dumps"):
        tens.load_prediction_dir(str(tmp_path))


def test_h5_dumps_need_h5py_and_one_format_a_clip(dumps, tmp_path, monkeypatch):
    mixed = tmp_path / "mixed"
    mixed.mkdir()
    for name in CLIPS:
        os.link(os.path.join(dumps["h5"][0], f"{name}.h5"), mixed / f"{name}.h5")
    os.link(os.path.join(dumps["npz"][0], "clip_b.npz"), mixed / "clip_b.npz")
    with pytest.raises(ValueError, match="both as .npz and as .h5"):
        tens.load_prediction_dir(str(mixed))
    monkeypatch.setitem(sys.modules, "h5py", None)  # a host without h5py
    with pytest.raises(ImportError, match="h5py"):
        tens.load_prediction_dir(dumps["h5"][0])
    assert set(tens.load_prediction_dir(dumps["npz"][0])) == set(CLIPS)


def _member_tree(rng, scale):
    """A checkpoint's trees with unsorted keys, float32 and integer leaves."""
    params = {"encoder": {"conv": {"kernel": rng.normal(0, scale, (3, 3, 2, 4)).astype(
        np.float32)}, "bn": {"scale": rng.normal(1, scale, (4,)).astype(np.float32),
                             "bias": rng.normal(0, scale, (4,)).astype(np.float32)}},
        "decoder": {"dense": {"kernel": rng.normal(0, scale, (4, 9)).astype(np.float32),
                              "bias": np.zeros(9, np.float32)}}}
    stats = {"encoder": {"bn": {"var": rng.uniform(0.5, 2, (4,)).astype(np.float32),
                                "mean": rng.normal(0, scale, (4,)).astype(np.float32)},
                         "count": np.array([int(scale * 10)], np.int32)}}
    opt = {"0": {"count": np.array(7, np.int32),
                 "mu": {"w": rng.normal(0, 1, (3,)).astype(np.float32)}}}
    return params, stats, opt


@pytest.mark.parametrize("weights", [None, [1.0, 2.0, 0.5]])
def test_average_checkpoint_files_equal_salsa_tpu(tmp_path, weights):
    """Leaves bit-equal to salsa_tpu's average (float64 sums in member order,
    integer leaves and opt_state from member 0), the file read by flax, its bytes
    and sidecar salsa_tpu's."""
    rng = np.random.default_rng(3)
    paths = []
    for m in range(N_MEMBERS):
        params, stats, opt = _member_tree(rng, 0.5 + m)
        paths.append(save_checkpoint(str(tmp_path / "ckpts"), f"epoch{m:03d}", params, stats,
                                     10 * (m + 1), {"epoch": m}, opt_state=opt))
    want = jens.average_checkpoint_files(paths, str(tmp_path / "jax" / "avg.msgpack"), weights)
    got = tens.average_checkpoint_files(paths, str(tmp_path / "port" / "avg.msgpack"), weights)
    with open(got, "rb") as f:
        got_tree = serialization.msgpack_restore(f.read())
    with open(want, "rb") as f:
        want_bytes = f.read()
    want_tree = serialization.msgpack_restore(want_bytes)
    got_leaves, got_def = jax.tree.flatten(got_tree)
    want_leaves, want_def = jax.tree.flatten(want_tree)
    assert got_def == want_def and got_tree["step"] == 10
    for g, w in zip(got_leaves, want_leaves):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    np.testing.assert_array_equal(got_tree["batch_stats"]["encoder"]["count"], [5])
    assert open(got, "rb").read() == want_bytes
    assert json.load(open(got[:-len(".msgpack")] + ".json")) == json.load(
        open(want[:-len(".msgpack")] + ".json"))


def test_average_keeps_empty_subtrees_as_salsa_tpu(tmp_path):
    """A tree with no BatchNorm statistics and an empty subtree averages to
    salsa_tpu's bytes (jax keeps empty dicts in the tree)."""
    paths = [save_checkpoint(str(tmp_path), f"e{i}", {"w": np.full(3, float(i), np.float32),
                                                      "empty": {}}, {}, i) for i in (1, 4)]
    want = jens.average_checkpoint_files(paths, str(tmp_path / "jax.msgpack"))
    got = tens.average_checkpoint_files(paths, str(tmp_path / "port.msgpack"))
    assert open(got, "rb").read() == open(want, "rb").read()
    with open(got, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    assert tree["batch_stats"] == {} and tree["params"]["empty"] == {}
    np.testing.assert_array_equal(tree["params"]["w"], [2.5, 2.5, 2.5])


def test_average_checkpoint_refusals(tmp_path):
    rng = np.random.default_rng(4)
    a = save_checkpoint(str(tmp_path), "a", *_member_tree(rng, 1.0)[:2], 1)
    params, stats, _ = _member_tree(rng, 1.0)
    params["decoder"]["extra"] = {"bias": np.zeros(2, np.float32)}
    b = save_checkpoint(str(tmp_path), "b", params, stats, 1)
    with pytest.raises(ValueError, match="parameter tree differs"):
        tens.average_checkpoint_files([a, b], str(tmp_path / "avg.msgpack"))
    with pytest.raises(ValueError, match=".msgpack"):
        tens.average_checkpoint_files([a, a], str(tmp_path / "avg.bin"))
    with pytest.raises(ValueError, match="2 checkpoints but 1 weights"):
        tens.average_checkpoint_files([a, a], str(tmp_path / "avg.msgpack"), [1.0])


def _run_main(main, argv, monkeypatch, capsys, pass_argv):
    if pass_argv:
        call = lambda: main(argv)  # noqa: E731
    else:
        monkeypatch.setattr(sys, "argv", ["ensemble", *argv])
        call = main
    with pytest.raises(SystemExit) as exc:
        call()
    return exc.value.code, capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--ckpts", "a.msgpack"],
    ["--ckpts", "a.msgpack", "--out-ckpt", "b.msgpack", "--out-dir", "o"],
    ["--ckpts", "a.msgpack", "--out-ckpt", "b.msgpack", "--pred-dirs", "p"],
    [],
    ["--pred-dirs", "p"],
    ["--out-dir", "o"],
])
def test_cli_ensemble_refuses_as_salsa_tpu(argv, monkeypatch, capsys):
    want = _run_main(jcli.main, argv, monkeypatch, capsys, pass_argv=False)
    got = _run_main(tcli.main, argv, monkeypatch, capsys, pass_argv=True)
    assert got == want and got[0] == 2 and got[1].startswith("error: ")


def test_cli_ensemble_tune_needs_ground_truth(dumps, tmp_path):
    for fn, dirs in ((jcli.ensemble, dumps["h5"]), (tcli.ensemble, dumps["npz"])):
        with pytest.raises(ValueError, match="--gt-meta-dir"):
            fn(dirs, str(tmp_path / "o"), n_classes=N_CLASSES, tune_threshold=True)


def test_cli_ensemble_main_fuses_and_averages(dumps, tmp_path):
    scores = tcli.main(["--pred-dirs", *dumps["npz"], "--out-dir", str(tmp_path / "fused"),
                        "--n-classes", str(N_CLASSES), "--gt-meta-dir", dumps["gt"],
                        "--weights", "1", "1", "2"])
    assert scores == jcli.ensemble(dumps["h5"], str(tmp_path / "jax"), [1, 1, 2], N_CLASSES,
                                   gt_meta_dir=dumps["gt"])
    rng = np.random.default_rng(5)
    paths = [save_checkpoint(str(tmp_path / "ck"), f"e{m}", *_member_tree(rng, 1.0)[:2], m)
             for m in range(2)]
    out = tcli.main(["--ckpts", *paths, "--out-ckpt", str(tmp_path / "swa" / "swa.msgpack")])
    assert out.endswith("swa.msgpack") and os.path.isfile(out[:-len(".msgpack")] + ".json")
