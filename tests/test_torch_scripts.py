"""The port's measurement scripts (`salsa_tpu_torch/scripts/`: bench_train,
bench_streaming, profile_step, probe_extract_stages, probe_stft_split,
quality_seeds) at a token size with `--cpu`: each prints one JSON object holding
the quantities its top-level counterpart in `scripts/` reports, read from that
script's source (the keys of its JSON, or the names of its cases and printed
figures), with finite values. `quality_seeds`' table is held against the
original's on the same per-seed results. Times taken here are the CPU's and are
never read as the card's."""
import ast
import importlib.util
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from salsa_tpu_torch.scripts import (  # noqa: E402
    bench_streaming,
    bench_train,
    probe_extract_stages,
    probe_stft_split,
    profile_step,
    quality_evidence,
    quality_seeds,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """The suite runs test files side by side, several workers on a few cores: two
    intra-op threads for this file keep torch's pools from thrashing against the
    other workers'."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def original(name: str) -> ast.Module:
    with open(os.path.join(REPO, "scripts", f"{name}.py")) as f:
        return ast.parse(f.read())


def json_keys(tree: ast.AST) -> set[str]:
    """The string keys of every dict literal passed to `json.dumps`."""
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and ast.unparse(node.func) == "json.dumps":
            keys |= {k.value for d in ast.walk(node.args[0]) if isinstance(d, ast.Dict)
                     for k in d.keys if isinstance(k, ast.Constant)}
    return keys


def out_keys(tree: ast.AST, name: str = "out") -> set[str]:
    """The keys the script gives the dict `name`: its literal's and `name["k"] = ...`."""
    keys = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if isinstance(t, ast.Name) and t.id == name and isinstance(node.value, ast.Dict):
                keys |= {k.value for k in node.value.keys if isinstance(k, ast.Constant)}
            elif (isinstance(t, ast.Subscript) and ast.unparse(t.value) == name
                  and isinstance(t.slice, ast.Constant)):
                keys.add(t.slice.value)
    return keys


def case_names(tree: ast.AST) -> set[str]:
    """The first string of every tuple in a `cases` list (and `cases.append`)."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Tuple) and node.elts and isinstance(node.elts[0], ast.Constant) \
                and isinstance(node.elts[0].value, str) and len(node.elts) >= 2:
            names.add(node.elts[0].value)
    return names


def finite(value) -> bool:
    if isinstance(value, dict):
        return all(finite(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return all(finite(v) for v in value)
    if isinstance(value, float):
        return math.isfinite(value)
    return True


def printed_json(capsys) -> dict:
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    return json.loads(lines[-1])


@pytest.mark.parametrize("from_wav", [False, True])
def test_bench_train_keys(capsys, from_wav):
    """Both metrics of the original: the feature-fed step and, with --from-wav, the
    step that extracts its chunks (K2, K1: plain versions here) first."""
    out = bench_train.main(["--cpu", "--batch", "1", "--iters", "1"]
                           + (["--from-wav"] if from_wav else []))
    assert printed_json(capsys) == json.loads(json.dumps(out))
    tree = original("bench_train")
    want = json_keys(tree) - ({"eig_method"} if not from_wav else set())
    assert {"metric", "steps_per_s", "audio_s_per_s", "batch", "bf16", "loss"} <= want
    assert want <= set(out) and finite(out) and out["device"] == "cpu"
    assert out["metric"] == ("train_step_throughput_from_wav" if from_wav
                             else "train_step_throughput")
    assert "CPU" in out["method"]


def test_profile_step_keys(capsys):
    out = profile_step.main(["--cpu", "--batch", "1", "--iters", "1", "--frames", "64",
                             "--matmul-size", "128"])
    assert printed_json(capsys) == json.loads(json.dumps(out))
    want = out_keys(original("profile_step"))
    assert {"full_step_ms", "fwd_train_ms", "fwd_eval_ms", "fwd_bwd_ms", "peak_matmul_tflops",
            "effective_tflops_fwd_bwd"} <= want
    assert want <= set(out) and finite(out)
    assert out["full_step_ms"] > 0 and out["peak_matmul_tflops"] > 0


@pytest.mark.parametrize("mode", [[], ["--pool", "--streams", "2", "--int16"],
                                  ["--realtime", "--seconds", "1.5"]])
def test_bench_streaming_keys(capsys, mode):
    """The original prints the label frames, the wall time, x realtime a stream
    and in aggregate, per-block p50 / p95 / max and the lookahead (with
    --realtime the push occupancy and the headroom; with --pool the round latency
    and the aggregate rate)."""
    argv = ["--cpu", "--seconds", "4", "--block", "32", "--context", "32"] + mode
    bench_streaming.main(argv)
    out = printed_json(capsys)["bench_streaming"]
    want = {"wall_s", "x_realtime_aggregate", "p50_ms", "p95_ms", "max_ms"}
    if "--pool" not in mode:
        want |= {"label_frames", "x_realtime_per_stream", "lookahead_ms"}
    if "--realtime" in mode:
        want |= {"push_occupancy", "headroom_streams"}
    assert want <= set(out) and finite(out) and out["p50_ms"] > 0
    text = open(os.path.join(REPO, "scripts", "bench_streaming.py")).read()
    for printed in ("p50", "p95", "max", "aggregate", "realtime per stream",
                    "algorithmic lookahead", "push-occupancy", "headroom"):
        assert printed in text


def test_probe_extract_stages_keys(capsys):
    out = probe_extract_stages.main(["--cpu", "--batch", "1", "2", "--seconds", "1",
                                     "--iters", "1"])
    assert printed_json(capsys) == json.loads(json.dumps(out))
    stages = case_names(original("probe_extract_stages"))
    assert stages == set(probe_extract_stages.STAGES)
    rows = out["probe_extract_stages"]
    assert [r["batch"] for r in rows] == [1, 2] and finite(rows)
    for r in rows:
        assert stages | {"k1", "k2"} <= set(r)


def test_probe_stft_split_keys(capsys):
    """The features of both ways agree (the script raises otherwise) before the
    cases are timed; the cases are the original's."""
    out = probe_stft_split.main(["--cpu", "--batch", "2", "--seconds", "0.5", "--iters", "1"])
    assert printed_json(capsys)["probe_stft_split"] == json.loads(json.dumps(out))
    cases = case_names(original("probe_stft_split"))
    assert cases == set(probe_stft_split.CASES) and cases <= set(out) and finite(out)
    assert out["mask_disagreement"] < 0.005 and out["stft_max_abs_diff"] < 1e-3


def test_quality_seeds_table_equals_the_original(capsys, tmp_path, monkeypatch):
    """Two seeds' quality_evidence results (stubbed: the study itself trains 4
    full-width members a seed and runs on the card in chip_smoke.py's phase 17)
    through the port's quality_seeds and the original's aggregation: the same
    table, the same JSON keys; a rerun reads the kept results."""
    def result(seed):
        r = np.random.default_rng(seed).uniform(0.1, 0.5, 7).round(4)
        return {"tta": {"no_tta": {"seld_error": r[0]}, "tta": {"seld_error": r[1]}},
                "ensemble": {"fused": r[2], "best_member": r[3]},
                "swa": {"swa": {"seld_error": r[4]}},
                "swa_tail": {"member_const_tail": {"seld_error": r[5]},
                             "swa": {"seld_error": r[6]}}}

    calls = []

    def fake_main(argv, device):
        calls.append((argv, device))
        return json.loads(json.dumps(result(int(argv[argv.index("--data-seed") + 1]))))

    monkeypatch.setattr(quality_evidence, "main", fake_main)
    argv = ["--cpu", "--seeds", "3", "4", "--clips", "4", "--epochs", "1", "--members", "1",
            "--workdir", str(tmp_path)]
    out = quality_seeds.main(argv)
    assert [c[1] for c in calls] == ["cpu", "cpu"]
    assert "--data-seed" in calls[0][0] and printed_json_tail(capsys) == {"quality_seeds": out}
    assert quality_seeds.main(argv) == out and len(calls) == 2  # kept results reused

    spec = importlib.util.spec_from_file_location(
        "original_quality_seeds", os.path.join(REPO, "scripts", "quality_seeds.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "run_seed", lambda seed, *a: json.loads(json.dumps(result(seed))))
    monkeypatch.setattr("sys.argv", ["quality_seeds.py", "--seeds", "3", "4"])
    capsys.readouterr()
    mod.main()
    want = printed_json_tail(capsys)
    assert want == {"quality_seeds": out}


def printed_json_tail(capsys) -> dict:
    """The last JSON object printed, which may span lines (indent=1)."""
    text = capsys.readouterr().out
    start = text.rfind('{\n "quality_seeds"')
    return json.loads(text[start:])
