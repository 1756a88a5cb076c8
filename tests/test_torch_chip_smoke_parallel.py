"""chip_smoke.py's phase 16 cut down to run on the CPU: the rank launcher (one and
two gloo ranks, torchrun's and salsa_tpu's variables), the loss comparisons, the
per-rank launch counts (none on CPU tensors), device_data_shard against
device_data, the resume, the interop CLIs, 6-channel SALSA and profiling. A file
of its own, so that the suite's workers run it beside the other phases' tests."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for this file, beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_phase16_trains_on_ranks_on_the_cpu(capsys):
    """Phase 16 cut down on the CPU (2 s clips, 0.4 s chunks, batch 2 = one row a
    rank, a narrow decoder)."""
    out = chip_smoke.phase16(torch.device("cpu"), seconds=2.0, timed=2,
                             k1_shape=(2, 4, 31, 46), overrides=(
        "data.train_chunk_len_s=0.4", "data.train_chunk_hop_len_s=0.2",
        "training.train_batch_size=2", "model.decoder.decoder_size=16",
        "data.test_chunk_len_s=2.0", "data.test_chunk_hop_len_s=2.1",
        "data.max_file_len_s=2.0"))
    zero = {"salsa_spatial": 0, "noise_floor": 0}
    assert out["one"]["launches"] == zero and all(r["launches"] == zero for r in out["two"])
    assert [r["rows"] for r in out["two"]] == [1, 1] and out["solo"]["rows"] == 2
    assert out["one_rel"] <= 1e-6 and out["two_rel"] <= 2e-3
    assert out["shard_rel"] <= 1e-4 and out["resume_rel"] <= 1e-4
    assert out["six"]["launches"] == zero and out["profile"]["k1_ms"] > 0
    assert out["two"][0]["collectives_per_step"] > 0 and out["one"]["collectives_per_step"] == 0
    text = capsys.readouterr().out
    assert "(e) export_ckpt -> import_ckpt" in text and "byte-identical CSVs" in text
    assert np.isfinite(out["two"][0]["step_ms"])


def test_launch_ranks_fails_with_a_failing_rank(tmp_path):
    """A rank that fails fails the launch, naming the rank and its error."""
    with pytest.raises(AssertionError, match=r"rank 0 of 1 exited"):
        chip_smoke.launch_ranks({"config": str(tmp_path / "missing.yml"), "group": str(tmp_path),
                                 "suffix": "", "device": "cpu"}, 1, str(tmp_path))


def test_compare_losses_bounds():
    assert chip_smoke.compare_losses([1.0, 2.0], [1.0, 2.0001], "equal-ish", 1e-4) < 1e-4
    with pytest.raises(AssertionError):
        chip_smoke.compare_losses([1.001, 2.0], [1.0, 2.0], "first step", 1e-4, 2e-3)
    with pytest.raises(AssertionError):
        chip_smoke.compare_losses([1.0], [1.0, 2.0], "lengths", 1e-4)


def test_profile_in_own_process_takes_its_sessions(tmp_path):
    """`chip_smoke.py --profile <spec>` in a fresh process: K1's trace on the CPU,
    where no session can hold the kernel's device row, takes all of its
    PROFILE_SESSIONS sessions and still reports the traced call."""
    out = chip_smoke.profile_in_own_process(
        {"kind": "k1_trace", "log_dir": str(tmp_path / "trace"), "device": "cpu",
         "shape": [1, 4, 7, 16]}, str(tmp_path), "16")
    assert out["sessions"] == chip_smoke.PROFILE_SESSIONS
    assert out["record_row"] and not out["kernel_row"] and out["device_events"] is None
