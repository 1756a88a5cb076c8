"""chip_smoke.py's phase 15 cut down to run on the CPU: a file of its own, so that
the suite's workers run it beside the other phases' tests."""
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


def test_phase15_runs_the_store_workflow_on_the_cpu(capsys):
    """Phase 15 cut down on the CPU (2 s clips, 0.4 s chunks, batch 2, a narrow
    decoder): cli.extract into the store, cli.train from it with the host
    transforms, the device_data, precompute and remat variants, cli.predict with
    the store's scaler, cli.infer and cli.evaluate from the store. On CPU tensors
    the kernels' wrappers count nothing."""
    out = chip_smoke.phase15(torch.device("cpu"), seconds=2.0, timed=3, overrides=(
        "data.train_chunk_len_s=0.4", "data.train_chunk_hop_len_s=0.2",
        "training.train_batch_size=2", "model.decoder.decoder_size=16",
        "data.test_chunk_len_s=2.0", "data.test_chunk_hop_len_s=2.1",
        "data.max_file_len_s=2.0"))
    zero = {"salsa_spatial": 0, "noise_floor": 0}
    assert out["extract"]["launches"] == out["train_launches"] == out["infer_launches"] == zero
    assert out["pre_launches"] == zero and out["extract"]["batches"] == 2
    assert out["first_step_rel"] < 1e-4 and out["remat_rel"] < 1e-4
    assert all(np.isfinite(v) for v in out["scores"].values())
    text = capsys.readouterr().out
    assert "--keep-existing rerun: 0 clips left to extract" in text
    assert "bit-equal to the host path's for the same chunks" in text
    assert "byte-identical to the in-memory pipeline's" in text
    assert "cli.evaluate of the infer's CSVs prints its scores" in text
