"""chip_smoke.py's phase 13 cut down to run on the CPU: a file of its own, so that
the suite's workers run it beside the other phases' tests."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from salsa_tpu_torch.train.threshold import DEFAULT_THRESHOLDS  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for this file, beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_phase13_infers_and_fuses_on_the_cpu(capsys):
    """Phase 13 cut down on the CPU (2 s clips, 0.4 s chunks, batch 2, a narrow
    decoder): both members trained, then per output format cli.infer plain and
    --tta, fused against sequential TTA, --tune-threshold with cli.predict
    --use-tuned-threshold, and cli.ensemble over one member, both and the
    averaged checkpoint. On CPU tensors the kernels' wrappers count nothing."""
    out = chip_smoke.phase13(torch.device("cpu"), seconds=2.0, overrides=(
        "data.train_chunk_len_s=0.4", "data.train_chunk_hop_len_s=0.2",
        "training.train_batch_size=2", "model.decoder.decoder_size=16",
        "data.test_chunk_len_s=2.0", "data.test_chunk_hop_len_s=2.1",
        "data.max_file_len_s=2.0"))
    for fmt in ("reg_xyz", "accdoa"):
        assert out[fmt]["launches"] == out[fmt]["tta_launches"] == {"salsa_spatial": 0,
                                                                    "noise_floor": 0}
        assert out[fmt]["fused_diff"] <= 1e-6
        # 2 clips of one chunk: one batch of 2 rows, 16 variants in one dispatch
        assert out[fmt]["tta"]["batches"] == [32] and out[fmt]["seq"]["batches"] == [2] * 16
        assert all(np.isfinite(s["seld_error"]) for s in out[fmt]["scores"].values())
    assert out["reg_xyz"]["tuned"] in DEFAULT_THRESHOLDS
    text = capsys.readouterr().out
    assert "TTA fold at the 2 s test chunk: 16 of 16" in text
    assert "one member's CSVs byte-identical to its infer's" in text
    assert "cli.predict --use-tuned-threshold served 2 CSVs at it (byte-identical" in text
