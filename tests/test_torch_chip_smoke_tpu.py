"""chip_smoke.py's phase 14 cut down to run on the CPU: a file of its own, so that
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


SMALL = ("data.train_chunk_len_s=0.4", "data.train_chunk_hop_len_s=0.2",
         "training.train_batch_size=2", "model.decoder.decoder_size=16",
         "data.test_chunk_len_s=2.0", "data.test_chunk_hop_len_s=2.1",
         "data.max_file_len_s=2.0")


def test_phase14_runs_seld_tpu_yml_on_the_cpu(capsys):
    """Phase 14 cut down on the CPU (configs/seld_tpu.yml's requests at 1 s, 2 s
    training clips at 0.4 s chunks, batch 2, a narrow decoder; the new decoders on
    one 1 s clip): every comparison and gate, the CSVs byte-identical to the
    in-memory pipeline's, streaming, TTA and --resume. On CPU tensors the kernels'
    wrappers count nothing, and the CPU against itself reads 0."""
    out = chip_smoke.phase14(torch.device("cpu"), seconds=2.0, request_seconds=(1.0, 1.0, 0.7),
                             overrides=SMALL, decoder_overrides=SMALL, timed=4, n_streams=2,
                             request_clips=1)
    zero = {"salsa_spatial": 0, "noise_floor": 0}
    req = out["requests"]
    assert req["launches"] == zero and req["event_prob_err"] == req["doa_err"] == 0.0
    train = out["train"]
    assert train["launches"] == {**zero, "noise_floor_collect": 0}
    assert train["first_step_rel"] == 0.0 and train["step_launches"] == zero
    assert train["n_steps"] >= 2 and train["step"]["augment"] > 0
    assert train["stream_streams"]["dispatches"] >= 1 and train["stream_pool"]["dispatches"] >= 1
    assert train["infer_launches"] == zero and train["resume_launches"]["salsa_spatial"] == 0
    assert set(out["decoders"]) == set(chip_smoke.NEW_DECODERS)
    for dt, res in out["decoders"].items():
        assert res["first_step_rel"] == 0.0 and res["event_prob_err"] == 0.0, dt
    text = capsys.readouterr().out
    assert "seld_tpu.yml (PannResNet22TPU, bf16)" in text
    assert "byte-identical to the in-memory pipeline's" in text
    assert "--resume from epoch001 to 3 epochs" in text and "cli.infer --splits val --tta" in text
    assert np.isfinite(train["step"]["step"])
