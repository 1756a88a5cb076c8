"""chip_smoke.py's phase 17 cut down to run on the CPU (a file of its own, so that
the suite's workers run it beside the other phases' tests): SALSA of a 17-mic
array against the plain run, a longer clip at 17 mics, the measurement scripts
at token sizes, a two-step cli.train with its TensorBoard scalars, and the same
experiment trained, served and resumed with `.orbax` checkpoints. Two of the
scripts run here, through the same in-process call as the card's six (each script at a token size is tests/test_torch_scripts.py's);
quality_seeds' study trains full-width bf16 members, which the card does in
phase 17 (its table is held against the original's there)."""
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402

CUT = ("data.train_chunk_len_s=0.4", "data.train_chunk_hop_len_s=0.2",
       "model.decoder.decoder_size=16", "data.test_chunk_len_s=2.0",
       "data.test_chunk_hop_len_s=2.1", "data.max_file_len_s=2.0")
TOKEN_RUNS = {
    "bench_streaming": [["--seconds", "4", "--block", "32", "--context", "32"]],
    "probe_extract_stages": [["--batch", "1", "--seconds", "1", "--iters", "1"]],
}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for this file, beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_phase17_runs_on_the_cpu(capsys):
    out = chip_smoke.phase17(torch.device("cpu"), seconds=2.0, counts=(17,), long_mics=17,
                             long_seconds=3.0, runs=TOKEN_RUNS, tb_seconds=2.0,
                             tb_overrides=CUT)
    zero = {"salsa_spatial": 0, "noise_floor": 0}
    assert out["many"][17]["launches"] == zero and out["many"][17]["max_abs_err"] < 5e-3
    assert out["long"]["launches"] == zero and out["long"]["ms"] > 0
    assert sorted(out["scripts"]) == sorted(TOKEN_RUNS)
    assert out["train"]["steps"] == 2 and not any(out["train"]["launches"].values())
    assert out["train"]["tensorboard"] == "13 tags at step 2"
    text = capsys.readouterr().out
    assert "17-channel SALSA (17 mics, 2 s): 33 channels" in text
    orbax = out["orbax"]
    assert orbax["predict_launches_orbax"] == orbax["predict_launches_twin"] == zero
    assert orbax["resume_losses"] and orbax["orbax_restore_s"] > 0 and orbax["plain_mb_s"] > 0
    assert "restore bit-equal to the trainer's state" in text
    assert "CSVs byte-identical to the msgpack twin experiment's" in text
    assert "bit-equal to --resume from the msgpack twin" in text
    assert "byte-equal through the C++ decoder" in text
    assert "(e) training.checkpoint_backend=zarr refused through cli.train" in text
    assert "unknown checkpoint backend 'zarr'" in text


def test_phase17_is_in_the_main_path():
    """main() runs phase 17 after phase 16 and the module docstring names it; the
    script's runs cover the six scripts, quality_seeds at 2 seeds x 4 clips x 1
    epoch."""
    import inspect

    src = inspect.getsource(chip_smoke.main)
    assert src.index("phase16(dev)") < src.index("phase17(dev)")
    assert "\n 17. SALSA at any channel count" in chip_smoke.__doc__
    assert sorted(chip_smoke.SCRIPT_RUNS) == sorted(chip_smoke.SCRIPT_KEYS) == [
        "bench_streaming", "bench_train", "probe_extract_stages", "probe_stft_split",
        "profile_step", "quality_seeds"]
    assert chip_smoke.SCRIPT_RUNS["quality_seeds"] == [
        ["--seeds", "1", "2", "--clips", "4", "--epochs", "1", "--members", "1"]]
