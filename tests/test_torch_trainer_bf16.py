"""bf16 training: salsa_tpu's from-wav trainer and the port's on configs/seld_tpu.yml's
model (PannResNet22TPU, compute_dtype bfloat16 on both parts), test_torch_trainer.py's
corpus and config, one flax init, dropout 0. A file of its own, so that the suite's
workers run it beside tests/test_torch_bf16.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from tests.test_torch_trainer import DEC, ENC, train_both  # noqa: E402

BF16 = "bfloat16"
# the loss trace of 10 steps: read 1.2e-3 relative at most (step 1, before any update,
# 6.6e-4: the bf16 forward alone); fp32's bound is 2e-3 on 20 steps
BF16_TRAIN_RTOL = 5e-3


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for this file, beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_bf16_training_matches_salsa_tpu(tmp_path):
    """salsa_tpu's trainer and the port's from one flax init of bf16
    PannResNet22TPU + bigru, 10 from-wav steps (test_torch_trainer.py's corpus and
    config, dropout 0): the loss traces within BF16_TRAIN_RTOL, and the steps see
    different batches and weights."""
    enc = {**ENC, "name": "PannResNet22TPU", "compute_dtype": BF16}
    dec = {**DEC, "compute_dtype": BF16}
    both = train_both(str(tmp_path), n_steps=10, enc=enc, dec=dec)
    run = next(both)
    try:
        jl, tl = np.array(run["losses"]["jax"]), np.array(run["losses"]["torch"])
        assert run["torch"].model.encoder.compute_dtype == torch.bfloat16
        np.testing.assert_allclose(tl, jl, rtol=BF16_TRAIN_RTOL, err_msg=f"{jl} vs {tl}")
        assert len(tl) == 10 and np.isfinite(tl).all() and np.std(tl) > 0.01
    finally:
        both.close()
