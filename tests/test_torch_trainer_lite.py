"""The port's fused raw-wav trainer against salsa_tpu's on salsa_lite (MIC,
configs/seld_salsa_lite.yml's feature type): tests/test_torch_trainer.py's slice
(one flax init, fp32, dropout 0, the same scaler and epoch order) with
frame-local chunks, no tracker checkpoints and no K1 or K2."""
import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tests.test_torch_trainer import (  # noqa: E402,F401
    _two_torch_threads,
    assert_loss_traces_match,
    train_both,
)

N_LITE_STEPS = 10


@pytest.fixture(scope="module")
def trained_lite(tmp_path_factory):
    """The slice on salsa_lite (MIC; configs/seld_salsa_lite.yml's feature type):
    frame-local chunks, no tracker checkpoints, no K1 or K2."""
    yield from train_both(str(tmp_path_factory.mktemp("torch_trainer_lite")), "salsa_lite",
                          "mic", N_LITE_STEPS)


def test_salsa_lite_loss_trace_matches_salsa_tpu(trained_lite):
    """10 from-wav steps of salsa_lite from one flax init, dropout 0: step 1 within
    1e-4 and every step within 2e-3 of salsa_tpu's losses; the chunk tables are
    salsa_tpu's, and no tracker checkpoint is made."""
    assert_loss_traces_match(trained_lite, N_LITE_STEPS)
    jt, tt = trained_lite["jax"], trained_lite["torch"]
    assert tt._floor_ck is None and tt.n_spec_channels == 4
    assert "tracker_checkpoints" not in tt.setup_seconds
    clip, f0, n_full, n_valid, l_start = (np.asarray(a) for a in jt._wav_tables[:5])
    for want, got in ((clip, tt._clip), (f0, tt._f0), (n_full, tt._n_full),
                      (n_valid, tt._n_valid), (l_start, tt._l_start)):
        np.testing.assert_array_equal(got.numpy(), want)
