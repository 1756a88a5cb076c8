"""salsa_tpu_torch.dsp against salsa_tpu.dsp on the same seeded inputs."""
import importlib

import numpy as np
import pytest
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from salsa_tpu.dsp.filterbank import high_freq_compression_matrix as j_hfcm  # noqa: E402
from salsa_tpu_torch.dsp import stft as tstft  # noqa: E402
from salsa_tpu_torch.dsp.filterbank import high_freq_compression_matrix as t_hfcm  # noqa: E402

# salsa_tpu.dsp re-exports a function named `stft`, which shadows the module
jstft = importlib.import_module("salsa_tpu.dsp.stft")


@pytest.mark.parametrize("n_samples,n_fft,hop,win", [
    (24000, 512, 300, None),   # the serving config, 1 s
    (1000, 512, 300, None),    # short signal: 4 frames
    (8000, 256, 150, 200),     # win_length < n_fft
    (4801, 512, 256, 400),
])
def test_stft_matches_jax(rng, n_samples, n_fft, hop, win):
    x = rng.standard_normal((2, 4, n_samples)).astype(np.float32)
    want = np.asarray(jstft.stft(jnp.asarray(x), n_fft=n_fft, hop_length=hop,
                                 win_length=win))
    got = tstft.stft(torch.from_numpy(x), n_fft=n_fft, hop_length=hop, win_length=win)
    assert got.dtype == torch.complex64
    got = got.numpy()
    assert got.shape == want.shape
    assert got.shape[-2] == tstft.n_stft_frames(n_samples, hop, n_fft)
    # f32 matmuls summed in different orders: bound relative to the peak magnitude
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("win_length,periodic", [(512, True), (400, True), (256, False)])
def test_hann_window_equal(win_length, periodic):
    np.testing.assert_array_equal(tstft.hann_window(win_length, periodic),
                                  jstft.hann_window(win_length, periodic))


@pytest.mark.parametrize("n,hop,n_fft,center", [(24000, 300, 512, True), (1000, 300, 512, False),
                                                (1441234, 300, 512, True)])
def test_n_stft_frames_equal(n, hop, n_fft, center):
    assert tstft.n_stft_frames(n, hop, n_fft, center) == jstft.n_stft_frames(n, hop, n_fft, center)


def test_cabs2_and_power_to_db_match_jax(rng):
    z = (rng.standard_normal((3, 50, 257)) + 1j * rng.standard_normal((3, 50, 257)))
    z = (z * np.logspace(-6, 2, 257)).astype(np.complex64)
    p_j = np.asarray(jstft.cabs2(jnp.asarray(z)))
    p_t = tstft.cabs2(torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(p_t, p_j)
    p = np.concatenate([p_j.ravel(), [0.0, 1e-12, 1e-10]]).astype(np.float32)
    for kw in ({}, {"ref": 2.0, "amin": 1e-8}, {"top_db": 80.0}):
        want = np.asarray(jstft.power_to_db(jnp.asarray(p), **kw))
        got = tstft.power_to_db(torch.from_numpy(p), **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("n_fft,compress", [(512, True), (256, True), (512, False)])
def test_high_freq_compression_matrix_equal(n_fft, compress):
    np.testing.assert_array_equal(t_hfcm(n_fft, compress), j_hfcm(n_fft, compress))
