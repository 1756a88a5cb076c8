"""salsa_tpu_torch.utils.threefry (jax.random.normal in numpy) against jax.random
on the CPU, bit for bit: the power iteration's start vectors at every channel
count up to 64, another seed and shape, and each stage (key, bits, uniform,
erf_inv) on its own."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from salsa_tpu_torch.utils import threefry  # noqa: E402


def assert_bits_equal(got: np.ndarray, want: np.ndarray):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


CHANNELS = range(2, 65)


@pytest.fixture(scope="module")
def start_vector_draws():
    """jax.random.normal(PRNGKey(20211021), (2, 2, C)) for every C in CHANNELS,
    from one compiled call (a compile a shape would take ~0.6 s each)."""
    draws = jax.jit(lambda key: tuple(jax.random.normal(key, (2, 2, c)) for c in CHANNELS))(
        jax.random.PRNGKey(20211021))
    return {c: np.asarray(d) for c, d in zip(CHANNELS, draws)}


@pytest.mark.parametrize("n_channels", CHANNELS)
def test_start_vector_draws_equal_jax_random(n_channels, start_vector_draws):
    """jax.random.normal(PRNGKey(20211021), (2, 2, C)), salsa_tpu's start vectors
    (`features/salsa.py:230-231`), at C = 2-64."""
    assert_bits_equal(threefry.normal(20211021, (2, 2, n_channels)),
                      start_vector_draws[n_channels])


@pytest.mark.parametrize("seed,shape", [(0, (3, 5)), (7, (2, 1000)), (2**31 - 1, (33,))])
def test_other_seeds_and_shapes_equal_jax_random(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    assert_bits_equal(threefry.normal(seed, shape), want)


def test_stages_equal_jax():
    """The key words, the 32-bit draws, the uniform on [nextafter(-1, 0), 1) and
    XLA's erf_inv over 200,001 points of (-1, 1) and its two ends."""
    key = jax.random.PRNGKey(20211021)
    assert threefry.prng_key(20211021) == tuple(int(k) for k in np.asarray(key))
    assert threefry.prng_key(2**40 + 5) == (256, 5)
    with pytest.raises(ValueError, match="outside"):
        threefry.prng_key(-1)
    n = 4099
    bits = np.asarray(jax.random.bits(key, (n,), jnp.uint32))
    np.testing.assert_array_equal(threefry.random_bits(threefry.prng_key(20211021), n), bits)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = np.asarray(jax.random.uniform(key, (n,), jnp.float32, lo, 1.0))
    assert_bits_equal(threefry.uniform(threefry.prng_key(20211021), n), u)
    grid = np.concatenate([np.linspace(-0.99999, 0.99999, 200_001, dtype=np.float32),
                           np.array([lo, -lo, 0.0], np.float32)])
    assert_bits_equal(threefry.erf_inv(grid), np.asarray(jax.jit(jax.lax.erf_inv)(grid)))
