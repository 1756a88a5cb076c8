"""salsa_tpu_torch.scripts.probe_pallas_conv (K4, the stage-1 3x3 conv with 64
outputs) against the JAX probe `scripts/probe_pallas_conv.py` on the same seeded
inputs: the port's plain version against the paired-position Pallas kernel in
interpret mode, as the JAX probe's own `--check-only` runs it."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import scripts.probe_pallas_conv as jconv  # noqa: E402
from salsa_tpu_torch.scripts import probe_pallas_conv as tconv  # noqa: E402


def _inputs(C, seed=20261016):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, 10, C)).astype(np.float32)
    w = rng.standard_normal((3, 3, C, 64)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("C", [64, 7])
def test_conv_plain_matches_jax_pallas(C):
    """The JAX kernel's packed weight goes back to HWIO through hwio_from_w_big;
    the bound is the JAX probe's own (probe_pallas_conv.py:176-177)."""
    x, w = _inputs(C)
    w_big = jconv.make_w_big(w, jnp.float32)
    want = np.asarray(jconv.paired_conv_pallas(jnp.asarray(x), w_big, bh=4, interpret=True))
    w_port = tconv.hwio_from_w_big(np.asarray(w_big))
    got = tconv.conv3x3_64(torch.from_numpy(x), torch.from_numpy(w_port), rows_per_block=4)
    assert got.shape == (2, 8, 10, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(jconv.xla_conv(jnp.asarray(x),
                                                                      jnp.asarray(w))),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("C", [64, 7])
def test_hwio_from_w_big_inverts_make_w_big(C):
    _, w = _inputs(C)
    w_big = np.asarray(jconv.make_w_big(w, jnp.float32))
    back = tconv.hwio_from_w_big(w_big)
    assert back.dtype == w.dtype and back.shape == w.shape
    np.testing.assert_array_equal(back, w)
    np.testing.assert_array_equal(tconv._pack_w_big(w), w_big)
    bad = w_big.copy()
    bad[2 * C * 3, 0] = 1.0  # a structural zero of the first "combined" block
    with pytest.raises(ValueError):
        tconv.hwio_from_w_big(bad)
    with pytest.raises(ValueError):
        tconv.hwio_from_w_big(w_big[:-1])


@pytest.mark.parametrize("C", [7, 64, 80])
def test_mma_weight_layout(C):
    """The bf16 kernel's weights in shared memory: per 64-channel chunk, HWIO w
    transposed to [dh, dw, n, c] and padded with zero channels to a multiple of
    16; read back at [dh, dw, n, c] it is w[dh, dw, c0 + c, n]. Taken so,
    B[k][n] = ws[tap, n, c] and A[m][k] = the zero-padded input give, as one GEMM
    per chunk, the float64 conv and the wrapper's output on the CPU."""
    x, w = _inputs(C)
    xp = torch.nn.functional.pad(torch.from_numpy(x), (0, 0, 1, 1, 1, 1))  # 1-pixel halo
    B_, H, W, _ = x.shape
    out = torch.zeros(B_ * H * W, 64, dtype=torch.float64)
    for c0 in range(0, C, 64):
        ck = min(64, C - c0)
        cp = -(-ck // 16) * 16
        wpad = torch.zeros(3, 3, 64, cp, dtype=torch.float64)
        wpad[..., :ck] = torch.from_numpy(w[:, :, c0:c0 + ck]).double().transpose(2, 3)
        for dh, dw, n, c in np.ndindex(3, 3, 64, ck):
            assert wpad[dh, dw, n, c] == w[dh, dw, c0 + c, n]
        assert not wpad[..., ck:].any()
        xpad = torch.zeros(B_, H + 2, W + 2, cp, dtype=torch.float64)
        xpad[..., :ck] = xp[..., c0:c0 + ck].double()
        A = torch.stack([xpad[:, dh:dh + H, dw:dw + W].reshape(-1, cp)
                         for dh in range(3) for dw in range(3)], 1).reshape(-1, 9 * cp)
        Bm = wpad.permute(0, 1, 3, 2).reshape(9 * cp, 64)  # k = tap * cp + c
        out += A @ Bm
    want = torch.nn.functional.conv2d(torch.from_numpy(x).double().permute(0, 3, 1, 2),
                                      torch.from_numpy(w).double().permute(3, 2, 0, 1),
                                      padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.reshape(B_, H, W, 64).numpy(), want.numpy(), atol=1e-10)
    got = tconv.conv3x3_64(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrapper_is_the_plain_version(dtype):
    x, w = _inputs(7)
    xt, wt = torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype)
    before = tconv.conv3x3_64.launches
    got = tconv.conv3x3_64(xt, wt)
    assert got.dtype == dtype and got.shape == (2, 8, 10, 64)
    assert torch.equal(got, tconv.conv3x3_64_plain(xt, wt))
    assert tconv.conv3x3_64.launches == before
    # the plain version is the f32 conv of the inputs, rounded once to the dtype
    want = torch.nn.functional.conv2d(xt.double().permute(0, 3, 1, 2),
                                      wt.double().permute(3, 2, 0, 1), padding=1)
    err = (got.double() - want.permute(0, 2, 3, 1)).abs().max() / want.abs().max()
    assert err <= (2.0 ** -8 if dtype == torch.bfloat16 else 1e-6)


def test_conv_rejects_bad_input():
    x, w = torch.zeros(1, 4, 5, 3), torch.zeros(3, 3, 3, 64)
    with pytest.raises(ValueError):
        tconv.conv3x3_64(x[0], w)                        # not 4-D
    with pytest.raises(ValueError):
        tconv.conv3x3_64(x, torch.zeros(3, 3, 4, 64))    # C mismatch
    with pytest.raises(ValueError):
        tconv.conv3x3_64(x, torch.zeros(3, 3, 3, 32))    # not 64 outputs
    with pytest.raises(TypeError):
        tconv.conv3x3_64(x.double(), w.double())         # dtype
    with pytest.raises(TypeError):
        tconv.conv3x3_64(x, w.to(torch.bfloat16))        # mixed dtypes
    with pytest.raises(ValueError):
        tconv.conv3x3_64(x, w, rows_per_block=3)
    with pytest.raises(ValueError):
        tconv.conv3x3_64(x.to("meta"), w.to("meta"))     # neither cuda nor cpu
    with pytest.raises(ValueError):
        tconv.conv3x3_64(x, w.to("meta"))                # two devices


def test_probe_main_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        tconv.main(["--batch", "1"])
