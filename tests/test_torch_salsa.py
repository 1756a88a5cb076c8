"""salsa_tpu_torch.features (tracker K2, spatial stage K1, extract_salsa) against
salsa_tpu.features on the same seeded inputs. The port runs its plain versions
here; where the JAX side reaches the Pallas kernel it runs in interpret mode, as
tests/test_salsa_pallas.py runs it."""
import os
import re

import numpy as np
import pytest
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from salsa_tpu.features import salsa as jsalsa  # noqa: E402
from salsa_tpu.features.registry import make_extractor as j_make_extractor  # noqa: E402
from salsa_tpu.features.salsa_pallas import (  # noqa: E402
    _start_vectors,
    salsa_spatial_pallas_planes,
)
from salsa_tpu_torch.features import salsa as tsalsa  # noqa: E402
from salsa_tpu_torch.features import salsa_spatial as tspatial  # noqa: E402
from salsa_tpu_torch.features.registry import make_extractor  # noqa: E402
from salsa_tpu_torch.scripts import bench_noise_floor, bench_salsa_spatial  # noqa: E402
from tests.test_salsa_pallas import make_band  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "reference_features.npz")
H = 3


def _planes(X, h=H):
    """(bins, frames, 4) complex band -> wrap-padded (4, bins, frames + 2h) planes."""
    Xpad = np.concatenate([X[:, -h:], X, X[:, :h]], axis=1)
    xr = np.ascontiguousarray(np.transpose(Xpad.real, (2, 0, 1))).astype(np.float32)
    xi = np.ascontiguousarray(np.transpose(Xpad.imag, (2, 0, 1))).astype(np.float32)
    return xr, xi


def test_start_vectors_equal_jax_draw():
    s0, s1 = _start_vectors()
    np.testing.assert_array_equal(tspatial.START_S0, s0)
    np.testing.assert_array_equal(tspatial.START_S1, s1)
    # the CUDA header that K1 and K3 share carries the same float32 literals
    src = open(os.path.join(os.path.dirname(tspatial.__file__), "..", "csrc",
                            "hermitian4.cuh")).read()

    def literals(name):
        body = re.search(rf"{name}\[C\] = \{{([^}}]*)\}}", src).group(1)
        return np.array([float(v.strip().rstrip("f")) for v in body.split(",")], np.float32)

    np.testing.assert_array_equal(literals("kS0Re"), s0.real)
    np.testing.assert_array_equal(literals("kS0Im"), s0.imag)
    np.testing.assert_array_equal(literals("kS1Re"), s1.real)
    np.testing.assert_array_equal(literals("kS1Im"), s1.imag)


def _band_mag(rng, n_bins=16, n_frames=700):
    X = make_band(rng, n_bins=n_bins, n_frames=n_frames)
    xr, xi = _planes(X)
    mag = np.array(jsalsa.tracking_magspec_planes(jnp.asarray(xr[0]), jnp.asarray(xi[0]),
                                                    H, n_frames))
    return xr, xi, mag


def _np_magnitudes(xr0, xi0, n_frames):
    """K2's magnitudes in numpy float32, every operation correctly rounded:
    sqrt(((|x[t]|^2 + |x[t-1]|^2) + |x[t-2]|^2) / 3) with |x|^2 = re*re + im*im."""
    acc = None
    for i in range(3):
        sl = slice(H - i, H - i + n_frames)
        p = xr0[..., sl] * xr0[..., sl] + xi0[..., sl] * xi0[..., sl]
        acc = p if acc is None else acc + p
    return np.sqrt(acc / np.float32(3.0))


def test_tracking_magnitude_matches_jax(rng):
    xr, xi, want = _band_mag(rng)
    got = tsalsa.tracking_magspec_planes(torch.from_numpy(xr[0]), torch.from_numpy(xi[0]),
                                         H, want.shape[1]).numpy()
    # |z|^2 via re*re + im*im here, abs(complex)**2 in JAX: ulp-level differences
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # and exactly the kernel's arithmetic
    np.testing.assert_array_equal(got, _np_magnitudes(xr[0], xi[0], want.shape[1]))


def test_sqrt_rn_is_correctly_rounded(rng):
    """torch's float32 sqrt on the CPU can be an ulp off; sqrt_rn equals numpy's
    correctly rounded root (and CUDA's __fsqrt_rn) on every input here."""
    q = np.concatenate([
        (rng.standard_normal(300_000) ** 2 * scale).astype(np.float32)
        for scale in (1.0, 3e-30, 7e25)] + [np.array([0.0, 1e-45, 1.0, 4.0, 3.4e38],
                                                     np.float32)])
    np.testing.assert_array_equal(tsalsa.sqrt_rn(torch.from_numpy(q)).numpy(), np.sqrt(q))


@pytest.mark.parametrize("n_frames", [700, 1, 2, 3, 4, 5, 6])
def test_tracker_init_state_matches_jax(rng, n_frames):
    """The clip-start floor is 0.5 x the mean of the first min(5, T) frames,
    summed in frame order (as K2 sums them). jnp.mean on the CPU sums 3 and 5
    frames in another order: the two differ by at most one ulp (ROADMAP queue 3)
    and agree exactly where the order cannot matter (1 or 2 frames)."""
    _, _, mag = _band_mag(rng)
    mag = mag[:, :n_frames]
    f_j, c_j = jsalsa.tracker_init_state(jnp.asarray(mag))
    f_t, c_t = tsalsa.tracker_init_state(torch.from_numpy(mag))
    n = min(5, n_frames)
    want = mag[:, 0]
    for t in range(1, n):
        want = want + mag[:, t]
    np.testing.assert_array_equal(f_t.numpy(), want / np.float32(n) * np.float32(0.5))
    ulps = np.abs(f_t.numpy().view(np.int32).astype(np.int64)
                  - np.asarray(f_j).view(np.int32).astype(np.int64))
    assert ulps.max() <= (0 if n <= 2 else 1)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    assert c_t.dtype == torch.int32


# (clips, bins, frames, resume_at, all-zero planes); ids "0" and "311" are the
# single-clip cases of 16 bins, "33rows" a block of 32 rows and one more
TRACKER_CASES = [
    pytest.param(1, 16, 389, 0, False, id="0"),
    pytest.param(1, 16, 389, 311, False, id="311"),
    pytest.param(3, 11, 1, 0, False, id="33rows-T1"),
    pytest.param(3, 11, 2, 0, False, id="33rows-T2"),
    pytest.param(3, 11, 3, 0, False, id="33rows-T3"),
    pytest.param(3, 11, 4, 0, False, id="33rows-T4"),
    pytest.param(3, 11, 5, 0, False, id="33rows-T5"),
    pytest.param(3, 11, 259, 0, False, id="33rows-T259"),
    pytest.param(3, 11, 3, 311, False, id="33rows-resume-T3"),
    pytest.param(2, 7, 100, 0, True, id="all-zero"),
]


@pytest.mark.parametrize("n_clips,n_bins,n_frames,resume_at,zero", TRACKER_CASES)
def test_tracker_scan_bit_equal_to_jax(rng, n_clips, n_bins, n_frames, resume_at, zero):
    """Frames [resume_at, resume_at + n_frames) of 700-frame clips: the port's scan
    on the same magnitudes and entering state, and the K2 wrapper (plain on CPU)
    on the planes, give the masks and final states of `salsa_tpu`'s
    noise_floor_scan exactly. At the clip start the state is the first
    min(5, n_frames) frames' (summed in frame order, within 1e-6 of JAX's mean);
    resume_at > 0 restarts from JAX's pre-state there, the clip's 5-frame start."""
    full = 700
    planes = [_planes(make_band(rng, n_bins=n_bins, n_frames=full)) for _ in range(n_clips)]
    xr0 = np.stack([p[0][0] for p in planes])  # (clips, bins, full + 2h)
    xi0 = np.stack([p[1][0] for p in planes])
    if zero:
        xr0, xi0 = np.zeros_like(xr0), np.zeros_like(xi0)
    rows = n_clips * n_bins
    mag = _np_magnitudes(xr0, xi0, full).reshape(rows, full)
    n0 = 5 if resume_at else min(5, n_frames)
    floor0 = mag[:, 0]
    for t in range(1, n0):
        floor0 = floor0 + mag[:, t]
    floor0 = floor0 / np.float32(n0) * np.float32(0.5)
    f_init, c_init = jsalsa.tracker_init_state(jnp.asarray(mag[:, :n0]))
    np.testing.assert_allclose(floor0, np.asarray(f_init), rtol=1e-6, atol=0)
    state0 = (jnp.asarray(floor0), c_init)
    if resume_at:
        _, _, pre = jsalsa.noise_floor_scan(jnp.asarray(mag), state0, collect_states=True)
        state0 = (pre[0][resume_at], pre[1][resume_at])
    seg = mag[:, resume_at:resume_at + n_frames]
    (f_j, c_j), m_j = jsalsa.noise_floor_scan(jnp.asarray(seg), state0)
    m_j, f_j, c_j = np.asarray(m_j), np.asarray(f_j), np.asarray(c_j)

    st = (torch.from_numpy(np.array(state0[0])), torch.from_numpy(np.array(state0[1])))
    (f_t, c_t), m_t = tsalsa.noise_floor_scan(torch.from_numpy(seg), st)
    np.testing.assert_array_equal(m_t.numpy(), m_j)
    np.testing.assert_array_equal(f_t.numpy(), f_j)
    np.testing.assert_array_equal(c_t.numpy(), c_j)

    win = slice(resume_at, resume_at + n_frames + 2 * H)  # the frames and their context
    st = None if not resume_at else tuple(s.reshape(n_clips, n_bins) for s in st)
    m_w, (f_w, c_w) = tsalsa.noise_floor_mask(
        torch.from_numpy(np.ascontiguousarray(xr0[..., win])),
        torch.from_numpy(np.ascontiguousarray(xi0[..., win])), n_hop=H, n_frames=n_frames,
        state0=st)
    np.testing.assert_array_equal(m_w.numpy().reshape(rows, n_frames), m_j)
    np.testing.assert_array_equal(f_w.numpy().ravel(), f_j)
    np.testing.assert_array_equal(c_w.numpy().ravel(), c_j)
    if zero:
        assert not m_j.any() and np.all(f_j == np.float32(1e-6))
    elif n_frames > 100:
        assert m_j.any() and not m_j.all()


@pytest.mark.parametrize("n_frames", [1, 2, 3, 4, 5, 6, 700])
def test_tracker_collect_states_bit_equal_to_jax(rng, n_frames):
    """collect_states: the state entering every frame, (floor, countdown) each
    (T, bins) per clip, from one explicit entering state (countdowns on both sides
    of 0), equals `salsa_tpu`'s noise_floor_scan(collect_states=True) bit for bit,
    through the scan and through the K2 wrapper (plain on CPU), beside equal masks
    and final states."""
    n_clips, n_bins = 3, 11
    # channel 0 of bands of n_frames + 2h frames: the frames and their context
    bands = [make_band(rng, n_bins=n_bins, n_frames=n_frames + 2 * H)[..., 0]
             for _ in range(n_clips)]
    xr0 = np.stack([b.real for b in bands]).astype(np.float32)
    xi0 = np.stack([b.imag for b in bands]).astype(np.float32)
    rows = n_clips * n_bins
    mag = _np_magnitudes(xr0, xi0, n_frames).reshape(rows, n_frames)
    floor0 = (mag[:, 0] * rng.uniform(0.3, 1.7, rows)).astype(np.float32)
    cd0 = rng.integers(-3, 4, rows, dtype=np.int32)
    (f_j, c_j), m_j, (fs_j, cs_j) = jsalsa.noise_floor_scan(
        jnp.asarray(mag), (jnp.asarray(floor0), jnp.asarray(cd0)), collect_states=True)
    fs_j, cs_j = np.asarray(fs_j), np.asarray(cs_j)
    assert fs_j.shape == (n_frames, rows) and cs_j.dtype == np.int32

    st = (torch.from_numpy(floor0), torch.from_numpy(cd0))
    (f_t, c_t), m_t, (fs_t, cs_t) = tsalsa.noise_floor_scan(torch.from_numpy(mag), st,
                                                            collect_states=True)
    assert fs_t.shape == (n_frames, rows) and cs_t.dtype == torch.int32
    np.testing.assert_array_equal(fs_t.numpy(), fs_j)
    np.testing.assert_array_equal(cs_t.numpy(), cs_j)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))

    # the wrapper: (B, T, bins) per clip
    st = (st[0].reshape(n_clips, n_bins), st[1].reshape(n_clips, n_bins))
    m_w, (f_w, c_w), (fs_w, cs_w) = tsalsa.noise_floor_mask(
        torch.from_numpy(xr0), torch.from_numpy(xi0), n_hop=H, n_frames=n_frames, state0=st,
        collect_states=True)
    assert fs_w.shape == (n_clips, n_frames, n_bins) and cs_w.dtype == torch.int32
    per_clip = lambda a: np.moveaxis(a.reshape(n_frames, n_clips, n_bins), 1, 0)  # noqa: E731
    np.testing.assert_array_equal(fs_w.numpy(), per_clip(fs_j))
    np.testing.assert_array_equal(cs_w.numpy(), per_clip(cs_j))
    np.testing.assert_array_equal(m_w.numpy().reshape(rows, n_frames), np.asarray(m_j))
    np.testing.assert_array_equal(c_w.numpy().ravel(), np.asarray(c_j))
    # the mask-only call is the same computation
    m_o, (f_o, _) = tsalsa.noise_floor_mask(torch.from_numpy(xr0), torch.from_numpy(xi0),
                                            n_hop=H, n_frames=n_frames, state0=st)
    assert torch.equal(m_o, m_w) and torch.equal(f_o, f_w)


def test_noise_floor_mask_wrapper_batches_and_resumes(rng):
    """The K2 wrapper on CPU tensors: a batch equals its rows run alone, and two
    halves chained through the returned state equal the whole clip."""
    n_frames = 333
    planes = [_planes(make_band(rng, n_bins=11, n_frames=n_frames)) for _ in range(2)]
    xr0 = torch.from_numpy(np.stack([p[0][0] for p in planes]))
    xi0 = torch.from_numpy(np.stack([p[1][0] for p in planes]))
    mask, (floor, cd) = tsalsa.noise_floor_mask(xr0, xi0, n_hop=H, n_frames=n_frames)
    assert mask.shape == (2, 11, n_frames) and mask.dtype == torch.bool
    for b in range(2):
        m1, (f1, c1) = tsalsa.noise_floor_mask(xr0[b:b + 1], xi0[b:b + 1], n_hop=H,
                                               n_frames=n_frames)
        assert torch.equal(m1[0], mask[b]) and torch.equal(f1[0], floor[b])
    cut = 200
    m_a, st = tsalsa.noise_floor_mask(xr0[..., :cut + 2 * H], xi0[..., :cut + 2 * H],
                                      n_hop=H, n_frames=cut)
    # the second half's context starts h frames before its first frame
    m_b, (f_b, c_b) = tsalsa.noise_floor_mask(
        xr0[..., cut:].contiguous(), xi0[..., cut:].contiguous(), n_hop=H,
        n_frames=n_frames - cut, state0=st)
    assert torch.equal(torch.cat([m_a, m_b], dim=-1), mask)
    assert torch.equal(f_b, floor) and torch.equal(c_b, cd)


def test_noise_floor_mask_rejects_bad_input():
    x = torch.zeros(1, 4, 20)
    with pytest.raises(ValueError):
        tsalsa.noise_floor_mask(x, x, n_hop=3, n_frames=15)  # 20 != 15 + 6
    with pytest.raises(ValueError):
        state = (torch.zeros(1, 4), torch.zeros(1, 4, dtype=torch.int32))
        tsalsa.noise_floor_mask(x[..., :6], x[..., :6], n_hop=3, n_frames=0, state0=state)
    with pytest.raises(ValueError):
        tsalsa.noise_floor_mask(x[..., :6], x[..., :6], n_hop=3, n_frames=0)  # no frame
    with pytest.raises(TypeError):
        tsalsa.noise_floor_mask(x.double(), x.double(), n_hop=3, n_frames=14)
    with pytest.raises(ValueError):
        tsalsa.noise_floor_mask(x.to("meta"), x.to("meta"), n_hop=3, n_frames=14)


def test_bench_noise_floor_variants_name_the_kernels_macros():
    name, defines = bench_noise_floor.parse_variant("t256=NF_TILE_FRAMES=256,NF_PRODUCER_WARPS=15")
    assert name == "t256" and defines == ["-DNF_TILE_FRAMES=256", "-DNF_PRODUCER_WARPS=15"]
    src = (bench_noise_floor.CSRC_DIR / "noise_floor.cu").read_text()
    for macro in ("NF_TILE_FRAMES", "NF_PRODUCER_WARPS"):
        assert f"#ifndef {macro}" in src
    for bad in ("t256", "t=", "t=TILE=256", "t=NF_TILE_FRAMES"):
        with pytest.raises(ValueError):
            bench_noise_floor.parse_variant(bad)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            bench_noise_floor.main([])


def test_bench_salsa_spatial_variants_name_the_kernels_macros():
    name, defines = bench_salsa_spatial.parse_variant("b256m2=K1_BLOCK=256,K1_MIN_BLOCKS=2")
    assert name == "b256m2" and defines == ["-DK1_BLOCK=256", "-DK1_MIN_BLOCKS=2"]
    src = (bench_salsa_spatial.CSRC_DIR / "salsa_spatial.cu").read_text()
    for macro in ("K1_BLOCK", "K1_MIN_BLOCKS"):
        assert f"#ifndef {macro}" in src
    for bad in ("b256", "b=", "b=NF_TILE_FRAMES=256", "b=K1_BLOCK"):
        with pytest.raises(ValueError):
            bench_salsa_spatial.parse_variant(bad)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            bench_salsa_spatial.main([])


def _compare_spatial(got, want, max_disagree=0.005):
    """test_salsa_pallas.py's bound: validity masks agree on > 99.5% of cells, and
    features agree to atol/rtol 5e-3 where both are valid."""
    assert got.shape == want.shape
    m_got, m_want = np.any(got != 0, axis=0), np.any(want != 0, axis=0)
    disagree = np.mean(m_got != m_want)
    assert disagree < max_disagree, f"validity masks disagree on {disagree:.2%}"
    both = m_got & m_want
    assert both.mean() > 0.05
    np.testing.assert_allclose(got[:, both], want[:, both], atol=5e-3, rtol=5e-3)


# The complex-pair algebra K1 ran before its Hermitian-real form: every entry of
# the upper triangle a complex pair, the lower read as conjugates, each product a
# full complex product.
def _pair_herm(H, i, j):
    return H[(i, j)] if i <= j else H[(j, i)].conj()


def _pair_matvec(H, v):
    out = []
    for i in range(4):
        acc = _pair_herm(H, i, 0) * v[0]
        for j in range(1, 4):
            acc = acc + _pair_herm(H, i, j) * v[j]
        out.append(acc)
    return out


def _pair_trace(H):
    return ((H[(0, 0)].re + H[(1, 1)].re) + H[(2, 2)].re) + H[(3, 3)].re


def _pair_square_renorm(H):
    out = {}
    for i in range(4):
        for j in range(i, 4):
            acc = _pair_herm(H, i, 0) * _pair_herm(H, 0, j)
            for k in range(1, 4):
                acc = acc + _pair_herm(H, i, k) * _pair_herm(H, k, j)
            out[(i, j)] = acc
    inv = 1.0 / (_pair_trace(out) + 1e-30)
    return {ij: out[ij].scale(inv) for ij in out}


def _pair_rayleigh(H, v):
    hv = _pair_matvec(H, v)
    acc = v[0].re * hv[0].re + v[0].im * hv[0].im
    for c in range(1, 4):
        acc = acc + (v[c].re * hv[c].re + v[c].im * hv[c].im)
    return acc


def _psd_cells(rng, n=400):
    """(n, 4, 4) complex64 Hermitian PSD matrices: random ranks 1-4 and scales
    over 12 decades, a near-rank-1 (coherent) share, and the all-zero matrix."""
    A = rng.standard_normal((n, 4, 4)) + 1j * rng.standard_normal((n, 4, 4))
    rank = rng.integers(1, 5, n)
    A = A * (np.arange(4)[None, None, :] < rank[:, None, None])
    A[: n // 4] += 30 * A[: n // 4, :, :1]
    M = A @ np.conj(np.transpose(A, (0, 2, 1))) * 10.0 ** rng.uniform(-6, 6, n)[:, None, None]
    M[-1] = 0
    return M.astype(np.complex64)


def _as_pairs_and_herm(M):
    cpl = lambda z: tspatial._Cplx(torch.from_numpy(np.ascontiguousarray(z.real)),
                                   torch.from_numpy(np.ascontiguousarray(z.imag)))
    pairs = {(i, j): cpl(M[:, i, j]) for i in range(4) for j in range(i, 4)}
    herm = tspatial.Herm([torch.from_numpy(np.ascontiguousarray(M[:, i, i].real))
                          for i in range(4)], {ij: pairs[ij] for ij in tspatial.UPPER})
    return pairs, herm


def _assert_close_per_cell(got, want, rel=1e-6, scale=None):
    """max |got - want| over a cell's entries within rel x `scale` there, by
    default max |want| over the cell."""
    got, want = np.stack(got, -1), np.stack(want, -1)
    err = np.abs(got - want).max(-1)
    scale = np.abs(want).max(-1) if scale is None else scale
    assert np.all(err <= rel * scale), (err / np.maximum(scale, 1e-38)).max()


@pytest.mark.parametrize("helper", ["trace", "square", "matvec", "rayleigh"])
def test_hermitian_real_helpers_match_complex_pair_algebra(rng, helper):
    """The Hermitian-real algebra (real diagonal, 6 upper entries, the kernel's
    term order) computes what the complex-pair algebra computes, within 1e-6 of
    each cell's scale (its largest value; |H| |v|^2 for a Rayleigh quotient), on
    seeded PSD matrices including the zero one, which gives zero."""
    M = _psd_cells(rng)
    pairs, herm = _as_pairs_and_herm(M)
    v = [tspatial._Cplx(*(torch.from_numpy(rng.standard_normal(len(M)).astype(np.float32))
                          for _ in "ri")) for _ in range(4)]
    if helper == "square":
        sq, psq = herm, pairs
        for _ in range(3):  # K1's three squarings
            sq, psq = tspatial._square_renorm(sq), _pair_square_renorm(psq)
            got = sq.d + [getattr(sq.o[ij], p) for ij in tspatial.UPPER for p in ("re", "im")]
            want = ([psq[(i, i)].re for i in range(4)]
                    + [getattr(psq[ij], p) for ij in tspatial.UPPER for p in ("re", "im")])
            _assert_close_per_cell([g.numpy() for g in got], [w.numpy() for w in want])
            # the complex pairs' diagonal imaginary parts are rounding noise
            assert max(float(psq[(i, i)].im.abs().max()) for i in range(4)) <= 1e-6
    elif helper == "trace":
        got, want = [tspatial._trace(herm)], [_pair_trace(pairs)]
    elif helper == "matvec":
        got = [getattr(c, p) for c in tspatial._matvec(herm, v) for p in ("re", "im")]
        want = [getattr(c, p) for c in _pair_matvec(pairs, v) for p in ("re", "im")]
    else:
        got, want = [tspatial._rayleigh(herm, v)], [_pair_rayleigh(pairs, v)]
        # a quotient near 0 (v near H's null space) cancels: its scale is |H| |v|^2
        v2 = sum(c.re.numpy() ** 2 + c.im.numpy() ** 2 for c in v)
        _assert_close_per_cell([got[0].numpy()], [want[0].numpy()],
                               scale=np.abs(M).max((1, 2)) * v2)
    if helper in ("trace", "matvec"):
        _assert_close_per_cell([g.numpy() for g in got], [w.numpy() for w in want])
    for t in got:
        assert float(t[-1].abs()) == 0.0  # the all-zero matrix


@pytest.mark.parametrize("audio_format,n_bins,n_frames", [
    ("foa", 16, 700), ("mic", 16, 700), ("foa", 11, 333), ("mic", 11, 333)])
def test_spatial_plain_matches_pallas(rng, audio_format, n_bins, n_frames):
    X = make_band(rng, n_bins=n_bins, n_frames=n_frames)
    xr, xi = _planes(X)
    mag = jsalsa.tracking_magspec_planes(jnp.asarray(xr[0]), jnp.asarray(xi[0]), H, n_frames)
    mask = jsalsa.noise_floor_mask(mag)
    kw = dict(n_hop=H, audio_format=audio_format, condition_number=5.0, lower_bin=1,
              fs=8000, n_fft=256)
    want = np.asarray(salsa_spatial_pallas_planes(jnp.asarray(xr), jnp.asarray(xi), mask,
                                                  interpret=True, **kw))
    t_mask = torch.from_numpy(np.asarray(mask))[None]
    got = tspatial.salsa_spatial(torch.from_numpy(xr)[None], torch.from_numpy(xi)[None],
                                 t_mask, **kw)
    assert got.shape == (1, 3, n_bins, n_frames) and got.dtype == torch.float32
    got = got[0].numpy()
    assert np.all(np.isfinite(got))
    _compare_spatial(got, want)


@pytest.mark.parametrize("audio_format", ["foa", "mic"])
def test_spatial_all_zero_input_gives_zero(audio_format):
    z = torch.zeros(2, 4, 5, 40 + 2 * H)
    out = tspatial.salsa_spatial(z, z, torch.ones(2, 5, 40, dtype=torch.bool), n_hop=H,
                                 audio_format=audio_format, condition_number=5.0,
                                 lower_bin=1, fs=24000, n_fft=512)
    assert out.shape == (2, 3, 5, 40)
    assert torch.isfinite(out).all() and not out.any()


def test_spatial_rejects_unsupported_input():
    kw = dict(n_hop=H, audio_format="foa", condition_number=5.0, lower_bin=1, fs=24000,
              n_fft=512)
    x3 = torch.zeros(1, 3, 4, 16)
    with pytest.raises(NotImplementedError):
        tspatial.salsa_spatial(x3, x3, torch.ones(1, 4, 10, dtype=torch.bool), **kw)
    x = torch.zeros(1, 4, 4, 16)
    with pytest.raises(ValueError):
        tspatial.salsa_spatial(x, x, torch.ones(1, 4, 9, dtype=torch.bool), **kw)
    with pytest.raises(TypeError):
        tspatial.salsa_spatial(x, x, torch.ones(1, 4, 10), **kw)
    with pytest.raises(ValueError):
        m = torch.ones(1, 4, 10, dtype=torch.bool, device="meta")
        tspatial.salsa_spatial(x.to("meta"), x.to("meta"), m, **kw)


@pytest.mark.parametrize("n_hop", [1, 2, 4])
def test_spatial_wrapper_takes_n_hop_3_only(n_hop):
    """The kernels are compiled for n_hop = 3 alone; the wrapper refuses any other
    window on every device, naming what is instantiated, and falls back to
    nothing."""
    x = torch.zeros(1, 4, 4, 10 + 2 * n_hop)
    m = torch.ones(1, 4, 10, dtype=torch.bool)
    with pytest.raises(NotImplementedError, match=r"n_hop in \(3,\)"):
        tspatial.salsa_spatial(x, x, m, n_hop=n_hop, audio_format="foa", condition_number=5.0,
                               lower_bin=1, fs=24000, n_fft=512)


def test_spatial_wrapper_refuses_planes_past_32_bit_indices():
    kw = dict(n_hop=H, audio_format="foa", condition_number=5.0, lower_bin=1, fs=24000,
              n_fft=512)
    n_t = 2**31 // (4 * 191 * 3) - 2 * H  # 3 clips of 191 bins: one element too many
    x = torch.empty((3, 4, 191, n_t + 2 * H + 1), device="meta")
    with pytest.raises(ValueError, match="32 bits"):
        tspatial.salsa_spatial(x, x, torch.empty((3, 191, n_t + 1), dtype=torch.bool,
                                                 device="meta"), **kw)


@pytest.fixture(scope="module")
def golden():
    return np.load(GOLDEN)


def _assert_golden_bounds(got, want):
    """tests/test_golden_features.py:57-64."""
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:4], want[:4], atol=2e-2, rtol=1e-3)
    ref_mask = np.any(want[4:] != 0, axis=0)
    got_mask = np.any(got[4:] != 0, axis=0)
    assert np.mean(ref_mask != got_mask) < 0.01
    both = ref_mask & got_mask
    np.testing.assert_allclose(got[4:][:, both], want[4:][:, both], atol=5e-3, rtol=1e-2)


@pytest.mark.parametrize("fmt", ["foa", "mic"])
def test_extract_salsa_matches_jax_pallas_and_golden(golden, fmt):
    x = golden["audio"]
    kw = dict(fs=int(golden["fs"]), n_fft=int(golden["n_fft"]), hop_length=int(golden["hop"]))
    want_jax = np.asarray(j_make_extractor("salsa", fmt, eig_method="pallas", **kw)(x))
    got = make_extractor("salsa", fmt, **kw)(torch.from_numpy(x)[None])
    assert got.shape == (1,) + want_jax.shape and got.dtype == torch.float32
    got = got[0].numpy()
    _assert_golden_bounds(got, want_jax)
    _assert_golden_bounds(got, golden[f"salsa_{fmt}"])


def test_make_extractor_metadata_and_unported_types():
    ex = make_extractor("salsa", "foa")
    j = j_make_extractor("salsa", "foa", jit=False)
    for k in ("name", "audio_format", "n_channels", "n_features", "n_spec_channels",
              "description"):
        assert getattr(ex, k) == getattr(j, k)
    # the types and options once refused are ported (tests/test_torch_features.py
    # holds their values); an unknown type still raises
    for args, kw in ((("salsa_lite", "mic"), {}), (("salsa", "foa"), {"is_tracking": False})):
        ex, j = make_extractor(*args, **kw), j_make_extractor(*args, jit=False, **kw)
        assert (ex.n_channels, ex.n_features, ex.description) == (
            j.n_channels, j.n_features, j.description)
    with pytest.raises(ValueError):
        make_extractor("nope", "foa")
