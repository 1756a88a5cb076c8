"""salsa_tpu_torch.scripts.probe_salsa_kernel (K3, the ablation variants of the
SALSA spatial stage) against the JAX probe `scripts/probe_salsa_kernel.py` on the
same seeded inputs. The port runs its plain version; the JAX probe's Pallas
kernel runs in interpret mode, with `pl.pallas_call` wrapped to pass
`interpret=True` and `run_variant` run eagerly under `jax.disable_jit()`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import scripts.probe_salsa_kernel as jprobe  # noqa: E402
from salsa_tpu.features import salsa as jsalsa  # noqa: E402
from salsa_tpu_torch.features.salsa_spatial import (  # noqa: E402
    salsa_spatial_plain,
    window_covariance,
)
from salsa_tpu_torch.scripts import probe_salsa_kernel as tprobe  # noqa: E402
from tests.test_salsa_pallas import make_band  # noqa: E402
from tests.test_torch_salsa import _compare_spatial, _planes  # noqa: E402

H = 3
N_BINS, N_FRAMES = 11, 300


@pytest.fixture(scope="module")
def band():
    """(complex band (bins, frames, 4), tracker mask (bins, frames) bool, port planes)."""
    X = make_band(np.random.default_rng(20261016), n_bins=N_BINS, n_frames=N_FRAMES)
    xr, xi = _planes(X)
    mag = jsalsa.tracking_magspec_planes(jnp.asarray(xr[0]), jnp.asarray(xi[0]), H, N_FRAMES)
    mask = np.array(jsalsa.noise_floor_mask(mag))
    assert 0.1 < mask.mean() < 0.9
    return X, mask, (torch.from_numpy(xr)[None], torch.from_numpy(xi)[None],
                     torch.from_numpy(mask)[None])


def jax_variant(monkeypatch, X, mask, variant, n_sq):
    """The JAX probe's kernel output (3, bins, frames), cropped from its padded
    (3, bins_pad, t_pad) pallas_call result."""
    seen = {}
    pallas_call = jprobe.pl.pallas_call

    def interpreted(*args, **kwargs):
        call = pallas_call(*args, interpret=True, **kwargs)

        def run(*operands):
            seen["out"] = call(*operands)
            return seen["out"]
        return run

    monkeypatch.setattr(jprobe.pl, "pallas_call", interpreted)
    with jax.disable_jit():
        jprobe.run_variant(jnp.asarray(X), jnp.asarray(mask), variant=variant, n_sq=n_sq,
                           bin_tile=8, t_tile=128, halo=128, n_hop=H)
    out = np.asarray(seen["out"])
    assert out.shape == (3, 16, 384)
    return out[:, :N_BINS, :N_FRAMES]


CASES = [("full", 1), ("full", 2), ("full", 3), ("full", 4), ("prep_only", 3),
         ("cov_only", 3), ("no_second", 3), ("prodslide", 3), ("realdiag", 3)]


@pytest.mark.parametrize("variant,n_sq", CASES)
def test_variant_plain_matches_jax_probe(monkeypatch, band, variant, n_sq):
    X, mask, (xr, xi, m) = band
    want = jax_variant(monkeypatch, X, mask, variant, n_sq)
    got = tprobe.salsa_spatial_variant(xr, xi, m, variant=variant, n_sq=n_sq, n_hop=H)
    assert got.shape == (1, 3, N_BINS, N_FRAMES) and got.dtype == torch.float32
    got = got[0].numpy()
    assert np.isfinite(got).all()
    if variant == "prep_only":
        np.testing.assert_array_equal(got, want)
        # frame t of the padded planes is frame t - n_hop of the clip
        np.testing.assert_array_equal(got[:, :, H:], np.where(
            mask[None, :, H:], np.transpose(X.real, (2, 0, 1))[:3, :, :N_FRAMES - H], 0))
    elif variant == "cov_only":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        assert np.array_equal(got != 0, want != 0) and (got != 0).mean() > 0.1
    else:
        _compare_spatial(got, want)  # K1's bound: < 0.5 % mask disagreement, 5e-3


def test_full_at_three_squarings_is_k1_plain(band):
    _, _, (xr, xi, m) = band
    xr2, xi2, m2 = (torch.cat([t, t.flip(-1)]) for t in (xr, xi, m))
    got = tprobe.salsa_spatial_variant_plain(xr2, xi2, m2, variant="full", n_sq=3, n_hop=H)
    want = salsa_spatial_plain(xr2, xi2, m2, n_hop=H, audio_format="foa",
                               condition_number=5.0, lower_bin=1, fs=24000, n_fft=512)
    assert torch.equal(got, want)


def test_prodslide_and_realdiag_reorder_without_changing_the_result(band):
    """Both reorderings sum each frame's finished products, where K1 (`full`)
    adds every product term to a chain: in IEEE float32 their covariance equals
    K1's to rounding (within 1e-6 of its largest entry), and their features hold
    K1's bound against `full`. The two give each other's result exactly, since
    the real part of x conj(x) is |x|^2 exactly."""
    _, _, (xr, xi, m) = band
    full = tprobe.salsa_spatial_variant_plain(xr, xi, m, variant="full", n_sq=3, n_hop=H)
    R = window_covariance(xr, xi, H)
    outs = []
    for variant in ("prodslide", "realdiag"):
        S = tprobe._slide_covariance(xr, xi, H, realdiag=variant == "realdiag")
        for want, got in [(R.d[i], S.d[i]) for i in range(4)] + [
                (getattr(R.o[ij], part), getattr(S.o[ij], part))
                for ij in R.o for part in ("re", "im")]:
            assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
        outs.append(tprobe.salsa_spatial_variant_plain(xr, xi, m, variant=variant, n_sq=3,
                                                       n_hop=H))
        tprobe.check_variant(outs[-1], full, variant, f"{variant} vs full")
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("variant", tprobe.VARIANTS)
def test_variant_all_zero_input_gives_zero(variant):
    z = torch.zeros(2, 4, 5, 40 + 2 * H)
    out = tprobe.salsa_spatial_variant(z, z, torch.ones(2, 5, 40, dtype=torch.bool),
                                       variant=variant, n_sq=3, n_hop=H)
    assert out.shape == (2, 3, 5, 40)
    assert torch.isfinite(out).all() and not out.any()


def test_variant_wrapper_dispatch_and_checks(band):
    _, _, (xr, xi, m) = band
    before = tprobe.salsa_spatial_variant.launches
    got = tprobe.salsa_spatial_variant(xr, xi, m, variant="no_second", n_sq=2, block=512)
    want = tprobe.salsa_spatial_variant_plain(xr, xi, m, variant="no_second", n_sq=2)
    assert torch.equal(got, want)
    assert tprobe.salsa_spatial_variant.launches == before  # CPU: the plain version
    kw = dict(variant="full", n_sq=3)
    with pytest.raises(ValueError):
        tprobe.salsa_spatial_variant(xr, xi, m, variant="nope", n_sq=3)
    with pytest.raises(ValueError):
        tprobe.salsa_spatial_variant(xr, xi, m, variant="full", n_sq=5)
    with pytest.raises(NotImplementedError, match=r"n_hop in \(3,\)"):
        tprobe.salsa_spatial_variant(xr, xi, m[..., 2:], n_hop=2, **kw)
    with pytest.raises(ValueError):
        tprobe.salsa_spatial_variant(xr, xi, m, block=96, **kw)
    with pytest.raises(ValueError):
        tprobe.salsa_spatial_variant(xr, xi, m[..., 1:], **kw)
    with pytest.raises(TypeError):
        tprobe.salsa_spatial_variant(xr.double(), xi.double(), m, **kw)
    with pytest.raises(ValueError):
        tprobe.salsa_spatial_variant(xr.to("meta"), xi.to("meta"), m.to("meta"), **kw)


def test_probe_planes_are_the_jax_probes_input():
    """probe_planes draws as the JAX probe's main does, then wrap-pads into planes."""
    xr, xi, mask = tprobe.probe_planes(2, "cpu", n_bins=5, n_frames=20, n_hop=H, seed=0)
    rng = np.random.default_rng(0)
    Xre = rng.standard_normal((2, 5, 20, 4)).astype(np.float32)
    Xim = rng.standard_normal((2, 5, 20, 4)).astype(np.float32)
    maskf = (rng.standard_normal((2, 5, 20)) > 0.2).astype(np.float32)
    for got, X in ((xr, Xre), (xi, Xim)):
        XP = np.concatenate([X[:, :, -H:], X, X[:, :, :H]], axis=2)
        np.testing.assert_array_equal(got.numpy(), np.transpose(XP, (0, 3, 1, 2)))
    np.testing.assert_array_equal(mask.numpy(), maskf > 0.5)


@pytest.mark.parametrize("variant", tprobe.VARIANTS)
def test_check_variant_holds_each_variants_bound(band, variant):
    """check_variant passes the plain output against itself and raises just
    outside its variant's bound."""
    _, _, (xr, xi, m) = band
    want = tprobe.salsa_spatial_variant_plain(xr, xi, m, variant=variant, n_sq=3, n_hop=H)
    err, line = tprobe.check_variant(want.clone(), want, variant, variant)
    assert err == 0.0 and line.startswith(variant)
    cell = tuple(int(i) for i in torch.nonzero(want[:, 0])[0])  # a valid (clip, bin, frame)
    off = want.clone()
    if variant == "prep_only":
        off[cell[0], 0, cell[1], cell[2]] = torch.nextafter(off[cell[0], 0, cell[1], cell[2]],
                                                            torch.tensor(np.inf))
    elif variant == "cov_only":
        off[cell[0], 0, cell[1], cell[2]] += 2e-5 * float(want.abs().max())
    else:
        off[cell[0], 0, cell[1], cell[2]] += 0.02  # one feature outside atol/rtol 5e-3
    with pytest.raises(AssertionError):
        tprobe.check_variant(off, want, variant, variant)
    if variant not in ("prep_only", "cov_only"):
        dropped = want.clone()
        dropped[..., ::2] = 0  # every second frame turned invalid
        valid = (want != 0).any(1)
        assert float(((dropped != 0).any(1) != valid).float().mean()) >= 0.005
        with pytest.raises(AssertionError, match="outside K1's bound"):
            tprobe.check_variant(dropped, want, variant, variant)
    nan = want.clone()
    nan[cell[0], 0, cell[1], cell[2]] = float("nan")
    for got, ref in ((nan, want), (want[..., 1:].contiguous(), want)):
        with pytest.raises(AssertionError, match="shape .* or non-finite"):
            tprobe.check_variant(got, ref, variant, variant)


def test_probe_main_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        tprobe.main(["--batch", "1"])
