"""`salsa_tpu_torch.train.device_augment` against `salsa_tpu.train.device_augment`.

Every deterministic core against salsa_tpu's `*_dev` function on the same flags,
shift or rectangles (every flag combination of the FOA, MIC and GCC swaps, shifts
1-9 both ways, each cutout kind), bit for bit; the assembled batch augmentation
against salsa_tpu's `make_device_augment` batch function, the port given the
draws that salsa_tpu's key tree makes (replayed here with `jax.random`), for salsa
FOA and MIC, salsa_lite MIC and linspecgcc MIC in modes 'full' and 'feature'; and
the port's own draws checked for their branch frequencies and ranges.

One tolerance: a cutout's fill value, max(lo, u * (hi - lo) + lo), may differ by
the product's rounding, at most 2 ulp of the sample's largest magnitude. XLA
contracts the multiply and the add into one fused multiply-add where it compiles
them (salsa_tpu's hole scan, its jitted batch function) and rounds twice where it
runs them op by op; the port's eager ops round twice on either device. Every
other cell is held bit for bit."""
import itertools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from salsa_tpu.train import device_augment as jda  # noqa: E402
from salsa_tpu_torch.train import device_augment as tda  # noqa: E402

N_CLASSES, T, F = 3, 40, 24


def _batch(rng, C, B=2):
    x = rng.standard_normal((B, C, T, F)).astype(np.float32)
    doa = rng.standard_normal((B, T, 3 * N_CLASSES)).astype(np.float32)
    return x, doa


def _swap_case(rng, core, C, m):
    """The port's core on a batch of two (flags m, then their complement) against
    salsa_tpu's on each sample."""
    x, doa = _batch(rng, C)
    flags = np.array([m, [1 - b for b in m]], np.float32)
    gx, gd = core[1](torch.from_numpy(x), torch.from_numpy(doa), torch.from_numpy(flags),
                     N_CLASSES)
    for b in range(2):
        wx, wd = core[0](jnp.asarray(x[b]), jnp.asarray(doa[b]), jnp.asarray(flags[b]),
                         N_CLASSES)
        np.testing.assert_array_equal(gx[b].numpy(), np.asarray(wx))
        np.testing.assert_array_equal(gd[b].numpy(), np.asarray(wd))
    return gx.numpy(), x


FOA = (jda.swap_channel_foa_dev, tda.swap_channel_foa)
MIC = (jda.swap_channel_mic_dev, tda.swap_channel_mic)
GCC = (jda.swap_channel_gcc_dev, tda.swap_channel_gcc)


@pytest.mark.parametrize("m", list(itertools.product((0, 1), repeat=4)))
def test_foa_swap_bit_equal(rng, m):
    _swap_case(rng, FOA, 7, m)


@pytest.mark.parametrize("m", list(itertools.product((0, 1), repeat=3)))
def test_mic_swap_bit_equal(rng, m):
    """The three generators in sequence: bit-equal only because the port keeps
    salsa_tpu's subtractions in order (no folded channel-mixing product)."""
    _swap_case(rng, MIC, 7, m)


@pytest.mark.parametrize("m", list(itertools.product((0, 1), repeat=3)))
def test_gcc_swap_bit_equal(rng, m):
    got, x = _swap_case(rng, GCC, 10, m)
    if any(m):  # the first set flag's generator moved channels and flipped lags
        assert not np.array_equal(got[0], x[0])


@pytest.mark.parametrize("up", [True, False])
@pytest.mark.parametrize("shift", range(1, 10))
def test_freq_shift_bit_equal(rng, shift, up):
    """Shifts 1-9 up and down, one sample shifted and one left as it is; salsa_tpu
    reflect-pads by 10 and slices."""
    x, _ = _batch(rng, 7)
    offset = torch.tensor([-shift if up else shift, 0])
    got = tda.freq_shift(torch.from_numpy(x), offset).numpy()
    want = np.asarray(jda.freq_shift_dev(jnp.asarray(x[0]), shift, up, 10))
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got[1], x[1])


# ---------------------------------------------------------------------------
# salsa_tpu's draws, replayed from its key tree
# ---------------------------------------------------------------------------

def _pad_rects(rects, us):
    rects = np.array(rects + [(0, 0, 0, 0)] * (tda.N_RECTS - len(rects)), np.int64)
    return rects, np.array(list(us) + [0.0] * (tda.N_RECTS - len(us)), np.float32)


def replay_cutout(key, aspect):
    """random_cutout_dev's rectangle and fill uniform from its key."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    r1, r2 = 0.3, 1 / 0.3
    if aspect > 1:
        r1 *= aspect
    elif aspect < 1:
        r2 *= aspect
    s = jax.random.uniform(k1, (), minval=0.02, maxval=0.3) * T * F
    r = jax.random.uniform(k2, (), minval=r1, maxval=r2)
    w = int(jnp.minimum(jnp.sqrt(s / r).astype(jnp.int32), F - 1))
    h = int(jnp.minimum(jnp.sqrt(s * r).astype(jnp.int32), T - 1))
    left = int(jax.random.randint(k3, (), 0, max(F - w, 1)))
    top = int(jax.random.randint(k4, (), 0, max(T - h, 1)))
    return _pad_rects([(top, h, left, w)], [jax.random.uniform(k5, ())])


def replay_spec(key):
    kt1, kt2, kt3, kf1, kf2, kf3 = jax.random.split(key, 6)
    t_max, f_max = max(1, int(0.15 * T)), max(1, int(0.2 * F))
    dur_t = int(jax.random.randint(kt1, (), 1, max(t_max, 2)))
    start_t = int(jax.random.randint(kt2, (), 0, max(T - dur_t, 1)))
    dur_f = int(jax.random.randint(kf1, (), 1, max(f_max, 2)))
    start_f = int(jax.random.randint(kf2, (), 0, max(F - dur_f, 1)))
    return _pad_rects([(start_t, dur_t, 0, F), (0, T, start_f, dur_f)],
                      [jax.random.uniform(kt3, ()), jax.random.uniform(kf3, ())])


def replay_holes(key):
    rects, us = [], []
    for k in jax.random.split(key, tda.N_HOLES):
        k1, k2, k3 = jax.random.split(k, 3)
        left = int(jax.random.randint(k1, (), 0, max(F - tda.HOLE_SIZE, 1)))
        top = int(jax.random.randint(k2, (), 0, max(T - tda.HOLE_SIZE, 1)))
        rects.append((top, tda.HOLE_SIZE, left, tda.HOLE_SIZE))
        us.append(jax.random.uniform(k3, ()))
    return _pad_rects(rects, us)


def assert_equal_but_fills(got, want, rects):
    """got == want bit for bit outside the samples' rectangles (B, K, 4), and
    inside them within 2 ulp of the largest magnitude in the sample (the fill
    value's rounding, see the docstring)."""
    covered = np.zeros((got.shape[0], T, F), bool)
    for b, sample in enumerate(rects):
        for top, h, left, w in sample:
            covered[b, top:top + h, left:left + w] = True
    covered = np.broadcast_to(covered[:, None], got.shape)
    np.testing.assert_array_equal(got[~covered], want[~covered])
    atol = 2 * np.spacing(np.abs(want).max(axis=(1, 2, 3), keepdims=True))
    atol = np.broadcast_to(atol, got.shape)[covered]
    assert np.all(np.abs(got[covered] - want[covered]) <= atol)


CUTOUTS = {"random_cutout": (lambda k, x: jda.random_cutout_dev(k, x, T / F, 3),
                             lambda k: replay_cutout(k, T / F)),
           "spec_augment": (lambda k, x: jda.spec_augment_dev(k, x, 3), replay_spec),
           "cutout_holes": (lambda k, x: jda.cutout_holes_dev(k, x, 8, 8, 3), replay_holes)}


@pytest.mark.parametrize("kind", sorted(CUTOUTS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cutout_fill_bit_equal(rng, kind, seed):
    """Each cutout kind on salsa_tpu's draws: the leading channels take the fill
    value (max(lo, u * (hi - lo) + lo) on the device), the last 3 take 0."""
    x, _ = _batch(rng, 7, B=1)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(CUTOUTS[kind][0](key, jnp.asarray(x[0])))
    rects, u = CUTOUTS[kind][1](key)
    got = tda.fill_rects(torch.from_numpy(x), torch.from_numpy(rects)[None],
                         torch.from_numpy(u)[None], 3).numpy()[0]
    assert_equal_but_fills(got[None], want[None], rects[None])
    assert not np.array_equal(got, x[0])
    changed = got[4:] != x[0, 4:]
    assert changed.any() and np.all(got[4:][changed] == 0.0)


def replay_batch(key, B, aug):
    """The draws of salsa_tpu's batch function for key: its per-sample key tree
    (split(key, B), split(k, 6), split(ks[5], 3), then the cutout's) replayed."""
    swap = np.zeros((B, aug.n_flags), np.float32)
    offset = np.zeros(B, np.int64)
    rects = np.zeros((B, tda.N_RECTS, 4), np.int64)
    fill_u = np.zeros((B, tda.N_RECTS), np.float32)
    branches = {"do_shift": set(), "choice": set(), "do_cut": set()}
    for b, k in enumerate(jax.random.split(key, B)):
        ks = jax.random.split(k, 6)
        if aug.mode == "full":
            m = np.asarray(jax.random.bernoulli(ks[0], 0.5, (aug.n_flags,)), np.float32)
            swap[b] = m * float(jax.random.bernoulli(ks[1], 0.5))
        shift = int(jax.random.randint(ks[2], (), 1, 10))
        up, do_shift = bool(jax.random.bernoulli(ks[3], 0.5)), bool(
            jax.random.bernoulli(ks[4], 0.5))
        offset[b] = (-shift if up else shift) if do_shift else 0
        branches["do_shift"].add(do_shift)
        if aug.use_cutout:
            kc, kp, kchoice = jax.random.split(ks[5], 3)
            choice = int(jax.random.randint(kchoice, (), 0, 3))
            do_cut = bool(jax.random.bernoulli(kp, 0.5))
            branches["choice"].add(choice)
            branches["do_cut"].add(do_cut)
            if do_cut:
                replay = (lambda kk: replay_cutout(kk, aug.aspect), replay_spec,
                          replay_holes)[choice]
                rects[b], fill_u[b] = replay(kc)
    draws = tda.AugmentDraws(*(torch.from_numpy(a) for a in (swap, offset, rects, fill_u)))
    return draws, branches


CONFIGS = [("salsa", "foa", 7), ("salsa", "mic", 7), ("salsa_lite", "mic", 7),
           ("linspecgcc", "mic", 10)]


@pytest.mark.parametrize("mode", ["full", "feature"])
@pytest.mark.parametrize("ft,fmt,C", CONFIGS)
def test_batch_augment_equals_salsa_tpu(rng, ft, fmt, C, mode):
    """make_device_augment end to end: salsa_tpu's batch function (jitted, as its
    trainer runs it) against the port's apply on the replayed draws, 12 samples;
    every branch is taken; bit for bit but the fill values' 1 ulp. The
    draws change x; sed never changes, doa never under 'feature'."""
    B = 12
    x, doa = _batch(rng, C, B)
    sed = (rng.random((B, T, N_CLASSES)) > 0.5).astype(np.float32)
    j_fn = jax.jit(jda.make_device_augment(ft, fmt, N_CLASSES, T, F, mode=mode))
    aug = tda.make_device_augment(ft, fmt, N_CLASSES, T, F, mode=mode)
    key = jax.random.PRNGKey(20261017)
    wx, wsed, wdoa = (np.asarray(a) for a in j_fn(key, x, sed, doa))
    draws, branches = replay_batch(key, B, aug)
    gx, gsed, gdoa = (a.numpy() for a in aug.apply(draws, *(torch.from_numpy(a)
                                                              for a in (x, sed, doa))))
    assert branches["do_shift"] == {True, False}
    if aug.use_cutout:
        assert branches["choice"] == {0, 1, 2} and branches["do_cut"] == {True, False}
    assert_equal_but_fills(gx, wx, draws.rects.numpy())
    np.testing.assert_array_equal(gdoa, wdoa)
    np.testing.assert_array_equal(gsed, sed)
    np.testing.assert_array_equal(wsed, sed)
    assert not np.array_equal(gx, x)
    if mode == "feature":
        np.testing.assert_array_equal(gdoa, doa)
    else:
        assert not np.array_equal(gdoa, doa)


def test_draws_copy_to_a_device_exactly():
    """The packed single copy carries every integer and uniform unchanged."""
    aug = tda.make_device_augment("salsa_lite", "mic", N_CLASSES, 640, 191)
    d = aug.draw(32, torch.Generator().manual_seed(3))
    e = d.to("cpu")
    for name in ("swap", "offset", "rects", "fill_u"):
        a, b = getattr(d, name), getattr(e, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("ft,fmt", [("salsa", "foa"), ("salsa_lite", "mic"),
                                    ("linspecgcc", "mic")])
def test_port_draws_follow_salsa_tpu_distributions(ft, fmt):
    """The port's own draws at the flagship chunk (640 x 191), 20,000 samples:
    each p = 0.5 branch, the swap's 1/2 x 1/2 flags, the shift's 1-9, the cutout
    choice's thirds within 5 binomial sigmas; every integer in its range."""
    n, Tc, Fc = 20000, 640, 191
    aug = tda.make_device_augment(ft, fmt, N_CLASSES, Tc, Fc)
    d = aug.draw(n, torch.Generator().manual_seed(11))

    def near(count, p, total=n):
        assert abs(count - p * total) <= 5 * np.sqrt(total * p * (1 - p)), (count, p, total)

    swap = d.swap.numpy()
    for j in range(aug.n_flags):
        near(int(swap[:, j].sum()), 0.25)
    off = d.offset.numpy()
    near(int((off != 0).sum()), 0.5)
    near(int((off < 0).sum()), 0.25)
    assert np.abs(off).max() == 9
    for s in range(1, 10):
        near(int((np.abs(off) == s).sum()), 1 / 18)
    rects = d.rects.numpy()
    if not aug.use_cutout:
        assert not rects.any()
        return
    used = (rects[:, :, 1] > 0).sum(1)
    near(int((used > 0).sum()), 0.5)
    kinds = {1: int(((used == 1) & (rects[:, 0, 1] < Tc)).sum()), 2: int((used == 2).sum()),
             8: int((used == 8).sum())}
    for v in kinds.values():
        near(v, 1 / 6)
    top, h, left, w = (rects[..., i] for i in range(4))
    on = h > 0
    assert (top >= 0).all() and (left >= 0).all() and (h <= Tc).all() and (w <= Fc).all()
    assert (top[on] < Tc).all() and (left[on] < Fc).all()
    cut = (used == 1) & (rects[:, 0, 1] < Tc)
    assert (w[cut, 0] <= Fc - 1).all() and (h[cut, 0] <= Tc - 1).all()
    assert (left[cut, 0] < np.maximum(Fc - w[cut, 0], 1)).all()
    assert (top[cut, 0] < np.maximum(Tc - h[cut, 0], 1)).all()
    holes = used == 8
    assert (h[holes] == 8).all() and (top[holes] < Tc - 8).all() and (left[holes] < Fc - 8).all()
    u = d.fill_u.numpy()
    assert (u >= 0).all() and (u < 1).all()


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="'full' or 'feature'"):
        tda.make_device_augment("salsa", "foa", N_CLASSES, T, F, mode="swap")
