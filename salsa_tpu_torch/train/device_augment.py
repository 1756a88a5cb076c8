"""In-step data augmentation (counterpart of `salsa_tpu.train.device_augment`).

The wiring of `salsa_tpu`'s `make_device_augment`: per sample, a label-coupled
channel swap (the FOA, MIC or GCC symmetry), a reflect-padded frequency shift and,
except on FOA SALSA, one of random cutout, SpecAugment or 8 cutout holes; each
stage applies with p = 0.5. Each transform is split in two:

- a **draw** on a CPU `torch.Generator` (`DeviceAugment.draw`): the swap flags,
  the shift, which cutout, and the rectangles' integers, which depend only on the
  chunk's shape (T, F) and the earlier draws; each fill value is drawn as a unit
  uniform u. A batch's draws are a few hundred numbers that go to the device in
  one copy (`AugmentDraws.to`), so the card and the CPU apply the same draws;
- an **apply** (`DeviceAugment.apply`): tensor code batched over B with
  per-sample parameters, no loop over samples. The fill value is the one draw
  that depends on x: max(lo, u * (hi - lo) + lo), with lo and hi the sample's min
  and max after the swap and the shift, which is how `jax.random.uniform` applies
  its minval and maxval.

The deterministic cores keep `salsa_tpu`'s order of operations, so on the same
draws they are bit-equal to its `*_dev` functions. The MIC generators apply one
after another: folded into one 7x7 channel-mixing product, g1 then g2 would give
-x4 where the sequence computes -x6 - (x4 - x6), which rounds differently.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

MAX_SHIFT = 10  # the frequency shift's reflect pad; shifts are drawn from [1, MAX_SHIFT)
N_HOLES, HOLE_SIZE = 8, 8  # cutout_holes
N_RECTS = N_HOLES  # rectangles a sample carries: 1 cutout, 2 SpecAugment bands or 8 holes
TFMAP_TYPES = ("salsa", "salsa_lite", "salsa_ipd", "linspeciv", "melspeciv")


def _where(flag: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a where the sample's flag (B,) is set, else b."""
    return torch.where(flag.view(-1, *([1] * (a.dim() - 1))), a, b)


def _doa_blocks(doa: torch.Tensor, src: torch.Tensor, sign: torch.Tensor,
                n_classes: int) -> torch.Tensor:
    """doa (B, T, 3n) with its x, y, z blocks re-laid per sample: block k of the
    output is sign[:, k] times block src[:, k] of the input (src, sign (B, 3))."""
    B, T, _ = doa.shape
    blocks = doa.reshape(B, T, 3, n_classes)
    moved = torch.gather(blocks, 2, src[:, None, :, None].expand(B, T, 3, n_classes))
    return (moved * sign[:, None, :, None]).reshape(B, T, 3 * n_classes)


def _table(rows, like: torch.Tensor, dtype=torch.int64) -> torch.Tensor:
    return torch.tensor(rows, dtype=dtype, device=like.device)


# ---------------------------------------------------------------------------
# label-coupled channel swaps (deterministic cores)
# ---------------------------------------------------------------------------

def swap_channel_foa(x: torch.Tensor, doa: torch.Tensor, m: torch.Tensor, n_classes: int):
    """x (B, 7, T, F), doa (B, T, 3n), m (B, 4) {0, 1} flags (swap_xy, neg_x, neg_y,
    neg_z): channels 1 <-> 3 and 4 <-> 6 and the DOA's x and y swapped, then the
    spatial channels 6, 4, 5 and the DOA's x, y, z blocks times 1 - 2 m."""
    swap = m[:, 0] > 0
    x = _where(swap, x[:, [0, 3, 2, 1, 6, 5, 4]], x)
    s = 1.0 - 2.0 * m[:, 1:]  # (B, 3): sx, sy, sz
    one = torch.ones_like(s[:, :1])
    x = x * torch.cat([one, one, one, one, s[:, 1:2], s[:, 2:3], s[:, :1]], 1)[:, :, None, None]
    src = torch.where(swap[:, None], _table([1, 0, 2], x), _table([0, 1, 2], x))
    return x, _doa_blocks(doa, src, s, n_classes)


def _mic_g0(x):
    return x[:, [0, 2, 1, 3, 5, 4, 6]]


def _mic_g1(x):
    return torch.stack([x[:, 3], x[:, 1], x[:, 2], x[:, 0],
                        x[:, 4] - x[:, 6], x[:, 5] - x[:, 6], -x[:, 6]], 1)


def _mic_g2(x):
    return torch.stack([x[:, 1], x[:, 0], x[:, 3], x[:, 2],
                        -x[:, 4], x[:, 6] - x[:, 4], x[:, 5] - x[:, 4]], 1)


# per generator: the feature map and the DOA blocks' (source, sign)
_MIC_GENERATORS = ((_mic_g0, (1, 0, 2), (1.0, 1.0, 1.0)),
                   (_mic_g1, (1, 0, 2), (-1.0, -1.0, 1.0)),
                   (_mic_g2, (0, 1, 2), (1.0, -1.0, -1.0)))


def swap_channel_mic(x: torch.Tensor, doa: torch.Tensor, m: torch.Tensor, n_classes: int):
    """x (B, 7, T, F), doa (B, T, 3n), m (B, 3) {0, 1} flags: the MIC tf-map
    generators g0, g1, g2 applied in sequence where their flag is set."""
    B = x.shape[0]
    for k, (g, src, sign) in enumerate(_MIC_GENERATORS):
        on = m[:, k] > 0
        x = _where(on, g(x), x)
        moved = _doa_blocks(doa, _table(src, x).expand(B, 3),
                            _table(sign, x, doa.dtype).expand(B, 3), n_classes)
        doa = _where(on, moved, doa)
    return x, doa


# per generator (the last is the identity): the output channels' sources, the
# output channels flipped along F, and the DOA blocks' (source, sign)
_GCC_PERM = ((0, 2, 1, 3, 5, 4, 6, 7, 9, 8), (3, 1, 2, 0, 8, 9, 6, 7, 4, 5),
             (1, 0, 3, 2, 4, 8, 7, 6, 5, 9), tuple(range(10)))
_GCC_FLIP = ((7,), (4, 5, 6, 8, 9), (4, 9), ())
_GCC_DOA = (((1, 0, 2), (1.0, 1.0, 1.0)), ((1, 0, 2), (-1.0, -1.0, 1.0)),
            ((0, 1, 2), (1.0, -1.0, -1.0)), ((0, 1, 2), (1.0, 1.0, 1.0)))


def swap_channel_gcc(x: torch.Tensor, doa: torch.Tensor, m: torch.Tensor, n_classes: int):
    """x (B, 10, T, F) (M1..M4, xc12..xc34), doa (B, T, 3n), m (B, 3) {0, 1} flags:
    at most one generator applies, the first whose flag is set (g0 swaps M2 and
    M3, g1 M1 and M4, g2 M1 with M2 and M3 with M4)."""
    on = m > 0
    g = torch.where(on[:, 0], 0, torch.where(on[:, 1], 1, torch.where(on[:, 2], 2, 3)))
    perm = _table(_GCC_PERM, x)[g]
    flip = _table([[c in f for c in range(10)] for f in _GCC_FLIP], x, torch.bool)[g]
    moved = torch.gather(x, 1, perm[:, :, None, None].expand_as(x))
    x = torch.where(flip[:, :, None, None], moved.flip(-1), moved)
    src = _table([s for s, _ in _GCC_DOA], x)[g]
    sign = _table([s for _, s in _GCC_DOA], x, doa.dtype)[g]
    return x, _doa_blocks(doa, src, sign, n_classes)


# ---------------------------------------------------------------------------
# feature-only transforms (deterministic cores)
# ---------------------------------------------------------------------------

def freq_shift(x: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """x (B, C, T, F) shifted along F by a per-sample offset (B,) int64 with
    |offset| < F - 1: out[..., f] = x[..., f + offset] with the index reflected at
    both edges (edge not repeated), as `jnp.pad(mode="reflect")` then a slice. A
    shift up by s is offset -s, down +s; 0 leaves the sample as it is."""
    F = x.shape[-1]
    src = torch.arange(F, device=x.device) + offset[:, None]
    src = torch.where(src < 0, -src, src)
    src = torch.where(src > F - 1, 2 * (F - 1) - src, src)
    return torch.gather(x, -1, src[:, None, None, :].expand_as(x))


def fill_rects(x: torch.Tensor, rects: torch.Tensor, fill_u: torch.Tensor,
               n_zero_channels: int) -> torch.Tensor:
    """Fill rectangles of x (B, C, T, F) in order, later ones over earlier ones:
    rects (B, K, 4) int64 rows (top, height, left, width) over (T, F), height 0
    for none; fill_u (B, K) unit uniforms. Inside rectangle k the leading
    channels take max(lo, u_k * (hi - lo) + lo), with lo and hi the sample's min
    and max before any fill, and the trailing `n_zero_channels` take 0."""
    B, C, T, F = x.shape
    t = torch.arange(T, device=x.device)[None, :, None]
    f = torch.arange(F, device=x.device)[None, None, :]
    last = torch.full((B, T, F), -1, dtype=torch.int8, device=x.device)
    for k in range(rects.shape[1]):
        top, h, left, w = (rects[:, k, i, None, None] for i in range(4))
        inside = (t >= top) & (t < top + h) & (f >= left) & (f < left + w)
        last = torch.where(inside, k, last)
    lo, hi = x.amin(dim=(1, 2, 3))[:, None], x.amax(dim=(1, 2, 3))[:, None]
    value = torch.maximum(lo, fill_u * (hi - lo) + lo)  # (B, K)
    cell = torch.gather(value, 1, last.clamp(min=0).long().view(B, -1)).view(B, 1, T, F)
    lead = (torch.arange(C, device=x.device) < C - n_zero_channels)[None, :, None, None]
    filled = torch.where(lead, cell, torch.zeros((), dtype=x.dtype, device=x.device))
    return torch.where((last >= 0)[:, None], filled, x)


# ---------------------------------------------------------------------------
# the draws and the assembled batch augmentation
# ---------------------------------------------------------------------------

@dataclass
class AugmentDraws:
    """One batch's draws: `swap` (B, n_flags) float32 {0, 1} flags, zero where the
    swap does not apply (and in mode 'feature'); `offset` (B,) int64, the shift
    (0 where it does not apply); `rects` (B, K, 4) int64 (top, height, left,
    width), height 0 for none; `fill_u` (B, K) float32 unit uniforms."""
    swap: torch.Tensor
    offset: torch.Tensor
    rects: torch.Tensor
    fill_u: torch.Tensor

    def rows(self, sl: slice) -> "AugmentDraws":
        """The draws of the samples `sl` (a rank's rows of a global batch's draws)."""
        return AugmentDraws(self.swap[sl], self.offset[sl], self.rects[sl], self.fill_u[sl])

    def to(self, device: torch.device | str) -> "AugmentDraws":
        """The draws on `device`, in one host -> device copy (every integer is far
        below 2^24, so a float32 carries it exactly)."""
        B = self.offset.shape[0]
        packed = torch.cat([self.swap, self.offset[:, None].float(),
                            self.rects.reshape(B, -1).float(), self.fill_u], 1).to(device)
        n_swap, n_rect = self.swap.shape[1], self.rects.shape[1]
        swap, offset, rects, fill_u = packed.split([n_swap, 1, 4 * n_rect, n_rect], 1)
        return AugmentDraws(swap, offset[:, 0].long(), rects.long().view(B, n_rect, 4), fill_u)


def _bernoulli(g: torch.Generator, *shape) -> torch.Tensor:
    return torch.rand(shape, generator=g, dtype=torch.float64) < 0.5


def _randint(g: torch.Generator, lo, hi, n: int) -> torch.Tensor:
    """n integers, each uniform in [lo, hi) (hi a scalar or a per-sample (n,)
    tensor above lo)."""
    u = torch.rand(n, generator=g, dtype=torch.float64)
    return (lo + torch.floor(u * (torch.as_tensor(hi, dtype=torch.float64) - lo))).long()


class DeviceAugment:
    """`salsa_tpu`'s per-sample augmentation for chunks (B, C, T, F) of one feature
    type: `draw` on a CPU generator, `apply` on the tensors' device, or both in
    `__call__`. `sed` never changes; `doa` only with the label-coupled swaps."""

    def __init__(self, feature_type: str, audio_format: str, n_classes: int,
                 train_chunk_len: int, n_features: int, mode: str = "full"):
        if mode not in ("full", "feature"):
            raise ValueError(f"device_augment mode must be 'full' or 'feature', got {mode!r}")
        self.mode = mode
        self.n_classes = n_classes
        self.T, self.F = int(train_chunk_len), int(n_features)
        self.aspect = train_chunk_len / n_features
        tfmap = feature_type in TFMAP_TYPES
        self.use_cutout = not (feature_type == "salsa" and audio_format == "foa")
        self.n_zero = 3 if tfmap else 6
        self.shift_last = 0 if tfmap else 6  # the GCC channels keep their lags
        if tfmap and audio_format == "foa":
            self.swap_fn, self.n_flags = swap_channel_foa, 4
        elif tfmap:
            self.swap_fn, self.n_flags = swap_channel_mic, 3
        else:
            self.swap_fn, self.n_flags = swap_channel_gcc, 3

    def draw(self, batch_size: int, generator: torch.Generator) -> AugmentDraws:
        """A batch's draws on the CPU generator `generator`. Every branch's numbers
        are drawn for every sample, so the count drawn is fixed by the batch size."""
        B, T, F, g = batch_size, self.T, self.F, generator
        flags = _bernoulli(g, B, self.n_flags) & _bernoulli(g, B, 1)
        swap = (flags if self.mode == "full" else torch.zeros_like(flags)).float()
        shift = _randint(g, 1, MAX_SHIFT, B)
        up, do_shift = _bernoulli(g, B), _bernoulli(g, B)
        offset = torch.where(do_shift, torch.where(up, -shift, shift), 0)
        rects = torch.zeros((B, N_RECTS, 4), dtype=torch.int64)
        fill_u = torch.rand((B, N_RECTS), generator=g, dtype=torch.float32)
        if self.use_cutout:
            choice, do_cut = _randint(g, 0, 3, B), _bernoulli(g, B)
            cut = torch.stack([self._cutout(g, B), self._spec_augment(g, B),
                               self._holes(g, B)], 1)
            rects = cut[torch.arange(B), choice] * do_cut[:, None, None]
        return AugmentDraws(swap, offset, rects, fill_u)

    def _cutout(self, g, B) -> torch.Tensor:
        """random_cutout's one rectangle: area s in [0.02, 0.3) of T x F and aspect
        r, in float32 as salsa_tpu computes them."""
        T, F = self.T, self.F
        r1, r2 = 0.3, 1 / 0.3
        if self.aspect > 1:
            r1 *= self.aspect
        elif self.aspect < 1:
            r2 *= self.aspect
        f32 = torch.float32
        s = (torch.rand(B, generator=g, dtype=f32) * (torch.tensor(0.3, dtype=f32) - 0.02)
             + 0.02) * T * F
        r = (torch.rand(B, generator=g, dtype=f32) * (torch.tensor(r2, dtype=f32) - r1) + r1)
        w = torch.clamp(torch.sqrt(s / r).long(), max=F - 1)
        h = torch.clamp(torch.sqrt(s * r).long(), max=T - 1)
        left = _randint(g, 0, torch.clamp(F - w, min=1), B)
        top = _randint(g, 0, torch.clamp(T - h, min=1), B)
        rect = torch.stack([top, h, left, w], 1)
        return torch.cat([rect[:, None], torch.zeros((B, N_RECTS - 1, 4), dtype=torch.int64)], 1)

    def _spec_augment(self, g, B) -> torch.Tensor:
        """SpecAugment's time band, then its frequency band."""
        T, F = self.T, self.F
        t_max, f_max = max(1, int(0.15 * T)), max(1, int(0.2 * F))
        dur_t = _randint(g, 1, max(t_max, 2), B)
        start_t = _randint(g, 0, torch.clamp(T - dur_t, min=1), B)
        dur_f = _randint(g, 1, max(f_max, 2), B)
        start_f = _randint(g, 0, torch.clamp(F - dur_f, min=1), B)
        zero, full_t, full_f = (torch.full((B,), v, dtype=torch.int64) for v in (0, T, F))
        bands = torch.stack([torch.stack([start_t, dur_t, zero, full_f], 1),
                             torch.stack([zero, full_t, start_f, dur_f], 1)], 1)
        return torch.cat([bands, torch.zeros((B, N_RECTS - 2, 4), dtype=torch.int64)], 1)

    def _holes(self, g, B) -> torch.Tensor:
        """cutout_holes' N_HOLES squares of HOLE_SIZE."""
        left = _randint(g, 0, max(self.F - HOLE_SIZE, 1), B * N_HOLES).view(B, N_HOLES)
        top = _randint(g, 0, max(self.T - HOLE_SIZE, 1), B * N_HOLES).view(B, N_HOLES)
        size = torch.full_like(top, HOLE_SIZE)
        return torch.stack([top, size, left, size], 2)

    def apply(self, draws: AugmentDraws, x: torch.Tensor, sed: torch.Tensor,
              doa: torch.Tensor):
        """(x, sed, doa) of a batch augmented by `draws` (on x's device): the
        swap (mode 'full'), the shift (the GCC types' last 6 channels not
        shifted), the cutout family (not on FOA SALSA)."""
        if self.mode == "full":
            x, doa = self.swap_fn(x, doa, draws.swap, self.n_classes)
        if self.shift_last:
            x = torch.cat([freq_shift(x[:, :-self.shift_last], draws.offset),
                           x[:, -self.shift_last:]], 1)
        else:
            x = freq_shift(x, draws.offset)
        if self.use_cutout:
            x = fill_rects(x, draws.rects, draws.fill_u, self.n_zero)
        return x, sed, doa

    def __call__(self, generator: torch.Generator, x: torch.Tensor, sed: torch.Tensor,
                 doa: torch.Tensor):
        """Draw on the CPU generator, copy the draws to x's device, apply."""
        return self.apply(self.draw(x.shape[0], generator).to(x.device), x, sed, doa)


def make_device_augment(feature_type: str, audio_format: str, n_classes: int,
                        train_chunk_len: int, n_features: int,
                        mode: str = "full") -> DeviceAugment:
    """The augmentation of `training.device_augment`: mode 'full' (the label-coupled
    channel swaps and the feature-only transforms) or 'feature' (the frequency
    shift and the cutout family only); any other mode raises ValueError."""
    return DeviceAugment(feature_type, audio_format, n_classes, train_chunk_len, n_features,
                         mode)
