"""Host-side (numpy) data augmentation for SELD spectrogram features (counterpart
of `salsa_tpu.data.transforms`, copied so that the port imports nothing of it).

Feature-only transforms (random cutout, spec-augment stripes, cutout holes,
composite cutout, frequency shift) and the label-coupled channel-swap transforms
that encode the spatial symmetries of the FOA and MIC arrays. On the same
`np.random.Generator` and input every transform draws and returns what
`salsa_tpu`'s does, bit for bit.

All transforms take (n_channels, n_time, n_freq) features; the joint ("map")
transforms also take and return (sed, doa) label arrays at label rate. Each
transform draws from the numpy Generator it owns. `cli.train` runs them on the
host over each train chunk (`data.dataset.SeldChunkDataset`), unless
`training.device_augment` or `training.device_data` is set.
"""
from __future__ import annotations

import numpy as np


class Transform:
    """Base: applies with probability p (always when always_apply)."""

    def __init__(self, always_apply: bool = False, p: float = 0.5, rng=None):
        self.always_apply = always_apply
        self.p = p
        self.rng = rng or np.random.default_rng()

    def __call__(self, x):
        if self.always_apply or self.rng.random() < self.p:
            return self.apply(x)
        return x

    def apply(self, x):
        raise NotImplementedError


class Compose:
    def __init__(self, transforms: list):
        self.transforms = transforms

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


class ComposeJoint:
    def __init__(self, transforms: list):
        self.transforms = transforms

    def __call__(self, x, sed, doa):
        for t in self.transforms:
            x, sed, doa = t(x, sed, doa)
        return x, sed, doa


def _masked_fill(x, t0, t1, f0, f1, value, n_zero_channels, fill_last):
    """Fill x[:, t0:t1, f0:f1] with `value`, except the trailing n_zero_channels
    spatial channels which get 0 (or are left untouched when not fill_last)."""
    if n_zero_channels is None:
        x[:, t0:t1, f0:f1] = value
    else:
        x[:-n_zero_channels, t0:t1, f0:f1] = value
        if fill_last:
            x[-n_zero_channels:, t0:t1, f0:f1] = 0.0
    return x


class RandomCutout(Transform):
    """Cut one random rectangle (area 2-30% of the image, aspect-jittered)."""

    def __init__(self, always_apply=False, p=0.5, image_aspect_ratio: float = 1.0,
                 random_value: float | None = None, n_zero_channels: int | None = None,
                 is_filled_last_channels: bool = True, rng=None):
        super().__init__(always_apply, p, rng)
        self.random_value = random_value
        self.n_zero_channels = n_zero_channels
        self.is_filled_last_channels = is_filled_last_channels
        self.s_range = (0.02, 0.3)
        r1, r2 = 0.3, 1 / 0.3
        if image_aspect_ratio > 1:
            r1 *= image_aspect_ratio
        elif image_aspect_ratio < 1:
            r2 *= image_aspect_ratio
        self.r_range = (r1, r2)

    def apply(self, x):
        img_h, img_w = x.shape[-2], x.shape[-1]  # (time, freq)
        out = x.copy()
        s = self.rng.uniform(*self.s_range) * img_h * img_w
        r = self.rng.uniform(*self.r_range)
        w = min(int(np.sqrt(s / r)), img_w - 1)
        h = min(int(np.sqrt(s * r)), img_h - 1)
        left = self.rng.integers(0, img_w - w)
        top = self.rng.integers(0, img_h - h)
        value = (
            self.rng.uniform(x.min(), x.max())
            if self.random_value is None
            else self.random_value
        )
        if x.ndim == 2:
            out[top : top + h, left : left + w] = value
            return out
        return _masked_fill(out, top, top + h, left, left + w, value,
                            self.n_zero_channels, self.is_filled_last_channels)


class SpecAugment(Transform):
    """Random time/frequency stripes filled with a random constant."""

    def __init__(self, always_apply=False, p=0.5, time_max_width: int | None = None,
                 freq_max_width: int | None = None, n_time_stripes: int = 1,
                 n_freq_stripes: int = 1, n_zero_channels: int | None = None,
                 is_filled_last_channels: bool = True, rng=None):
        super().__init__(always_apply, p, rng)
        self.time_max_width = time_max_width
        self.freq_max_width = freq_max_width
        self.n_time_stripes = n_time_stripes
        self.n_freq_stripes = n_freq_stripes
        self.n_zero_channels = n_zero_channels
        self.is_filled_last_channels = is_filled_last_channels

    def apply(self, x):
        assert x.ndim == 3
        n_frames, n_freqs = x.shape[1], x.shape[2]
        lo, hi = x.min(), x.max()
        t_max = max(1, self.time_max_width or int(0.15 * n_frames))
        f_max = max(1, self.freq_max_width or int(0.2 * n_freqs))
        out = x.copy()
        for _ in range(self.n_time_stripes):
            dur = int(self.rng.integers(1, t_max))
            start = int(self.rng.integers(0, n_frames - dur))
            _masked_fill(out, start, start + dur, 0, n_freqs, self.rng.uniform(lo, hi),
                         self.n_zero_channels, self.is_filled_last_channels)
        for _ in range(self.n_freq_stripes):
            dur = int(self.rng.integers(1, f_max))
            start = int(self.rng.integers(0, n_freqs - dur))
            _masked_fill(out, 0, n_frames, start, start + dur, self.rng.uniform(lo, hi),
                         self.n_zero_channels, self.is_filled_last_channels)
        return out


class RandomCutoutHole(Transform):
    """Cut n small fixed-size holes at random positions."""

    def __init__(self, always_apply=False, p=0.5, n_max_holes: int = 8,
                 max_h_size: int = 8, max_w_size: int = 8,
                 filled_value: float | None = None, n_zero_channels: int | None = None,
                 is_filled_last_channels: bool = True, rng=None):
        super().__init__(always_apply, p, rng)
        self.n_max_holes = n_max_holes
        self.max_h_size = max(max_h_size, 5)
        self.max_w_size = max(max_w_size, 5)
        self.filled_value = filled_value
        self.n_zero_channels = n_zero_channels
        self.is_filled_last_channels = is_filled_last_channels

    def apply(self, x):
        assert x.ndim == 3
        img_h, img_w = x.shape[-2], x.shape[-1]
        lo, hi = x.min(), x.max()
        out = x.copy()
        for _ in range(self.n_max_holes):
            w, h = self.max_w_size, self.max_h_size
            left = int(self.rng.integers(0, img_w - w))
            top = int(self.rng.integers(0, img_h - h))
            value = self.rng.uniform(lo, hi) if self.filled_value is None else self.filled_value
            _masked_fill(out, top, top + h, left, left + w, value,
                         self.n_zero_channels, self.is_filled_last_channels)
        return out


class CompositeCutout(Transform):
    """Randomly pick one of {RandomCutout, SpecAugment, RandomCutoutHole}."""

    def __init__(self, always_apply=False, p=0.5, image_aspect_ratio: float = 1.0,
                 n_zero_channels: int | None = None,
                 is_filled_last_channels: bool = True, rng=None):
        super().__init__(always_apply, p, rng)
        common = dict(always_apply=True, n_zero_channels=n_zero_channels,
                      is_filled_last_channels=is_filled_last_channels, rng=self.rng)
        self.choices = [
            RandomCutout(image_aspect_ratio=image_aspect_ratio, **common),
            SpecAugment(**common),
            RandomCutoutHole(**common),
        ]

    def apply(self, x):
        return self.choices[int(self.rng.integers(0, 3))](x)


class RandomShiftUpDown(Transform):
    """Shift the frequency axis up/down with reflect padding; the trailing
    n_last_channels spatial channels are left untouched when requested."""

    def __init__(self, always_apply=False, p=0.5, freq_shift_range: int | None = None,
                 direction: str | None = None, mode: str = "reflect",
                 n_last_channels: int = 0, rng=None):
        super().__init__(always_apply, p, rng)
        self.freq_shift_range = freq_shift_range
        self.direction = direction
        self.mode = mode
        self.n_last_channels = n_last_channels

    def apply(self, x):
        n_channels, n_time, n_freq = x.shape
        shift_range = self.freq_shift_range or int(n_freq * 0.08)
        shift = int(self.rng.integers(1, shift_range))
        direction = self.direction or ("up" if self.rng.random() < 0.5 else "down")
        out = x.copy()
        target = out if self.n_last_channels == 0 else out[: -self.n_last_channels]
        if direction == "up":
            shifted = np.pad(target, ((0, 0), (0, 0), (shift, 0)), mode=self.mode)[:, :, :n_freq]
        else:
            shifted = np.pad(target, ((0, 0), (0, 0), (0, shift)), mode=self.mode)[:, :, shift:]
        if self.n_last_channels == 0:
            out = shifted
        else:
            out[: -self.n_last_channels] = shifted
        return out


# ---------------------------------------------------------------------------
# Label-coupled channel-swap transforms (spatial symmetry algebra)
# ---------------------------------------------------------------------------

class JointTransform:
    def __init__(self, always_apply: bool = False, p: float = 0.5, n_classes: int = 12,
                 rng=None):
        self.always_apply = always_apply
        self.p = p
        self.n_classes = n_classes
        self.rng = rng or np.random.default_rng()

    def __call__(self, x, sed, doa):
        if self.always_apply or self.rng.random() < self.p:
            return self.apply(x, sed, doa)
        return x, sed, doa

    def apply(self, x, sed, doa):
        raise NotImplementedError

    def _swap_xy_doa(self, doa):
        n = self.n_classes
        out = doa.copy()
        out[:, 0:n] = doa[:, n : 2 * n]
        out[:, n : 2 * n] = doa[:, 0:n]
        return out


def swap_channel_foa(x, sed, doa, m, n_classes):
    """Deterministic FOA symmetry with mask m = (swap_xy, neg_x, neg_y, neg_z).
    Feature layout (7ch): [W, Y, Z, X, IVy, IVz, IVx]."""
    n = n_classes
    xf = x.copy()
    df = doa.copy()
    if m[0]:  # swap X and Y: spec channels 1<->3, spatial channels -3<->-1
        xf[1], xf[3] = x[3], x[1]
        xf[-3], xf[-1] = x[-1], x[-3]
        df[:, 0:n], df[:, n : 2 * n] = doa[:, n : 2 * n], doa[:, 0:n].copy()
    if m[1]:  # negate x
        xf[-1] = -xf[-1]
        df[:, 0:n] = -df[:, 0:n]
    if m[2]:  # negate y
        xf[-3] = -xf[-3]
        df[:, n : 2 * n] = -df[:, n : 2 * n]
    if m[3]:  # negate z
        xf[-2] = -xf[-2]
        df[:, 2 * n :] = -df[:, 2 * n :]
    return xf, sed, df


class SwapChannelFoa(JointTransform):
    """FOA tf-map symmetry: random {swap X<->Y, negate X, negate Y, negate Z}.

    Feature layout (7ch): [W, Y, Z, X, IVy, IVz, IVx]
    (reference transforms.py:394-437; spec channels 1..3 are Y,Z,X and the spatial
    channels -3,-2,-1 are the matching intensity/eigenvector components).
    """

    def apply(self, x, sed, doa):
        assert x.shape[0] == 7, f"FOA tf-map expects 7 channels, got {x.shape[0]}"
        m = self.rng.integers(2, size=4)
        return swap_channel_foa(x, sed, doa, m, self.n_classes)


class SwapChannelMic(JointTransform):
    """MIC tf-map symmetry for the tetrahedral array.

    Feature layout (7ch): [M1, M2, M3, M4, P12, P13, P14] where P1k is the phase
    feature of mic k vs mic 1. Three generators (reference transforms.py:469-523):
      swap M2<->M3            -> swap x/y        P12' = P13, P13' = P12
      swap M1<->M4            -> swap&negate x,y P14' = -P14, P13' = P13-P14, P12' = P12-P14
      swap M1<->M2, M3<->M4   -> negate y,z      P12' = -P12, P13' = P14-P12, P14' = P13-P12
    """

    def apply(self, x, sed, doa):
        assert x.shape[0] == 7, f"MIC tf-map expects 7 channels, got {x.shape[0]}"
        m = self.rng.integers(2, size=3)
        return swap_channel_mic(x, sed, doa, m, self.n_classes)


def swap_channel_mic(x, sed, doa, m, n_classes):
    """Deterministic MIC tf-map symmetry, mask m = (swap_m2m3, swap_m1m4, swap_pairs)."""
    n = n_classes
    xf = x.copy()
    df = doa.copy()
    if m[0]:
        xf[1], xf[2] = x[2], x[1]
        xf[-3], xf[-2] = x[-2], x[-3]
        df[:, 0:n], df[:, n : 2 * n] = doa[:, n : 2 * n], doa[:, 0:n].copy()
    if m[1]:
        cur = xf.copy()
        xf[0], xf[3] = cur[3], cur[0]
        xf[-1] = -cur[-1]
        xf[-2] = cur[-2] - cur[-1]
        xf[-3] = cur[-3] - cur[-1]
        tmp = -df[:, 0:n].copy()
        df[:, 0:n] = -df[:, n : 2 * n]
        df[:, n : 2 * n] = tmp
    if m[2]:
        cur = xf.copy()
        xf[0], xf[1] = cur[1], cur[0]
        xf[2], xf[3] = cur[3], cur[2]
        xf[-3] = -cur[-3]
        xf[-2] = cur[-1] - cur[-3]
        xf[-1] = cur[-2] - cur[-3]
        df[:, n : 2 * n] = -df[:, n : 2 * n]
        df[:, 2 * n :] = -df[:, 2 * n :]
    return xf, sed, df


def swap_channel_gcc(x, sed, doa, m, n_classes):
    """Deterministic MIC GCC symmetry, mask m = (swap_m2m3, swap_m1m4, swap_pairs);
    the generators are mutually exclusive (if/elif — reference semantics), so at
    most one applies, priority m[0] > m[1] > m[2].

    Feature layout (10ch): [M1..M4, xc12, xc13, xc14, xc23, xc24, xc34]; swapping two
    mics permutes the pair channels and mirrors the lag axis of pairs whose order
    flips (reference transforms.py:555-618)."""
    n = n_classes
    xf = x.copy()
    df = doa.copy()
    if m[0]:  # swap M2 <-> M3
        xf[1], xf[2] = x[2], x[1]
        xf[4], xf[5] = x[5], x[4]          # xc12 <-> xc13
        xf[7] = np.flip(x[7], axis=-1)      # xc23 time-reverses
        xf[8], xf[9] = x[9], x[8]          # xc24 <-> xc34
    elif m[1]:  # swap M1 <-> M4
        cur = xf.copy()
        xf[0], xf[3] = cur[3], cur[0]
        xf[4] = np.flip(cur[8], axis=-1)
        xf[5] = np.flip(cur[9], axis=-1)
        xf[6] = np.flip(cur[6], axis=-1)
        xf[8] = np.flip(cur[4], axis=-1)
        xf[9] = np.flip(cur[5], axis=-1)
    elif m[2]:  # swap M1<->M2 and M3<->M4
        cur = xf.copy()
        xf[0], xf[1] = cur[1], cur[0]
        xf[2], xf[3] = cur[3], cur[2]
        xf[4] = np.flip(cur[4], axis=-1)
        xf[5] = cur[8]
        xf[6] = cur[7]
        xf[7] = cur[6]
        xf[8] = cur[5]
        xf[9] = np.flip(cur[9], axis=-1)
    # Deviation from the reference: its feature path applies at most ONE generator
    # (if/elif) while its label path applies every flagged generator (if/if/if),
    # desynchronizing features and labels whenever m has two+ ones
    # (transforms.py:574-614). We keep labels consistent with features.
    if m[0]:
        df[:, 0:n], df[:, n : 2 * n] = doa[:, n : 2 * n], doa[:, 0:n].copy()
    elif m[1]:
        tmp = -df[:, 0:n].copy()
        df[:, 0:n] = -df[:, n : 2 * n]
        df[:, n : 2 * n] = tmp
    elif m[2]:
        df[:, n : 2 * n] = -df[:, n : 2 * n]
        df[:, 2 * n :] = -df[:, 2 * n :]
    return xf, sed, df


class SwapChannelGccMic(JointTransform):
    """MIC GCC symmetry as a random joint transform (see swap_channel_gcc)."""

    def apply(self, x, sed, doa):
        assert x.shape[0] == 10, f"MIC GCC expects 10 channels, got {x.shape[0]}"
        m = self.rng.integers(2, size=3)
        return swap_channel_gcc(x, sed, doa, m, self.n_classes)


def build_train_transforms(
    feature_type: str,
    audio_format: str,
    n_classes: int,
    train_chunk_len: int,
    n_features: int,
    rng=None,
):
    """Per-(format, feature) augmentation wiring, mirroring the reference datamodule
    (dataset/datamodule.py:44-100). Returns (joint_transform, feature_transform)."""
    rng = rng or np.random.default_rng()
    aspect = train_chunk_len / n_features
    if audio_format == "foa":
        joint = ComposeJoint([SwapChannelFoa(n_classes=n_classes, rng=rng)])
        if feature_type == "salsa":
            feat = Compose([RandomShiftUpDown(freq_shift_range=10, rng=rng)])
        else:  # linspeciv / melspeciv
            feat = Compose([
                RandomShiftUpDown(freq_shift_range=10, rng=rng),
                CompositeCutout(image_aspect_ratio=aspect, n_zero_channels=3, rng=rng),
            ])
    elif audio_format == "mic":
        if feature_type in ("salsa", "salsa_lite", "salsa_ipd"):
            joint = ComposeJoint([SwapChannelMic(n_classes=n_classes, rng=rng)])
            feat = Compose([
                RandomShiftUpDown(freq_shift_range=10, rng=rng),
                CompositeCutout(image_aspect_ratio=aspect, n_zero_channels=3, rng=rng),
            ])
        else:  # linspecgcc / melspecgcc
            joint = ComposeJoint([SwapChannelGccMic(n_classes=n_classes, rng=rng)])
            feat = Compose([
                RandomShiftUpDown(freq_shift_range=10, n_last_channels=6, rng=rng),
                CompositeCutout(image_aspect_ratio=aspect, n_zero_channels=6, rng=rng),
            ])
    else:
        raise ValueError(f"unknown audio format '{audio_format}'")
    return joint, feat
