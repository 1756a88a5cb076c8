"""Test-time augmentation over the array's spatial symmetries (counterpart of
`salsa_tpu.train.tta`).

Inference runs under every channel-swap symmetry variant; each variant's DOA
predictions are mapped back through the inverse label transform (a signed
permutation of the x/y/z class blocks) and the variants are averaged.

The label matrices are derived empirically from the port's own swap functions
(`train/device_augment.py`, the training augmentation's), so the TTA algebra cannot
drift from the augmentation algebra. The features are transformed on the device by
the same functions, a whole batch at once: every row carries its variant's mask, so
a group of variants folded into the batch dimension is one call
(`transform_group`), where `salsa_tpu` transforms each row through numpy.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from salsa_tpu_torch.train.device_augment import (
    swap_channel_foa,
    swap_channel_gcc,
    swap_channel_mic,
)

# kind -> (swap function, mask bits, feature channels)
_KIND_FNS = {
    "foa": (swap_channel_foa, 4, 7),
    "mic": (swap_channel_mic, 3, 7),
    "gcc": (swap_channel_gcc, 3, 10),
}


def tta_kind(feature_type: str, audio_format: str) -> str:
    """Map a (feature_type, audio_format) stream to its TTA symmetry group."""
    if feature_type.endswith("gcc"):
        return "gcc"
    return audio_format


def tta_fold(n_variants: int, x_shape, budget: float = 2e8) -> int:
    """Variants per eval dispatch: the largest power-of-two divisor of n_variants
    whose folded batch (fold * prod(x_shape) elements) stays under `budget`, at
    least 1. This bounds the CRNN's activation memory at 60 s eval chunks (8 clips
    of (7, 4800, 200) fold 2 at the default budget)."""
    per_variant = float(np.prod(x_shape))
    fold = n_variants
    while fold > 1 and fold * per_variant > float(budget):
        fold //= 2
    return max(1, fold)


class ChannelSwapTTA:
    """Enumerates all symmetry variants for a (feature_type, audio_format) stream.

    kind: 'foa' (tf-map FOA: 16 variants) | 'mic' (tf-map MIC: 8 variants) |
    'gcc' (GCC-lag MIC: 4 variants; its generators are mutually exclusive, so the
    group is {identity, g0, g1, g2}). Variant 0 is the identity.
    """

    def __init__(self, kind: str, n_classes: int, n_input_channels: int | None = None):
        if kind not in _KIND_FNS:
            raise ValueError(f"TTA kind '{kind}' not supported")
        self.kind = kind
        self.n_classes = n_classes
        self.fn, n_bits, self.n_channels = _KIND_FNS[kind]
        if n_input_channels is not None and n_input_channels != self.n_channels:
            # fail at config time, not on the first batch inside predict_split
            raise ValueError(
                f"TTA kind '{kind}' needs {self.n_channels}-channel features, but "
                f"this stream has {n_input_channels} channels — channel-swap TTA "
                "only applies to directional feature types (salsa/iv/gcc)")
        if kind == "gcc":
            self.masks = [np.array(m) for m in ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1))]
        else:
            self.masks = [np.array(m) for m in itertools.product((0, 1), repeat=n_bits)]
        self._mask_table = torch.tensor(np.stack(self.masks), dtype=torch.float32)
        self._label_mats = [self._label_matrix(i) for i in range(len(self.masks))]
        # L^-1 = L^T as (source block, sign) per output block: the inverse map
        # moves and negates blocks, exactly
        self._inverse = []
        for L in self._label_mats:
            inv = L.T
            src = np.abs(inv).argmax(axis=1)
            sign = inv[np.arange(3), src]
            back = np.zeros((3, 3))
            back[np.arange(3), src] = sign
            if not np.array_equal(back, inv) or not set(np.abs(sign)) <= {1.0}:
                raise AssertionError(f"label matrix {L.tolist()} is not a signed permutation")
            self._inverse.append((torch.as_tensor(src), torch.as_tensor(sign, dtype=torch.float32)))

    def _label_matrix(self, idx: int) -> np.ndarray:
        """3x3 signed permutation L with doa_new_blocks = L @ doa_old_blocks,
        measured by pushing unit block vectors through the label transform. Probed
        for two distinct classes (0 and n-1) to verify, not assume, that the swap
        algebra is class-independent."""
        n = self.n_classes
        m = self._mask_table[idx:idx + 1]
        dummy_x = torch.zeros((1, self.n_channels, 2, 2))
        mats = []
        for cls in sorted({0, n - 1}):
            L = np.zeros((3, 3))
            for axis in range(3):
                doa = torch.zeros((1, 1, 3 * n))
                doa[0, 0, axis * n + cls] = 1.0  # class `cls`, unit along `axis`
                _, doa_t = self.fn(dummy_x, doa, m, n)
                for out_axis in range(3):
                    L[out_axis, axis] = float(doa_t[0, 0, out_axis * n + cls])
            mats.append(L)
        if len(mats) == 2 and not np.array_equal(mats[0], mats[1]):
            raise AssertionError(
                f"label transform for mask {self.masks[idx]} is class-dependent — TTA "
                "inverse derivation assumption violated")
        return mats[0]

    def __len__(self):
        return len(self.masks)

    def transform_group(self, x: torch.Tensor, idxs) -> torch.Tensor:
        """x (B, C, T, F) -> (len(idxs) * B, C, T, F): the batch under each variant
        of `idxs`, variant-major, in one call of the swap function."""
        idxs = list(idxs)
        B = x.shape[0]
        m = self._mask_table[idxs].to(x.device).repeat_interleave(B, 0)
        xs = x.repeat(len(idxs), 1, 1, 1)
        doa = torch.zeros((xs.shape[0], 1, 3 * self.n_classes), dtype=x.dtype, device=x.device)
        return self.fn(xs, doa, m, self.n_classes)[0]

    def transform_features(self, x: torch.Tensor, idx: int) -> torch.Tensor:
        """x: (B, C, T, F) batch; returns its transformed copy under variant idx."""
        return self.transform_group(x, [idx])

    def inverse_doa(self, doa: torch.Tensor, idx: int) -> torch.Tensor:
        """Map predictions made in the transformed frame back: apply L^-1 = L^T to
        the (x, y, z) class blocks. doa: (..., 3 * n_classes)."""
        src, sign = self._inverse[idx]
        blocks = doa.unflatten(-1, (3, self.n_classes))
        mapped = blocks[..., src.to(doa.device), :] * sign.to(doa.device, doa.dtype)[:, None]
        return mapped.flatten(-2)
