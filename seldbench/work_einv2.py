"""EINV2's operations counted from its shapes (arXiv:2010.13092, as
`seldbench/reference/einv2.py` computes it), whatever kernels run it.

Convolutions: 2 Cin Cout k^2 an output cell, the two 3x3 convs of each of the
four double-conv blocks of both branches at the block's input resolution (the
pools come after the convs): (T, F), (T/2, F/2), (T/4, F/4), (T/4, F/8).
Attention: the scores q k^T and their product with v, 2 T'^2 d each, a layer
of a stack. Linear: each layer's q/k/v and output projections (2 T' d 4d), its
feed-forward (2 T' d ff 2) and the per-track heads (2 T' d (n_classes + 3)).
BatchNorm, pooling, the cross-stitch units, LayerNorm, softmax and the
activations are left out. At one request of 4 x 60 s FOA clips, (4, 7, 4801,
200), it is 4.40 TFLOP: convolutions 4.01, attention 0.14, linear 0.24.
"""
from __future__ import annotations

from seldbench.work import conv_flops

WIDTHS = (64, 128, 256, 512)
POOLS = ((2, 2), (2, 2), (1, 2), (1, 2))  # (time, freq) of each block's pool


def einv2_flops(batch: int, frames: int, freqs: int, n_in: int = 7, n_sed_in: int = 4,
                n_classes: int = 12, n_tracks: int = 3, n_layers: int = 2, d_model: int = 512,
                dim_feedforward: int = 1024) -> dict[str, float]:
    """Operations of one eval forward pass of EINV2 on (batch, n_in, frames,
    freqs), by part: conv, attention, linear, and their total."""
    conv = 0.0
    for branch_in in (n_sed_in, n_in):
        t, f, c_in = frames, freqs, branch_in
        for width, (pt, pf) in zip(WIDTHS, POOLS):
            conv += conv_flops(c_in, width, 3, t * f) + conv_flops(width, width, 3, t * f)
            t, f, c_in = t // pt, f // pf, width
    stacks = 2 * n_tracks * n_layers  # layers over both branches' track stacks
    attention = stacks * 2 * (2.0 * t * t * d_model)
    linear = stacks * (2.0 * t * d_model * 4 * d_model + 2 * 2.0 * t * d_model * dim_feedforward)
    linear += n_tracks * 2.0 * t * d_model * (n_classes + 3)
    parts = {"conv": conv * batch, "attention": attention * batch, "linear": linear * batch}
    parts["total"] = sum(parts.values())
    return parts
