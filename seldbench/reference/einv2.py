"""EINV2 (Cao, Iqbal, Kong, An, Wang, Plumbley, ICASSP 2021, arXiv:2010.13092) in
plain float32 PyTorch operations, for the benchmark's comparison and the port's
tests: two CNN branches, the SED branch on the first 4 feature channels and the
DOA branch on all 7, each four double-conv blocks (two rounds of 3x3 conv without
bias, BatchNorm, ReLU, then an average pool of (2,2), (2,2), (1,2), (1,2) over
(time, freq)), 64 / 128 / 256 / 512 wide; after each of the first three blocks a
cross-stitch unit with a (C, 2, 2) parameter alpha, sed' = alpha[:,0,0] sed +
alpha[:,0,1] doa and doa' = alpha[:,1,0] sed + alpha[:,1,1] doa from the unit's
inputs; each branch's mean over frequency; per track (3) and branch a stack of
two post-LN transformer encoder layers (d_model 512, 8 heads, ReLU feed-forward
1024, dropout 0.2 on the attention weights, after the attention, after the ReLU
and after the feed-forward, LayerNorm eps 1e-5, no positional encoding); per
track the heads: SED Linear(512, n_classes) logits, DOA Linear(512, 3) -> tanh.
Training takes the frame-level permutation-invariant loss (tPIT, `tpit`).

The weights are a dict of tensors under the port's state-dict names
(`encoder.sed_blocks.0.conv1.weight`, `encoder.stitch.0.alpha`,
`decoder.sed_stacks.0.layers.1.self_attn.in_proj_weight`,
`decoder.doa_heads.2.bias`, ...). In training mode BatchNorm normalises by the
batch's statistics (biased variance) and returns its running statistics moved by
momentum 0.9, and each dropout asks `draw(shape)` for its uniform numbers, in the
order the layers run: the SED stacks of tracks 0, 1, 2, then the DOA stacks, and
in each layer the attention weights, after the attention, after the ReLU, after
the feed-forward.

Departures from the published description, each the port's:
* The attention-weight dropout draws one (T, T) mask shared by the batch and the
  heads (flax's broadcast dropout, `models.layers.SelfAttention`); torch's
  nn.MultiheadAttention draws one per element. The queries are scaled by
  1/sqrt(head_dim) before the product.
* tPIT's DOA term is the squared error averaged over the tracks and xyz, each
  track's masked by its permuted target track's activity (any class active), and
  SED's BCE averaged over tracks and classes; the loss weights are the
  configuration's (the paper's are not in the repository).
* The paper's later cross-stitch units inside the transformer stacks are not in
  this model: the branches meet only after the first three conv blocks.
* The output comes to label rate by keeping every second frame (`decimate`):
  the encoder's 20 frames a second against 10 labels a second.
"""
from __future__ import annotations

import itertools
import math
from typing import Callable

import torch
import torch.nn.functional as F

BN_EPS, LN_EPS = 1e-5, 1e-5
BN_MOMENTUM = 0.9
POOLS = ((2, 2), (2, 2), (1, 2), (1, 2))  # (time, freq)
N_SED_CHANNELS, N_TRACKS, N_LAYERS, N_HEADS = 4, 3, 2, 8
DROPOUT = 0.2


class Forward:
    """One forward pass over the weights `w`: eval mode with `draw` None, else
    training mode; `stats` collects the moved running statistics."""

    def __init__(self, w: dict[str, torch.Tensor], draw: Callable | None = None):
        self.w, self.draw, self.stats = w, draw, {}

    @property
    def training(self) -> bool:
        return self.draw is not None

    def bn(self, x, name):
        w = self.w
        if not self.training:
            mean, var = w[f"{name}.running_mean"], w[f"{name}.running_var"]
        else:
            mean = x.mean(dim=(0, 2, 3))
            var = ((x - mean[:, None, None]) ** 2).mean(dim=(0, 2, 3))
            m = BN_MOMENTUM
            self.stats[f"{name}.running_mean"] = (m * w[f"{name}.running_mean"]
                                                  + (1 - m) * mean.detach())
            self.stats[f"{name}.running_var"] = (m * w[f"{name}.running_var"]
                                                 + (1 - m) * var.detach())
        inv = torch.rsqrt(var + BN_EPS)
        return ((x - mean[:, None, None]) * (inv * w[f"{name}.weight"])[:, None, None]
                + w[f"{name}.bias"][:, None, None])

    def dropout(self, x, shape=None):
        """Inverted dropout of x with a keep mask of `shape` (x's by default),
        broadcast over x."""
        if not self.training:
            return x
        keep = self.draw(list(x.shape) if shape is None else shape) >= DROPOUT
        return torch.where(keep, x * (1.0 / (1.0 - DROPOUT)),
                           torch.zeros((), dtype=x.dtype, device=x.device))

    def block(self, x, name, pool):
        for i in (1, 2):
            x = F.conv2d(x, self.w[f"{name}.conv{i}.weight"], padding=1)
            x = F.relu(self.bn(x, f"{name}.bn{i}"))
        return F.avg_pool2d(x, pool)

    def encoder(self, x):
        sed, doa = x[:, :N_SED_CHANNELS], x
        for i, pool in enumerate(POOLS):
            sed = self.block(sed, f"encoder.sed_blocks.{i}", pool)
            doa = self.block(doa, f"encoder.doa_blocks.{i}", pool)
            if i < len(POOLS) - 1:
                a = self.w[f"encoder.stitch.{i}.alpha"][:, :, :, None, None]
                sed, doa = a[:, 0, 0] * sed + a[:, 0, 1] * doa, a[:, 1, 0] * sed + a[:, 1, 1] * doa
        return sed, doa

    def attention(self, x, name):
        """(B, T, d) -> (B, T, d), multi-head self-attention."""
        w, (B, T, d) = self.w, x.shape
        qkv = x @ w[f"{name}.in_proj_weight"].T + w[f"{name}.in_proj_bias"]
        q, k, v = (t.reshape(B, T, N_HEADS, d // N_HEADS).transpose(1, 2)
                   for t in qkv.split(d, dim=-1))
        scores = (q / math.sqrt(d // N_HEADS)) @ k.transpose(-1, -2)
        weights = self.dropout(torch.softmax(scores, dim=-1), [1, 1, T, T])
        out = (weights @ v).transpose(1, 2).reshape(B, T, d)
        return out @ w[f"{name}.out_proj.weight"].T + w[f"{name}.out_proj.bias"]

    def layer(self, x, name):
        w = self.w

        def norm(y, n):
            return F.layer_norm(y, y.shape[-1:], w[f"{name}.{n}.weight"], w[f"{name}.{n}.bias"],
                                eps=LN_EPS)

        x = norm(x + self.dropout(self.attention(x, f"{name}.self_attn")), "norm1")
        h = F.relu(x @ w[f"{name}.linear1.weight"].T + w[f"{name}.linear1.bias"])
        h = self.dropout(h) @ w[f"{name}.linear2.weight"].T + w[f"{name}.linear2.bias"]
        return norm(x + self.dropout(h), "norm2")

    def track(self, x, branch, k):
        for i in range(N_LAYERS):
            x = self.layer(x, f"decoder.{branch}_stacks.{k}.layers.{i}")
        head = f"decoder.{branch}_heads.{k}"
        return x @ self.w[f"{head}.weight"].T + self.w[f"{head}.bias"]

    def __call__(self, x):
        """(B, 7, T, F) features -> (event logits (B, T', 3, n), DOA (B, T', 3, 3))
        at the encoder's rate T' = T // 4."""
        sed, doa = (m.mean(dim=3).transpose(1, 2) for m in self.encoder(x))
        event = torch.stack([self.track(sed, "sed", k) for k in range(N_TRACKS)], dim=2)
        xyz = torch.stack([torch.tanh(self.track(doa, "doa", k)) for k in range(N_TRACKS)], dim=2)
        return event, xyz


def tpit(event_logit, doa, sed_gt, doa_gt, loss_weight=(0.5, 0.5)):
    """Frame-level permutation-invariant loss: (total, sed, doa). Inputs (B, T,
    K, n) logits and targets, (B, T, K, 3) DOA and targets; for each frame the
    least over the K! assignments of target tracks to output tracks of w_sed BCE
    + w_doa masked MSE, then the mean over frames; sed and doa are that
    assignment's terms, averaged likewise."""
    K = event_logit.shape[2]
    active = (sed_gt.sum(dim=-1) > 0).to(doa.dtype)  # (B, T, K)
    sed_all, doa_all = [], []
    for perm in itertools.permutations(range(K)):
        sed_k = [F.binary_cross_entropy_with_logits(event_logit[:, :, k], sed_gt[:, :, j],
                                                    reduction="none").mean(dim=-1)
                 for k, j in enumerate(perm)]
        doa_k = [((doa[:, :, k] - doa_gt[:, :, j]) ** 2).mean(dim=-1) * active[:, :, j]
                 for k, j in enumerate(perm)]
        sed_all.append(torch.stack(sed_k).mean(dim=0))
        doa_all.append(torch.stack(doa_k).mean(dim=0))
    sed_all, doa_all = torch.stack(sed_all), torch.stack(doa_all)  # (K!, B, T)
    best = torch.min(loss_weight[0] * sed_all + loss_weight[1] * doa_all, dim=0).indices
    sed_l = sed_all.gather(0, best[None])[0].mean()
    doa_l = doa_all.gather(0, best[None])[0].mean()
    return loss_weight[0] * sed_l + loss_weight[1] * doa_l, sed_l, doa_l


def decimate(x: torch.Tensor, stride: int) -> torch.Tensor:
    """(B, T', ...) -> every `stride`-th frame from the first."""
    return x[:, ::stride]


@torch.no_grad()
def serve(w: dict[str, torch.Tensor], feats: torch.Tensor, stride: int = 2):
    """Eval-mode outputs at label rate: (event probabilities (B, T, 3, n), DOA
    (B, T, 3, 3))."""
    event, doa = Forward(w)(feats)
    return torch.sigmoid(decimate(event, stride)), decimate(doa, stride)
