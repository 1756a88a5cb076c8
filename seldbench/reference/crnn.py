"""The SALSA CRNN in plain float32 PyTorch operations, for the benchmark's
comparison: PANNs' ResNet22 encoder as the SALSA recipe uses it (a stem of two
3x3 conv + BatchNorm + ReLU and a 2x2 average pool, then four stages of two
basic residual blocks, 64 to 512 channels, each stride-2 block pooling before its
convs and projecting its shortcut by a pool, a 1x1 conv and BatchNorm, dropout 0.1
inside each block), the mean over frequency, a 2-layer bidirectional GRU, and the
heads: events FC-ReLU-FC, DOA x, y and z each FC-ReLU-FC-tanh, with dropout 0.2
before each head layer and 0.3 between the GRU layers.

The weights are a dict of tensors under the layer names of the published torch
model (`encoder.resnet.layer2.0.conv1.weight`, `decoder.gru.weight_hh_l0`, ...).
The GRU is written out gate by gate (r, z, n; n = tanh(W_in x + b_in + r (W_hn h +
b_hn))). In training mode BatchNorm normalises by the batch's statistics (biased
variance) and returns its running statistics moved by momentum 0.9, and each
dropout asks `draw(shape)` for its uniform numbers, in the order the layers run.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.9
STAGES = ((1, 64, 1), (2, 128, 2), (3, 256, 2), (4, 512, 2))  # (stage, width, stride)
BLOCK_DROPOUT, RNN_DROPOUT, HEAD_DROPOUT = 0.1, 0.3, 0.2


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

    def dropout(self, x, p):
        if not self.training:
            return x
        keep = self.draw(list(x.shape)) >= p
        return torch.where(keep, x * (1.0 / (1.0 - p)), torch.zeros((), dtype=x.dtype,
                                                                     device=x.device))

    def conv(self, x, name, padding):
        return F.conv2d(x, self.w[f"{name}.weight"], padding=padding)

    def block(self, x, name, stride, project):
        out = F.avg_pool2d(x, 2) if stride == 2 else x
        out = self.dropout(F.relu(self.bn(self.conv(out, f"{name}.conv1", 1), f"{name}.bn1")),
                           BLOCK_DROPOUT)
        out = self.bn(self.conv(out, f"{name}.conv2", 1), f"{name}.bn2")
        if project:
            d = f"{name}.downsample"
            s = F.avg_pool2d(x, 2) if stride == 2 else x
            first = 1 if stride == 2 else 0
            identity = self.bn(self.conv(s, f"{d}.{first}", 0), f"{d}.{first + 1}")
        else:
            identity = x
        return F.relu(out + identity)

    def encoder(self, x):
        e = "encoder.conv_block1"
        x = F.relu(self.bn(self.conv(x, f"{e}.conv1", 1), f"{e}.bn1"))
        x = F.avg_pool2d(F.relu(self.bn(self.conv(x, f"{e}.conv2", 1), f"{e}.bn2")), 2)
        in_width = 64
        for stage, width, stride in STAGES:
            for b in range(2):
                name = f"encoder.resnet.layer{stage}.{b}"
                s = stride if b == 0 else 1
                x = self.block(x, name, s, b == 0 and (s != 1 or in_width != width))
                in_width = width
        return x

    def gru_layer(self, x, layer):
        """(B, T, In) -> (B, T, 2H): both directions of one bidirectional layer."""
        w, outs = self.w, []
        for suffix in ("", "_reverse"):
            g = f"decoder.gru.%s_l{layer}{suffix}"
            seq = x if not suffix else x.flip(1)
            gi = seq @ w[g % "weight_ih"].T + w[g % "bias_ih"]  # (B, T, 3H)
            w_hh, b_hh = w[g % "weight_hh"], w[g % "bias_hh"]
            H = w_hh.shape[1]
            h = torch.zeros(x.shape[0], H, dtype=x.dtype, device=x.device)
            hs = []
            for t in range(seq.shape[1]):
                gh = h @ w_hh.T + b_hh
                r = torch.sigmoid(gi[:, t, :H] + gh[:, :H])
                z = torch.sigmoid(gi[:, t, H:2 * H] + gh[:, H:2 * H])
                n = torch.tanh(gi[:, t, 2 * H:] + r * gh[:, 2 * H:])
                h = (1.0 - z) * n + z * h
                hs.append(h)
            out = torch.stack(hs, dim=1)
            outs.append(out if not suffix else out.flip(1))
        return torch.cat(outs, dim=-1)

    def head(self, x, name):
        w = self.w
        h = F.relu(F.linear(self.dropout(x, HEAD_DROPOUT), w[f"decoder.{name}_fc_1.weight"],
                            w[f"decoder.{name}_fc_1.bias"]))
        return F.linear(self.dropout(h, HEAD_DROPOUT), w[f"decoder.{name}_fc_2.weight"],
                        w[f"decoder.{name}_fc_2.bias"])

    def __call__(self, x):
        """(B, 7, T, F) features -> (event logits (B, T', n), DOA (B, T', 3n)) at
        the encoder's rate T' = T // 16."""
        h = self.encoder(x).mean(dim=3).transpose(1, 2)
        h = self.dropout(self.gru_layer(h, 0), RNN_DROPOUT)
        h = self.gru_layer(h, 1)
        event = self.head(h, "event")
        doa = torch.cat([torch.tanh(self.head(h, a)) for a in ("x", "y", "z")], dim=-1)
        return event, doa


def index_repeat(x: torch.Tensor, ratio: int) -> torch.Tensor:
    """(B, T', ...) -> (B, T' ratio, ...): each frame repeated `ratio` times."""
    return torch.repeat_interleave(x, ratio, dim=1)


@torch.no_grad()
def serve(w: dict[str, torch.Tensor], feats: torch.Tensor, ratio: int):
    """Eval-mode outputs at label rate: (event probabilities, DOA)."""
    event, doa = Forward(w)(feats)
    return torch.sigmoid(index_repeat(event, ratio)), index_repeat(doa, ratio)
