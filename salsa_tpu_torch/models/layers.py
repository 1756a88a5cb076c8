"""Conv blocks, ResNet blocks, the positional table and the transformer layer
(counterpart of `salsa_tpu.models.layers`), NCHW.

Module attribute names are the reference's torch names (`conv1`, `bn1`, ...,
`downsample`, `layer1`..., `self_attn.in_proj_weight`, `norm1`, ...), which are
the keys `interop.flax_to_torch_state_dict` emits (as
`salsa_tpu.interop.torch_export` does), so flax weights load with strict=True.
The flax `ConvBnRelu` submodule therefore has no module of its own here: the
reference flattens it into `convN`/`bnN` pairs, applied by `conv_bn_relu`.

Reference quirks kept: pre-conv 2x2 average pool in stride-2 blocks, dropout 0.1
inside every residual block, avgpool + 1x1 conv + BN shortcut.

Training mode follows flax, not torch: `BatchNorm2d` moves its running statistics
as flax's BatchNorm(momentum=0.9, epsilon=1e-5) does, with the biased batch
variance mean(x^2) - mean(x)^2 in float32 (torch's own update takes the unbiased
one), and `Dropout` draws its keep mask from an explicit torch.Generator
(`generator`, set by the trainer; torch's default generator when unset).

Across ranks (a `torch.distributed` group of more than one process, each rank
holding its rows of one global batch) both keep `salsa_tpu`'s one-global-batch
semantics: `BatchNorm2d` normalizes by the statistics of the global batch, its
sums (sum x, sum x^2, count) all-reduced, and its backward all-reduces its two
sums (`_CrossRankBatchNorm`); `Dropout` draws the global batch's mask from the
step's generator and keeps the rank's rows. With one rank neither changes.

The compute dtype (`compute_dtype`, flax's per-module `dtype`) is flax's per-op
arithmetic, not autocast: `Conv2d` and `Linear` cast their input and weights to
it (float32 sums, results in it), `BatchNorm2d` normalizes a bfloat16 input in
float32 with float32 statistics and parameters and rounds the result back to
bfloat16, and relu, pooling (the average's window summed one rounded add at a
time, as XLA sums it), residual adds and dropout run in the input's dtype.
Parameters stay float32. With no compute dtype every op is the float32 one.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from salsa_tpu_torch.parallel import distributed
from salsa_tpu_torch.utils.profiling import span

COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def resolve_dtype(compute_dtype: str | None) -> torch.dtype | None:
    """A config's compute_dtype as a torch dtype, None for float32 throughout
    (no compute_dtype or 'float32'); ValueError on a name the port does not run."""
    if compute_dtype is None:
        return None
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"unknown compute_dtype '{compute_dtype}': the port runs "
                         f"{sorted(COMPUTE_DTYPES)} or none")
    return COMPUTE_DTYPES[compute_dtype]


class Conv2d(nn.Conv2d):
    """nn.Conv2d (same parameters) computing in `compute_dtype` where one is set:
    input and weight cast to it, as flax's Conv(dtype=...) casts them."""

    def __init__(self, *args, compute_dtype: torch.dtype | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(self.compute_dtype)
        return self._conv_forward(x.to(self.compute_dtype), self.weight.to(self.compute_dtype),
                                  bias)


class Linear(nn.Linear):
    """nn.Linear (same parameters) computing in `compute_dtype` where one is set:
    the product of the cast input and weight, then the cast bias added in that
    dtype, as flax's Dense(dtype=...)."""

    def __init__(self, *args, compute_dtype: torch.dtype | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype is None:
            return super().forward(x)
        d = self.compute_dtype
        return F.linear(x.to(d), self.weight.to(d)) + self.bias.to(d)


def conv3x3(in_features: int, features: int, compute_dtype=None) -> Conv2d:
    """3x3 conv, flax 'SAME' padding, no bias."""
    return Conv2d(in_features, features, 3, padding=1, bias=False, compute_dtype=compute_dtype)


def conv1x1(in_features: int, features: int, compute_dtype=None) -> Conv2d:
    return Conv2d(in_features, features, 1, bias=False, compute_dtype=compute_dtype)


FLAX_BN_MOMENTUM = 0.9


class _CrossRankBatchNorm(torch.autograd.Function):
    """Training-mode batch norm over the global batch of the ranks: (sum x,
    sum x^2, count) per channel over (N, H, W) all-reduced, the global mean and
    biased variance max(E[x^2] - E[x]^2, 0) in float32. The backward all-reduces
    (sum g, sum g * xhat) for the input's gradient; the scale's and shift's
    gradients stay the rank's own sums, which the trainer's gradient all-reduce
    adds up. Returns (y in x's dtype, mean, var)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float):
        xf = x.float()
        C = x.shape[1]
        count = xf.new_full((1,), float(xf.numel() // C))
        stats = distributed.all_reduce_sum(
            torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)), count]))
        n = stats[-1]
        mean = stats[:C] / n
        var = torch.clamp(stats[C:2 * C] / n - mean * mean, min=0.0)
        invstd = torch.rsqrt(var + eps)
        xhat = (xf - mean[:, None, None]) * invstd[:, None, None]
        y = xhat * weight[:, None, None] + bias[:, None, None]
        ctx.save_for_backward(x, mean, invstd, weight)
        ctx.n = n
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, mean, invstd, weight = ctx.saved_tensors
        g = gy.float()
        xhat = (x.float() - mean[:, None, None]) * invstd[:, None, None]
        C = x.shape[1]
        local = torch.cat([g.sum(dim=(0, 2, 3)), (g * xhat).sum(dim=(0, 2, 3))])
        sums = distributed.all_reduce_sum(local.clone())
        mean_g = (sums[:C] / ctx.n)[:, None, None]
        mean_gx = (sums[C:] / ctx.n)[:, None, None]
        gx = (weight * invstd)[:, None, None] * (g - mean_g - xhat * mean_gx)
        return gx.to(x.dtype), local[C:], local[:C], None


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d (same parameters, buffers and eval mode) whose training mode
    normalizes by the batch statistics and then moves the running statistics as
    flax does: ra = 0.9 ra + (1 - 0.9) batch, with the batch variance
    max(mean(x^2) - mean(x)^2, 0) over (N, H, W) in float32. A bfloat16 input is
    normalized in float32 (F.batch_norm's mixed-dtype path: float32 statistics
    and parameters) and comes out bfloat16. Across ranks the batch is the global
    batch (`_CrossRankBatchNorm`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if distributed.process_count() > 1:
            y, mean, var = _CrossRankBatchNorm.apply(x, self.weight, self.bias, self.eps)
            self._move_running_stats(mean.detach(), var.detach())
            return y
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        with torch.no_grad():
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            self._move_running_stats(mean, var)
        return y

    @torch.no_grad()
    def _move_running_stats(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        m = FLAX_BN_MOMENTUM
        self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        self.num_batches_tracked.add_(1)


def batch_norm(features: int) -> BatchNorm2d:
    return BatchNorm2d(features, eps=1e-5, momentum=0.1)


class Dropout(nn.Module):
    """Inverted dropout (survivors scaled by 1 / (1 - p)) in training mode only,
    its keep mask drawn from `generator` on the input's device. `shared_dims`:
    dimensions along which one mask is broadcast (flax's broadcast dropout).
    Across ranks the mask is the global batch's (dimension 0 times the number of
    ranks), of which the rank keeps its rows: the draws do not depend on how
    the batch is split."""

    def __init__(self, p: float, shared_dims: tuple[int, ...] = ()):
        super().__init__()
        self.p = float(p)
        self.shared_dims = tuple(shared_dims)
        self.generator: torch.Generator | None = None

    def keep_mask(self, shape: list[int], device: torch.device) -> torch.Tensor:
        """A keep mask of `shape` (True where the element survives)."""
        return torch.rand(shape, generator=self.generator, device=device) >= self.p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        shape = [1 if d in self.shared_dims else n for d, n in enumerate(x.shape)]
        n_ranks = distributed.process_count()
        if n_ranks > 1 and 0 not in self.shared_dims:
            B, r = shape[0], distributed.process_index()
            shape[0] = B * n_ranks
            keep = self.keep_mask(shape, x.device)[r * B:(r + 1) * B]
        else:
            keep = self.keep_mask(shape, x.device)
        return torch.where(keep, x * (1.0 / (1.0 - self.p)), torch.zeros((), dtype=x.dtype,
                                                                          device=x.device))

    def extra_repr(self) -> str:
        return f"p={self.p}"


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2. Below float32 the window sums as XLA's
    reduce_window does in that dtype, one rounded add at a time in row-major
    window order, then divides by 4 (exact); F.avg_pool2d would round once."""
    if x.dtype == torch.float32:
        return F.avg_pool2d(x, 2)
    h, w = x.shape[-2] // 2 * 2, x.shape[-1] // 2 * 2
    x = x[..., :h, :w]
    return (((x[..., 0::2, 0::2] + x[..., 0::2, 1::2]) + x[..., 1::2, 0::2])
            + x[..., 1::2, 1::2]) / 4


class AvgPool2x2(nn.Module):
    """`avg_pool_2x2` as a module (the shortcut's downsample.0)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return avg_pool_2x2(x)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2)


def conv_bn_relu(x: torch.Tensor, conv: nn.Conv2d, bn: nn.BatchNorm2d) -> torch.Tensor:
    """The flax `ConvBnRelu` block: relu(bn(conv(x)))."""
    return F.relu(bn(conv(x)))


POOLS = {"avg": avg_pool_2x2, "max": max_pool_2x2,
         "avg+max": lambda x: avg_pool_2x2(x) + max_pool_2x2(x),
         "avg_1x2": lambda x: F.avg_pool2d(x, (1, 2)), "none": lambda x: x}


class DoubleConvBlock(nn.Module):
    """Two 3x3 conv+BN+relu followed by pooling (reference ConvBlock):
    `pool_type` 'avg' (2x2, PannResNet22), 'max', 'avg+max', 'avg_1x2' (an
    average over frequency pairs alone, EINV2's last two blocks) or 'none' (the
    caller pools, as PannResNet22TPU's stem does before the convs)."""

    def __init__(self, in_features: int, features: int, pool_type: str = "avg",
                 compute_dtype=None):
        super().__init__()
        if pool_type not in POOLS:
            raise ValueError(f"unknown pool type {pool_type}")
        self.pool_type = pool_type
        self.conv1 = conv3x3(in_features, features, compute_dtype)
        self.bn1 = batch_norm(features)
        self.conv2 = conv3x3(features, features, compute_dtype)
        self.bn2 = batch_norm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv_bn_relu(x, self.conv1, self.bn1)
        return POOLS[self.pool_type](conv_bn_relu(x, self.conv2, self.bn2))


def shortcut(in_features: int, features: int, stride: int, compute_dtype) -> nn.Sequential:
    """avgpool (stride 2) + 1x1 conv + BN: keys downsample.{0,1} at stride 1,
    downsample.{1,2} at stride 2 (the AvgPool2d at .0 holds nothing)."""
    proj = [conv1x1(in_features, features, compute_dtype), batch_norm(features)]
    if stride == 2:
        proj.insert(0, AvgPool2x2())
    return nn.Sequential(*proj)


class ResNetBasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 use_shortcut_proj: bool = False, compute_dtype=None):
        super().__init__()
        self.stride = stride
        self.conv1 = conv3x3(in_features, features, compute_dtype)
        self.bn1 = batch_norm(features)
        self.dropout = Dropout(0.1)
        self.conv2 = conv3x3(features, features, compute_dtype)
        self.bn2 = batch_norm(features)  # zero-initialized scale in the flax module
        self.downsample = (shortcut(in_features, features, stride, compute_dtype)
                           if use_shortcut_proj else None)

    @property
    def last_bn(self) -> BatchNorm2d:
        return self.bn2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = avg_pool_2x2(x) if self.stride == 2 else x
        out = self.dropout(conv_bn_relu(out, self.conv1, self.bn1))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNetBottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck, expansion 4 (reference _ResnetBottleneck):
    pre-conv 2x2 average pool at stride 2, dropout 0.1 after the 3x3, the last
    BN's scale zero-initialized, avgpool + 1x1 + BN shortcut."""

    expansion = 4

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 use_shortcut_proj: bool = False, compute_dtype=None):
        super().__init__()
        self.stride = stride
        out_features = self.expansion * features
        self.conv1 = conv1x1(in_features, features, compute_dtype)
        self.bn1 = batch_norm(features)
        self.conv2 = conv3x3(features, features, compute_dtype)
        self.bn2 = batch_norm(features)
        self.dropout = Dropout(0.1)
        self.conv3 = conv1x1(features, out_features, compute_dtype)
        self.bn3 = batch_norm(out_features)
        self.downsample = (shortcut(in_features, out_features, stride, compute_dtype)
                           if use_shortcut_proj else None)

    @property
    def last_bn(self) -> BatchNorm2d:
        return self.bn3

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = avg_pool_2x2(x) if self.stride == 2 else x
        out = conv_bn_relu(out, self.conv1, self.bn1)
        out = self.dropout(conv_bn_relu(out, self.conv2, self.bn2))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


BLOCKS = {"basic": ResNetBasicBlock, "bottleneck": ResNetBottleneckBlock}


class ResNetTrunk(nn.Module):
    """Four stages of residual blocks (`layers` a stage, default two), widths
    [64,128,256,512], first stage stride 1, the others stride 2; a stage's first
    block projects its shortcut where the stride or the width changes. `block`
    'basic' (PannResNet22) or 'bottleneck' (expansion 4)."""

    def __init__(self, in_features: int = 64, layers=(2, 2, 2, 2),
                 widths=(64, 128, 256, 512), block: str = "basic", compute_dtype=None):
        super().__init__()
        if block not in BLOCKS:
            raise ValueError(f"unknown block '{block}'")
        block_cls = BLOCKS[block]
        self.n_stages = len(layers)
        for stage, (n_blocks, width) in enumerate(zip(layers, widths)):
            stride = 1 if stage == 0 else 2
            out_features = width * block_cls.expansion
            blocks = [block_cls(in_features, width, stride=stride,
                                use_shortcut_proj=stride != 1 or in_features != out_features,
                                compute_dtype=compute_dtype)]
            blocks += [block_cls(out_features, width, compute_dtype=compute_dtype)
                       for _ in range(n_blocks - 1)]
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            in_features = out_features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for stage in range(self.n_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x


def sinusoid_position_encoding(pos_len: int, d_model: int, scale: float = 0.1) -> np.ndarray:
    """0.1-scaled sin/cos table (pos_len, d_model) (reference PositionalEncoding),
    computed in float64 and rounded to float32."""
    pe = np.zeros((pos_len, d_model), dtype=np.float32)
    pos = np.arange(pos_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * (-np.log(10000.0) / d_model))
    pe[:, 0::2] = scale * np.sin(pos * div)
    pe[:, 1::2] = scale * np.cos(pos * div)
    return pe


def layer_norm(features: int, eps: float = 1e-6) -> nn.LayerNorm:
    """flax's LayerNorm by default: epsilon 1e-6 (torch's default is 1e-5)."""
    return nn.LayerNorm(features, eps=eps)


class SelfAttention(nn.Module):
    """Multi-head self-attention with nn.MultiheadAttention's parameters
    (`in_proj_weight` rows [q; k; v], `in_proj_bias`, `out_proj`) and flax's
    MultiHeadDotProductAttention arithmetic: queries scaled by 1/sqrt(head_dim)
    before the product, softmax over the keys, dropout on the attention weights
    with one (T, T) mask shared by the batch and the heads. Each call is a
    `model.attention` span and adds the (B, H, T, T) score elements it
    materialises to `SelfAttention.score_elements`, the process's count."""

    score_elements = 0  # attention scores materialised by every call, B H T^2 a call

    def __init__(self, d_model: int, n_heads: int, dropout: float):
        super().__init__()
        self.n_heads = n_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        self.dropout = Dropout(dropout, shared_dims=(0, 1))
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, d) -> (B, T, d)."""
        B, T, d = x.shape
        with span("model.attention"):
            q, k, v = (t.reshape(B, T, self.n_heads, -1).transpose(1, 2)  # (B, H, T, hd)
                       for t in F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, -1))
            q = q / float(np.sqrt(q.shape[-1]))
            w = self.dropout(torch.softmax(q @ k.transpose(-1, -2), dim=-1))
            SelfAttention.score_elements += B * self.n_heads * T * T
            return self.out_proj((w @ v).transpose(1, 2).reshape(B, T, d))


class TransformerEncoderLayer(nn.Module):
    """Post-LN transformer encoder layer with nn.TransformerEncoderLayer's
    parameter names (self_attn, linear1, linear2, norm1, norm2) and salsa_tpu's
    arithmetic: 8 heads, ReLU feed-forward of 1024, dropout 0.2 on the attention
    weights, after the attention, after the ReLU and after the feed-forward, each
    a `Dropout` (the trainer's generator), LayerNorm epsilon `eps` (1e-6, flax's;
    EINV2 takes torch's 1e-5)."""

    def __init__(self, d_model: int, n_heads: int = 8, dim_feedforward: int = 1024,
                 dropout: float = 0.2, eps: float = 1e-6):
        super().__init__()
        self.self_attn = SelfAttention(d_model, n_heads, dropout)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = layer_norm(d_model, eps)
        self.norm2 = layer_norm(d_model, eps)
        self.dropout = Dropout(dropout)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.dropout1(self.self_attn(x)))
        y = self.linear2(self.dropout(F.relu(self.linear1(x))))
        return self.norm2(x + self.dropout2(y))
