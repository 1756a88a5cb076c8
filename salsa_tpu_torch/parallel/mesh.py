"""The data axis over ranks (counterpart of `salsa_tpu.parallel.mesh`).

`salsa_tpu` lays a (data, model) mesh over its devices and lets GSPMD insert the
collectives. Here each rank is one device of the data axis: a training batch
is split by rows over the ranks (`data_width`), the parameters are rank 0's,
broadcast once (`replicate`), and a tensor sharded over the data axis is a
rank's contiguous block of it (`shard_global`). The 'model' axis (tensor
parallelism, `param_sharding` with n_model > 1) is not ported: the CRNN has
12.1M parameters, and no config or CLI reaches it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from salsa_tpu_torch.parallel import distributed


def data_width(train_batch_size: int, n_ranks: int | None = None) -> int:
    """The data axis's width: `salsa_tpu`'s gcd(train_batch_size, n_devices) with
    one device a rank, which must be every rank; a batch that does not divide by
    the number of ranks raises ValueError, as `salsa_tpu`'s multi-process trainer
    does."""
    n = distributed.process_count() if n_ranks is None else n_ranks
    if math.gcd(train_batch_size, n) != n:
        raise ValueError(f"train_batch_size {train_batch_size} not divisible by {n} processes")
    return n


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and buffer of `module` set to rank 0's (one broadcast each);
    no-op with one rank."""
    if distributed.process_count() > 1:
        for t in list(module.parameters()) + list(module.buffers()):
            distributed.broadcast(t.data)
    return module


def shard_rows(n_rows: int, n_ranks: int | None = None) -> tuple[int, int]:
    """(rows a rank holds, rows padded to a multiple of the ranks) of a tensor of
    `n_rows` sharded over the data axis."""
    n = distributed.process_count() if n_ranks is None else n_ranks
    padded = -(-n_rows // n) * n
    return padded // n, padded


def shard_global(x: np.ndarray, rank: int | None = None,
                 n_ranks: int | None = None) -> np.ndarray:
    """Rank `rank`'s block along axis 0 of `x`, which every rank holds in full:
    the rows [rank * m, (rank + 1) * m), zero rows past the end of `x` (the
    padding to a multiple of the ranks)."""
    rank = distributed.process_index() if rank is None else rank
    m, _ = shard_rows(x.shape[0], n_ranks)
    block = x[rank * m:(rank + 1) * m]
    if block.shape[0] < m:
        block = np.concatenate([block, np.zeros((m - block.shape[0],) + x.shape[1:], x.dtype)])
    return block


def param_sharding(n_model: int) -> None:
    """The 'model' axis: refused with more than one model shard."""
    if n_model > 1:
        raise NotImplementedError("the 'model' mesh axis (tensor parallelism) is not ported: "
                                  "the CRNN's 12.1M parameters train data-parallel only")
