"""Chunk dataset and host batching (counterpart of `salsa_tpu.data.dataset`, without
its prefetch thread, worker pool and multi-host sharding).

`SeldChunkDataset` slices fixed-length windows out of the concatenated split
arrays; `batch_iterator` yields them in order as fixed-size numpy batches for
validation, where the overlapping chunks of a clip are recombined downstream.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

from salsa_tpu_torch.data.database import SplitData


class SeldChunkDataset:
    def __init__(self, data: SplitData):
        self.data = data

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, index: int):
        d = self.data
        l0 = d.label_chunk_starts[index]
        x = d.get_feature_chunk(index)
        sed = d.sed_targets[l0 : l0 + d.label_chunk_len]
        doa = d.doa_targets[l0 : l0 + d.label_chunk_len]
        return x, sed, doa, d.clip_names[index]


def batch_iterator(
    dataset: SeldChunkDataset, batch_size: int,
) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray, list[str], int]]:
    """Yields (x, sed, doa, clip_names, n_real) batches as stacked numpy arrays, in
    dataset order. A short tail batch is padded by repeating its last sample, so
    that every batch has one shape (salsa_tpu's pad_to_batch); n_real counts the
    unpadded samples."""
    n = len(dataset)
    for i in range(0, n, batch_size):
        idx = list(range(i, min(i + batch_size, n)))
        n_real = len(idx)
        idx += [idx[-1]] * (batch_size - n_real)
        samples = [dataset[j] for j in idx]
        yield (np.stack([s[0] for s in samples]), np.stack([s[1] for s in samples]),
               np.stack([s[2] for s in samples]), [s[3] for s in samples], n_real)
