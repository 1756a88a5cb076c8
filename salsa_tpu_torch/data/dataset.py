"""Chunk dataset, host batching and background prefetch (counterpart of
`salsa_tpu.data.dataset`).

`SeldChunkDataset` slices fixed-length windows out of a split (preloaded or lazy)
and applies the host transforms; `batch_iterator` yields shuffled fixed-size
batches for training (the incomplete tail dropped only where asked) and in-order
batches for validation, where the overlapping chunks of a clip are recombined
downstream; `prefetch` builds batches on a background thread. With
`process_shard` each rank of a data-parallel run reads and transforms only its
rows of every global batch.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from salsa_tpu_torch.data.database import SplitData


class SeldChunkDataset:
    def __init__(self, data: SplitData, joint_transform=None, transform=None):
        self.data = data
        self.joint_transform = joint_transform
        self.transform = transform

    def __len__(self) -> int:
        return len(self.data)

    def fetch_raw(self, index: int):
        """The chunk's window and label windows, no transform (thread-safe: draws
        nothing)."""
        d = self.data
        l0 = d.label_chunk_starts[index]
        x = d.get_feature_chunk(index)
        sed = d.sed_targets[l0 : l0 + d.label_chunk_len]
        doa = d.doa_targets[l0 : l0 + d.label_chunk_len]
        return x, sed, doa, d.clip_names[index]

    def apply_transforms(self, item):
        x, sed, doa, name = item
        if self.joint_transform is not None:
            x, sed, doa = self.joint_transform(x, sed, doa)
        if self.transform is not None:
            x = self.transform(x)
        return x, sed, doa, name

    def __getitem__(self, index: int):
        return self.apply_transforms(self.fetch_raw(index))


def batch_iterator(
    dataset: SeldChunkDataset,
    batch_size: int,
    shuffle: bool = False,
    drop_last: bool = False,
    rng: np.random.Generator | None = None,
    pad_to_batch: bool = False,
    process_shard: tuple[int, int] | None = None,
    num_workers: int = 0,
) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray, list[str], int]]:
    """Yields (x, sed, doa, clip_names, n_real) batches as stacked numpy arrays.

    With `shuffle`, the order is `rng`'s permutation of the chunks. A short tail
    batch is dropped with `drop_last`, else padded with `pad_to_batch` by
    repeating its last sample, so that every batch has one shape; n_real counts
    the unpadded samples.

    `num_workers` > 0 reads each batch's windows on a thread pool (a lazy split
    reads from disk on every access); the transforms still run in this thread,
    in order, so their draws do not depend on the worker count.

    `process_shard=(rank, n_ranks)` is `salsa_tpu`'s multi-process mode: the
    shuffle is over the whole split (the same order on every same-seeded rank),
    each rank reads and transforms only its rows [rank * B / n, (rank + 1) * B / n)
    of each global batch of B, and n_real is that row count. The host transforms
    then draw on each rank's own generator for its own rows, so their draws are
    not one process's draws over the whole batch, as in `salsa_tpu`. It needs
    `drop_last` and a batch that divides by n_ranks (ValueError otherwise).
    """
    order = np.arange(len(dataset))
    if shuffle:
        (rng or np.random.default_rng()).shuffle(order)
    pool = None
    if num_workers > 0:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(num_workers)
        materialize = lambda idx: [dataset.apply_transforms(it) for it in  # noqa: E731
                                   pool.map(dataset.fetch_raw, [int(j) for j in idx])]
    else:
        materialize = lambda idx: [dataset[int(j)] for j in idx]  # noqa: E731
    try:
        if process_shard is not None:
            rank, n_ranks = process_shard
            if not drop_last or batch_size % n_ranks:
                raise ValueError("process_shard needs drop_last and a batch that divides by "
                                 f"the {n_ranks} ranks, got batch {batch_size}")
            per = batch_size // n_ranks
            for i in range(0, len(order) - batch_size + 1, batch_size):
                samples = materialize(order[i + rank * per:i + (rank + 1) * per])
                yield (np.stack([s[0] for s in samples]), np.stack([s[1] for s in samples]),
                       np.stack([s[2] for s in samples]), [s[3] for s in samples], per)
            return
        for i in range(0, len(order), batch_size):
            idx = order[i : i + batch_size]
            if len(idx) < batch_size:
                if drop_last:
                    return
                if pad_to_batch:
                    idx = np.concatenate([idx, np.repeat(idx[-1:], batch_size - len(idx))])
            samples = materialize(idx)
            yield (np.stack([s[0] for s in samples]), np.stack([s[1] for s in samples]),
                   np.stack([s[2] for s in samples]), [s[3] for s in samples],
                   min(batch_size, len(order) - i))
    finally:
        # on exhaustion and on an early close of the generator
        if pool is not None:
            pool.shutdown(wait=False)


def prefetch(iterator, depth: int = 2):
    """Run `iterator` on a background thread, keeping up to `depth` items ready.

    The producer's exceptions are raised at the consumer. Closing this generator
    early (the trainer stops at steps_per_epoch) stops the producer and closes
    the inner iterator, so no thread, worker pool or open file is left behind."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterator:
                if not put(item):
                    break
            put(end)
        except BaseException as e:  # noqa: BLE001 - raised at the consumer
            put(e)
        finally:
            if hasattr(iterator, "close"):
                iterator.close()  # batch_iterator's pool shutdown

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
