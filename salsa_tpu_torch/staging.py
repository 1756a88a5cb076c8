"""Host-to-device upload of a serving request through a ring of pinned host blocks.

A pageable `tensor.to("cuda")` makes CUDA stage the bytes through its own
small bounce buffers on one host thread, at a fraction of the link's rate, and
blocks the caller until the last byte lands. `upload` instead walks the request
in chunks of CHUNK_BYTES: each chunk is copied into a pinned block by the host
library `csrc/host_copy.cpp` (512 KiB pieces off a shared counter to a pool of
threads, so one slow thread holds back one piece) and then copied to the card
asynchronously on the current stream, so the host fills block k+1 while the
card's DMA reads block k, and whatever the caller queues next on that stream
runs after the last chunk.
"""
from __future__ import annotations

import threading

import torch

# From a sweep of 2-32 MiB chunks and 2-4 slots at a 92.16 MB request on an H100's host (blocks
# filled by torch's copy_): 16 MiB overlapped the host's copy and the DMA best (3.8 ms a request,
# 4.4 at 8 MiB, 4.7 at 32 MiB); the slot counts timed alike, and 3 leave the host one block of
# slack over double buffering.
CHUNK_BYTES = 16 << 20
RING_SLOTS = 3


def host_copy_library():
    """`csrc/host_copy.cpp`, built by the host compiler at first use."""
    from salsa_tpu_torch.kernels.build import load_host_library

    return load_host_library("host_copy")


class PinnedRing:
    """`slots` host blocks of `chunk_bytes` each, handed out in turn and kept for
    the ring's life. With `pinned` (for a card) the blocks are page-locked, from
    PyTorch's caching host allocator, and each carries a CUDA event recorded
    after the copy that last read it. `take` waits on that event, so a block is
    never refilled while the card still reads it and the ring's host memory
    stays `slots` blocks, whatever the request's size. The blocks are made
    by the first request that needs them. Without `pinned` they are plain host
    memory and there is no event to wait on: the CPU tests' stand-in.

    The caching allocator alone, a block a chunk, also holds each block until its
    copy is done, but grows its pool with a `cudaHostAlloc` whenever the host
    runs ahead of the DMA, at any request; the ring allocates only at its first."""

    def __init__(self, pinned: bool = True, chunk_bytes: int = CHUNK_BYTES,
                 slots: int = RING_SLOTS):
        self.pinned, self.chunk_bytes, self.slots = pinned, chunk_bytes, slots
        self.blocks: list[torch.Tensor] = []
        self.events: list[torch.cuda.Event | None] = []
        self.turn = 0
        self.lock = threading.Lock()  # one request walks the ring at a time

    def take(self) -> tuple[torch.Tensor, torch.cuda.Event | None]:
        """The next block (uint8, `chunk_bytes`), once nothing reads it, and its event."""
        i = self.turn
        self.turn = (i + 1) % self.slots
        if i == len(self.blocks):
            self.blocks.append(torch.empty(self.chunk_bytes, dtype=torch.uint8,
                                           pin_memory=self.pinned))
            self.events.append(torch.cuda.Event() if self.pinned else None)
        elif self.events[i] is not None:
            self.events[i].synchronize()
        return self.blocks[i], self.events[i]


def stage(src: torch.Tensor, dst: torch.Tensor, ring: PinnedRing) -> torch.Tensor:
    """Copy host tensor `src` into `dst`, a contiguous tensor of its dtype and size
    (on the card, or on the host for an unpinned ring), chunk by chunk through
    `ring`; returns `dst`. A `src` smaller than one chunk is one chunk; a
    non-contiguous `src` is made contiguous first. Counts `stage.chunks` and
    `stage.bytes`."""
    copy = host_copy_library().host_copy
    flat = src.contiguous().view(-1).view(torch.uint8)
    out = dst.view(-1).view(torch.uint8)
    stream = torch.cuda.current_stream(dst.device) if ring.pinned else None
    with ring.lock:
        for i in range(0, flat.numel(), ring.chunk_bytes):
            n = min(ring.chunk_bytes, flat.numel() - i)
            block, event = ring.take()
            copy(block.data_ptr(), flat.data_ptr() + i, n)
            out[i:i + n].copy_(block[:n], non_blocking=ring.pinned)
            if event is not None:
                event.record(stream)
            stage.chunks += 1
            stage.bytes += n
    return dst


stage.chunks = 0  # chunks copied through a ring
stage.bytes = 0  # bytes copied through a ring


def upload(src: torch.Tensor, device: torch.device, ring: PinnedRing) -> torch.Tensor:
    """Host tensor `src` on `device`: on a CUDA device staged through `ring` into a
    new tensor from the caching allocator; elsewhere `src.to(device)`, which on the
    CPU copies nothing. Counts `upload.pageable`, the requests of the second kind."""
    if device.type != "cuda":
        upload.pageable += 1
        return src.to(device)
    return stage(src, torch.empty(src.shape, dtype=src.dtype, device=device), ring)


upload.pageable = 0  # requests that took `src.to(device)`
