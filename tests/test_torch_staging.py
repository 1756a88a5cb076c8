"""The serving upload (`salsa_tpu_torch/staging.py`): the chunk walk through a
ring of host blocks, bit-equal to `torch.from_numpy(np.asarray(x, np.float32))`,
its counters, and the pipeline's choice of path. The walk runs on the CPU with
an unpinned ring and tiny chunks; the tests marked `card` run the pinned ring on
an NVIDIA card and skip without one. This file imports nothing of JAX, so on the
card it runs as `python -m pytest --noconftest tests/test_torch_staging.py`."""
import math
import os
import sys
import threading

import numpy as np
import pytest
import torch

from salsa_tpu_torch import staging
from salsa_tpu_torch.features.registry import make_extractor
from salsa_tpu_torch.models.seld import build_model
from salsa_tpu_torch.pipeline import SeldInferencePipeline
from salsa_tpu_torch.staging import PinnedRing, stage, upload

CHUNK = 64  # bytes: 16 float32 samples a chunk


def request(case: str, rng) -> np.ndarray:
    """Host arrays as callers hand them over, by the chunks they split into."""
    if case == "under_one_chunk":
        return rng.standard_normal((2, 3)).astype(np.float32)[None]
    if case == "chunk_multiple":
        return rng.standard_normal((2, 4, 8)).astype(np.float32)
    if case == "remainder":
        return rng.standard_normal((3, 4, 7)).astype(np.float32)
    if case == "two_dim":
        return rng.standard_normal((4, 50)).astype(np.float32)
    if case == "non_contiguous":
        return rng.standard_normal((2, 8, 40)).astype(np.float32)[:, ::2, 1::3]
    if case == "float64":
        return rng.standard_normal((2, 4, 9))
    raise ValueError(case)


def as_served(x) -> np.ndarray:
    """What `SeldInferencePipeline.__call__` hands to the upload: float32, 3-D."""
    waves = np.asarray(x, dtype=np.float32)
    return waves[None] if waves.ndim == 2 else waves


def same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    return got.shape == want.shape and torch.equal(got.cpu().contiguous().view(torch.int32),
                                                   want.contiguous().view(torch.int32))


@pytest.mark.parametrize("case", ["under_one_chunk", "chunk_multiple", "remainder", "two_dim",
                                  "non_contiguous", "float64"])
def test_stage_walk_is_bit_equal_and_counted(case):
    x = request(case, np.random.default_rng(23))
    src = torch.from_numpy(as_served(x))
    want = torch.from_numpy(np.asarray(x, np.float32)).reshape(src.shape)
    ring = PinnedRing(pinned=False, chunk_bytes=CHUNK)
    chunks, n_bytes, pageable = stage.chunks, stage.bytes, upload.pageable
    got = stage(src, torch.full(src.shape, np.nan, dtype=torch.float32), ring)
    assert same_bits(got, want)
    nbytes = 4 * src.numel()
    assert stage.chunks - chunks == max(1, math.ceil(nbytes / CHUNK))
    assert stage.bytes - n_bytes == nbytes and upload.pageable == pageable
    assert len(ring.blocks) <= ring.slots


def test_ring_reuses_its_blocks_across_requests():
    """Many requests through one ring leave it at `slots` blocks, handed out in
    turn; a chunk size that splits float32 samples still copies every byte."""
    rng = np.random.default_rng(5)
    ring = PinnedRing(pinned=False, chunk_bytes=10, slots=3)
    for size in (1, 7, 30, 2, 64, 5):
        x = rng.standard_normal((1, 4, size)).astype(np.float32)
        got = stage(torch.from_numpy(x), torch.empty(x.shape, dtype=torch.float32), ring)
        assert same_bits(got, torch.from_numpy(x))
    assert len(ring.blocks) == ring.slots == 3
    assert all(b.numel() == 10 and b.dtype == torch.uint8 for b in ring.blocks)
    assert ring.events == [None, None, None]


@pytest.mark.parametrize("n", [0, 1, 4095, 512 << 10, (512 << 10) + 1, 3 << 20, (5 << 20) + 12345])
def test_host_copy_copies_every_byte(n):
    """The host library's pooled copy, at sizes under, at and over its 512 KiB
    pieces: every byte lands and nothing past the end is written, by a pool of
    one thread fewer than the CPUs the process may run on."""
    lib = staging.host_copy_library()
    src = torch.randint(0, 256, (n,), dtype=torch.uint8)
    dst = torch.full((n + 64,), 7, dtype=torch.uint8)
    lib.host_copy(dst.data_ptr(), src.data_ptr(), n)
    assert torch.equal(dst[:n], src) and bool((dst[n:] == 7).all())
    assert lib.host_copy_threads() == len(os.sched_getaffinity(0)) - 1


def test_ring_and_pool_under_more_threads_than_cores():
    """Twice as many threads as CPUs stage their own requests through one shared
    ring at once, with a short switch interval: the ring's lock and the pool's
    one copy at a time keep every request bit-equal, and the ring at its slots."""
    ring = PinnedRing(pinned=False, chunk_bytes=(1 << 20) + 12, slots=3)
    n_threads = 2 * len(os.sched_getaffinity(0))
    results: list[bool] = [False] * n_threads

    def serve(k: int) -> None:
        rng = np.random.default_rng(k)
        for _ in range(4):
            x = torch.from_numpy(rng.standard_normal((2, 4, 70_000 + 997 * k)).astype(np.float32))
            got = stage(x, torch.empty(x.shape, dtype=torch.float32), ring)
            if not same_bits(got, x):
                return
        results[k] = True

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=serve, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert all(results) and len(ring.blocks) == ring.slots


def test_upload_on_the_cpu_copies_nothing_and_counts_a_pageable_request():
    x = np.random.default_rng(1).standard_normal((2, 4, 100)).astype(np.float32)
    src = torch.from_numpy(x)
    chunks, pageable = stage.chunks, upload.pageable
    ring = PinnedRing(pinned=False)
    got = upload(src, torch.device("cpu"), ring)
    assert got.data_ptr() == src.data_ptr() and not ring.blocks
    assert stage.chunks == chunks and upload.pageable == pageable + 1


def small_pipeline(device) -> SeldInferencePipeline:
    """SALSA-FOA and a narrow CRNN with torch's initial weights (seeded)."""
    torch.manual_seed(23)
    model = build_model(encoder={"name": "PannResNet22", "n_input_channels": 7},
                        decoder={"name": "SeldDecoder", "decoder_type": "gru",
                                 "decoder_size": 32, "freq_pool": "avg"}, n_classes=3)
    scaler = (np.full((4, 1, 200), -5.0, np.float32), np.full((4, 1, 200), 6.0, np.float32))
    return SeldInferencePipeline(make_extractor("salsa", "foa"), model, None, scaler,
                                 16 * 10 / (24000 / 300), 3, device=device)


def test_pipeline_serves_a_changed_array_anew():
    """The pipeline keeps nothing of a request: the same array, changed in place,
    gets the answers of its new content. On the CPU nothing is staged and each
    request counts as pageable."""
    pipe = small_pipeline("cpu")
    rng = np.random.default_rng(9)
    waves = (0.1 * rng.standard_normal((2, 4, 24000))).astype(np.float32)
    chunks, pageable = stage.chunks, upload.pageable
    first = pipe(waves)
    waves[:, :, ::2] *= -3.0
    second = pipe(waves)
    fresh = pipe(waves.copy())
    assert not np.array_equal(first[0], second[0]) and not np.array_equal(first[1], second[1])
    for got, want in zip(second, fresh):
        np.testing.assert_array_equal(got, want)
    assert stage.chunks == chunks and upload.pageable == pageable + 3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("change_after_call", [False, True], ids=["kept", "changed"])
def test_ring_back_to_back_requests_bit_equal(card, change_after_call):
    """40 distinct requests through a pinned ring of 1 MiB chunks, sent back to
    back behind a ~50 ms kernel, so the card still reads the first blocks when the
    host wants them again: each lands bit-equal to the pageable `.to()`. With
    `change_after_call` each host array is overwritten as soon as its call
    returns, which only a copy finished with that array survives."""
    rng = np.random.default_rng(40)
    ring = PinnedRing(pinned=True, chunk_bytes=1 << 20)
    samples = [65536 * k + extra for k in (1, 2, 3, 5, 8) for extra in (0, 37, 4096, 65535)]
    kept, gots = [], []
    torch.cuda._sleep(100_000_000)
    for i in range(40):
        x = rng.standard_normal((4, samples[i % len(samples)])).astype(np.float32)[None]
        kept.append(x.copy())
        gots.append(upload(torch.from_numpy(x), card, ring))
        if change_after_call:
            x[...] = np.nan
    torch.cuda.synchronize()
    for got, x in zip(gots, kept):  # the pageable copies only now: they wait for the stream
        want = torch.from_numpy(x).to(card)
        assert got.shape == want.shape and torch.equal(got.view(torch.int32),
                                                       want.view(torch.int32))
    assert len(ring.blocks) == ring.slots


@pytest.mark.card
def test_ring_counts_a_served_request(card):
    """A request of the benchmark's size (4 clips x 4 ch x 60 s at 24 kHz, 92.16 MB)
    takes ceil(92.16 MB / CHUNK_BYTES) chunks through the default ring."""
    x = np.random.default_rng(3).standard_normal((4, 4, 1_440_000)).astype(np.float32)
    ring = PinnedRing(pinned=True)
    chunks, n_bytes, pageable = stage.chunks, stage.bytes, upload.pageable
    got = upload(torch.from_numpy(x), card, ring)
    assert same_bits(got, torch.from_numpy(x))
    assert stage.chunks - chunks == math.ceil(92_160_000 / staging.CHUNK_BYTES)
    assert stage.bytes - n_bytes == 92_160_000 and upload.pageable == pageable
    assert len(ring.blocks) == ring.slots and all(b.is_pinned() for b in ring.blocks)


@pytest.mark.card
def test_pipeline_answers_equal_the_pageable_path(card):
    """The served answers are bit-equal to those of the same request copied by the
    pageable `.to()`, as the pipeline did before the ring."""
    pipe = small_pipeline(card)
    waves = (0.1 * np.random.default_rng(4).standard_normal((2, 4, 3 * 24000))).astype(np.float32)
    got = pipe(waves)
    with torch.inference_mode():
        want = [t.cpu().numpy() for t in pipe.forward(torch.from_numpy(waves).to(card))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert pipe._ring.blocks and all(b.is_pinned() for b in pipe._ring.blocks)
