"""salsa_tpu_torch.scripts.probe_pallas_conv (K4, the stage-1 3x3 conv with 64
outputs) against the JAX probe `scripts/probe_pallas_conv.py` on the same seeded
inputs: the port's plain version against the paired-position Pallas kernel in
interpret mode, as the JAX probe's own `--check-only` runs it."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import scripts.probe_pallas_conv as jconv  # noqa: E402
from salsa_tpu_torch.scripts import probe_pallas_conv as tconv  # noqa: E402


def _inputs(C, seed=20261016):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 8, 10, C)).astype(np.float32)
    w = rng.standard_normal((3, 3, C, 64)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("C", [64, 7])
def test_conv_plain_matches_jax_pallas(C):
    """The JAX kernel's packed weight goes back to HWIO through hwio_from_w_big;
    the bound is the JAX probe's own (probe_pallas_conv.py:176-177)."""
    x, w = _inputs(C)
    w_big = jconv.make_w_big(w, jnp.float32)
    want = np.asarray(jconv.paired_conv_pallas(jnp.asarray(x), w_big, bh=4, interpret=True))
    w_port = tconv.hwio_from_w_big(np.asarray(w_big))
    got = tconv.conv3x3_64(torch.from_numpy(x), torch.from_numpy(w_port), rows_per_block=4)
    assert got.shape == (2, 8, 10, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(jconv.xla_conv(jnp.asarray(x),
                                                                      jnp.asarray(w))),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("C", [64, 7])
def test_hwio_from_w_big_inverts_make_w_big(C):
    _, w = _inputs(C)
    w_big = np.asarray(jconv.make_w_big(w, jnp.float32))
    back = tconv.hwio_from_w_big(w_big)
    assert back.dtype == w.dtype and back.shape == w.shape
    np.testing.assert_array_equal(back, w)
    np.testing.assert_array_equal(tconv._pack_w_big(w), w_big)
    bad = w_big.copy()
    bad[2 * C * 3, 0] = 1.0  # a structural zero of the first "combined" block
    with pytest.raises(ValueError):
        tconv.hwio_from_w_big(bad)
    with pytest.raises(ValueError):
        tconv.hwio_from_w_big(w_big[:-1])


def _block_tiles(tiles, blocks):
    """The contiguous tile range of each persistent block, as the kernel splits
    them: block i takes [i tiles / blocks, (i + 1) tiles / blocks)."""
    return [range(i * tiles // blocks, (i + 1) * tiles // blocks) for i in range(blocks)]


def _swizzle(addr):
    """The 128-byte swizzle as TMA writes shared memory and wgmma reads it: in
    each 1024-byte-aligned atom, the 16-byte chunk (address bits 4-6) is XORed
    with the 128-byte row (bits 7-9)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _weights_smem(w, c0):
    """The kernel's fill_weights in numpy: channels c0..c0+63 of HWIO w at tap
    * 8192 + n * 128 + ((c / 8) ^ (n % 8)) * 16 + (c % 8) * 2, zeros past C; one
    float64 a bf16 slot (byte address / 2)."""
    C = w.shape[2]
    smem = np.zeros(tconv.WEIGHT_BYTES // 2)
    for tap, n, c in np.ndindex(9, 64, 64):
        if c0 + c < C:
            byte = tap * 8192 + n * 128 + ((c // 8) ^ (n % 8)) * 16 + (c % 8) * 2
            smem[byte // 2] = w[tap // 3, tap % 3, c0 + c, n]
    return smem


def _fill_row(ring, byte0, x, b, h, c0):
    """One 64-channel chunk of image row h (columns -1..W) at byte0 of the ring as
    the producer's element-load fill writes it: 16-byte unit (pixel p, channels
    8j..8j+7) at p * 128 + ((j ^ (p % 8)) << 4), zeros outside the image and past
    C. TMA's box (64 channels x W + 2 pixels from column -1) lands at
    _swizzle(p * 128 + c * 2), which the test checks is the same place."""
    _, H, W, C = x.shape
    for p, j, e in np.ndindex(W + 2, 8, 8):
        col, c = p - 1, c0 + 8 * j + e
        byte = p * 128 + ((j ^ (p % 8)) << 4) + 2 * e
        assert byte == _swizzle(p * 128 + 2 * (8 * j + e))
        inside = 0 <= h < H and 0 <= col < W and c < C
        ring[(byte0 + byte) // 2] = x[b, h, col, c] if inside else 0.0


@pytest.mark.parametrize("C", [7, 64, 80])
def test_mma_weight_layout(C):
    """The bf16 kernel's shared-memory layouts, read back by the addresses the
    kernel computes, give the conv: the resident weights through the wgmma
    descriptor (K-major, 128-byte swizzle, a k16 step 32 B further), a tile's A
    rows through ldmatrix's per-lane addresses into the ring of image rows (slot
    (key - k0) % slots), tile by tile over each persistent block; the GEMM over
    them equals the float64 conv, and so does the wrapper's output on the CPU.
    The epilogue's buffer holds the tile 128-byte swizzled: the fragments' bf16
    pairs land where the copy-out's 16-byte chunk j of pixel m reads them."""
    x, w = _inputs(C)
    B, H, W, _ = x.shape
    P, nch = H * W, -(-C // 64)
    slots = tconv.bf16_ring_slots(B, H, W, C)
    row_bytes = -(-(W + 2) * 128 // 1024) * 1024
    slot_bytes = nch * row_bytes
    per_image = -(-P // tconv.TILE)
    out = np.zeros((B, P, 64))
    for block in _block_tiles(B * per_image, 3):
        k0 = tconv.tile_keys(block.start, H, W)[0]
        ring = np.full(slots * slot_bytes // 2, np.nan)
        for t in block:
            first, last = tconv.tile_keys(t, H, W)
            for key in range(first, last + 1):  # the producer's rows, in their slots
                b, h = divmod(key, H + 2)
                for c in range(nch):
                    _fill_row(ring, (key - k0) % slots * slot_bytes + c * row_bytes, x, b, h - 1,
                              64 * c)
            b, q0 = divmod(t, per_image)
            q0 *= tconv.TILE
            acc = np.zeros((64, 64))
            for c in range(nch):
                ws = _weights_smem(w, 64 * c)
                for m in range(64):
                    q = min(q0 + m, P - 1)
                    oh, ow = divmod(q, W)
                    a = np.empty((9, 64))
                    for tap, s, khalf in np.ndindex(9, 4, 2):
                        dh, dw = divmod(tap, 3)
                        row = ((b * (H + 2) + oh + dh - k0) % slots * slot_bytes + c * row_bytes
                               + ow * 128)
                        addr = row + dw * 128 + (((2 * s + khalf) ^ ((ow + dw) & 7)) << 4)
                        a[tap, 16 * s + 8 * khalf:16 * s + 8 * khalf + 8] = \
                            ring[addr // 2:addr // 2 + 8]
                    for tap, s in np.ndindex(9, 4):
                        start = tap * 8192 + s * 32
                        bmat = np.array([[ws[_swizzle(start + n * 128 + 2 * kk) // 2]
                                          for n in range(64)] for kk in range(16)])
                        acc[m] += a[tap, 16 * s:16 * s + 16] @ bmat
            valid = min(tconv.TILE, P - q0)
            out[b, q0:q0 + valid] = acc[:valid]
    want = torch.nn.functional.conv2d(torch.from_numpy(x).double().permute(0, 3, 1, 2),
                                      torch.from_numpy(w).double().permute(3, 2, 0, 1),
                                      padding=1).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out.reshape(B, H, W, 64), want, atol=1e-10)
    for m, n in np.ndindex(64, 64):  # the epilogue: bf16 pair (n, n + 1) of pixel m
        if n % 2 == 0:
            byte = m * 128 + (((n // 8) ^ (m % 8)) << 4) + 4 * (n % 8 // 2)  # fragment write
            chunk = m * 128 + (((n // 8) ^ (m % 8)) << 4)  # copy-out read of chunk n // 8
            assert byte == _swizzle(m * 128 + 2 * n) and byte - chunk == 2 * (n % 8)
    got = tconv.conv3x3_64(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def _walk_block(tiles, H, W, slots, lockstep, rng):
    """The kernel's hand-over of ring rows in one persistent block, run as
    coroutines in a seeded random order: the producer fills rows k0..k1 into slot
    (key - k0) % slots once every consumer released the row `slots` before; each
    consumer warpgroup takes turns of TURN consecutive tiles, releases the rows
    below its next turn's first (waiting for each to arrive), waits for its
    turn's rows and reads them (all consumers together each round when
    `lockstep`, as at C > 64). Returns the tiles computed; raises on a deadlock,
    a row read from a slot that holds another, or a row released other than once
    by every consumer."""
    k0, k1 = tconv.tile_keys(tiles.start, H, W)[0], tconv.tile_keys(tiles[-1], H, W)[1]
    consumers = tconv.CONSUMERS
    ring, filled, released, arrived, computed = {}, set(), {}, {}, []

    def producer():
        for key in range(k0, k1 + 1):
            if key - slots >= k0:
                yield lambda key=key: released.get(key - slots, 0) == consumers
            ring[(key - k0) % slots] = key
            filled.add(key)

    turns = [tiles[i:i + tconv.TURN] for i in range(0, len(tiles), tconv.TURN)]

    def consumer(g):
        own = turns[g::consumers]
        done = [k0]

        def release_below(end):
            for key in range(done[0], end):
                yield lambda key=key: key in filled
                released[key] = released.get(key, 0) + 1
            done[0] = max(done[0], end)

        def first(i):
            return tconv.tile_keys(own[i][0], H, W)[0] if i < len(own) else k1 + 1

        yield from release_below(first(0))
        for r in range(-(-len(turns) // consumers)):
            have = r < len(own)
            if have:
                lo, hi = tconv.tile_keys(own[r][0], H, W)[0], tconv.tile_keys(own[r][-1], H, W)[1]
                yield lambda lo=lo, hi=hi: all(k in filled for k in range(lo, hi + 1))
            if lockstep:
                arrived[r] = arrived.get(r, 0) + 1
                yield lambda r=r: arrived[r] == consumers
            if have:
                assert all(ring[(k - k0) % slots] == k for k in range(lo, hi + 1))
                computed.extend(own[r])
                yield from release_below(first(r + 1))

    agents = {i: (a, None) for i, a in enumerate([producer()] +
                                                 [consumer(g) for g in range(consumers)])}
    while agents:
        ready = [i for i, (_, cond) in agents.items() if cond is None or cond()]
        assert ready, f"the ring's hand-over deadlocked in tiles {tiles}"
        i = ready[rng.integers(len(ready))]
        try:
            agents[i] = (agents[i][0], next(agents[i][0]))
        except StopIteration:
            del agents[i]
    assert released == {key: consumers for key in range(k0, k1 + 1)}
    return computed


@pytest.mark.parametrize("shape", [(32, 320, 100, 64), (3, 13, 37, 7), (3, 13, 37, 80),
                                   (1, 1, 1, 64), (2, 150, 3, 64), (512, 8, 8, 64),
                                   (64, 4, 8, 128), (9, 7, 9, 128)])
def test_bf16_tile_walk(shape):
    """A Python mirror of the bf16 kernel's tile walk: the persistent blocks' tile
    ranges (132, an H100's SMs, or fewer tiles) cover every output pixel exactly
    once; a tile's row keys hold every input row of its pixels; the ring depth the
    wrapper picks holds the rows of the consumers' turns (CONSUMERS x TURN
    consecutive tiles) and one more; and the rows' hand-over runs to its end
    without a deadlock, resident and in lockstep (as at C > 64). (2, 150, 3): W =
    3 makes a tile span 22 image rows; (512, 8, 8), (64, 4, 8) and (9, 7, 9) hold
    one tile an image, so the consumers' turns span four images (and, at C = 128,
    the ring takes two 64-channel chunks a row)."""
    B, H, W, C = shape
    P, per_image = H * W, -(-H * W // tconv.TILE)
    tiles = B * per_image
    blocks = _block_tiles(tiles, min(tiles, 132))
    assert [t for blk in blocks for t in blk] == list(range(tiles))
    assert all(len(blk) > 0 for blk in blocks)
    slots = tconv.bf16_ring_slots(B, H, W, C)
    assert slots >= tconv.ring_rows(B, H, W, tconv.CONSUMERS * tconv.TURN) + 1
    assert tconv.bf16_smem_bytes(W, C, slots) <= tconv.H100_SMEM_BYTES
    count = np.zeros(B * P, np.int64)
    for t in range(tiles):
        b, q0 = divmod(t, per_image)
        q = np.arange(q0 * tconv.TILE, min(q0 * tconv.TILE + tconv.TILE, P))
        count[b * P + q] += 1
        first, last = tconv.tile_keys(t, H, W)
        rows = b * (H + 2) + q // W  # the key of input row oh - 1; oh and oh + 1 follow
        assert rows.min() == first and rows.max() + 2 == last
    np.testing.assert_array_equal(count, 1)
    for blk in blocks:
        for i in range(len(blk)):
            window = blk[i:i + tconv.CONSUMERS * tconv.TURN]
            span = tconv.tile_keys(window[-1], H, W)[1] - tconv.tile_keys(window[0], H, W)[0] + 1
            assert span + 1 <= slots
    rng = np.random.default_rng(sum(shape))
    for lockstep in (False, True):
        computed = [t for blk in blocks for t in _walk_block(blk, H, W, slots, lockstep, rng)]
        assert sorted(computed) == list(range(tiles))


def test_bf16_wrapper_refusals():
    """The bf16 kernel's own refusals, the same on the CPU as on the card: the
    f32 kernel's rows_per_block, a view 2 bytes off a 16-byte boundary (TMA), a
    row over TMA's box of 256 pixels, and a ring that does not fit in shared
    memory (a wide row of four chunks; four small images a turn window of two
    chunks each; a block given less shared memory than an H100's)."""
    x = torch.zeros(1, 4, 5, 8, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 8, 64, dtype=torch.bfloat16)
    assert tconv.conv3x3_64(x, w).shape == (1, 4, 5, 64)
    with pytest.raises(ValueError, match="rows_per_block"):
        tconv.conv3x3_64(x, w, rows_per_block=8)
    buf = torch.zeros(x.numel() + 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        tconv.conv3x3_64(buf[1:].view(x.shape), w)
    with pytest.raises(ValueError, match="box"):
        tconv.conv3x3_64(torch.zeros(1, 2, 255, 8, dtype=torch.bfloat16), w)
    with pytest.raises(ValueError, match="shared memory"):
        tconv.conv3x3_64(torch.zeros(1, 2, 200, 256, dtype=torch.bfloat16),
                         torch.zeros(3, 3, 256, 64, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="shared memory"):
        tconv.bf16_ring_slots(512, 8, 8, 128)  # 41 rows of 4 KB
    assert tconv.bf16_ring_slots(32, 320, 100, 64) == 11
    with pytest.raises(ValueError, match="shared memory"):
        tconv.bf16_ring_slots(32, 320, 100, 64, 48 * 1024)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrapper_is_the_plain_version(dtype):
    x, w = _inputs(7)
    xt, wt = torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype)
    before = tconv.conv3x3_64.launches
    got = tconv.conv3x3_64(xt, wt)
    assert got.dtype == dtype and got.shape == (2, 8, 10, 64)
    assert torch.equal(got, tconv.conv3x3_64_plain(xt, wt))
    assert tconv.conv3x3_64.launches == before
    # the plain version is the f32 conv of the inputs, rounded once to the dtype
    want = torch.nn.functional.conv2d(xt.double().permute(0, 3, 1, 2),
                                      wt.double().permute(3, 2, 0, 1), padding=1)
    err = (got.double() - want.permute(0, 2, 3, 1)).abs().max() / want.abs().max()
    assert err <= (2.0 ** -8 if dtype == torch.bfloat16 else 1e-6)


def test_conv_rejects_bad_input():
    x, w = torch.zeros(1, 4, 5, 3), torch.zeros(3, 3, 3, 64)
    with pytest.raises(ValueError):
        tconv.conv3x3_64(x[0], w)                        # not 4-D
    with pytest.raises(ValueError):
        tconv.conv3x3_64(x, torch.zeros(3, 3, 4, 64))    # C mismatch
    with pytest.raises(ValueError):
        tconv.conv3x3_64(x, torch.zeros(3, 3, 3, 32))    # not 64 outputs
    with pytest.raises(TypeError):
        tconv.conv3x3_64(x.double(), w.double())         # dtype
    with pytest.raises(TypeError):
        tconv.conv3x3_64(x, w.to(torch.bfloat16))        # mixed dtypes
    with pytest.raises(ValueError):
        tconv.conv3x3_64(x, w, rows_per_block=3)
    with pytest.raises(ValueError):
        tconv.conv3x3_64(x.to("meta"), w.to("meta"))     # neither cuda nor cpu
    with pytest.raises(ValueError):
        tconv.conv3x3_64(x, w.to("meta"))                # two devices


def test_probe_main_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        tconv.main(["--batch", "1"])
