"""salsa_tpu_torch.scripts.probe_pallas_conv (K4, the stage-1 3x3 conv with 64
outputs) against the JAX probe `scripts/probe_pallas_conv.py` on the same seeded
inputs: the port's plain version against the paired-position Pallas kernel in
interpret mode, as the JAX probe's own `--check-only` runs it."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import scripts.probe_pallas_conv as jconv  # noqa: E402
from salsa_tpu_torch.scripts import bench_conv3x3  # noqa: E402
from salsa_tpu_torch.scripts import probe_pallas_conv as tconv  # noqa: E402
from salsa_tpu_torch.scripts import timing  # noqa: E402


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
    got = tconv.conv3x3_64(torch.from_numpy(x), torch.from_numpy(w_port))
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
    """The bf16 kernel's own refusals, the same on the CPU as on the card: a
    launch parameter (neither kernel takes one), a view 2 bytes off a 16-byte
    boundary (TMA), a row over TMA's box of 256 pixels, and a ring that does not
    fit in shared memory (a wide row of four chunks; four small images a turn
    window of two chunks each; a block given less shared memory than an H100's)."""
    x = torch.zeros(1, 4, 5, 8, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 8, 64, dtype=torch.bfloat16)
    assert tconv.conv3x3_64(x, w).shape == (1, 4, 5, 64)
    with pytest.raises(TypeError):
        tconv.conv3x3_64(x, w, 8)
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


# ---- f32: the plan, and mirrors of the kernel's ring and shared-memory addresses

F32 = tconv.F32_TILE


def _old_tile_keys(t, H, W):
    """The bf16 tile walk as it was before it took a tile size (64 pixels)."""
    per_image = -(-H * W // 64)
    b, q0 = t // per_image, t % per_image * 64
    return b * (H + 2) + q0 // W, b * (H + 2) + (min(q0 + 64, H * W) - 1) // W + 2


@pytest.mark.parametrize("shape", [(32, 320, 100, 64), (3, 13, 37, 80), (2, 150, 3, 64),
                                   (512, 8, 8, 128), (2, 5, 300, 64)])
def test_shared_tile_walk(shape):
    """One tile walk for both kernels: at its default (bf16's 64 pixels) it gives
    the keys it gave before it took a tile size, and ring_rows agrees with them;
    at F32_TILE a tile's keys hold the input rows of its 128 pixels."""
    B, H, W, _ = shape
    for t in range(min(B * -(-H * W // 64), 700)):
        assert tconv.tile_keys(t, H, W) == tconv.tile_keys(t, H, W, 64) == _old_tile_keys(t, H, W)
    per_image = -(-H * W // F32)
    for t in range(min(B * per_image, 300)):
        b, q0 = divmod(t, per_image)
        q = np.arange(q0 * F32, min(q0 * F32 + F32, H * W))
        assert tconv.tile_keys(t, H, W, F32) == (b * (H + 2) + q.min() // W,
                                                 b * (H + 2) + q.max() // W + 2)
    for tiles in (1, 2, 4):
        assert tconv.ring_rows(B, H, W, tiles) == tconv.ring_rows(B, H, W, tiles, 64)


def test_f32_ring_rows():
    """The rows 1 / 2 / 4 consecutive 128-pixel tiles read: 5 / 8 / 10 at W = 100
    (eight where two tiles straddle two images), 7 / 11 / 18 at W = 37, 4 / 6 / 7
    at W = 300 (two tiles across images need 6)."""
    for (B, H, W), rows in (((32, 320, 100), (5, 8, 10)), ((3, 13, 37), (7, 11, 18)),
                            ((2, 5, 300), (4, 6, 7))):
        assert tuple(tconv.ring_rows(B, H, W, n, F32) for n in (1, 2, 4)) == rows


@pytest.mark.parametrize("shape,boxes,box_px,slots,last", [
    ((32, 320, 100, 64), 1, 104, 12, 128),   # 250 tiles an image, none ragged
    ((4, 2400, 100, 64), 1, 104, 12, 128),   # the serving request's stage-1 shape
    ((3, 13, 37, 7), 1, 40, 32, 97),         # 481 pixels: 3 tiles and one of 97
    ((3, 13, 37, 64), 1, 40, 32, 97),
    ((3, 13, 37, 80), 1, 40, 32, 97),        # C > 64: 64 channels of weights resident
    ((2, 5, 300, 7), 2, 152, 4, 92),         # 302 pixels a row: two boxes of 152
    ((2, 5, 300, 64), 2, 152, 4, 92),
    ((2, 5, 300, 80), 2, 152, 4, 92),
])
def test_f32_plan(shape, boxes, box_px, slots, last):
    """The f32 plan: B ceil(H W / 128) tiles, an image's last ragged where H W %
    128 != 0; a ring row of W + 2 pixels in whole boxes of a multiple of 8 pixels
    (<= TMA's 256); all the slots the shared memory leaves beside 147,456 B of
    weights, the same at every C; and a tile's rows fit."""
    B, H, W, C = shape
    plan = tconv.f32_plan(B, H, W, C)
    per_image = -(-H * W // F32)
    assert plan.tiles == B * per_image and H * W - (per_image - 1) * F32 == last
    assert (plan.boxes, plan.box_px, plan.slots) == (boxes, box_px, slots)
    assert plan.box_px % 8 == 0 and plan.box_px <= tconv.TMA_BOX
    assert plan.boxes * plan.box_px >= W + 2 > (plan.boxes - 1) * tconv.TMA_BOX
    assert plan.smem_bytes == tconv.f32_smem_bytes(W, slots) <= tconv.H100_SMEM_BYTES
    assert tconv.f32_smem_bytes(W, slots + 1) > tconv.H100_SMEM_BYTES
    assert tconv.ring_rows(B, H, W, 1, F32) <= plan.slots
    assert tconv.F32_WEIGHT_BYTES == 147_456


def test_f32_plan_refusals():
    """The wrapper refuses, on both devices, only a ring that cannot hold one
    tile's rows beside the weights: at W = 500 a row is 32 KB (two boxes of 256)
    and a tile reads 4; a block given 160 KB; and W = 1 at full size runs (130
    rows of 512 B)."""
    with pytest.raises(ValueError, match=r"\(1, 2, 500, 3\) reads 4 ring rows of 32768 B.*"
                                         r"shared memory, over the 232448 B"):
        tconv.f32_plan(1, 2, 500, 3)
    with pytest.raises(ValueError, match="shared memory"):
        tconv.conv3x3_64(torch.zeros(1, 2, 500, 3), torch.zeros(3, 3, 3, 64))
    with pytest.raises(ValueError, match="over the 163840 B"):
        tconv.f32_plan(32, 320, 100, 64, 160 * 1024)
    assert tconv.f32_plan(2, 200, 1, 64).slots >= tconv.ring_rows(2, 200, 1, 1, F32) == 130


def _f32_unit(idx, j):
    """The kernel's f32_unit: 16-byte unit j of slot pixel idx."""
    return idx * 64 + ((j ^ ((idx >> 1) & 3)) << 4)


def _f32_swizzle(addr):
    """TMA's 64-byte swizzle as it writes a 512-byte-aligned slot: address bits
    4-5 XOR bits 7-8."""
    return addr ^ ((addr >> 3) & 0x30)


def _f32_rounds(block, H, W, slots):
    """The kernel's rounds over a block's tiles: (first tile, 1 or 2 tiles), two
    where both tiles' rows fit the ring together (f32_round_tiles)."""
    rounds, t = [], block.start
    while t < block.stop:
        pair = t + 1 < block.stop and (tconv.tile_keys(t + 1, H, W, F32)[1]
                                       - tconv.tile_keys(t, H, W, F32)[0] < slots)
        rounds.append((t, 2 if pair else 1))
        t += rounds[-1][1]
    return rounds


def _f32_hand_overs(block, H, W, C, slots):
    """The ring's hand-overs in one block, in the order both sides make them:
    per round and chunk a list of (slot, parity, key), key None for a slot
    passed over where the chunk's rows would wrap; the chunk's rows take
    consecutive slots."""
    slot, parity, out = 0, 0, []
    for t, nt in _f32_rounds(block, H, W, slots):
        kf, kl = tconv.tile_keys(t, H, W, F32)[0], tconv.tile_keys(t + nt - 1, H, W, F32)[1]
        for c in range(-(-C // tconv.F32_CHUNK)):
            entries = []
            keys = [None] * (slots - slot) if slot + kl - kf + 1 > slots else []
            for key in keys + list(range(kf, kl + 1)):
                entries.append((slot, parity, key))
                slot += 1
                if slot == slots:
                    slot, parity = 0, parity ^ 1
            out.append((t, nt, c, entries))
    return out


def _f32_pixels():
    """Tile pixel p of thread (warp wq of its group, pixel group pg = lane / 8,
    i): p = 32 wq + pg + 4 i. Returns (wq, pg, i) for p = 0..127."""
    p = np.arange(F32)
    return p // 32, p % 4, p % 32 // 4


def _f32_a_addresses(tile, kf, slot0, H, W, slot_bytes):
    """The consumers' A addresses (bytes into the ring) of a tile's 128 pixels
    for each (dw, j, dh), as f32_chunk computes them: poff once a tile, the
    swizzle once a column tap, an XOR a channel quad, dh slots further."""
    P, per_image = H * W, -(-H * W // F32)
    b, q0 = tile // per_image, tile % per_image * F32
    wq, pg, i = _f32_pixels()
    q = np.minimum(q0 + 32 * wq + pg + 4 * i, P - 1)
    oh, ow = q // W, q % W
    poff = (b * (H + 2) + oh - kf) * slot_bytes + ow * 64
    addr = {}
    for dw, j, dh in np.ndindex(3, 4, 3):
        v = poff + dw * 64
        z = v ^ ((v >> 3) & 0x30)
        addr[dw, j, dh] = slot0 * slot_bytes + dh * slot_bytes + (z ^ (j << 4))
    return addr


def _f32_weights_smem(w, G):
    """f32_load_weights and f32_zero_rows in numpy: [tap][64 rows][64 outputs]
    f32, channels 64 G.. copied, zeros past C up to the last chunk's end, NaN
    where nothing is written."""
    C = w.shape[2]
    ws = np.full((9, 64, 64), np.nan, np.float32)
    rows = min(64, C - 64 * G)
    ws[:, :rows] = w.reshape(9, C, 64)[:, 64 * G:64 * G + rows]
    ws[:, rows:min(64, 16 * -(-C // 16) - 64 * G)] = 0.0
    return ws.reshape(-1)


@pytest.mark.parametrize("shape", [(2, 8, 10, 7), (3, 13, 37, 80), (1, 7, 100, 64),
                                   (2, 5, 300, 8), (5, 3, 11, 20)])
def test_f32_smem_layout(shape):
    """The f32 kernel's shared memory, written as the producer writes it (TMA's
    64-byte swizzle, which the element fill's f32_unit matches) and read back by
    the addresses the consumers compute, gives the conv: every block's rounds and
    ring hand-overs (passed-over slots included) over its tiles, each chunk's rows
    in their slots (the rest NaN), the resident weights of the chunk's 64-channel
    group by the B addresses of each lane; the GEMM over them equals the float64
    conv, and so does the wrapper's output on the CPU."""
    B, H, W, C = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((3, 3, C, 64)).astype(np.float32)
    plan = tconv.f32_plan(B, H, W, C)
    slot_px = plan.boxes * plan.box_px
    slot_bytes = slot_px * 64
    P, per_image = H * W, -(-H * W // F32)
    idx, ch = np.meshgrid(np.arange(slot_px), np.arange(16), indexing="ij")
    np.testing.assert_array_equal(_f32_swizzle(idx * 64 + ch * 4),
                                  _f32_unit(idx, ch // 4) + ch % 4 * 4)
    out = np.full((B, P, 64), np.nan)
    for block in _block_tiles(plan.tiles, min(plan.tiles, 132)):
        ring = np.full(plan.slots * slot_bytes // 4, np.nan, np.float32)
        for t, nt, c, entries in _f32_hand_overs(block, H, W, C, plan.slots):
            for slot, _, key in entries:
                ring[slot * slot_bytes // 4:(slot + 1) * slot_bytes // 4] = np.nan
                if key is None:
                    continue
                b, h = divmod(key, H + 2)
                h, col, chan = h - 1, idx - 1, 16 * c + ch
                inside = (0 <= h < H) & (col >= 0) & (col < W) & (chan < C)
                vals = np.where(inside, x[b, min(max(h, 0), H - 1), np.clip(col, 0, W - 1),
                                          np.minimum(chan, C - 1)],
                                0.0)
                ring[(slot * slot_bytes + _f32_swizzle(idx * 64 + ch * 4)) // 4] = vals
            kf, slot0 = tconv.tile_keys(t, H, W, F32)[0], [e for e in entries if e[2] is not None][0][0]
            ws = _f32_weights_smem(w, c // 4)
            lc, h2, e4 = np.meshgrid(np.arange(8), np.arange(2), np.arange(4), indexing="ij")
            for tile in range(t, t + nt):
                addr = _f32_a_addresses(tile, kf, slot0, H, W, slot_bytes)
                b, q0 = divmod(tile, per_image)
                q0 *= F32
                if c == 0:
                    out[b, q0:q0 + F32] = 0.0
                acc = np.zeros((F32, 64))
                for dw, j, dh in np.ndindex(3, 4, 3):
                    a = ring[addr[dw, j, dh][:, None] // 4 + np.arange(4)]  # (pixel, k)
                    wc = lc * 16 + c % 4 * 16 * 256
                    bm = np.empty((4, 64))
                    for k in range(4):
                        byte = wc + (dh * 3 + dw) * 16384 + 4 * j * 256 + k * 256 + h2 * 128
                        bm[k, (4 * lc + 32 * h2 + e4).ravel()] = ws[(byte // 4 + e4).ravel()]
                    acc += a.astype(np.float64) @ bm
                valid = min(F32, P - q0)
                out[b, q0:q0 + valid] += acc[:valid]
    want = torch.nn.functional.conv2d(torch.from_numpy(x).double().permute(0, 3, 1, 2),
                                      torch.from_numpy(w).double().permute(3, 2, 0, 1),
                                      padding=1).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out.reshape(B, H, W, 64), want, atol=1e-10)
    got = tconv.conv3x3_64(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def _bank_ways(word_addrs):
    """The most distinct 4-byte words one bank serves in a warp's access (1:
    conflict-free, broadcasts aside)."""
    banks = {}
    for a in np.asarray(word_addrs).ravel():
        banks.setdefault(int(a) % 32, set()).add(int(a))
    return max(len(v) for v in banks.values())


@pytest.mark.parametrize("shape,ways", [((32, 320, 100, 64), 1), ((4, 2400, 100, 64), 1),
                                        ((3, 13, 37, 64), 1), ((2, 5, 300, 64), 1),
                                        ((2, 8, 10, 64), 2)])
def test_f32_bank_conflicts(shape, ways):
    """One warp's 16-byte shared loads, lane by lane as f32_chunk issues them:
    the A load of pixel i reads 4 consecutive pixels (pg = 0..3, broadcast over
    the 8 output lanes), which the 64-byte swizzle puts on 4 distinct banks
    groups, and each B load 128 contiguous bytes (lc = 0..7, broadcast over pg).
    Conflict-free at W = 100 (the stage-1 and serving shapes; 128 x 25 pixels
    are 32 rows, so the first 25 tiles and those across an image boundary hold
    every case), 37 and 300; at W = 10 a quad of pixels that wraps into the next
    image row can land two on one bank group (2-way)."""
    B, H, W, C = shape
    plan = tconv.f32_plan(B, H, W, C)
    slot_bytes = plan.boxes * plan.box_px * 64
    per_image = -(-H * W // F32)
    worst = 1
    lane = np.arange(32)
    pg, lc = lane // 8, lane % 8
    for tile in sorted({*range(min(26, B * per_image)),
                        *range(per_image - 2, min(per_image + 2, B * per_image))}):
        kf = tconv.tile_keys(tile, H, W, F32)[0]
        addr = _f32_a_addresses(tile, kf, 0, H, W, slot_bytes)
        for (dw, j, dh), a in addr.items():
            for wq, i in np.ndindex(4, 8):
                lanes = a[32 * wq + pg + 4 * i]  # lane (pg, lc) reads pixel 32 wq + pg + 4 i
                worst = max(worst, _bank_ways(lanes[:, None] // 4 + np.arange(4)))
    assert worst == ways
    for tap, j, k, h in np.ndindex(9, 4, 4, 2):  # B: the weights' row 4 j + k of a tap
        byte = lc * 16 + tap * 16384 + (4 * j + k) * 256 + h * 128
        assert _bank_ways(byte[:, None] // 4 + np.arange(4)) == 1


def _f32_walk_block(block, H, W, C, slots, rng):
    """The f32 ring's hand-over in one block run as coroutines in a seeded random
    order: the producer fills each entry once every consumer warp released the
    slot's previous use; each of the 8 consumer warps waits for a round chunk's
    entries (passed-over slots too), checks that its tile's rows are there,
    computes, and releases them all; at C > 64 both groups meet at every
    64-channel boundary (the weights' refill). Returns the tiles computed;
    raises on a deadlock or a wrong row."""
    warps = tconv.F32_GROUPS * 4
    seq = _f32_hand_overs(block, H, W, C, slots)
    ring, filled, released, met, computed = {}, set(), {}, {}, []
    flat = [e for *_, entries in seq for e in entries]

    def producer():
        uses = {}
        for slot, parity, key in flat:
            n = uses.get(slot, 0)
            if n:
                yield lambda s=slot, n=n: released.get((s, n - 1), 0) == warps
            ring[slot] = key
            filled.add((slot, n))
            uses[slot] = n + 1

    def consumer(warp):
        uses, g = {}, warp // 4
        for r, (t, nt, c, entries) in enumerate(seq):
            if C > 64 and c % 4 == 0:
                met[r] = met.get(r, 0) + 1
                yield lambda r=r: met[r] == warps
            use = []
            for slot, _, key in entries:
                use.append((slot, uses.get(slot, 0), key))
                uses[slot] = use[-1][1] + 1
            yield lambda use=use: all((s, n) in filled for s, n, _ in use)
            if g < nt:
                lo, hi = tconv.tile_keys(t + g, H, W, F32)
                held = [ring[s] for s, _, k in use if k is not None]
                assert [k for k in held if lo <= k <= hi] == list(range(lo, hi + 1))
                assert all(ring[s] == k for s, _, k in use)
                if warp % 4 == 0 and c == 0:
                    computed.append(t + g)
            for s, n, _ in use:
                released[s, n] = released.get((s, n), 0) + 1

    agents = {i: (a, None) for i, a in enumerate([producer()] +
                                                 [consumer(k) for k in range(warps)])}
    while agents:
        ready = [i for i, (_, cond) in agents.items() if cond is None or cond()]
        assert ready, f"the f32 ring's hand-over deadlocked in tiles {block}"
        i = ready[rng.integers(len(ready))]
        try:
            agents[i] = (agents[i][0], next(agents[i][0]))
        except StopIteration:
            del agents[i]
    return computed


@pytest.mark.parametrize("shape,smem", [((32, 320, 100, 64), None), ((3, 13, 37, 7), None),
                                        ((3, 13, 37, 80), None), ((2, 5, 300, 64), None),
                                        ((2, 5, 300, 80), None), ((6, 9, 40, 64), 176_000),
                                        ((9, 7, 9, 128), 158_000), ((2, 150, 3, 64), None)])
def test_f32_ring_hand_over(shape, smem):
    """A Python mirror of the f32 kernel's ring: every block's rounds (two tiles
    where their rows fit together, as across images at W = 300 they do not)
    cover its tiles once; each round chunk's rows take consecutive slots, the
    ring's last slots passed over where they would wrap; and the hand-over runs
    to its end without a deadlock, resident and in lockstep (C > 64), also in
    rings cut to a few slots more than a tile's rows."""
    B, H, W, C = shape
    plan = tconv.f32_plan(B, H, W, C, *([smem] if smem else []))
    rng = np.random.default_rng(sum(shape))
    blocks = _block_tiles(plan.tiles, min(plan.tiles, 132))
    for block in blocks[:6] + blocks[-3:]:
        rounds = _f32_rounds(block, H, W, plan.slots)
        assert [t + k for t, n in rounds for k in range(n)] == list(block)
        for t, nt, c, entries in _f32_hand_overs(block, H, W, C, plan.slots):
            rows = [s for s, _, k in entries if k is not None]
            assert rows == list(range(rows[0], rows[0] + len(rows))) and rows[-1] < plan.slots
        assert sorted(_f32_walk_block(block, H, W, C, plan.slots, rng)) == list(block)

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
    with pytest.raises(ValueError, match="shared memory"):
        tconv.conv3x3_64(torch.zeros(1, 2, 500, 3), w)   # f32 rows of 32 KB: 2 slots for 4
    with pytest.raises(ValueError):
        tconv.conv3x3_64(x.to("meta"), w.to("meta"))     # neither cuda nor cpu
    with pytest.raises(ValueError):
        tconv.conv3x3_64(x, w.to("meta"))                # two devices


def test_probe_main_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        tconv.main(["--batch", "1"])


def test_bench_conv3x3_variants_name_the_kernels_macros():
    """bench_conv3x3's variants set the f32 kernel's own K4_* macros: the unroll
    depth the source defines and checks (1, 3, 12 or 36 steps, 3 by default)."""
    name, defines = timing.parse_variant("u36=K4_F32_UNROLL=36", "K4_")
    assert name == "u36" and defines == ["-DK4_F32_UNROLL=36"]
    src = (bench_conv3x3.CSRC_DIR / "conv3x3_64.cu").read_text()
    assert "#ifndef K4_F32_UNROLL\n#define K4_F32_UNROLL 3\n" in src
    assert "K4_F32_UNROLL == 1 || K4_F32_UNROLL == 3 || K4_F32_UNROLL == 12" in src
    for bad in ("u36", "u=", "u=K1_BLOCK=256", "u=K4_F32_UNROLL"):
        with pytest.raises(ValueError):
            timing.parse_variant(bad, "K4_")
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            bench_conv3x3.main([])
