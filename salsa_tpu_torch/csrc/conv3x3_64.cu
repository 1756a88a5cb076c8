// K4: NHWC 3x3 SAME convolution with 64 output channels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scripts/probe_pallas_conv.py:90
// paired_conv_pallas.kernel (pallas_call at :115), the probe of a hand-written
// stage-1 conv of the CRNN:
//   out[b, h, w, o] = sum_{dh, dw, c} x[b, h+dh-1, w+dw-1, c] * w[dh, dw, c, o]
// with zeros outside the image, f32 accumulation, stored in the input's type
// (f32 or bf16). The TPU kernel packs pairs of output positions into one
// 128-lane row to fill the MXU; that packing exists for the TPU's matrix unit
// and is not carried over: x keeps the JAX layout (NHWC), w HWIO.
//
// bf16: a persistent, warp-specialised implicit GEMM on wgmma. M = output
// pixels, N = 64 outputs, K = 9 taps x C channels; A[m][k] = x[b, h+dh-1,
// col+dw-1, c], B[k][n] = w[dh, dw, c, n], an f32 sum in registers rounded once.
// What bounds it on the H100: at the stage-1 training shape (B=32, 320 x 100,
// C=64) the conv is 75.5 GFLOP against 262 MB moved (x in, out back), ~290
// flop/B, at the ridge of the bf16 tensor cores (~295): 0.078 ms by bytes,
// 0.076 ms by operations. The design before this one (mma.sync m16n8k16, one
// block per 8 rows x 32 columns) reached 13 % of that, held back by (1)
// synchronous fills: every block loaded its 73.7 KB of weights and its input
// tile and only then computed; (2) shared-memory bytes per mma: ~192 B of 32-bit
// fragment loads per m16n8k16; (3) idle columns: column tiles of 32 at W = 100
// computed 128 columns, 22 % masked. This design answers them so:
// - A persistent block per SM (grid min(tiles, SMs)) walks a contiguous range of
//   output tiles, so consecutive tiles share their input rows. One producer warp
//   (of a producer warpgroup, which setmaxnreg shrinks to 40 registers a thread)
//   feeds two consumer warpgroups (grown to 232). The consumers take the block's
//   tiles in turns of two consecutive tiles each, so one's bookkeeping and
//   stores overlap the other's wgmma, and each turn's waits, releases and index
//   arithmetic are paid once for two tiles.
// - (3) A tile is 64 consecutive pixels of one image in row-major (h, w) order,
//   the M of one wgmma m64n64k16: at 320 x 100 an image is exactly 500 tiles and
//   nothing is masked; only the last tile of an image with H*W % 64 != 0 is.
// - (1) The weights are loaded once, at the block's start, into shared memory
//   in wgmma's K-major B layout with the 128-byte swizzle: tap t, output n,
//   channel c at t * 8192 + n * 128 + ((c / 8) ^ (n % 8)) * 16 + (c % 8) * 2,
//   73,728 B; a k16 step advances the descriptor by 32 B inside the swizzle atom.
//   The input comes through a ring of image rows: the producer issues one TMA
//   load (cp.async.bulk.tensor, CU_TENSOR_MAP_SWIZZLE_128B) per row of 64
//   channels x (W + 2) pixels starting at column -1, so TMA's out-of-bounds zero
//   fill gives the halo columns -1 and W and the rows -1 and H. A slot is aligned
//   to 1024 B (13,312 B at W = 100); full and empty mbarriers hand each slot over
//   (expect_tx with the box's bytes). The block is alone on its SM, so the ring
//   takes all the shared memory the weights leave (11 slots at W = 100, 221 KB
//   with the weights); the wrapper refuses a shape where that is fewer than the
//   rows the two consumers' turns read plus one in flight.
// - (2) A tap's A operand is a window of the ring shifted by (dh, dw) pixels,
//   which breaks the alignment a shared-memory descriptor needs, so each consumer
//   loads A with ldmatrix.x4 (per-lane row addresses with the TMA swizzle's XOR,
//   free of bank conflicts) and issues wgmma.mma_async m64n64k16 with A from
//   registers and B from the resident weights: 36 wgmma a tile at C <= 64, A
//   double-buffered a tap ahead (wait_group 1). Each wgmma reads 2 KB of A (by
//   ldmatrix) and 2 KB of B from shared memory for 64 x 64 x 16 MACs, the SM's
//   128 B/clk at the dense tensor rate: shared memory, not the tensor cores,
//   caps this design.
// - Epilogue: each lane rounds its f32 sums to bf16 pairs, a 4 x 4 transpose of
//   words within each quad (shuffles) gives it whole 16-byte chunks of its
//   pixels, and it stores them, masking the pixels past H * W of a ragged last
//   tile. No shared memory and no barrier: a TMA store from a staging buffer,
//   one in flight a consumer, held the writes near 1.25 TB/s and doubled the
//   kernel's time.
// Rows are released by warp: a consumer warp arrives on a row's empty barrier
// once no later turn of its own reads it (after waiting for the row to have
// arrived), so every row is released by every consumer warp exactly once; each
// warp keeps its place in the ring (key, slot, parity) as running cursors.
// C > 64: the ring rows hold every 64-channel chunk (one TMA a chunk; the chunk
// past C is zero-filled by TMA, e.g. channels 80-127 at C = 80), but the weights
// of a second chunk cannot stay resident: the consumers refill the one weight
// buffer per chunk and turn, in lockstep (a named barrier over both warpgroups).
// C % 8 != 0 (e.g. C = 7, 14 B a pixel): TMA needs 16-byte global strides, so
// the producer warp fills the same swizzled slot layout with element loads
// (zeros past C and outside the image). Both branches are chosen by shape, and
// every chunk runs all 4 k16 steps (zero channels add nothing).
//
// f32: a persistent FFMA implicit GEMM on the fp32 CUDA cores (tensor cores
// would mean TF32, ~3 decimal digits). What bounds it on the H100: at the
// stage-1 shape the conv is 75.5 GFLOP of FFMA against 524 MB moved, 1.13 ms at
// the 67 TFLOP/s fp32 rate against 0.16 ms by bytes: the FFMA issue rate, 128
// lanes a clock on each SM. The design before this one (a block per 8 rows x 32
// columns, 128 registers, two blocks an SM) reached 30 % of that, held back by
// (1) idle columns: 32-column tiles at W = 100 computed 128 columns, 22 %
// masked; (2) the weights refilled every block: each of 5,120 blocks loaded all
// 147 KB of them and its input tile 16 channels at a time, in element loops that
// divided by the run-time chunk width, synchronously (two __syncthreads a
// chunk), ~10^4 non-FMA instructions a thread against 36,864 FFMAs; (3) narrow
// reuse: a thread's one column x 8 outputs fed each input value to at most 24
// FFMAs. This design answers them so:
// - (1) A persistent block per SM (grid min(tiles, SMs)) walks a contiguous range
//   of tiles of 128 consecutive pixels of one image in row-major (h, w) order x
//   all 64 outputs: 250 tiles an image at 320 x 100, none masked; only the last
//   tile of an image with H W % 128 != 0 is. The tile walk and the ring's row
//   keys are the bf16 kernel's (tile_first_key / tile_last_key) at this tile.
// - (2) The weights (9 x 64 x 64 f32, HWIO order, 147,456 B) are loaded once a
//   block by nine bulk copies (cp.async.bulk, one a tap) and stay resident. The
//   84,992 B they leave hold 3 image rows of 64 f32 channels, too few, so the
//   ring holds 16-channel chunks of image rows: W + 2 pixels from column -1 at
//   64 B each, rounded up to whole TMA boxes of a multiple of 8 pixels (12
//   slots of 6,656 B at W = 100; a row over 256 pixels takes several boxes).
//   One producer warp fills it with TMA (cp.async.bulk.tensor, 64-byte swizzle,
//   zero fill for the halo rows and columns) and full/empty mbarriers hand each
//   slot over, with the bf16 path's helpers and its trap on a wait that does
//   not end. C % 4 != 0 (16-byte global strides) or an x off 16 bytes: the
//   producer fills the same layout with element loads.
// - Two consumer groups of four warps take a round of two consecutive tiles, a
//   tile each, chunk by chunk: a round's chunk is the rows both tiles read (5-8
//   at W = 100) in consecutive slots, so a tile's rows lie one slot apart and a
//   tap is a constant shift; where they would wrap, the slots left at the ring's
//   end are passed over (an empty hand-over). Where two tiles' rows do not fit
//   the ring together (across images at W = 300) a round is one tile.
// - (3) A warp computes 32 pixels x 64 outputs, a thread 8 pixels (32 w + pg +
//   4 i, pg = lane / 8) x 8 outputs (4 lc.. and 32 + 4 lc.., lc = lane % 8), 64
//   accumulators: per 4 channels of a tap it loads 8 A and 8 B values of 16
//   bytes and issues 256 FFMAs. The 8 lanes of a pixel group read one A address
//   and the 4 groups of an output lane one B address (broadcasts); the 8 lanes
//   of a group read 128 contiguous B bytes. The A loads of a warp read 4
//   consecutive pixels, which the 64-byte swizzle (16-byte unit j of pixel idx
//   at idx * 64 + ((j ^ (idx / 2 % 4)) << 4)) puts on distinct banks. Pixel
//   offsets are computed once a tile; the swizzle once a pixel and column tap,
//   an XOR a channel quad; no division in the loop. A chunk's 36 steps (3 dw x
//   4 j x 3 dh) run as a loop of 3-step bodies (K4_F32_UNROLL): unrolled whole,
//   a chunk is ~12,500 instructions (200 KB), more than the instruction cache
//   holds, and the kernel ran 2.4x slower.
// What still holds it back: an LDS.128 returns 512 B to the warp whatever it
// broadcasts, so 16 of them a 256-FFMA step ask shared memory for its whole 128
// B/clk at the FFMA rate; the two contend. A larger register tile or reuse of A
// across column taps would cut that.
// - Epilogue: each thread stores its 8 pixels' 8 outputs as two 16-byte stores
//   each (a warp's store writes 4 whole 128-byte lines), masking pixels past H W.
// C > 64: 64 channels of weights stay resident at a time; the consumers refill
// them (bulk copies) at each 64-channel boundary of every round, both groups in
// lockstep (a named barrier). Channels past C in the last chunk are zeros in
// the ring (TMA's fill) and in the weights.
#include <cuda.h>  // CUtensorMap and the driver's enums; the entry point comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kOut = 64;

// ------------------------------------ bf16: persistent, warp-specialised wgmma

using bf16 = __nv_bfloat16;
constexpr int kTile = 64;                    // output pixels a tile: wgmma's M
constexpr int kPixelBytes = 128;             // one pixel's 64-channel chunk, one swizzle row
constexpr int kTapBytes = kOut * 128;        // one tap's B operand: 64 n-rows x 128 B
constexpr int kWeightBytes = 9 * kTapBytes;  // 73,728
constexpr int kTurn = 2;  // consecutive tiles a consumer takes at a time (the wrapper's TURN)
constexpr int kConsumers = 2;  // consumer warpgroups a block (the wrapper's CONSUMERS)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr long long kWaitCycles = 1ll << 34;  // ~9 s at the H100's clock

// Bytes of one 64-channel chunk of an image row in the ring: W + 2 pixels
// (columns -1..W), aligned to the 128-byte swizzle's 1024-byte atom.
__host__ __device__ constexpr int ring_row_bytes(int W) {
  return ((W + 2) * kPixelBytes + 1023) / 1024 * 1024;
}
__host__ __device__ constexpr int chunks(int C) { return (C + 63) / 64; }

// Dynamic shared memory: 1024 B of alignment slack, the weights, the ring, a
// full and an empty mbarrier a slot.
constexpr size_t wgmma_smem_bytes(int W, int C, int slots) {
  return 1024 + kWeightBytes + static_cast<size_t>(slots) * (chunks(C) * ring_row_bytes(W) + 16);
}

// The ring's rows: key(b, h) = b * (H + 2) + h + 1 for h = -1..H, so the rows
// that a contiguous range of tiles reads are a contiguous range of keys. A tile
// is `tile` consecutive pixels of one image (bf16: 64, f32: 128).
__device__ __forceinline__ int tile_first_key(int t, int H, int W, int tiles_per_image,
                                              int tile = kTile) {
  const int b = t / tiles_per_image, q0 = t % tiles_per_image * tile;
  return b * (H + 2) + q0 / W;  // row q0 / W - 1
}
__device__ __forceinline__ int tile_last_key(int t, int H, int W, int tiles_per_image,
                                             int tile = kTile) {
  const int b = t / tiles_per_image, q0 = t % tiles_per_image * tile;
  return b * (H + 2) + (min(q0 + tile, H * W) - 1) / W + 2;  // row (last pixel) / W + 1
}

// A place in the ring: a row key, its slot (key - k0) % slots and the parity of
// that slot's use, ((key - k0) / slots) % 2, stepped without dividing.
struct RingCursor {
  int key, slot;
  uint32_t parity;
  __device__ __forceinline__ void step(int slots) {
    ++key;
    if (++slot == slots) slot = 0, parity ^= 1;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// Wait for the completion of the barrier's phase of this parity. A wait that has
// not ended after kWaitCycles traps, so a broken hand-over faults the launch
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

// TMA: one chunk of an image row (64 channels x W + 2 pixels from column -1)
// into a ring slot.
__device__ __forceinline__ void tma_load_row(uint32_t dst, const CUtensorMap* map, int c, int col,
                                             int h, int b, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(col), "r"(h), "r"(b), "r"(bar)
      : "memory");
}
// generic-proxy writes to shared memory made visible to wgmma
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// wgmma shared-memory descriptor of a K-major operand with the 128-byte swizzle:
// rows of 128 B, 8-row groups 1024 B apart (SBO), LBO unused (1).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across a wgmma
// fence or wait
__device__ __forceinline__ void fence_accumulators(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64 f32, the warpgroup's accumulators) += a (64 x 16 bf16, registers,
// m16n8k16's A fragments, 16 rows a warp) * b (16 x 64 bf16, K-major in shared
// memory). d[4j + 2r + e] = D[16 warp + lane / 4 + 8 r][8 j + 2 (lane % 4) + e].
// scale-d is 1 (accumulate: a tile's sums start at zero); A and B unscaled, B
// not transposed (K-major).
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t b_desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b_desc), "r"(1));
}

// 32-bit word q (0..3) of a uint4
__device__ __forceinline__ uint32_t word(const uint4& v, int q) {
  switch (q) {
    case 0: return v.x;
    case 1: return v.y;
    case 2: return v.z;
    default: return v.w;
  }
}

// The weights of channels c0..c0+63 of HWIO w (3, 3, C, 64) into `ws` in the B
// layout above, zeros past C. A unit is 8 channels x 8 outputs: eight 16-byte
// loads (a channel's 8 outputs each), an 8 x 8 transpose in registers, eight
// 16-byte stores (an output's 8 channels each).
__device__ void fill_weights(uint8_t* ws, const bf16* __restrict__ w, int C, int c0, int tid,
                             int nthreads) {
  for (int u = tid; u < 9 * 8 * 8; u += nthreads) {
    const int ng = u % 8, j = u / 8 % 8, tap = u / 64;
    uint4 r[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = c0 + 8 * j + e;
      r[e] = c < C ? *reinterpret_cast<const uint4*>(w + (static_cast<long long>(tap) * C + c) *
                                                             kOut + 8 * ng)
                   : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const uint32_t sel = n % 2 ? 0x7632 : 0x5410;  // the high or the low bf16 of each word
      const uint4 col = make_uint4(__byte_perm(word(r[0], n / 2), word(r[1], n / 2), sel),
                                   __byte_perm(word(r[2], n / 2), word(r[3], n / 2), sel),
                                   __byte_perm(word(r[4], n / 2), word(r[5], n / 2), sel),
                                   __byte_perm(word(r[6], n / 2), word(r[7], n / 2), sel));
      *reinterpret_cast<uint4*>(ws + tap * kTapBytes + (8 * ng + n) * 128 + ((j ^ n) << 4)) = col;
    }
  }
}

// One 64-channel chunk of a turn's two tiles: 9 taps x 4 k16 steps x 2 tiles,
// the two tiles' wgmma sharing each B descriptor. rows[i][dh] is the shared
// address of this lane's A row of tile i (its output pixel's input row h + dh -
// 1, column ow - 1) in the ring; ldmatrix.x4's four 8 x 8 matrices are rows 0-7
// and 8-15 of the warp's 16 x k0-7, then x k8-15 (lane / 8 picks them). A is
// double-buffered a tap ahead: wait_group 1 retires tap t - 1 before its
// registers are loaded for tap t + 1.
__device__ __forceinline__ void turn_chunk(float (&acc)[kTurn][32],
                                           const uint32_t (&rows)[kTurn][3],
                                           const int (&ow)[kTurn], int khalf, uint32_t ws) {
  uint32_t a[2][kTurn][4][4];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int dh = tap / 3, dw = tap % 3;
#pragma unroll
    for (int i = 0; i < kTurn; ++i) {
      const uint32_t swz = (ow[i] + dw) & 7;  // the pixel's row in the swizzle atom
      const uint32_t base = rows[i][dh] + dw * kPixelBytes;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        ldmatrix_x4(a[tap & 1][i][s], base + (((2 * s + khalf) ^ swz) << 4));
      }
    }
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint64_t desc = sw128_desc(ws + tap * kTapBytes + s * 32);
#pragma unroll
      for (int i = 0; i < kTurn; ++i) wgmma_64x64x16(acc[i], a[tap & 1][i][s], desc);
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < kTurn; ++i) fence_accumulators(acc[i]);
}

// v[idx] of four values for an index known only at run time, by selects (a
// register array indexed at run time would live in local memory)
__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], int idx) {
  const uint32_t lo = idx & 1 ? v[1] : v[0], hi = idx & 1 ? v[3] : v[2];
  return idx & 2 ? hi : lo;
}

// One tile's outputs from the accumulators, 16 B a store. A lane (row r = lane
// / 4 of its warp's 16, quad lane q = lane % 4) holds outputs 8 j + 2 q, + 1 of
// pixels r and r + 8 for j = 0..7 as bf16 pairs; a 4 x 4 transpose of those
// words within the quad (shuffles) gives it outputs 8 j .. 8 j + 7 for j = q and
// q + 4: two 16-byte chunks of each of its pixels, stored whole. A pixel past
// H W (a ragged last tile) is not stored.
__device__ __forceinline__ void store_tile(const float (&acc)[32], bf16* __restrict__ orow,
                                           int q0, int P, int warp_row, int lane) {
  const int r = lane / 4, q = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = warp_row + r + 8 * half;
#pragma unroll
    for (int jg = 0; jg < 2; ++jg) {  // words j = 4 jg .. 4 jg + 3
      uint32_t mine[4], got[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * jg + k;
        const __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * j + 2 * half],
                                                       acc[4 * j + 2 * half + 1]);
        mine[k] = *reinterpret_cast<const uint32_t*>(&v);
      }
      // round k: lane q reads lane q ^ k's word for j = 4 jg + q, which that lane
      // picks by its own quad index: got[k] = word q of lane q ^ k
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t send = pick4(mine, q ^ k);
        got[k] = k == 0 ? send : __shfl_xor_sync(0xffffffffu, send, k);
      }
      // the chunk's words in order of their source lane: lane s's is got[s ^ q]
      const uint4 chunk = make_uint4(pick4(got, q), pick4(got, 1 ^ q), pick4(got, 2 ^ q),
                                     pick4(got, 3 ^ q));
      if (q0 + m < P) {
        *reinterpret_cast<uint4*>(orow + static_cast<long long>(m) * kOut + 8 * (4 * jg + q)) =
            chunk;
      }
    }
  }
}

// x: (B, H, W, C); w: (3, 3, C, 64); out: (B, H, W, 64), all bf16. kConsumers
// consumer warpgroups (warps 0..7) and a producer warpgroup whose first warp
// produces; its other three only give their registers up (setmaxnreg moves
// registers within a block: at 168 a thread at launch, the producer
// warpgroup's 128 x 128 freed are the two consumers' 256 x 64 taken). Block i owns
// tiles [i tiles / grid, (i + 1) tiles / grid), taken kTurn at a time by the
// consumers in turn. xmap (C % 8 == 0): (C, W, H, B), box (64, W + 2, 1, 1),
// 128-byte swizzled.
__global__ void __launch_bounds__((kConsumers + 1) * 128, 1)
    conv3x3_64_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const bf16* __restrict__ x,
                            const bf16* __restrict__ w, bf16* __restrict__ out, int H, int W, int C,
                            int tiles, int slots, int use_tma) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - smem_addr(smem_raw) % 1024) % 1024);
  uint8_t* ws = smem;
  uint8_t* ring = ws + kWeightBytes;
  const int n_chunks = chunks(C), row_bytes = ring_row_bytes(W), slot_bytes = n_chunks * row_bytes;
  const uint32_t full = smem_addr(ring + static_cast<size_t>(slots) * slot_bytes);  // + 8 s
  const uint32_t empty = full + 8 * slots;
  const int P = H * W, per_image = (P + kTile - 1) / kTile;
  const int t0 = static_cast<long long>(blockIdx.x) * tiles / gridDim.x;
  const int t1 = static_cast<long long>(blockIdx.x + 1) * tiles / gridDim.x;
  const int k0 = tile_first_key(t0, H, W, per_image);
  const int k1 = tile_last_key(t1 - 1, H, W, per_image);

  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(full + 8 * s, use_tma ? 1 : 32);  // the producer's expect_tx, or its 32 lanes
      mbar_init(empty + 8 * s, kConsumers * 4);   // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (n_chunks == 1) fill_weights(ws, w, C, 0, threadIdx.x, blockDim.x);  // resident
  fence_async_shared();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kConsumers * 4) {
    // ---- producer: rows k0..k1 in order, row k into slot (k - k0) % slots
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp > kConsumers * 4) return;
    for (RingCursor row{k0, 0, 0}; row.key <= k1; row.step(slots)) {
      const int k = row.key, slot = row.slot, b = k / (H + 2), h = k % (H + 2) - 1;
      uint8_t* dst = ring + static_cast<size_t>(slot) * slot_bytes;
      if (use_tma) {
        if (lane == 0) {
          mbar_wait(empty + 8 * slot, row.parity ^ 1);
          mbar_arrive_expect_tx(full + 8 * slot, n_chunks * (W + 2) * kPixelBytes);
          for (int c = 0; c < n_chunks; ++c) {
            tma_load_row(smem_addr(dst + c * row_bytes), &xmap, 64 * c, -1, h, b, full + 8 * slot);
          }
        }
      } else {
        // C % 8 != 0: element loads into the layout TMA would have written
        mbar_wait(empty + 8 * slot, row.parity ^ 1);
        const int units = n_chunks * (W + 2) * 8;
        for (int u = lane; u < units; u += 32) {
          const int c = u / ((W + 2) * 8), p = u / 8 % (W + 2), j = u % 8, col = p - 1;
          const bool inside = h >= 0 && h < H && col >= 0 && col < W;
          const bf16* src = x + ((static_cast<long long>(b) * H + h) * W + col) * C;
          uint32_t v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int ch = 64 * c + 8 * j + 2 * q;
            const uint32_t lo = inside && ch < C ? __bfloat16_as_ushort(src[ch]) : 0;
            const uint32_t hi = inside && ch + 1 < C ? __bfloat16_as_ushort(src[ch + 1]) : 0;
            v[q] = lo | hi << 16;
          }
          *reinterpret_cast<uint4*>(dst + c * row_bytes + p * kPixelBytes + ((j ^ (p & 7)) << 4)) =
              make_uint4(v[0], v[1], v[2], v[3]);
        }
        mbar_arrive(full + 8 * slot);
      }
    }
  } else {
    // ---- consumers: warpgroup g takes turns of kTurn tiles, starting at t0 + g kTurn
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int g = warp / 4, warp_row = 16 * (warp % 4);
    const uint32_t ring_s = smem_addr(ring), ws_s = smem_addr(ws);
    // this lane's A row of the warp's 16 (ldmatrix.x4 row addresses) and k half
    const int m = warp_row + (lane & 7) + (lane & 8);
    const int khalf = lane >> 4;
    // this warp's two places in the ring: the next row it waits for and the
    // next it releases. Each row is waited for once, by every lane (each reads
    // it), and released once, by lane 0, after it arrived: a row no tile of this
    // warpgroup reads is waited for too, so its release counts for its own use.
    RingCursor arrived{k0, 0, 0}, freed{k0, 0, 0};
    auto wait_through = [&](int last) {
      for (; arrived.key <= last; arrived.step(slots)) {
        mbar_wait(full + 8 * arrived.slot, arrived.parity);
      }
    };
    auto release_below = [&](int end) {
      wait_through(end - 1);
      __syncwarp();
      for (; freed.key < end; freed.step(slots)) {
        if (lane == 0) mbar_arrive(empty + 8 * freed.slot);
      }
      __syncwarp();
    };
    auto turn_first_key = [&](int turn) {
      const int t = t0 + turn * kTurn;
      return t < t1 ? tile_first_key(t, H, W, per_image) : k1 + 1;
    };
    release_below(turn_first_key(g));
    const int turns = (t1 - t0 + kTurn - 1) / kTurn;
    const int rounds = (turns + kConsumers - 1) / kConsumers;
    for (int turn = g; turn < rounds * kConsumers; turn += kConsumers) {
      const int tt = t0 + turn * kTurn;  // the turn's first tile
      const bool have = tt < t1;
      float acc[kTurn][32];
#pragma unroll
      for (int i = 0; i < kTurn; ++i) {
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[i][e] = 0.0f;
        fence_accumulators(acc[i]);
      }
      int b[kTurn], q0[kTurn], ow[kTurn];
      uint32_t rows[kTurn][3];
      if (have) {
        // the turn's rows are freed.key (its first, released up to) .. its last
        wait_through(tile_last_key(min(tt + kTurn, t1) - 1, H, W, per_image));
#pragma unroll
        for (int i = 0; i < kTurn; ++i) {
          const int t = min(tt + i, t1 - 1);  // a turn short of tiles repeats its last
          b[i] = t / per_image;
          q0[i] = t % per_image * kTile;
          const int q = min(q0[i] + m, P - 1);  // a masked pixel reads the last one
          const int oh = q / W;
          ow[i] = q - oh * W;
          const int offset = b[i] * (H + 2) + oh - freed.key;  // row oh - 1 from the first
#pragma unroll
          for (int dh = 0; dh < 3; ++dh) {
            const int slot = freed.slot + offset + dh;  // < 2 slots: a turn's rows fit the ring
            rows[i][dh] =
                ring_s + (slot < slots ? slot : slot - slots) * slot_bytes + ow[i] * kPixelBytes;
          }
        }
      }
      for (int c = 0; c < n_chunks; ++c) {
        if (n_chunks > 1) {  // the weights of chunk c, both warpgroups in lockstep
          named_sync(1, kConsumers * 128);
          fill_weights(ws, w, C, 64 * c, threadIdx.x, kConsumers * 128);
          fence_async_shared();
          named_sync(1, kConsumers * 128);
        }
        if (have) {
          uint32_t chunk_rows[kTurn][3];
#pragma unroll
          for (int i = 0; i < kTurn; ++i) {
#pragma unroll
            for (int dh = 0; dh < 3; ++dh) chunk_rows[i][dh] = rows[i][dh] + c * row_bytes;
          }
          turn_chunk(acc, chunk_rows, ow, khalf, ws_s);
        }
      }
      if (!have) continue;
      release_below(turn_first_key(turn + kConsumers));
#pragma unroll
      for (int i = 0; i < kTurn; ++i) {
        if (tt + i < t1) {
          store_tile(acc[i], out + (static_cast<long long>(b[i]) * P + q0[i]) * kOut, q0[i], P,
                     warp_row, lane);
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
                       cudaSuccess &&
                   found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A tensor map (bf16 with the 128-byte swizzle unless told otherwise): dims and
// box innermost first, strides in bytes of dims 1.. .
bool encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box,
            CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  EncodeTiled fn = encode_tiled();
  return fn != nullptr &&
         fn(map, type, rank, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_wgmma(const void* x, const void* w, void* out, int batch, int H, int W, int C,
                 int slots, int blocks, cudaStream_t stream) {
  const int use_tma = C % 8 == 0;
  CUtensorMap xmap{};
  const cuuint64_t P = static_cast<cuuint64_t>(H) * W;
  const cuuint64_t xdims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                               static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(batch)};
  const cuuint64_t xstrides[3] = {2ull * C, 2ull * W * C, 2ull * P * C};
  const cuuint32_t xbox[4] = {64, static_cast<cuuint32_t>(W + 2), 1, 1};
  if (use_tma && !encode(&xmap, x, 4, xdims, xstrides, xbox)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = wgmma_smem_bytes(W, C, slots);
  cudaError_t err = cudaFuncSetAttribute(conv3x3_64_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = batch * static_cast<int>((P + kTile - 1) / kTile);
  conv3x3_64_wgmma_kernel<<<blocks, (kConsumers + 1) * 128, smem, stream>>>(
      xmap, static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(out), H,
      W, C, tiles, slots, use_tma);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------- f32: persistent FFMA implicit GEMM

constexpr int kF32Tile = 128;        // output pixels a tile (the wrapper's F32_TILE)
constexpr int kF32Chunk = 16;        // input channels a ring entry (F32_CHUNK)
constexpr int kF32PixelBytes = 64;   // one pixel's chunk in the ring, the swizzle's row
constexpr int kF32Groups = 2;        // consumer groups of 4 warps, a tile each a round
constexpr int kF32Threads = (kF32Groups * 4 + 1) * 32;  // and the producer warp: 288
constexpr int kF32TapBytes = 64 * kOut * 4;              // one tap of 64 channels: 16,384
constexpr int kF32WeightBytes = 9 * kF32TapBytes;        // 147,456
constexpr int kF32Align = 512;  // the 64-byte swizzle's period: every slot starts on it

// Steps of a chunk's (dw, j, dh) loop unrolled into one loop body: 1 (dh runs),
// 3 (dh unrolled), 12 (j and dh) or 36 (the whole chunk). A step is 16 LDS.128
// and 256 FFMA, ~4.5 KB of code; the whole chunk, ~200 KB, runs out of the
// instruction cache (scripts/bench_conv3x3.py times the four).
#ifndef K4_F32_UNROLL
#define K4_F32_UNROLL 3
#endif
static_assert(K4_F32_UNROLL == 1 || K4_F32_UNROLL == 3 || K4_F32_UNROLL == 12 ||
                  K4_F32_UNROLL == 36,
              "K4_F32_UNROLL: 1, 3, 12 or 36 steps");
constexpr int kF32UnrollDw = K4_F32_UNROLL == 36 ? 3 : 1;
constexpr int kF32UnrollJ = K4_F32_UNROLL >= 12 ? 4 : 1;
constexpr int kF32UnrollDh = K4_F32_UNROLL >= 3 ? 3 : 1;

__host__ __device__ constexpr int f32_chunks(int C) { return (C + kF32Chunk - 1) / kF32Chunk; }

// Dynamic shared memory: alignment slack, the ring, the weights, a full and an
// empty mbarrier a slot and the weights' mbarrier (the wrapper's f32_smem_bytes).
constexpr size_t f32_smem_bytes(int slots, int slot_bytes) {
  return kF32Align + static_cast<size_t>(slots) * (slot_bytes + 16) + kF32WeightBytes + 8;
}

// Byte offset in a slot of the 16-byte unit holding channels 4 j..4 j + 3 of
// slot pixel idx (image column idx - 1), as TMA's 64-byte swizzle writes it:
// address bits 4-5 XOR bits 7-8.
__device__ __forceinline__ uint32_t f32_unit(int idx, int j) {
  return idx * kF32PixelBytes + ((j ^ ((idx >> 1) & 3)) << 4);
}

// The tiles of the round that starts at tile t of a block's range [.., t1): t
// and t + 1 where the rows of both fit the ring together, else t alone.
__device__ __forceinline__ int f32_round_tiles(int t, int t1, int H, int W, int per_image,
                                               int slots) {
  return t + 1 < t1 && tile_last_key(t + 1, H, W, per_image, kF32Tile) -
                               tile_first_key(t, H, W, per_image, kF32Tile) < slots
             ? 2
             : 1;
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Channels 64 G.. of every tap (64, or the C - 64 G left) into the resident
// weights, [tap][channel][output], by bulk copies that complete on `bar`.
__device__ void f32_load_weights(uint32_t ws, const float* __restrict__ w, int C, int G,
                                 uint32_t bar) {
  const int rows = min(64, C - 64 * G);
  mbar_arrive_expect_tx(bar, 9 * rows * kOut * 4);
  for (int tap = 0; tap < 9; ++tap) {
    bulk_copy(ws + tap * kF32TapBytes, w + (static_cast<long long>(tap) * C + 64 * G) * kOut,
              rows * kOut * 4, bar);
  }
}

// Zeros in the weight rows past C that the last chunk reads (C % 16 != 0): the
// ring's zeros there must not meet a NaN.
__device__ void f32_zero_rows(uint8_t* ws, int C, int G, int tid, int nthreads) {
  const int r0 = min(64, C - 64 * G), r1 = min(64, kF32Chunk * f32_chunks(C) - 64 * G);
  const int units = (r1 - r0) * 16;  // 16-byte units past row r0 of a tap
  for (int u = tid; u < 9 * units; u += nthreads) {
    *reinterpret_cast<float4*>(ws + u / units * kF32TapBytes + r0 * kOut * 4 + u % units * 16) =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// One 16-channel chunk of image row h into a slot in the layout TMA writes, by a
// warp's element loads (zeros outside the image and past C): for the x that TMA
// cannot take, C % 4 != 0 or an address off 16 bytes.
__device__ void f32_fill_row(uint8_t* dst, const float* __restrict__ x, int H, int W, int C,
                             int b, int h, int c, int slot_px, int lane) {
  for (int u = lane; u < slot_px * 4; u += 32) {
    const int idx = u / 4, j = u % 4, col = idx - 1, ch = kF32Chunk * c + 4 * j;
    const bool inside = h >= 0 && h < H && col >= 0 && col < W;
    const float* src = x + ((static_cast<long long>(b) * H + h) * W + col) * C + ch;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = inside && ch + e < C ? src[e] : 0.0f;
    *reinterpret_cast<float4*>(dst + f32_unit(idx, j)) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ float lane4(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// A 16-byte shared load at a 32-bit shared address: one LDS.128 (a float4 read
// through the byte-typed dynamic shared array compiles to four LDS.32).
__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// One chunk of a tile: 9 taps x 16 channels into the thread's 8 pixels x 8
// outputs. rc: the shared address of the chunk's first ring slot; poff[i]:
// pixel i's input row oh - 1 as slots past rc, in bytes, + its column ow * 64
// (slot pixel ow is column ow - 1, tap dw reads slot pixel ow + dw); wc: the
// shared address of the chunk's first weight row of tap 0 at this lane's outputs
// 4 lc... The swizzle is computed once a pixel and column
// tap (bits 4-5 of an offset whose bits 0-5 are zero hold it) and XORed with a
// channel quad's j; a row tap dh is dh slots further, a multiple of 512 B that
// leaves the swizzle alone.
__device__ __forceinline__ void f32_chunk(float (&acc)[8][8], const uint32_t (&poff)[8],
                                          uint32_t rc, int slot_bytes, uint32_t wc) {
#pragma unroll kF32UnrollDw
  for (int dw = 0; dw < 3; ++dw) {
    uint32_t z[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t v = poff[i] + dw * kF32PixelBytes;
      z[i] = v ^ ((v >> 3) & 0x30);
    }
#pragma unroll kF32UnrollJ
    for (int j = 0; j < 4; ++j) {
#pragma unroll kF32UnrollDh
      for (int dh = 0; dh < 3; ++dh) {
        const uint32_t row = rc + dh * slot_bytes;
        const uint32_t wt = wc + (dh * 3 + dw) * kF32TapBytes + 4 * j * kOut * 4;
        float4 a[8], b[4][2];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = lds128(row + (z[i] ^ (j << 4)));
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          b[k][0] = lds128(wt + k * kOut * 4);
          b[k][1] = lds128(wt + k * kOut * 4 + 128);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float av = lane4(a[i], k);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[i][e] = fmaf(av, lane4(b[k][0], e), acc[i][e]);
              acc[i][4 + e] = fmaf(av, lane4(b[k][1], e), acc[i][4 + e]);
            }
          }
        }
      }
    }
  }
}

// x: (B, H, W, C); w: (3, 3, C, 64); out: (B, H, W, 64), all f32. Warps 0-7 are
// two consumer groups, warp 8 the producer. Block i owns tiles [i tiles / grid,
// (i + 1) tiles / grid). xmap (use_tma): (C, W, H, B), box (16, box_px, 1, 1),
// 64-byte swizzled; a ring slot is `boxes` boxes of one row.
__global__ void __launch_bounds__(kF32Threads, 1)
    conv3x3_64_f32_kernel(const __grid_constant__ CUtensorMap xmap, const float* __restrict__ x,
                          const float* __restrict__ w, float* __restrict__ out, int H, int W, int C,
                          int tiles, int slots, int box_px, int boxes, int use_tma) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((kF32Align - smem_addr(smem_raw) % kF32Align) % kF32Align);
  const int slot_px = box_px * boxes, slot_bytes = slot_px * kF32PixelBytes;
  uint8_t* ws = ring + static_cast<size_t>(slots) * slot_bytes;
  const uint32_t full = smem_addr(ws + kF32WeightBytes), empty = full + 8 * slots;
  const uint32_t wbar = empty + 8 * slots;
  const int n_chunks = f32_chunks(C), n_groups = (C + 63) / 64;
  const int P = H * W, per_image = (P + kF32Tile - 1) / kF32Tile;
  const int t0 = static_cast<long long>(blockIdx.x) * tiles / gridDim.x;
  const int t1 = static_cast<long long>(blockIdx.x + 1) * tiles / gridDim.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(full + 8 * s, use_tma ? 1 : 32);  // the producer's expect_tx, or its 32 lanes
      mbar_init(empty + 8 * s, kF32Groups * 4);   // every consumer warp
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (n_groups == 1) f32_zero_rows(ws, C, 0, threadIdx.x, blockDim.x);
  __syncthreads();
  if (n_groups == 1 && threadIdx.x == 0) f32_load_weights(smem_addr(ws), w, C, 0, wbar);

  // A round's chunk takes as many consecutive slots as its rows; where they would
  // wrap, both sides pass over the slots left at the ring's end (an empty
  // hand-over each), so a cursor's slot and parity follow the same sequence.
  if (warp == kF32Groups * 4) {
    // ---- producer: each round's rows, chunk by chunk, in key order
    if (use_tma && lane != 0) return;
    RingCursor cur{0, 0, 0};
    for (int t = t0; t < t1;) {
      const int nt = f32_round_tiles(t, t1, H, W, per_image, slots);
      const int kf = tile_first_key(t, H, W, per_image, kF32Tile);
      const int kl = tile_last_key(t + nt - 1, H, W, per_image, kF32Tile);
      for (int c = 0; c < n_chunks; ++c) {
        if (cur.slot + kl - kf + 1 > slots) {
          for (; cur.slot != 0; cur.step(slots)) {
            mbar_wait(empty + 8 * cur.slot, cur.parity ^ 1);
            mbar_arrive(full + 8 * cur.slot);
          }
        }
        for (int k = kf; k <= kl; ++k, cur.step(slots)) {
          const int b = k / (H + 2), h = k % (H + 2) - 1;
          uint8_t* dst = ring + static_cast<size_t>(cur.slot) * slot_bytes;
          const uint32_t bar = full + 8 * cur.slot;
          mbar_wait(empty + 8 * cur.slot, cur.parity ^ 1);
          if (use_tma) {
            mbar_arrive_expect_tx(bar, slot_bytes);
            for (int i = 0; i < boxes; ++i) {
              tma_load_row(smem_addr(dst + i * box_px * kF32PixelBytes), &xmap, kF32Chunk * c,
                           i * box_px - 1, h, b, bar);
            }
          } else {
            f32_fill_row(dst, x, H, W, C, b, h, c, slot_px, lane);
            mbar_arrive(bar);
          }
        }
      }
      t += nt;
    }
    return;
  }

  // ---- consumers: group g takes tile t + g of each round
  const int g = warp / 4, wq = warp % 4, pg = lane / 8, lc = lane % 8;
  const uint32_t ring_s = smem_addr(ring), wl = smem_addr(ws) + lc * 16;
  RingCursor cur{0, 0, 0};
  uint32_t wphase = 0;
  if (n_groups == 1) mbar_wait(wbar, wphase);
  for (int t = t0; t < t1;) {
    const int nt = f32_round_tiles(t, t1, H, W, per_image, slots);
    const int kf = tile_first_key(t, H, W, per_image, kF32Tile);
    const int n = tile_last_key(t + nt - 1, H, W, per_image, kF32Tile) - kf + 1;
    const bool have = g < nt;
    const int tile = t + g;
    const int b = tile / per_image, q0 = tile % per_image * kF32Tile;
    uint32_t poff[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = min(q0 + 32 * wq + pg + 4 * i, P - 1);  // a masked pixel reads the last one
      const int oh = q / W, ow = q - oh * W;
      poff[i] = (b * (H + 2) + oh - kf) * slot_bytes + ow * kF32PixelBytes;
    }
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int o = 0; o < 8; ++o) acc[i][o] = 0.0f;
    }
    for (int c = 0; c < n_chunks; ++c) {
      if (n_groups > 1 && c % 4 == 0) {  // the weights of channels 16 c.., both groups in lockstep
        named_sync(1, kF32Groups * 128);
        if (threadIdx.x == 0) {
          fence_async_shared();
          f32_load_weights(smem_addr(ws), w, C, c / 4, wbar);
        }
        f32_zero_rows(ws, C, c / 4, threadIdx.x, kF32Groups * 128);
        named_sync(1, kF32Groups * 128);
        mbar_wait(wbar, wphase);
        wphase ^= 1;
      }
      if (cur.slot + n > slots) {
        for (; cur.slot != 0; cur.step(slots)) {
          mbar_wait(full + 8 * cur.slot, cur.parity);
          if (lane == 0) mbar_arrive(empty + 8 * cur.slot);
        }
      }
      RingCursor arrived = cur;
      for (int e = 0; e < n; ++e, arrived.step(slots)) {
        mbar_wait(full + 8 * arrived.slot, arrived.parity);
      }
      if (have) {
        f32_chunk(acc, poff, ring_s + cur.slot * slot_bytes, slot_bytes,
                  wl + c % 4 * kF32Chunk * kOut * 4);
      }
      __syncwarp();
      for (int e = 0; e < n; ++e, cur.step(slots)) {
        if (lane == 0) mbar_arrive(empty + 8 * cur.slot);
      }
    }
    if (have) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int p = q0 + 32 * wq + pg + 4 * i;
        if (p < P) {
          float* o = out + (static_cast<long long>(b) * P + p) * kOut + 4 * lc;
          *reinterpret_cast<float4*>(o) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          *reinterpret_cast<float4*>(o + 32) =
              make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        }
      }
    }
    t += nt;
  }
}

int launch_f32(const void* x, const void* w, void* out, int batch, int H, int W, int C,
               int slots, int box_px, int boxes, int blocks, cudaStream_t stream) {
  const int use_tma = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  CUtensorMap xmap{};
  const cuuint64_t P = static_cast<cuuint64_t>(H) * W;
  const cuuint64_t xdims[4] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(W),
                               static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(batch)};
  const cuuint64_t xstrides[3] = {4ull * C, 4ull * W * C, 4ull * P * C};
  const cuuint32_t xbox[4] = {kF32Chunk, static_cast<cuuint32_t>(box_px), 1, 1};
  if (use_tma && !encode(&xmap, x, 4, xdims, xstrides, xbox, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                         CU_TENSOR_MAP_SWIZZLE_64B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = f32_smem_bytes(slots, box_px * boxes * kF32PixelBytes);
  cudaError_t err = cudaFuncSetAttribute(conv3x3_64_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = batch * static_cast<int>((P + kF32Tile - 1) / kF32Tile);
  conv3x3_64_f32_kernel<<<blocks, kF32Threads, smem, stream>>>(
      xmap, static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(out),
      H, W, C, tiles, slots, box_px, boxes, use_tma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// f32 x (B, H, W, C), w HWIO (3, 3, C, 64) -> out (B, H, W, 64) on `stream`:
// `blocks` persistent blocks, a ring of `slots` 16-channel row chunks of `boxes`
// TMA boxes of `box_px` pixels. The kernel trusts its caller: the wrapper
// (probe_pallas_conv.conv3x3_64, its f32_plan) is the one place that checks a
// ring that holds a tile's rows and fits, and hands over a 16-byte-aligned w.
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a
// tensor map that cuTensorMapEncodeTiled refuses.
extern "C" int conv3x3_64_f32_launch(const void* x, const void* w, void* out, int batch, int H,
                                     int W, int C, int slots, int box_px, int boxes, int blocks,
                                     void* stream) {
  return launch_f32(x, w, out, batch, H, W, C, slots, box_px, boxes, blocks,
                    static_cast<cudaStream_t>(stream));
}

// bf16 x (B, H, W, C), w HWIO (3, 3, C, 64) -> out (B, H, W, 64) on `stream`:
// `blocks` persistent blocks, a ring of `slots` image rows. The kernel trusts
// its caller: the wrapper (probe_pallas_conv.conv3x3_64, its bf16_ring_slots)
// is the one place that checks the 16-byte-aligned tensors, W + 2 <= 256 and a
// ring that holds the rows in flight and fits. Returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a tensor map the driver refuses.
extern "C" int conv3x3_64_bf16_launch(const void* x, const void* w, void* out, int batch, int H,
                                      int W, int C, int slots, int blocks, void* stream) {
  return launch_wgmma(x, w, out, batch, H, W, C, slots, blocks,
                      static_cast<cudaStream_t>(stream));
}
