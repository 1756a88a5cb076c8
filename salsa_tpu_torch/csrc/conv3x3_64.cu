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
// f32: the fp32 CUDA cores (tensor cores would mean TF32, ~3 decimal digits).
// A block owns R output rows (1/2/4/8, chosen at launch, the counterpart of the
// JAX probe's --bh) x 32 columns of one image and all 64 outputs. Warp g
// computes outputs 8g..8g+7, lane l column l of the tile, so each thread keeps
// R x 8 f32 accumulators in registers. Input channels go through shared memory
// in chunks of 16: the (R+2) x 34 input tile and the (3, 3, 16, 64) weight chunk
// (HWIO). Per channel and column tap a thread reads R+2 inputs (conflict-free: a
// warp reads 32 neighbouring columns) and 3 x 8 weights (a broadcast), then does
// 24 R FMAs; bound by the fp32 FMA rate. Ragged rows, columns and channel counts
// are masked.
#include <cuda.h>  // CUtensorMap and the driver's enums; the entry point comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kOut = 64;
constexpr int kTileW = 32;           // f32: output columns per block
constexpr int kTileW2 = kTileW + 2;  // with the halo

// ---------------------------------------------------------------- f32, CUDA cores

constexpr int kOutPerWarp = 8;
constexpr int kWarps = kOut / kOutPerWarp;  // 8
constexpr int kThreads = 32 * kWarps;       // 256
constexpr int kChunk = 16;                  // input channels per shared-memory pass

template <int R>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (9 * kChunk * kOut + kChunk * (R + 2) * kTileW2);
}

// x: (B, H, W, C); w: (3, 3, C, 64); out: (B, H, W, 64).
// Grid (column tiles, row stripes, images).
template <int R>
__global__ void __launch_bounds__(kThreads) conv3x3_64_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out, int H,
    int W, int C) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [9][ck][64]
  float* xs = ws + 9 * kChunk * kOut;           // [ck][R+2][kTileW2]
  const int col0 = blockIdx.x * kTileW;
  const int h0 = blockIdx.y * R;
  const int b = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const int o0 = (threadIdx.x / 32) * kOutPerWarp;
  const float* xb = x + (long long)b * H * W * C;

  float acc[R][kOutPerWarp];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int o = 0; o < kOutPerWarp; ++o) acc[r][o] = 0.0f;
  }

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    const int ck = min(kChunk, C - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int i = threadIdx.x; i < 9 * ck * kOut; i += kThreads) {
      const int o = i % kOut;
      const int c = (i / kOut) % ck;
      const int tap = i / (kOut * ck);
      ws[i] = w[((long long)tap * C + c0 + c) * kOut + o];
    }
    for (int i = threadIdx.x; i < (R + 2) * kTileW2 * ck; i += kThreads) {
      const int c = i % ck;  // channels fastest: neighbouring threads read neighbouring bytes
      const int col = (i / ck) % kTileW2;
      const int row = i / (ck * kTileW2);
      const int h = h0 + row - 1;
      const int ww = col0 + col - 1;
      const bool in = h >= 0 && h < H && ww >= 0 && ww < W;
      xs[(c * (R + 2) + row) * kTileW2 + col] = in ? xb[((long long)h * W + ww) * C + c0 + c]
                                                   : 0.0f;
    }
    __syncthreads();

    for (int c = 0; c < ck; ++c) {
#pragma unroll
      for (int dw = 0; dw < 3; ++dw) {
        float xv[R + 2];
#pragma unroll
        for (int r = 0; r < R + 2; ++r) xv[r] = xs[(c * (R + 2) + r) * kTileW2 + lane + dw];
#pragma unroll
        for (int dh = 0; dh < 3; ++dh) {
          const float4* wp = reinterpret_cast<const float4*>(
              ws + ((dh * 3 + dw) * ck + c) * kOut + o0);
          const float4 wa = wp[0];
          const float4 wb = wp[1];
          const float wv[kOutPerWarp] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int r = 0; r < R; ++r) {
#pragma unroll
            for (int o = 0; o < kOutPerWarp; ++o) acc[r][o] = fmaf(xv[r + dh], wv[o], acc[r][o]);
          }
        }
      }
    }
  }

  const int col = col0 + lane;
  if (col >= W) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int h = h0 + r;
    if (h >= H) break;
    float* op = out + (((long long)b * H + h) * W + col) * kOut + o0;
#pragma unroll
    for (int o = 0; o < kOutPerWarp; ++o) op[o] = acc[r][o];
  }
}

template <int R>
int launch_f32(const void* x, const void* w, void* out, int batch, int H, int W, int C,
               cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<R>();
  cudaError_t err = cudaFuncSetAttribute(conv3x3_64_f32_kernel<R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + R - 1) / R, batch);
  conv3x3_64_f32_kernel<R><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(out), H,
      W, C);
  return static_cast<int>(cudaGetLastError());
}

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
// that a contiguous range of tiles reads are a contiguous range of keys.
__device__ __forceinline__ int tile_first_key(int t, int H, int W, int tiles_per_image) {
  const int b = t / tiles_per_image, q0 = t % tiles_per_image * kTile;
  return b * (H + 2) + q0 / W;  // row q0 / W - 1
}
__device__ __forceinline__ int tile_last_key(int t, int H, int W, int tiles_per_image) {
  const int b = t / tiles_per_image, q0 = t % tiles_per_image * kTile;
  return b * (H + 2) + (min(q0 + kTile, H * W) - 1) / W + 2;  // row (last pixel) / W + 1
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

// A bf16 tensor map with the 128-byte swizzle: dims and box innermost first,
// strides in bytes of dims 1.. .
bool encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  EncodeTiled fn = encode_tiled();
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

}  // namespace

// f32 x (B, H, W, C), w HWIO (3, 3, C, 64) -> out (B, H, W, 64) on `stream`, a
// block per rows_per_block output rows x 32 columns. Returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for rows_per_block other than 1, 2,
// 4 or 8.
extern "C" int conv3x3_64_f32_launch(const void* x, const void* w, void* out, int batch, int H,
                                     int W, int C, int rows_per_block, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (rows_per_block) {
    case 1: return launch_f32<1>(x, w, out, batch, H, W, C, s);
    case 2: return launch_f32<2>(x, w, out, batch, H, W, C, s);
    case 4: return launch_f32<4>(x, w, out, batch, H, W, C, s);
    case 8: return launch_f32<8>(x, w, out, batch, H, W, C, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
