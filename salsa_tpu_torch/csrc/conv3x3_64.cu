// K4: NHWC 3x3 SAME convolution with 64 output channels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scripts/probe_pallas_conv.py:90
// paired_conv_pallas.kernel (pallas_call at :115), the probe of a hand-written
// stage-1 conv of the CRNN:
//   out[b, h, w, o] = sum_{dh, dw, c} x[b, h+dh-1, w+dw-1, c] * w[dh, dw, c, o]
// with zeros outside the image, f32 accumulation, stored in the input's type
// (f32 or bf16). The TPU kernel packs pairs of output positions into one
// 128-lane row to fill the MXU; that packing exists for the TPU's matrix unit
// and is not carried over: x keeps the JAX layout (NHWC).
//
// Both kernels own R output rows x 32 columns of one image and all 64 outputs
// per block; R (rows per block, 1/2/4/8) is chosen at launch, the counterpart of
// the JAX probe's --bh. Ragged rows, columns and channel counts are masked.
//
// bf16: an implicit GEMM on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate). M = output pixels, N = 64 outputs, K = 9 taps x C channels;
// A[m][k] = x[b, h+dh-1, col+dw-1, c], B[k][n] = w[dh, dw, c, n]. One warp per
// output row: a warp tile of 32 pixels x 64 outputs (2 m16 x 8 n8 tiles, 64 f32
// accumulators a thread), each B fragment used by both m16 tiles. Per 64-channel
// chunk the block fills shared memory once, synchronously: all 9 x 64 weight
// rows and the (R+2) x 34 input tile (1-pixel halo), channels padded with zeros
// to Cp (a multiple of 16, at most 64) at a pitch of Cp + 8 bf16, so the 8 row
// groups of a warp's 32-bit fragment loads land on distinct banks (word stride =
// 4 mod 8). The weights come in as HWIO, as in f32, and are transposed on the way
// into shared memory to [tap][n][c], n-major, so that a B fragment's two k values
// are one 32-bit word. C = 64, R = 8: 82,944 B of weights + 48,960 B of tile;
// R = 4: 112,320 B in all, two blocks an SM.
//
// What bounds it on the H100: at the stage-1 training shape (B=32, 320 x 100,
// C=64) the conv is 75.5 GFLOP against ~262 MB moved (x in, out back), ~290
// flop/B, at the ridge of the bf16 tensor cores (~295). This design is bound
// below that by (1) shared-memory bytes per mma: each m16n8k16 reads ~192 B of
// fragments (24 32-bit loads per 16 mma a warp) against the SM's 128 B/clk, which
// caps it near 65 % of the dense bf16 rate; a 64-pixel warp tile, ldmatrix or
// wgmma with operands read by the tensor cores from shared memory would cut that;
// (2) synchronous fills: a block loads its 73.7 KB of weights and its input tile
// and only then computes, so fills overlap only with a second block on the SM
// (R <= 4); cp.async or TMA into a ring of stages and a persistent block that
// keeps its weights would hide them; (3) idle columns: at W = 100 the 4 column
// tiles of 32 compute 128 columns, 22 % of them masked; a column tile sized to
// W would recover them. Measured on an H100 (700 W) at R = 8 with the fills and
// the mma switched off in turn in a copy of this kernel, when the weights still
// came in n-major (PERF.md): the fills took ~60 % of the time and did not overlap
// the mma, and the mma part alone ran at ~26 % of the dense bf16 rate, below the
// cap of (1).
//
// f32: the fp32 CUDA cores (tensor cores would mean TF32, ~3 decimal digits).
// Warp g computes outputs 8g..8g+7, lane l column l of the tile, so each thread
// keeps R x 8 f32 accumulators in registers. Input channels go through shared
// memory in chunks of 16: the (R+2) x 34 input tile and the (3, 3, 16, 64)
// weight chunk (HWIO). Per channel and column tap a thread reads R+2 inputs
// (conflict-free: a warp reads 32 neighbouring columns) and 3 x 8 weights (a
// broadcast), then does 24 R FMAs; bound by the fp32 FMA rate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kOut = 64;
constexpr int kTileW = 32;           // output columns per block
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

// ------------------------------------------------------- bf16, tensor cores (mma)

using bf16 = __nv_bfloat16;
constexpr int kMmaChunk = 64;  // input channels per shared-memory fill

// Channels of a fill, padded to the mma's k of 16; the pitch adds 8 bf16 (16 B).
__host__ __device__ constexpr int mma_cp(int C) {
  return ((C < kMmaChunk ? C : kMmaChunk) + 15) / 16 * 16;
}
__host__ __device__ constexpr int mma_pitch(int C) { return mma_cp(C) + 8; }

constexpr size_t mma_smem_bytes(int R, int C) {
  return sizeof(bf16) * mma_pitch(C) * (9 * kOut + (R + 2) * kTileW2);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a (16 x 16, row) * b (16 x 8, col); fragments as in the PTX ISA for
// m16n8k16 with g = lane / 4, t = lane % 4:
//   a[0] = A[g][2t..2t+1]   a[1] = A[g+8][2t..]   a[2] = A[g][2t+8..]  a[3] = A[g+8][2t+8..]
//   b0 = B[2t..2t+1][g]     b1 = B[2t+8..][g]
//   d[0..1] = D[g][2t..2t+1]  d[2..3] = D[g+8][2t..2t+1]
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy `rows` rows of `ck` channels (global row `src(row)`, or zeros where it is
// null) into shared rows of `pitch`, zero-padded to `cp` channels; 16-byte loads
// when `vec` (C % 8 == 0 and 16-byte aligned bases), kFillBatch of them in
// flight a thread before their stores, single elements otherwise.
constexpr int kFillBatch = 8;
constexpr int kWeightBatch = 2;  // weight units in flight a thread (4 loads each)

// 16 bf16 from s (zeros where s is null) as two uint4: 16-byte loads when `vec`.
__device__ __forceinline__ void load16(uint4 (&v)[2], const bf16* s, bool vec) {
  if (s == nullptr) {
    v[0] = v[1] = make_uint4(0, 0, 0, 0);
  } else if (vec) {
    v[0] = reinterpret_cast<const uint4*>(s)[0];
    v[1] = reinterpret_cast<const uint4*>(s)[1];
  } else {
    uint32_t p[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      p[q] = __bfloat16_as_ushort(s[2 * q]) | uint32_t{__bfloat16_as_ushort(s[2 * q + 1])} << 16;
    }
    v[0] = make_uint4(p[0], p[1], p[2], p[3]);
    v[1] = make_uint4(p[4], p[5], p[6], p[7]);
  }
}

// 32-bit word q (0..7) of 16 bf16 held as two uint4
__device__ __forceinline__ uint32_t word(const uint4 (&v)[2], int q) {
  const uint4& h = v[q / 4];
  switch (q % 4) {
    case 0: return h.x;
    case 1: return h.y;
    case 2: return h.z;
    default: return h.w;
  }
}

// The weights of channels c0..c0+ck, HWIO (3, 3, C, 64) in global memory, into
// shared memory as [tap][n][pitch], zero-padded to `cp` channels: transposed on
// the way. A unit is a channel pair (c, c+1) and 16 outputs: 2 x 32 B read, 16
// 32-bit words (c, c+1) written, one an output row. The 32 threads of a warp take
// 32 neighbouring pairs, so at cp = 64 their stores land on 32 distinct banks.
__device__ __forceinline__ void fill_weights(bf16* ws, const bf16* w, int C, int c0, int ck,
                                             int cp, int pitch, bool vec, int nthreads) {
  constexpr int kGroups = kOut / 16;
  const int np = cp / 2, total = 9 * kGroups * np;
  for (int i0 = threadIdx.x; i0 < total; i0 += kWeightBatch * nthreads) {
    uint4 v[kWeightBatch][2][2];  // [unit][channel c, c + 1][outputs n0.., n0 + 8..]
#pragma unroll
    for (int u = 0; u < kWeightBatch; ++u) {
      const int i = i0 + u * nthreads;
      const int c = 2 * (i % np), n0 = i / np % kGroups * 16, tap = i / (np * kGroups);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        load16(v[u][k],
               i < total && c + k < ck ? w + ((long long)tap * C + c0 + c + k) * kOut + n0
                                       : nullptr,
               vec);
      }
    }
#pragma unroll
    for (int u = 0; u < kWeightBatch; ++u) {
      const int i = i0 + u * nthreads;
      if (i >= total) continue;
      const int c = 2 * (i % np), n0 = i / np % kGroups * 16, tap = i / (np * kGroups);
      bf16* d = ws + (tap * kOut + n0) * pitch + c;
#pragma unroll
      for (int q = 0; q < 8; ++q) {  // outputs n0 + 2q and n0 + 2q + 1
        const uint32_t a = word(v[u][0], q), b = word(v[u][1], q);
        *reinterpret_cast<uint32_t*>(d + 2 * q * pitch) = __byte_perm(a, b, 0x5410);
        *reinterpret_cast<uint32_t*>(d + (2 * q + 1) * pitch) = __byte_perm(a, b, 0x7632);
      }
    }
  }
}

template <typename Src>
__device__ __forceinline__ void fill_rows(bf16* dst, int rows, int cp, int pitch, int ck,
                                          bool vec, int nthreads, Src src) {
  if (vec) {
    const int nv = cp / 8, total = rows * nv;
    for (int i0 = threadIdx.x; i0 < total; i0 += kFillBatch * nthreads) {
      uint4 val[kFillBatch];
#pragma unroll
      for (int j = 0; j < kFillBatch; ++j) {
        const int i = i0 + j * nthreads, v = i % nv;
        const bf16* s = i < total ? src(i / nv) : nullptr;
        val[j] = make_uint4(0, 0, 0, 0);
        if (s != nullptr && v * 8 < ck) val[j] = *reinterpret_cast<const uint4*>(s + v * 8);
      }
#pragma unroll
      for (int j = 0; j < kFillBatch; ++j) {
        const int i = i0 + j * nthreads;
        if (i < total) *reinterpret_cast<uint4*>(dst + i / nv * pitch + i % nv * 8) = val[j];
      }
    }
  } else {
    const bf16 zero = __float2bfloat16_rn(0.0f);
    for (int i = threadIdx.x; i < rows * cp; i += nthreads) {
      const int c = i % cp, row = i / cp;
      const bf16* s = src(row);
      dst[row * pitch + c] = (s != nullptr && c < ck) ? s[c] : zero;
    }
  }
}

// x: (B, H, W, C); w: (3, 3, C, 64); out: (B, H, W, 64), all bf16.
// Grid (column tiles, row stripes, images); warp r computes output row h0 + r.
template <int R>
__global__ void __launch_bounds__(32 * R) conv3x3_64_mma_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w, bf16* __restrict__ out, int H,
    int W, int C, int vec) {
  extern __shared__ uint4 smem_mma[];
  const int cp = mma_cp(C);
  const int pitch = mma_pitch(C);
  bf16* ws = reinterpret_cast<bf16*>(smem_mma);  // [9 * 64][pitch]
  bf16* xs = ws + 9 * kOut * pitch;              // [(R + 2) * kTileW2][pitch]
  const int col0 = blockIdx.x * kTileW;
  const int h0 = blockIdx.y * R;
  const int b = blockIdx.z;
  const int r = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const bf16* xb = x + (long long)b * H * W * C;

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
    }
  }

  // this lane's fragment bases: A at output row r (tap dh = 0), pixel g (dw = 0);
  // B at output n = g of tap 0
  const bf16* xa = xs + (r * kTileW2 + g) * pitch + 2 * t;
  const bf16* wb = ws + g * pitch + 2 * t;

  for (int c0 = 0; c0 < C; c0 += kMmaChunk) {
    const int ck = min(kMmaChunk, C - c0);
    __syncthreads();  // the previous chunk is no longer read
    fill_weights(ws, w, C, c0, ck, cp, pitch, vec, 32 * R);
    fill_rows(xs, (R + 2) * kTileW2, cp, pitch, ck, vec, 32 * R,
              [&](int row) -> const bf16* {
                const int h = h0 + row / kTileW2 - 1;
                const int ww = col0 + row % kTileW2 - 1;
                return (h >= 0 && h < H && ww >= 0 && ww < W)
                           ? xb + ((long long)h * W + ww) * C + c0
                           : nullptr;
              });
    __syncthreads();

    const int ksteps = (ck + 15) / 16;
    for (int ks = 0; ks < ksteps; ++ks) {
#pragma unroll
      for (int dh = 0; dh < 3; ++dh) {
#pragma unroll
        for (int dw = 0; dw < 3; ++dw) {
          uint32_t a[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const bf16* p = xa + (dh * kTileW2 + mt * 16 + dw) * pitch + ks * 16;
            a[mt][0] = lds32(p);
            a[mt][1] = lds32(p + 8 * pitch);
            a[mt][2] = lds32(p + 8);
            a[mt][3] = lds32(p + 8 * pitch + 8);
          }
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const bf16* q = wb + ((dh * 3 + dw) * kOut + nt * 8) * pitch + ks * 16;
            const uint32_t b0 = lds32(q), b1 = lds32(q + 8);
            mma_16816(acc[0][nt], a[0], b0, b1);
            mma_16816(acc[1][nt], a[1], b0, b1);
          }
        }
      }
    }
  }

  const int h = h0 + r;
  if (h >= H) return;
  bf16* orow = out + ((long long)b * H + h) * W * kOut;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = col0 + mt * 16 + half * 8 + g;
      if (col >= W) continue;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        *reinterpret_cast<__nv_bfloat162*>(orow + (long long)col * kOut + nt * 8 + 2 * t) =
            __float22bfloat162_rn(
                make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]));
      }
    }
  }
}

template <int R>
int launch_mma(const void* x, const void* w, void* out, int batch, int H, int W, int C,
               cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(R, C);
  cudaError_t err = cudaFuncSetAttribute(conv3x3_64_mma_kernel<R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = C % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + R - 1) / R, batch);
  conv3x3_64_mma_kernel<R><<<grid, 32 * R, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(out), H, W,
      C, vec);
  return static_cast<int>(cudaGetLastError());
}

int launch_rows(const void* x, const void* w, void* out, int batch, int H, int W, int C,
                bool bf16_in, int rows, cudaStream_t s) {
  switch (rows) {
    case 1: return bf16_in ? launch_mma<1>(x, w, out, batch, H, W, C, s)
                           : launch_f32<1>(x, w, out, batch, H, W, C, s);
    case 2: return bf16_in ? launch_mma<2>(x, w, out, batch, H, W, C, s)
                           : launch_f32<2>(x, w, out, batch, H, W, C, s);
    case 4: return bf16_in ? launch_mma<4>(x, w, out, batch, H, W, C, s)
                           : launch_f32<4>(x, w, out, batch, H, W, C, s);
    case 8: return bf16_in ? launch_mma<8>(x, w, out, batch, H, W, C, s)
                           : launch_f32<8>(x, w, out, batch, H, W, C, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (B, H, W, C), w HWIO (3, 3, C, 64) and out (B, H, W, 64) in the same type:
// is_bf16 = 1 for bfloat16, 0 for float32. Launches on `stream`; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for rows_per_block
// other than 1, 2, 4 or 8.
extern "C" int conv3x3_64_launch(const void* x, const void* w, void* out, int batch, int H,
                                 int W, int C, int is_bf16, int rows_per_block,
                                 void* stream) {
  return launch_rows(x, w, out, batch, H, W, C, is_bf16 != 0, rows_per_block,
                     static_cast<cudaStream_t>(stream));
}
