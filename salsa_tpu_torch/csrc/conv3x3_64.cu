// K4: NHWC 3x3 SAME convolution with 64 output channels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scripts/probe_pallas_conv.py:90
// paired_conv_pallas.kernel (pallas_call at :115), the probe of a hand-written
// stage-1 conv of the CRNN:
//   out[b, h, w, o] = sum_{dh, dw, c} x[b, h+dh-1, w+dw-1, c] * w[dh, dw, c, o]
// with zeros outside the image, f32 accumulation, stored in the input's type
// (f32 or bf16). The TPU kernel packs pairs of output positions into one
// 128-lane row to fill the MXU; that packing exists for the TPU's matrix unit
// and is not carried over: x and w keep the JAX layouts (NHWC, HWIO).
//
// What bounds it on the H100: at the stage-1 training shape (B=32, 320 x 100,
// C=64, bf16) the conv is 75.5 GFLOP against ~262 MB moved (x in, out back),
// ~290 flop/B, at the ridge of the bf16 tensor cores (~295). This kernel runs
// on the fp32 CUDA cores, not the tensor cores, so it is bound by the fp32
// FMA rate: at least 1.13 ms at the nominal 67 TFLOP/s, where cuDNN's tensor
// core kernels can reach ~0.1 ms. It is the simple, right first version;
// mma.sync / wgmma, TMA and pipelining are later work.
// Design: a block owns R rows x 32 columns of one image and all 64 outputs;
// warp g computes outputs 8g..8g+7, lane l column l of the tile, so each thread
// keeps R x 8 f32 accumulators in registers. Input channels go through shared
// memory in chunks of 16: the (R+2) x 34 input tile (1-pixel halo, zeros
// outside the image) and the (3, 3, 16, 64) weight chunk, both converted to f32.
// Per channel and column tap a thread reads R+2 inputs (conflict-free: a warp
// reads 32 neighbouring columns) and 3 x 8 weights (a broadcast), then does
// 24 R FMAs. Ragged rows, columns and channel counts are masked. R (rows per
// block, 1/2/4/8) is chosen at launch, the counterpart of the JAX probe's --bh.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kOut = 64;
constexpr int kOutPerWarp = 8;
constexpr int kWarps = kOut / kOutPerWarp;  // 8
constexpr int kThreads = 32 * kWarps;       // 256
constexpr int kTileW = 32;                  // output columns per block
constexpr int kTileW2 = kTileW + 2;         // with the halo
constexpr int kChunk = 16;                  // input channels per shared-memory pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <int R>
constexpr size_t smem_bytes() {
  return sizeof(float) * (9 * kChunk * kOut + kChunk * (R + 2) * kTileW2);
}

// x: (B, H, W, C); w: (3, 3, C, 64); out: (B, H, W, 64).
// Grid (column tiles, row stripes, images).
template <typename T, int R>
__global__ void __launch_bounds__(kThreads) conv3x3_64_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int H, int W,
    int C) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [9][ck][64]
  float* xs = ws + 9 * kChunk * kOut;           // [ck][R+2][kTileW2]
  const int col0 = blockIdx.x * kTileW;
  const int h0 = blockIdx.y * R;
  const int b = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const int o0 = (threadIdx.x / 32) * kOutPerWarp;
  const T* xb = x + (long long)b * H * W * C;

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
      ws[i] = to_f32(w[((long long)tap * C + c0 + c) * kOut + o]);
    }
    for (int i = threadIdx.x; i < (R + 2) * kTileW2 * ck; i += kThreads) {
      const int c = i % ck;  // channels fastest: neighbouring threads read neighbouring bytes
      const int col = (i / ck) % kTileW2;
      const int row = i / (ck * kTileW2);
      const int h = h0 + row - 1;
      const int ww = col0 + col - 1;
      const bool in = h >= 0 && h < H && ww >= 0 && ww < W;
      xs[(c * (R + 2) + row) * kTileW2 + col] =
          in ? to_f32(xb[((long long)h * W + ww) * C + c0 + c]) : 0.0f;
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
    T* op = out + (((long long)b * H + h) * W + col) * kOut + o0;
#pragma unroll
    for (int o = 0; o < kOutPerWarp; ++o) store(op + o, acc[r][o]);
  }
}

template <typename T, int R>
int launch(const void* x, const void* w, void* out, int batch, int H, int W, int C,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<R>();
  cudaError_t err = cudaFuncSetAttribute(conv3x3_64_kernel<T, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + R - 1) / R, batch);
  conv3x3_64_kernel<T, R><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), H, W, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(const void* x, const void* w, void* out, int batch, int H, int W, int C,
                int rows, cudaStream_t stream) {
  switch (rows) {
    case 1: return launch<T, 1>(x, w, out, batch, H, W, C, stream);
    case 2: return launch<T, 2>(x, w, out, batch, H, W, C, stream);
    case 4: return launch<T, 4>(x, w, out, batch, H, W, C, stream);
    case 8: return launch<T, 8>(x, w, out, batch, H, W, C, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, w and out in the same type: is_bf16 = 1 for bfloat16, 0 for float32.
// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for rows_per_block other than 1, 2, 4 or 8.
extern "C" int conv3x3_64_launch(const void* x, const void* w, void* out, int batch, int H,
                                 int W, int C, int is_bf16, int rows_per_block,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_rows<__nv_bfloat16>(x, w, out, batch, H, W, C, rows_per_block, s)
                 : launch_rows<float>(x, w, out, batch, H, W, C, rows_per_block, s);
}
