// K2: SALSA noise-floor tracker for Hopper (sm_90a).
//
// Replaces the frame recurrence that salsa_tpu runs as a lax.scan
// (salsa_tpu/features/salsa.py::noise_floor_scan, fed by
// tracking_magspec_planes); there it is no Pallas kernel, but in eager PyTorch the
// scan would be ~4,800 sequential frame steps of several launches each per 60 s
// clip. Per (clip, bin): the 3-frame RMS magnitude of channel 0, then the
// up/down floor tracker (rise x1.02, x1.002 once the 3-frame countdown has run
// out, fall x0.98, floor >= 1e-6) and sig = mag > snr_ratio * floor.
//
// What bounds it on the H100: the recurrence is strictly sequential over frames
// and only (clips x bins) wide, ~760 threads for 4 clips of 191 bins, so it is
// latency-bound: one dependent chain of a few flops per frame. Design: one
// thread per (clip, bin) loops over all frames with the magnitude fused in, so
// the band is read once and nothing but the mask and the final state is
// written. Loads do not depend on the recurrence, so the compiler can issue them
// ahead of it. Small blocks (32 threads) spread the few warps over many SMs.
//
// Every product and sum is written with __fmul_rn / __fadd_rn / __fdiv_rn /
// __fsqrt_rn so nvcc cannot contract them into FMAs: mask and state are
// bit-equal to the plain PyTorch version, which sums in the same order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 32;

__device__ __forceinline__ float power(const float* re, const float* im, long long i) {
  return __fadd_rn(__fmul_rn(re[i], re[i]), __fmul_rn(im[i], im[i]));
}

// sqrt((|x[f]|^2 + |x[f-1]|^2 + |x[f-2]|^2) / 3) at padded frame f = t + n_hop
__device__ __forceinline__ float tracking_mag(const float* re, const float* im, long long f) {
  const float acc = __fadd_rn(__fadd_rn(power(re, im, f), power(re, im, f - 1)),
                              power(re, im, f - 2));
  return __fsqrt_rn(__fdiv_rn(acc, 3.0f));
}

// xr0, xi0: (rows, n_frames + 2*n_hop) channel-0 planes, one row per (clip, bin).
// floor0/countdown0: entering state per row, or null for the clip-start state.
// mask: (rows, n_frames) bytes; floor_out/countdown_out: final state per row.
__global__ void __launch_bounds__(kBlock) noise_floor_kernel(
    const float* __restrict__ xr0, const float* __restrict__ xi0,
    const float* __restrict__ floor0, const int* __restrict__ countdown0,
    uint8_t* __restrict__ mask, float* __restrict__ floor_out,
    int* __restrict__ countdown_out, int rows, int n_frames, int n_hop, float snr_ratio,
    float floor_up, float floor_up_slow, float floor_down) {
  const int row = blockIdx.x * kBlock + threadIdx.x;
  if (row >= rows) return;
  const long long tp = (long long)n_frames + 2 * n_hop;
  const float* re = xr0 + row * tp + n_hop;
  const float* im = xi0 + row * tp + n_hop;
  uint8_t* m = mask + (long long)row * n_frames;

  float floor;
  int countdown;
  if (floor0 == nullptr) {
    // 0.5 * mean of the first 5 frames, summed in frame order
    float s = tracking_mag(re, im, 0);
    for (int t = 1; t < 5; ++t) s = __fadd_rn(s, tracking_mag(re, im, t));
    floor = __fmul_rn(__fdiv_rn(s, 5.0f), 0.5f);
    countdown = 3;
  } else {
    floor = floor0[row];
    countdown = countdown0[row];
  }

  for (int t = 0; t < n_frames; ++t) {
    const float x = tracking_mag(re, im, t);
    const bool above = x > floor;
    const int next = above ? countdown - 1 : 3;
    const float factor = above ? (next < 0 ? floor_up_slow : floor_up) : floor_down;
    const float next_floor = fmaxf(__fmul_rn(floor, factor), 1e-6f);
    m[t] = x > __fmul_rn(snr_ratio, next_floor);
    floor = next_floor;
    countdown = next;
  }
  floor_out[row] = floor;
  countdown_out[row] = countdown;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int noise_floor_launch(const void* xr0, const void* xi0, const void* floor0,
                                  const void* countdown0, void* mask, void* floor_out,
                                  void* countdown_out, int rows, int n_frames, int n_hop,
                                  float snr_ratio, float floor_up, float floor_up_slow,
                                  float floor_down, void* stream) {
  const int grid = (rows + kBlock - 1) / kBlock;
  noise_floor_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr0), static_cast<const float*>(xi0),
      static_cast<const float*>(floor0), static_cast<const int*>(countdown0),
      static_cast<uint8_t*>(mask), static_cast<float*>(floor_out),
      static_cast<int*>(countdown_out), rows, n_frames, n_hop, snr_ratio, floor_up,
      floor_up_slow, floor_down);
  return static_cast<int>(cudaGetLastError());
}
