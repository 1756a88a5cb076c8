// K1: fused SALSA spatial stage for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel salsa_tpu/features/salsa_pallas.py::_kernel
// (entry salsa_spatial_pallas_planes). Per (clip, bin, frame) of the DOA band:
// the 7-frame spatial covariance R of the 4 channels, R/tr(R) squared 3 times
// with trace renormalisation, the principal eigenvector from two matvecs with
// that power, lambda0 = v^H R v, lambda1 from 3 orthogonalised steps with R/tr(R),
// the coherence test lambda0 > cond * lambda1 AND the noise-tracker mask, then the
// FOA direction Re(v_c conj(v_0)) / |v_0|^2, L2-normalised, or the MIC phase
// atan2(.) / (delta * absolute_bin). Zero where invalid.
//
// What bounds it on the H100: it must read the band once (4 channels x re/im x
// (T + 2h) frames), the mask, and write 3 output planes, ~45 B per cell, against
// ~2,100 fp32 operations per cell (chip_smoke.K1_FLOPS_PER_CELL itemises them):
// ~47 flop/B, above the card's fp32 ridge of ~20, so it is bound by the fp32
// pipes' issue slots. No tensor cores: the algebra is 4x4 complex, one matrix per
// cell, and the coherence test needs fp32 through three squarings.
// Design, all aimed at fewer issued instructions a cell (hermitian4.cuh):
// - one thread per (clip, bin, frame), frames on threadIdx.x, so a warp reads 32
//   neighbouring frames of one plane (coalesced); the 7-frame windows overlap
//   between neighbouring threads, so the 6 extra frames come from L1/L2;
// - the Hermitian matrices are 4 real diagonal floats and 6 complex upper
//   entries, in registers; sums are FFMA chains;
// - n_hop is a template parameter (3, the only value any configuration uses), so
//   the window's 56 loads are unrolled and issued up front at immediate offsets
//   from 8 plane pointers, computed once in 32-bit (the wrapper asserts that every
//   element index fits);
// - the four trace renormalisations, which only set the scale of quantities that
//   are normalised or compared afterwards, take MUFU.RCP; the divide that sets the
//   FOA feature values stays correctly rounded;
// - threads per block and the minimum resident blocks (K1_BLOCK, K1_MIN_BLOCKS:
//   64 and 12, so ptxas keeps to 85 registers) were picked with
//   scripts/bench_salsa_spatial.py on an H100 (PERF.md): the fastest setting
//   without spills, by 1-2 % over 64-256 threads with 64-80 registers, since the
//   kernel is bound by issue slots rather than by occupancy.
// Arithmetic follows the Pallas kernel's function (1/win scaling, the 1e-30
// guards, rsqrtf normalisation, 3 squarings) in another order, except that atan2f
// replaces its polynomial atan2. nvcc contracts products and sums into FMAs, so
// results differ from the plain PyTorch version in the last bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hermitian4.cuh"

#ifndef K1_BLOCK
#define K1_BLOCK 64
#endif
#ifndef K1_MIN_BLOCKS
#define K1_MIN_BLOCKS 12
#endif

namespace {

using herm4::C;
using herm4::Eig;

constexpr int kBlock = K1_BLOCK;
constexpr int kSquarings = 3;
constexpr int kHop = 3;  // the instantiated n_hop
static_assert(kBlock % 32 == 0 && kBlock <= 1024, "whole warps of frames");

// xr, xi: (B, C, n_bins, n_frames + 2*NHOP); mask: (B, n_bins, n_frames) bytes;
// out: (B, C-1, n_bins, n_frames). Grid (frame tiles, bins, clips). Every element
// index is below 2^31.
template <int NHOP>
__global__ void __launch_bounds__(kBlock, K1_MIN_BLOCKS) salsa_spatial_kernel(
    const float* __restrict__ xr, const float* __restrict__ xi,
    const uint8_t* __restrict__ mask, float* __restrict__ out, int n_bins,
    int n_frames, int is_mic, float condition_number, int lower_bin, float delta) {
  const unsigned t = blockIdx.x * kBlock + threadIdx.x;
  if (t >= (unsigned)n_frames) return;
  const unsigned bin = blockIdx.y;
  const unsigned b = blockIdx.z;
  const unsigned tp = n_frames + 2 * NHOP;
  const unsigned plane = n_bins * tp;
  const unsigned base = (b * C * n_bins + bin) * tp + t;
  const Eig e = herm4::solve_cell<NHOP, kSquarings>(xr + base, xi + base, plane);

  const unsigned cell = (b * n_bins + bin) * n_frames + t;
  const bool valid = mask[cell] != 0 && e.lam0 > e.lam1 * condition_number;

  // ---- normalisation to the 3 spatial channels ----
  float feats[C - 1];
  if (!is_mic) {
    herm4::foa_direction(e.v, feats);
  } else {
    const float inv_bin = 1.0f / (delta * (float)(lower_bin + (int)bin));
#pragma unroll
    for (int c = 1; c < C; ++c) {
      const float pr = e.v[c].re * e.v[0].re + e.v[c].im * e.v[0].im;
      const float pi = e.v[c].im * e.v[0].re - e.v[c].re * e.v[0].im;
      feats[c - 1] = atan2f(pi, pr) * inv_bin;
    }
  }

  const unsigned out_plane = n_bins * n_frames;
  float* o = out + (b * (C - 1) * n_bins + bin) * n_frames + t;
#pragma unroll
  for (int c = 0; c < C - 1; ++c) o[c * out_plane] = valid ? feats[c] : 0.0f;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for an n_hop other than 3.
extern "C" int salsa_spatial_launch(const void* xr, const void* xi, const void* mask,
                                    void* out, int batch, int n_bins, int n_frames,
                                    int n_hop, int is_mic, float condition_number,
                                    int lower_bin, float delta, void* stream) {
  if (n_hop != kHop) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_frames + kBlock - 1) / kBlock, n_bins, batch);
  salsa_spatial_kernel<kHop><<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), n_bins, n_frames, is_mic,
      condition_number, lower_bin, delta);
  return static_cast<int>(cudaGetLastError());
}
