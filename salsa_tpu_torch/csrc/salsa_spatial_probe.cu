// K3: ablation variants of the SALSA spatial stage for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scripts/probe_salsa_kernel.py:67
// make_kernel(variant, n_sq, bin_tile, t_tile)._kernel (pallas_call at :206):
// K1's FOA arithmetic (salsa_spatial.cu) with parts dropped or reordered, to
// show where K1's time goes. Per (clip, bin, frame), as the JAX probe defines
// each variant:
//   full       K1's FOA numerics with n_sq squarings (n_sq = 3 is K1: both call
//              herm4::solve_cell, so the two are bit-equal);
//   prep_only  load and store only: where(mask, re x_c[t] of the PADDED planes,
//              0) for c = 0..2, i.e. frame t - n_hop of the clip, no algebra;
//   cov_only   the 7-frame covariance only: where(mask, Re R[0][c+1], 0), the
//              tracker mask with no coherence test;
//   no_second  no runner-up eigenvector: lambda1 = 0, so valid = mask AND
//              lambda0 > 0;
//   prodslide  each frame's 10 products x_i conj(x_j) (20 floats, the diagonal's
//              imaginary parts too) computed once per block into shared memory
//              and summed over 7 shifts, instead of once per output frame;
//   realdiag   prodslide with the diagonal products staged real (|x_i|^2, 16
//              floats a frame).
// Since K1 holds every Hermitian matrix with a real diagonal (hermitian4.cuh),
// prodslide and realdiag differ from `full` only in how the covariance is formed:
// they measure shared-memory staging against K1's recomputation in registers.
//
// What bounds it on the H100: at (32, 4, 191, 4807) the band planes are 940 MB,
// the mask 29 MB and the 3 output planes 352 MB. prep_only reads 3 of the 8
// planes, the mask and writes the output, ~0.73 GB: a pure copy, bound by
// device memory (~0.22 ms at 3.35 TB/s). Every variant that runs the
// eigensolver does K1's ~2,100 fp32 operations a cell (~47 flop/B, above the
// card's fp32 ridge of ~20), so it is bound by the fp32 pipes, like K1.
// cov_only in between: 7 frames of 4 + 6 Hermitian products and sums a cell.
// Design: the variant and the squaring count are template parameters, so each
// variant is its own straight-line kernel with no runtime branch; n_hop is 3, as
// in K1; threads per block are chosen at launch (64 to 512) with K1's mapping,
// one thread per (clip, bin, frame), frames on threadIdx.x for coalesced plane
// reads. The TPU probe's BIN_TILE x T_TILE sweep and its 128-frame halo do not
// carry over: the block size is the sweep here. prodslide/realdiag stage the
// block's per-frame products (the block's frames plus 2*n_hop context frames) in
// dynamic shared memory, one pass of loads, then each thread sums its 7 shifted
// entries.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hermitian4.cuh"

namespace {

using herm4::C;
using herm4::Cf;
using herm4::Eig;
using herm4::Herm;
using herm4::pair;

// variant codes, as salsa_tpu_torch/scripts/probe_salsa_kernel.py::VARIANTS
enum Variant : int {
  kFull = 0,
  kPrepOnly = 1,
  kCovOnly = 2,
  kNoSecond = 3,
  kProdSlide = 4,
  kRealDiag = 5,
};
constexpr int kMaxBlock = 512;
constexpr int kHop = 3;  // K1's n_hop
constexpr int kWin = 2 * kHop + 1;
constexpr int kPairs = C * (C + 1) / 2;  // upper triangle of R, diagonal included

// xr, xi: (B, C, n_bins, n_frames + 2*kHop); mask: (B, n_bins, n_frames) bytes;
// out: (B, C-1, n_bins, n_frames). Grid (frame tiles of blockDim.x, bins, clips).
// Every element index is below 2^31.
template <int V, int NSQ>
__global__ void __launch_bounds__(kMaxBlock) salsa_spatial_probe_kernel(
    const float* __restrict__ xr, const float* __restrict__ xi,
    const uint8_t* __restrict__ mask, float* __restrict__ out, int n_bins,
    int n_frames, float condition_number) {
  constexpr bool kSlide = V == kProdSlide || V == kRealDiag;
  const unsigned t0 = blockIdx.x * blockDim.x;
  const unsigned t = t0 + threadIdx.x;
  const unsigned bin = blockIdx.y;
  const unsigned b = blockIdx.z;
  const unsigned tp = n_frames + 2 * kHop;
  const unsigned plane = n_bins * tp;
  const unsigned row = (b * C * n_bins + bin) * tp;
  const unsigned cell = (b * n_bins + bin) * n_frames + t;
  const unsigned out_plane = n_bins * n_frames;
  float* o = out + (b * (C - 1) * n_bins + bin) * n_frames + t;

  Herm R;
  if constexpr (kSlide) {
    // per-frame products of the block's frames and context, staged plane q at
    // prod[q * span + f]: pair p of the upper triangle (diagonal included) in
    // planes 2p (re) and 2p + 1 (im); with a real diagonal, |x_i|^2 in plane i
    // and upper entry pair(i, j) in planes C + 2 pair(i, j) and the one after
    extern __shared__ float prod[];
    const unsigned span = blockDim.x + 2 * kHop;
    for (unsigned f = threadIdx.x; f < span; f += blockDim.x) {
      Cf x[C];
      const bool in = t0 + f < tp;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        x[c] = in ? Cf{xr[row + c * plane + t0 + f], xi[row + c * plane + t0 + f]}
                  : Cf{0.0f, 0.0f};
      }
      if constexpr (V == kRealDiag) {
#pragma unroll
        for (int i = 0; i < C; ++i) prod[i * span + f] = x[i].re * x[i].re + x[i].im * x[i].im;
#pragma unroll
        for (int i = 0; i < C; ++i) {
#pragma unroll
          for (int j = i + 1; j < C; ++j) {
            const Cf q = herm4::cmul(x[i], {x[j].re, -x[j].im});
            prod[(C + 2 * pair(i, j)) * span + f] = q.re;
            prod[(C + 2 * pair(i, j) + 1) * span + f] = q.im;
          }
        }
      } else {
        int p = 0;
#pragma unroll
        for (int i = 0; i < C; ++i) {
#pragma unroll
          for (int j = i; j < C; ++j, ++p) {
            const Cf q = herm4::cmul(x[i], {x[j].re, -x[j].im});
            prod[(2 * p) * span + f] = q.re;
            prod[(2 * p + 1) * span + f] = q.im;
          }
        }
      }
    }
    __syncthreads();
    if (t >= (unsigned)n_frames) return;
    // the sum over the window of staged plane q, in frame order
    auto window_sum = [&](int q) {
      const float* s = prod + q * span + threadIdx.x;
      float acc = s[0];
#pragma unroll
      for (int k = 1; k < kWin; ++k) acc += s[k];
      return acc;
    };
    constexpr float kInvWin = 1.0f / kWin;
    int p = 0;
#pragma unroll
    for (int i = 0; i < C; ++i) {
#pragma unroll
      for (int j = i; j < C; ++j, ++p) {
        if (i == j) {
          R.d[i] = window_sum(V == kRealDiag ? i : 2 * p) * kInvWin;
        } else {
          const int q = V == kRealDiag ? C + 2 * pair(i, j) : 2 * p;
          R.o[pair(i, j)] = {window_sum(q) * kInvWin, window_sum(q + 1) * kInvWin};
        }
      }
    }
  } else {
    if (t >= (unsigned)n_frames) return;
    if constexpr (V == kPrepOnly) {
      const bool m = mask[cell] != 0;
#pragma unroll
      for (int c = 0; c < C - 1; ++c) o[c * out_plane] = m ? xr[row + c * plane + t] : 0.0f;
      return;
    }
    if constexpr (V == kCovOnly) {
      R = herm4::window_covariance<kHop>(xr + row + t, xi + row + t, plane);
    }
  }

  if constexpr (V == kCovOnly) {
    const bool m = mask[cell] != 0;
#pragma unroll
    for (int c = 0; c < C - 1; ++c) o[c * out_plane] = m ? R.o[pair(0, c + 1)].re : 0.0f;
  } else if constexpr (V != kPrepOnly) {
    Eig e;
    if constexpr (kSlide) {
      e = herm4::top_eigs<NSQ, true>(R);
    } else {
      e = herm4::solve_cell<kHop, NSQ, V != kNoSecond>(xr + row + t, xi + row + t, plane);
    }
    const bool valid = mask[cell] != 0 && e.lam0 > e.lam1 * condition_number;
    float feats[C - 1];
    herm4::foa_direction(e.v, feats);
#pragma unroll
    for (int c = 0; c < C - 1; ++c) o[c * out_plane] = valid ? feats[c] : 0.0f;
  }
}

using KernelFn = void (*)(const float*, const float*, const uint8_t*, float*, int, int, float);

template <int V>
KernelFn pick_squarings(int n_sq) {
  switch (n_sq) {
    case 1: return salsa_spatial_probe_kernel<V, 1>;
    case 2: return salsa_spatial_probe_kernel<V, 2>;
    case 3: return salsa_spatial_probe_kernel<V, 3>;
    case 4: return salsa_spatial_probe_kernel<V, 4>;
    default: return nullptr;
  }
}

KernelFn pick(int variant, int n_sq) {
  if (n_sq < 1 || n_sq > 4) return nullptr;
  switch (variant) {
    case kFull: return pick_squarings<kFull>(n_sq);
    case kPrepOnly: return salsa_spatial_probe_kernel<kPrepOnly, 3>;  // no squaring
    case kCovOnly: return salsa_spatial_probe_kernel<kCovOnly, 3>;    // no squaring
    case kNoSecond: return pick_squarings<kNoSecond>(n_sq);
    case kProdSlide: return pick_squarings<kProdSlide>(n_sq);
    case kRealDiag: return pick_squarings<kRealDiag>(n_sq);
    default: return nullptr;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for an unknown variant, n_sq outside 1..4, n_hop other
// than 3 or a block size other than 64, 128, 256 or 512.
extern "C" int salsa_spatial_probe_launch(const void* xr, const void* xi, const void* mask,
                                          void* out, int batch, int n_bins, int n_frames,
                                          int n_hop, int variant, int n_sq,
                                          float condition_number, int threads, void* stream) {
  const KernelFn fn = pick(variant, n_sq);
  if (fn == nullptr || n_hop != kHop ||
      !(threads == 64 || threads == 128 || threads == 256 || threads == 512)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // staged planes a frame: every pair's re and im, or with a real diagonal its re
  const int planes = variant == kRealDiag ? 2 * kPairs - C : 2 * kPairs;
  const bool slide = variant == kProdSlide || variant == kRealDiag;
  const size_t smem = slide ? sizeof(float) * planes * (threads + 2 * kHop) : 0;
  const dim3 grid((n_frames + threads - 1) / threads, n_bins, batch);
  fn<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), n_bins, n_frames,
      condition_number);
  return static_cast<int>(cudaGetLastError());
}
