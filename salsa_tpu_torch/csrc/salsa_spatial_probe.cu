// K3: ablation variants of the SALSA spatial stage for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scripts/probe_salsa_kernel.py:67
// make_kernel(variant, n_sq, bin_tile, t_tile)._kernel (pallas_call at :206):
// K1's FOA arithmetic (salsa_spatial.cu) with parts dropped or reordered, to
// show where K1's time goes. Per (clip, bin, frame), as the JAX probe defines
// each variant:
//   full       K1's FOA numerics with n_sq squarings (n_sq = 3 is K1);
//   prep_only  load and store only: where(mask, re x_c[t] of the PADDED planes,
//              0) for c = 0..2, i.e. frame t - n_hop of the clip, no algebra;
//   cov_only   the 7-frame covariance only: where(mask, Re R[0][c+1], 0), the
//              tracker mask with no coherence test;
//   no_second  no runner-up eigenvector: lambda1 = 0, so valid = mask AND
//              lambda0 > 0;
//   prodslide  each frame's 10 products x_i conj(x_j) computed once per block
//              and summed over 7 shifts, instead of once per output frame;
//   realdiag   prodslide with the diagonals of R and of every squared P kept
//              real (|h_ik|^2 sums, imaginary part 0).
//
// What bounds it on the H100: at (32, 4, 191, 4807) the band planes are 940 MB,
// the mask 29 MB and the 3 output planes 352 MB. prep_only reads 3 of the 8
// planes, the mask and writes the output, ~0.73 GB: a pure copy, bound by
// device memory (~0.22 ms at 3.35 TB/s). Every variant that runs the
// eigensolver does ~2,700 fp32 operations per cell (~60 flop/B, above the
// card's fp32 ridge of ~20), so it is bound by the fp32 pipes, like K1.
// cov_only in between: 7 x 10 complex products and sums per cell.
// Design: the variant and the squaring count are template parameters, so each
// variant is its own straight-line kernel with no runtime branch; threads per
// block are chosen at launch (64 to 512) with K1's mapping, one thread per
// (clip, bin, frame), frames on threadIdx.x for coalesced plane reads. The
// TPU probe's BIN_TILE x T_TILE sweep and its 128-frame halo do not carry over:
// the block size is the sweep here. prodslide/realdiag stage the block's
// per-frame products (the block's frames plus 2*n_hop context frames, 20 floats
// each) in dynamic shared memory, one pass of loads, then each thread sums its
// 7 shifted entries; without that staging they would time what full times.
// K1's device helpers and start vectors are shared through hermitian4.cuh; K1's
// arithmetic is unchanged.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hermitian4.cuh"

namespace {

using herm4::C;
using herm4::cadd;
using herm4::Cf;
using herm4::cmul;
using herm4::cconj;
using herm4::cscale;
using herm4::herm;
using herm4::kS0Im;
using herm4::kS0Re;
using herm4::kS1Im;
using herm4::kS1Re;
using herm4::matvec;
using herm4::normalize;
using herm4::orth;
using herm4::rayleigh;
using herm4::square_renorm;
using herm4::trace;

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
constexpr int kPairs = C * (C + 1) / 2;  // upper triangle of R

// square_renorm with real diagonals: P2[i][i] = sum_k |p_ik|^2 (probe's
// _matsquare_v(realdiag=True)), off-diagonals as square_renorm.
__device__ __forceinline__ void square_renorm_realdiag(Cf (&H)[C][C]) {
  Cf out[C][C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
#pragma unroll
    for (int j = i; j < C; ++j) {
      if (i == j) {
        const Cf h0 = H[0][i];  // |h_i0| = |h_0i|
        float acc = h0.re * h0.re + h0.im * h0.im;
#pragma unroll
        for (int k = 1; k < C; ++k) {
          const Cf h = i <= k ? H[i][k] : H[k][i];
          acc += h.re * h.re + h.im * h.im;
        }
        out[i][i] = {acc, 0.0f};
      } else {
        Cf acc = cmul(herm(H, i, 0), herm(H, 0, j));
#pragma unroll
        for (int k = 1; k < C; ++k) acc = cadd(acc, cmul(herm(H, i, k), herm(H, k, j)));
        out[i][j] = acc;
      }
    }
  }
  const float inv = 1.0f / (trace(out) + 1e-30f);
#pragma unroll
  for (int i = 0; i < C; ++i) {
    out[i][i].re *= inv;  // the imaginary part stays 0
    H[i][i] = out[i][i];
#pragma unroll
    for (int j = i + 1; j < C; ++j) H[i][j] = cscale(out[i][j], inv);
  }
}

// xr, xi: (B, C, n_bins, n_frames + 2*n_hop); mask: (B, n_bins, n_frames) bytes;
// out: (B, C-1, n_bins, n_frames). Grid (frame tiles of blockDim.x, bins, clips).
template <int V, int NSQ>
__global__ void __launch_bounds__(kMaxBlock) salsa_spatial_probe_kernel(
    const float* __restrict__ xr, const float* __restrict__ xi,
    const uint8_t* __restrict__ mask, float* __restrict__ out, int n_bins,
    int n_frames, int n_hop, float condition_number) {
  constexpr bool kSlide = V == kProdSlide || V == kRealDiag;
  constexpr bool kRealDiagonal = V == kRealDiag;
  const int t0 = blockIdx.x * blockDim.x;
  const int t = t0 + threadIdx.x;
  const int bin = blockIdx.y;
  const int b = blockIdx.z;
  const int win = 2 * n_hop + 1;
  const long long tp = (long long)n_frames + 2 * n_hop;
  const long long plane = (long long)n_bins * tp;
  const long long row = ((long long)b * C * n_bins + bin) * tp;
  const long long cell = ((long long)b * n_bins + bin) * n_frames + t;
  const long long out_plane = (long long)n_bins * n_frames;
  const long long out_base = ((long long)b * (C - 1) * n_bins + bin) * n_frames + t;
  const float inv_win = 1.0f / (float)win;

  Cf R[C][C];
  if constexpr (kSlide) {
    // per-frame products of the block's frames and context: prod[2p (+1)][f]
    extern __shared__ float prod[];
    const int span = blockDim.x + 2 * n_hop;
    for (int f = threadIdx.x; f < span; f += blockDim.x) {
      Cf x[C];
      const bool in = t0 + f < tp;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        x[c] = in ? Cf{xr[row + c * plane + t0 + f], xi[row + c * plane + t0 + f]}
                  : Cf{0.0f, 0.0f};
      }
      int p = 0;
#pragma unroll
      for (int i = 0; i < C; ++i) {
#pragma unroll
        for (int j = i; j < C; ++j, ++p) {
          if (kRealDiagonal && i == j) {
            prod[(2 * p) * span + f] = x[i].re * x[i].re + x[i].im * x[i].im;
          } else {
            const Cf q = cmul(x[i], cconj(x[j]));
            prod[(2 * p) * span + f] = q.re;
            prod[(2 * p + 1) * span + f] = q.im;
          }
        }
      }
    }
    __syncthreads();
    if (t >= n_frames) return;
    int p = 0;
#pragma unroll
    for (int i = 0; i < C; ++i) {
#pragma unroll
      for (int j = i; j < C; ++j, ++p) {
        const float* pr = prod + (2 * p) * span + threadIdx.x;
        const float* pi = prod + (2 * p + 1) * span + threadIdx.x;
        if (kRealDiagonal && i == j) {
          float acc = pr[0];
          for (int k = 1; k < win; ++k) acc += pr[k];
          R[i][j] = {acc * inv_win, 0.0f};
        } else {
          Cf acc = {pr[0], pi[0]};
          for (int k = 1; k < win; ++k) acc = cadd(acc, Cf{pr[k], pi[k]});
          R[i][j] = cscale(acc, inv_win);
        }
      }
    }
  } else {
    if (t >= n_frames) return;
    const long long base = row + t;
    if constexpr (V == kPrepOnly) {
      const bool m = mask[cell] != 0;
#pragma unroll
      for (int c = 0; c < C - 1; ++c) out[out_base + c * out_plane] = m ? xr[base + c * plane] : 0.0f;
      return;
    }
    // K1's windowed covariance, products recomputed for every output frame
    {
      Cf x[C];
#pragma unroll
      for (int c = 0; c < C; ++c) x[c] = {xr[base + c * plane], xi[base + c * plane]};
#pragma unroll
      for (int i = 0; i < C; ++i) {
#pragma unroll
        for (int j = i; j < C; ++j) R[i][j] = cmul(x[i], cconj(x[j]));
      }
    }
    for (int k = 1; k < win; ++k) {
      Cf x[C];
#pragma unroll
      for (int c = 0; c < C; ++c) x[c] = {xr[base + c * plane + k], xi[base + c * plane + k]};
#pragma unroll
      for (int i = 0; i < C; ++i) {
#pragma unroll
        for (int j = i; j < C; ++j) R[i][j] = cadd(R[i][j], cmul(x[i], cconj(x[j])));
      }
    }
#pragma unroll
    for (int i = 0; i < C; ++i) {
#pragma unroll
      for (int j = i; j < C; ++j) R[i][j] = cscale(R[i][j], inv_win);
    }
  }

  if constexpr (V == kCovOnly) {
    const bool m = mask[cell] != 0;
#pragma unroll
    for (int c = 0; c < C - 1; ++c) out[out_base + c * out_plane] = m ? R[0][c + 1].re : 0.0f;
    return;
  } else if constexpr (V != kPrepOnly) {
    // ---- trace normalisation + NSQ squarings ----
    Cf Rn[C][C], P[C][C];
    const float inv_tr = 1.0f / (trace(R) + 1e-30f);
#pragma unroll
    for (int i = 0; i < C; ++i) {
#pragma unroll
      for (int j = i; j < C; ++j) {
        Rn[i][j] = cscale(R[i][j], inv_tr);
        if (kRealDiagonal && i == j) Rn[i][j].im = 0.0f;
        P[i][j] = Rn[i][j];
      }
    }
#pragma unroll
    for (int s = 0; s < NSQ; ++s) {
      if constexpr (kRealDiagonal) {
        square_renorm_realdiag(P);
      } else {
        square_renorm(P);
      }
    }

    // ---- principal eigenpair ----
    Cf s[C], v[C], w[C];
#pragma unroll
    for (int c = 0; c < C; ++c) s[c] = {kS0Re[c], kS0Im[c]};
    matvec(P, s, v);
    normalize(v);
    matvec(P, v, w);
    normalize(w);
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = w[c];
    const float lam0 = rayleigh(R, v);

    // ---- runner-up eigenvalue ----
    float lam1 = 0.0f;
    if constexpr (V != kNoSecond) {
      Cf u[C];
#pragma unroll
      for (int c = 0; c < C; ++c) u[c] = {kS1Re[c], kS1Im[c]};
      orth(u, v);
#pragma unroll
      for (int it = 0; it < 3; ++it) {
        matvec(Rn, u, w);
        orth(w, v);
        normalize(w);
#pragma unroll
        for (int c = 0; c < C; ++c) u[c] = w[c];
      }
      lam1 = rayleigh(R, u);
    }
    const bool valid = mask[cell] != 0 && lam0 > lam1 * condition_number;

    // ---- FOA direction, L2-normalised over the 3 spatial channels ----
    float feats[C - 1];
    const float inv_v0 = 1.0f / (v[0].re * v[0].re + v[0].im * v[0].im + 1e-30f);
    float sum = 0.0f;
#pragma unroll
    for (int c = 1; c < C; ++c) {
      feats[c - 1] = (v[c].re * v[0].re + v[c].im * v[0].im) * inv_v0;
      sum += feats[c - 1] * feats[c - 1];
    }
    const float nrm = rsqrtf(sum + 1e-30f);
#pragma unroll
    for (int c = 0; c < C - 1; ++c) out[out_base + c * out_plane] = valid ? feats[c] * nrm : 0.0f;
  }
}

using KernelFn = void (*)(const float*, const float*, const uint8_t*, float*, int, int, int,
                          float);

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
// cudaErrorInvalidValue for an unknown variant, n_sq outside 1..4 or a block
// size other than 64, 128, 256 or 512.
extern "C" int salsa_spatial_probe_launch(const void* xr, const void* xi, const void* mask,
                                          void* out, int batch, int n_bins, int n_frames,
                                          int n_hop, int variant, int n_sq,
                                          float condition_number, int threads, void* stream) {
  const KernelFn fn = pick(variant, n_sq);
  if (fn == nullptr || !(threads == 64 || threads == 128 || threads == 256 || threads == 512)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool slide = variant == kProdSlide || variant == kRealDiag;
  const size_t smem = slide ? sizeof(float) * 2 * kPairs * (threads + 2 * n_hop) : 0;
  const dim3 grid((n_frames + threads - 1) / threads, n_bins, batch);
  fn<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), n_bins, n_frames, n_hop,
      condition_number);
  return static_cast<int>(cudaGetLastError());
}
