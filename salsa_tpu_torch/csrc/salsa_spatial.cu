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
// ~2,700 fp32 operations per cell (covariance, 3 Hermitian squarings, 7
// matvecs): ~60 flop/B, above the card's fp32 ridge of ~20, so it leans
// compute-bound on the fp32 pipes. No tensor cores: the algebra is 4x4 complex.
// Design: one thread per (clip, bin, frame), frames on threadIdx.x so a warp
// reads 32 neighbouring frames of one plane (coalesced); the 7-frame window
// overlaps between neighbouring threads, so the 6 extra frames come from L1/L2
// rather than device memory. The whole 4x4 Hermitian algebra (upper triangle
// only) lives in registers; nothing but the 3 outputs is written. The TPU
// kernel's 16 x 1024 tiling and its 128-frame halo are gone: a thread needs
// only its 2*n_hop context frames, and ragged edges are masked per thread.
//
// Arithmetic follows the Pallas kernel term by term (multiply by 1/win, the
// 1e-30 guards, rsqrtf normalisation, 3 squarings), except that atan2f
// replaces its polynomial atan2. nvcc may contract products and sums into
// FMAs here, so results differ from the plain PyTorch mirror in the last bits.
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
using herm4::matvec;
using herm4::normalize;
using herm4::orth;
using herm4::rayleigh;
using herm4::square_renorm;
using herm4::trace;

using herm4::kS0Im;
using herm4::kS0Re;
using herm4::kS1Im;
using herm4::kS1Re;

constexpr int kBlock = 128;
constexpr int kSquarings = 3;

// xr, xi: (B, C, n_bins, n_frames + 2*n_hop); mask: (B, n_bins, n_frames) bytes;
// out: (B, C-1, n_bins, n_frames). Grid (frame tiles, bins, clips).
__global__ void __launch_bounds__(kBlock) salsa_spatial_kernel(
    const float* __restrict__ xr, const float* __restrict__ xi,
    const uint8_t* __restrict__ mask, float* __restrict__ out, int n_bins,
    int n_frames, int n_hop, int is_mic, float condition_number, int lower_bin,
    float delta) {
  const int t = blockIdx.x * kBlock + threadIdx.x;
  if (t >= n_frames) return;
  const int bin = blockIdx.y;
  const int b = blockIdx.z;
  const int win = 2 * n_hop + 1;
  const long long tp = (long long)n_frames + 2 * n_hop;
  const long long plane = (long long)n_bins * tp;
  const long long base = ((long long)b * C * n_bins + bin) * tp + t;

  // ---- windowed covariance R[i][j] = mean_k x_i[t+k] conj(x_j[t+k]) ----
  Cf R[C][C];
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
  const float inv_win = 1.0f / (float)win;
#pragma unroll
  for (int i = 0; i < C; ++i) {
#pragma unroll
    for (int j = i; j < C; ++j) R[i][j] = cscale(R[i][j], inv_win);
  }

  // ---- trace normalisation + repeated squaring ----
  Cf Rn[C][C], P[C][C];
  const float inv_tr = 1.0f / (trace(R) + 1e-30f);
#pragma unroll
  for (int i = 0; i < C; ++i) {
#pragma unroll
    for (int j = i; j < C; ++j) {
      Rn[i][j] = cscale(R[i][j], inv_tr);
      P[i][j] = Rn[i][j];
    }
  }
#pragma unroll
  for (int s = 0; s < kSquarings; ++s) square_renorm(P);

  // ---- principal eigenpair ----
  Cf s[C], v[C];
#pragma unroll
  for (int c = 0; c < C; ++c) s[c] = {kS0Re[c], kS0Im[c]};
  matvec(P, s, v);
  normalize(v);
  Cf w[C];
  matvec(P, v, w);
  normalize(w);
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = w[c];
  const float lam0 = rayleigh(R, v);

  // ---- runner-up eigenvalue ----
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
  const float lam1 = rayleigh(R, u);

  const long long cell = ((long long)b * n_bins + bin) * n_frames + t;
  const bool valid = mask[cell] != 0 && lam0 > lam1 * condition_number;

  // ---- normalisation to the 3 spatial channels ----
  float feats[C - 1];
  if (!is_mic) {
    const float inv_v0 = 1.0f / (v[0].re * v[0].re + v[0].im * v[0].im + 1e-30f);
    float sum = 0.0f;
#pragma unroll
    for (int c = 1; c < C; ++c) {
      feats[c - 1] = (v[c].re * v[0].re + v[c].im * v[0].im) * inv_v0;
      sum += feats[c - 1] * feats[c - 1];
    }
    const float nrm = rsqrtf(sum + 1e-30f);
#pragma unroll
    for (int c = 0; c < C - 1; ++c) feats[c] *= nrm;
  } else {
    const float inv_bin = 1.0f / (delta * (float)(lower_bin + bin));
#pragma unroll
    for (int c = 1; c < C; ++c) {
      const float pr = v[c].re * v[0].re + v[c].im * v[0].im;
      const float pi = v[c].im * v[0].re - v[c].re * v[0].im;
      feats[c - 1] = atan2f(pi, pr) * inv_bin;
    }
  }

  const long long out_plane = (long long)n_bins * n_frames;
  const long long out_base = ((long long)b * (C - 1) * n_bins + bin) * n_frames + t;
#pragma unroll
  for (int c = 0; c < C - 1; ++c) out[out_base + c * out_plane] = valid ? feats[c] : 0.0f;
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int salsa_spatial_launch(const void* xr, const void* xi, const void* mask,
                                    void* out, int batch, int n_bins, int n_frames,
                                    int n_hop, int is_mic, float condition_number,
                                    int lower_bin, float delta, void* stream) {
  const dim3 grid((n_frames + kBlock - 1) / kBlock, n_bins, batch);
  salsa_spatial_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), n_bins, n_frames,
      n_hop, is_mic, condition_number, lower_bin, delta);
  return static_cast<int>(cudaGetLastError());
}
