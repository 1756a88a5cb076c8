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

namespace {

constexpr int C = 4;
constexpr int kBlock = 128;
constexpr int kSquarings = 3;

// jax.random.normal(PRNGKey(20211021), (2, 2, 4)) as salsa_pallas._start_vectors
// returns it: s0 = v[0, 0] + 1j * v[0, 1], s1 = v[1, 0] + 1j * v[1, 1].
__constant__ float kS0Re[C] = {0.72769094f, -0.9307311f, 1.1572573f, 0.88554f};
__constant__ float kS0Im[C] = {0.32384574f, -2.380504f, -1.076081f, 0.3645283f};
__constant__ float kS1Re[C] = {-2.3784811f, -1.759696f, 0.7045168f, 0.38834825f};
__constant__ float kS1Im[C] = {0.20879258f, 1.0385665f, 0.97886115f, 0.60916615f};

struct Cf {
  float re, im;
};

__device__ __forceinline__ Cf cmul(Cf a, Cf b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
__device__ __forceinline__ Cf cadd(Cf a, Cf b) { return {a.re + b.re, a.im + b.im}; }
__device__ __forceinline__ Cf cconj(Cf a) { return {a.re, -a.im}; }
__device__ __forceinline__ Cf cscale(Cf a, float s) { return {a.re * s, a.im * s}; }

// H holds the upper triangle (i <= j) of a Hermitian matrix.
__device__ __forceinline__ Cf herm(const Cf (&H)[C][C], int i, int j) {
  return i <= j ? H[i][j] : cconj(H[j][i]);
}

__device__ __forceinline__ void matvec(const Cf (&H)[C][C], const Cf (&v)[C], Cf (&out)[C]) {
#pragma unroll
  for (int i = 0; i < C; ++i) {
    Cf acc = cmul(herm(H, i, 0), v[0]);
#pragma unroll
    for (int j = 1; j < C; ++j) acc = cadd(acc, cmul(herm(H, i, j), v[j]));
    out[i] = acc;
  }
}

__device__ __forceinline__ float trace(const Cf (&H)[C][C]) {
  float t = H[0][0].re;
#pragma unroll
  for (int i = 1; i < C; ++i) t += H[i][i].re;
  return t;
}

// H <- H @ H, then H <- H / (tr(H) + 1e-30)
__device__ __forceinline__ void square_renorm(Cf (&H)[C][C]) {
  Cf out[C][C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
#pragma unroll
    for (int j = i; j < C; ++j) {
      Cf acc = cmul(herm(H, i, 0), herm(H, 0, j));
#pragma unroll
      for (int k = 1; k < C; ++k) acc = cadd(acc, cmul(herm(H, i, k), herm(H, k, j)));
      out[i][j] = acc;
    }
  }
  const float inv = 1.0f / (trace(out) + 1e-30f);
#pragma unroll
  for (int i = 0; i < C; ++i) {
#pragma unroll
    for (int j = i; j < C; ++j) H[i][j] = cscale(out[i][j], inv);
  }
}

__device__ __forceinline__ void normalize(Cf (&v)[C]) {
  float nrm2 = v[0].re * v[0].re + v[0].im * v[0].im;
#pragma unroll
  for (int c = 1; c < C; ++c) nrm2 += v[c].re * v[c].re + v[c].im * v[c].im;
  const float inv = rsqrtf(nrm2 + 1e-30f);
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = cscale(v[c], inv);
}

__device__ __forceinline__ float rayleigh(const Cf (&H)[C][C], const Cf (&v)[C]) {
  Cf hv[C];
  matvec(H, v, hv);
  float acc = v[0].re * hv[0].re + v[0].im * hv[0].im;
#pragma unroll
  for (int c = 1; c < C; ++c) acc += v[c].re * hv[c].re + v[c].im * hv[c].im;
  return acc;
}

// u <- u - (v^H u) v
__device__ __forceinline__ void orth(Cf (&u)[C], const Cf (&v)[C]) {
  float dr = v[0].re * u[0].re + v[0].im * u[0].im;
  float di = v[0].re * u[0].im - v[0].im * u[0].re;
#pragma unroll
  for (int c = 1; c < C; ++c) {
    dr += v[c].re * u[c].re + v[c].im * u[c].im;
    di += v[c].re * u[c].im - v[c].im * u[c].re;
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    u[c] = {u[c].re - (dr * v[c].re - di * v[c].im),
            u[c].im - (dr * v[c].im + di * v[c].re)};
  }
}

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
