// 4x4 complex Hermitian algebra in registers, shared by K1 (salsa_spatial.cu)
// and K3 (salsa_spatial_probe.cu). A Hermitian matrix is held as its upper
// triangle H[i][j], i <= j; the lower entries are never read. Every function is
// forced inline, so each kernel compiles it as if it were written in place.
#pragma once

#include <cuda_runtime.h>

namespace herm4 {

constexpr int C = 4;

struct Cf {
  float re, im;
};

// Power-iteration start vectors: jax.random.normal(PRNGKey(20211021), (2, 2, 4))
// as salsa_pallas._start_vectors returns it, s0 = v[0, 0] + 1j * v[0, 1],
// s1 = v[1, 0] + 1j * v[1, 1]. `static`: each kernel file keeps its own copy.
static __constant__ float kS0Re[C] = {0.72769094f, -0.9307311f, 1.1572573f, 0.88554f};
static __constant__ float kS0Im[C] = {0.32384574f, -2.380504f, -1.076081f, 0.3645283f};
static __constant__ float kS1Re[C] = {-2.3784811f, -1.759696f, 0.7045168f, 0.38834825f};
static __constant__ float kS1Im[C] = {0.20879258f, 1.0385665f, 0.97886115f, 0.60916615f};

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

}  // namespace herm4
