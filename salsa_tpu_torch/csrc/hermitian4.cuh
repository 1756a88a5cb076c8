// 4x4 complex Hermitian algebra in registers, and the per-cell solve that K1
// (salsa_spatial.cu) and K3 (salsa_spatial_probe.cu) both run.
//
// A Hermitian matrix is held as its 4 real diagonal entries and its 6 complex
// upper entries, 16 floats: the diagonal of the covariance R, of R / tr R and of
// every squared power of it is real, so no operation is spent on an imaginary
// part that is zero. A diagonal output of a square is h_ii^2 + sum |h_ik|^2, a
// product with a diagonal entry is real x complex, and a Rayleigh quotient is
// sum h_ii |v_i|^2 + 2 Re sum_{i<j} conj(v_i) h_ij v_j. Sums are written as chains
// (acc = acc + a * b) that nvcc contracts into FFMAs. Every function is forced
// inline and every loop fully unrolled, so each index is a compile-time constant
// and the matrices stay in registers.
#pragma once

#include <cuda_runtime.h>

namespace herm4 {

constexpr int C = 4;
constexpr int kOff = C * (C - 1) / 2;  // upper entries

struct Cf {
  float re, im;
};

// d: the real diagonal; o[pair(i, j)]: the entry H[i][j], i < j
struct Herm {
  float d[C];
  Cf o[kOff];
};

// (0,1) (0,2) (0,3) (1,2) (1,3) (2,3) -> 0 .. 5
__host__ __device__ constexpr int pair(int i, int j) { return i * (5 - i) / 2 + j - 1; }

// Power-iteration start vectors: jax.random.normal(PRNGKey(20211021), (2, 2, 4))
// as salsa_pallas._start_vectors returns it, s0 = v[0, 0] + 1j * v[0, 1],
// s1 = v[1, 0] + 1j * v[1, 1]. `static`: each kernel file keeps its own copy.
static __constant__ float kS0Re[C] = {0.72769094f, -0.9307311f, 1.1572573f, 0.88554f};
static __constant__ float kS0Im[C] = {0.32384574f, -2.380504f, -1.076081f, 0.3645283f};
static __constant__ float kS1Re[C] = {-2.3784811f, -1.759696f, 0.7045168f, 0.38834825f};
static __constant__ float kS1Im[C] = {0.20879258f, 1.0385665f, 0.97886115f, 0.60916615f};

// H[i][k] for i != k
__device__ __forceinline__ Cf entry(const Herm& H, int i, int k) {
  return i < k ? H.o[pair(i, k)] : Cf{H.o[pair(k, i)].re, -H.o[pair(k, i)].im};
}

__device__ __forceinline__ Cf cmul(Cf a, Cf b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}

// acc + a * b as two chains of two products each
__device__ __forceinline__ Cf cmac(Cf acc, Cf a, Cf b) {
  acc.re = acc.re + a.re * b.re;
  acc.re = acc.re - a.im * b.im;
  acc.im = acc.im + a.re * b.im;
  acc.im = acc.im + a.im * b.re;
  return acc;
}

__device__ __forceinline__ float trace(const Herm& H) {
  return ((H.d[0] + H.d[1]) + H.d[2]) + H.d[3];
}

__device__ __forceinline__ void scale(Herm& H, float s) {
#pragma unroll
  for (int i = 0; i < C; ++i) H.d[i] *= s;
#pragma unroll
  for (int p = 0; p < kOff; ++p) H.o[p] = {H.o[p].re * s, H.o[p].im * s};
}

// 1 / x for a scale that is renormalised away afterwards: MUFU.RCP, within an
// ulp or so, where an IEEE divide costs a Newton step and a slow-path branch.
// x >= 1e-30 here (a trace plus its guard), a normal number.
__device__ __forceinline__ float rcp_scale(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void matvec(const Herm& H, const Cf (&v)[C], Cf (&out)[C]) {
#pragma unroll
  for (int i = 0; i < C; ++i) {
    Cf acc = {H.d[i] * v[i].re, H.d[i] * v[i].im};
#pragma unroll
    for (int k = 0; k < C; ++k) {
      if (k != i) acc = cmac(acc, entry(H, i, k), v[k]);
    }
    out[i] = acc;
  }
}

// H <- H @ H, then H <- H / (tr(H @ H) + 1e-30)
__device__ __forceinline__ void square_renorm(Herm& H) {
  Herm out;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    float acc = H.d[i] * H.d[i];
#pragma unroll
    for (int k = 0; k < C; ++k) {
      if (k == i) continue;
      const Cf h = H.o[i < k ? pair(i, k) : pair(k, i)];  // |h_ik| = |h_ki|
      acc = acc + h.re * h.re;
      acc = acc + h.im * h.im;
    }
    out.d[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < C; ++i) {
#pragma unroll
    for (int j = i + 1; j < C; ++j) {
      const float dd = H.d[i] + H.d[j];
      const Cf h = H.o[pair(i, j)];
      Cf acc = {dd * h.re, dd * h.im};
#pragma unroll
      for (int k = 0; k < C; ++k) {
        if (k != i && k != j) acc = cmac(acc, entry(H, i, k), entry(H, k, j));
      }
      out.o[pair(i, j)] = acc;
    }
  }
  scale(out, rcp_scale(trace(out) + 1e-30f));
  H = out;
}

__device__ __forceinline__ void normalize(Cf (&v)[C]) {
  float nrm2 = v[0].re * v[0].re + v[0].im * v[0].im;
#pragma unroll
  for (int c = 1; c < C; ++c) nrm2 += v[c].re * v[c].re + v[c].im * v[c].im;
  const float inv = rsqrtf(nrm2 + 1e-30f);
#pragma unroll
  for (int c = 0; c < C; ++c) v[c] = {v[c].re * inv, v[c].im * inv};
}

// v^H H v = sum h_ii |v_i|^2 + 2 Re sum_{i<j} conj(v_i) h_ij v_j
__device__ __forceinline__ float rayleigh(const Herm& H, const Cf (&v)[C]) {
  float diag = H.d[0] * (v[0].re * v[0].re + v[0].im * v[0].im);
#pragma unroll
  for (int i = 1; i < C; ++i) diag = diag + H.d[i] * (v[i].re * v[i].re + v[i].im * v[i].im);
  float cross = 0.0f;
#pragma unroll
  for (int i = 0; i < C; ++i) {
#pragma unroll
    for (int j = i + 1; j < C; ++j) {
      const Cf w = cmul(H.o[pair(i, j)], v[j]);
      if (i == 0 && j == 1) {
        cross = v[i].re * w.re + v[i].im * w.im;
      } else {
        cross = cross + v[i].re * w.re;
        cross = cross + v[i].im * w.im;
      }
    }
  }
  return diag + 2.0f * cross;
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

// The (2 NHOP + 1)-frame covariance R = mean_k x[k] x[k]^H of 4 channels, channel
// c's frames at xr[c * plane + k], xi[c * plane + k], k = 0 .. 2 NHOP. All loads
// are issued before the first product; the diagonal accumulates |x_i|^2.
template <int NHOP>
__device__ __forceinline__ Herm window_covariance(const float* __restrict__ xr,
                                                  const float* __restrict__ xi,
                                                  unsigned plane) {
  constexpr int kWin = 2 * NHOP + 1;
  float re[kWin][C], im[kWin][C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float* pr = xr + c * plane;
    const float* pi = xi + c * plane;
#pragma unroll
    for (int k = 0; k < kWin; ++k) {
      re[k][c] = pr[k];
      im[k][c] = pi[k];
    }
  }
  Herm R;
#pragma unroll
  for (int i = 0; i < C; ++i) R.d[i] = re[0][i] * re[0][i] + im[0][i] * im[0][i];
#pragma unroll
  for (int i = 0; i < C; ++i) {
#pragma unroll
    for (int j = i + 1; j < C; ++j) {
      R.o[pair(i, j)] = {re[0][i] * re[0][j] + im[0][i] * im[0][j],
                         im[0][i] * re[0][j] - re[0][i] * im[0][j]};
    }
  }
#pragma unroll
  for (int k = 1; k < kWin; ++k) {
#pragma unroll
    for (int i = 0; i < C; ++i) {
      R.d[i] = R.d[i] + re[k][i] * re[k][i];
      R.d[i] = R.d[i] + im[k][i] * im[k][i];
    }
#pragma unroll
    for (int i = 0; i < C; ++i) {
#pragma unroll
      for (int j = i + 1; j < C; ++j) {
        Cf& o = R.o[pair(i, j)];
        o.re = o.re + re[k][i] * re[k][j];
        o.re = o.re + im[k][i] * im[k][j];
        o.im = o.im + im[k][i] * re[k][j];
        o.im = o.im - re[k][i] * im[k][j];
      }
    }
  }
  scale(R, 1.0f / kWin);
  return R;
}

struct Eig {
  Cf v[C];          // principal eigenvector, unit norm
  float lam0, lam1;  // v^H R v and the runner-up's Rayleigh quotient
};

// From R: R / tr R squared NSQ times with trace renormalisation, the principal
// eigenvector from two matvecs with that power, lambda0 = v^H R v, and (with
// kSecond) lambda1 from 3 orthogonalised steps with R / tr R, else 0.
template <int NSQ, bool kSecond>
__device__ __forceinline__ Eig top_eigs(const Herm& R) {
  Herm Rn = R;
  scale(Rn, rcp_scale(trace(R) + 1e-30f));
  Herm P = Rn;
#pragma unroll
  for (int s = 0; s < NSQ; ++s) square_renorm(P);

  Eig e;
  Cf s[C], w[C];
#pragma unroll
  for (int c = 0; c < C; ++c) s[c] = {kS0Re[c], kS0Im[c]};
  matvec(P, s, w);
  normalize(w);
  matvec(P, w, e.v);
  normalize(e.v);
  e.lam0 = rayleigh(R, e.v);
  e.lam1 = 0.0f;
  if constexpr (kSecond) {
    Cf u[C];
#pragma unroll
    for (int c = 0; c < C; ++c) u[c] = {kS1Re[c], kS1Im[c]};
    orth(u, e.v);
#pragma unroll
    for (int it = 0; it < 3; ++it) {
      matvec(Rn, u, w);
      orth(w, e.v);
      normalize(w);
#pragma unroll
      for (int c = 0; c < C; ++c) u[c] = w[c];
    }
    e.lam1 = rayleigh(R, u);
  }
  return e;
}

// The per-cell solve of K1 and K3: covariance of the window at xr/xi, then
// top_eigs. Both kernels call this one function, so K3 `full` at NSQ = 3 is K1.
template <int NHOP, int NSQ, bool kSecond = true>
__device__ __forceinline__ Eig solve_cell(const float* __restrict__ xr,
                                          const float* __restrict__ xi, unsigned plane) {
  return top_eigs<NSQ, kSecond>(window_covariance<NHOP>(xr, xi, plane));
}

// FOA direction Re(v_c conj(v_0)) / |v_0|^2 for c = 1..3, L2-normalised. The
// divide sets the feature values, so it stays correctly rounded.
__device__ __forceinline__ void foa_direction(const Cf (&v)[C], float (&f)[C - 1]) {
  const float inv_v0 = 1.0f / (v[0].re * v[0].re + v[0].im * v[0].im + 1e-30f);
  float sum = 0.0f;
#pragma unroll
  for (int c = 1; c < C; ++c) {
    f[c - 1] = (v[c].re * v[0].re + v[c].im * v[0].im) * inv_v0;
    sum += f[c - 1] * f[c - 1];
  }
  const float nrm = rsqrtf(sum + 1e-30f);
#pragma unroll
  for (int c = 0; c < C - 1; ++c) f[c] *= nrm;
}

}  // namespace herm4
