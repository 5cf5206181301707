// Reduced friction-structure Schur solve shared by K1 (pdipm_fwd.cu) and K2
// (kkt_bwd.cu): the device code of the JAX package's `_make_fric_ops`
// (diffsdfsim_tpu/ops/qp_pallas.py:107-244), one warp per problem.
//
// For the physics mixed LCP (G = [Jc; Jf; 0], Jf laid out per contact as
// [+dirs | -dirs], F the E/mu cone coupling) the Schur complement
//
//   S = [[A Q^-1 A', A Q^-1 G'], [G Q^-1 A', G Q^-1 G' + F + D^-1]]
//
// is solved without ever forming it: the k cone rows are eliminated, each
// +/- friction pair is folded into sum/difference variables (a per-contact
// Sherman-Morrison), and the remaining m2 = neq + k + k*fd/2 rows (26 on the
// bench) are inverted by pivot-free Gauss-Jordan on [K | I] with the JAX
// kernel's tiny-pivot guard (safe_pv). `factor` builds and inverts K for one
// diagonal d (given as dinv = 1/d); `solve_S` then solves S w = hvec in the
// full m = neq + nineq frame.
//
// Everything lives in shared memory; barriers are __syncwarp and
// reductions warp shuffles, so a block is exactly one warp.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace fric {

constexpr int WARP = 32;

struct Dims {
  int nz, neq, neq_real, nineq, k, fd;
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = WARP / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
  for (int o = WARP / 2; o > 0; o >>= 1) v = fmin(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_any(int v) { return __any_sync(0xffffffffu, v); }

// out[i] = sum_j M[i, j] v[j]
template <typename T>
__device__ void mv(T* out, const T* M, const T* v, int rows, int cols, int lane) {
  for (int i = lane; i < rows; i += WARP) {
    T acc = 0;
    for (int j = 0; j < cols; ++j) acc += M[i * cols + j] * v[j];
    out[i] = acc;
  }
}

// out[j] = sum_i M[i, j] v[i]
template <typename T>
__device__ void mtv(T* out, const T* M, const T* v, int rows, int cols, int lane) {
  for (int j = lane; j < cols; j += WARP) {
    T acc = 0;
    for (int i = 0; i < rows; ++i) acc += M[i * cols + j] * v[i];
    out[j] = acc;
  }
}

template <typename T>
__device__ T dot(const T* a, const T* b, int n, int lane) {
  T acc = 0;
  for (int i = lane; i < n; i += WARP) acc += a[i] * b[i];
  return warp_sum(acc);
}

template <typename T>
__device__ void copy(T* dst, const T* src, int n, int lane) {
  for (int i = lane; i < n; i += WARP) dst[i] = src[i];
}

template <typename T>
__device__ T* carve(T*& p, int n) {
  T* out = p;
  p += n;
  return out;
}

// Shared-memory arrays of the reduced solve: its inputs (base_red, mu) and
// the factorization and scratch that `factor` and `solve_S` use.
template <typename T>
struct Work {
  T *base_red, *mu;                            // inputs: (m2, m2), (k)
  T *aug, *rhs2, *w2, *rhs_red;                // [K | I] (m2, 2 m2), pivot row, column, rhs
  T *sig_inv, *cj_r, *delta, *dsig;            // per folded friction row (k fd/2)
  T *t2a, *t2b, *t2c, *t2d;                    // scratch per folded row
  T *dc, *cj, *sj, *tk2;                       // per contact (k)
};

__host__ __device__ inline int m2_of(const Dims& S) { return S.neq + S.k + S.k * (S.fd / 2); }

__host__ __device__ inline size_t work_elems(const Dims& S) {
  const int m2 = m2_of(S), nf2 = S.k * (S.fd / 2);
  return (size_t)3 * m2 * m2 + 4 * m2 + 8 * nf2 + 5 * S.k;
}

template <typename T>
__device__ Work<T> carve_work(T*& p, const Dims& S) {
  const int m2 = m2_of(S), nf2 = S.k * (S.fd / 2), k = S.k;
  Work<T> w;
  w.base_red = carve(p, m2 * m2);
  w.mu = carve(p, k);
  w.aug = carve(p, m2 * 2 * m2);
  w.rhs2 = carve(p, 2 * m2);
  w.w2 = carve(p, m2);
  w.rhs_red = carve(p, m2);
  w.sig_inv = carve(p, nf2); w.cj_r = carve(p, nf2); w.delta = carve(p, nf2); w.dsig = carve(p, nf2);
  w.t2a = carve(p, nf2); w.t2b = carve(p, nf2); w.t2c = carve(p, nf2); w.t2d = carve(p, nf2);
  w.dc = carve(p, k); w.cj = carve(p, k); w.sj = carve(p, k); w.tk2 = carve(p, k);
  return w;
}

// reduced factorization of the Schur complement for dinv = 1 / d
// (JAX _make_fric_ops.factor); the inverse of K lands in aug[:, m2:]
template <typename T>
__device__ void factor(const Dims& S, Work<T>& w, const T* dinv, int lane) {
  const int k = S.k, fd = S.fd, fd2 = fd / 2, nf = k * fd, nf2 = k * fd2;
  const int neq = S.neq, m2 = neq + k + nf2, vstart = neq + k;
  for (int c = lane; c < k; c += WARP) w.dc[c] = (T)1 / dinv[k + nf + c];
  for (int r = lane; r < nf2; r += WARP) {
    const int c = r / fd2, j = r % fd2, src = c * fd + j;
    const T dpi = dinv[k + src], dmi = dinv[k + src + fd2];
    const T sigma = (T)0.5 * (dpi + dmi);
    const T delta = (T)0.5 * (dpi - dmi);
    const T si = (T)1 / sigma;
    w.sig_inv[r] = si;
    w.delta[r] = delta;
    w.dsig[r] = delta * si;
    w.t2a[r] = (T)0.5 * sigma - (T)0.5 * delta * (delta * si);  // diag add on v rows
  }
  __syncwarp();
  for (int c = lane; c < k; c += WARP) {
    T acc = 0;
    for (int j = 0; j < fd2; ++j) acc += w.sig_inv[c * fd2 + j];
    w.sj[c] = acc;
    w.cj[c] = (T)2 * w.dc[c] / ((T)1 + (T)2 * w.dc[c] * acc);
  }
  __syncwarp();
  for (int r = lane; r < nf2; r += WARP) w.cj_r[r] = w.cj[r / fd2];
  __syncwarp();
  const int ld = 2 * m2;
  for (int e = lane; e < m2 * m2; e += WARP) {
    const int i = e / m2, j = e % m2;
    T diag = 0;
    if (i == j) {
      if (j >= S.neq_real && j < neq) diag = 1;  // pad_reg: pins a padded y to 0
      else if (j >= neq && j < vstart) diag = dinv[j - neq];
      else if (j >= vstart) diag = w.t2a[j - vstart];
    }
    T v = w.base_red[e] + diag;
    if (i >= vstart && j >= vstart) {
      const int ri = i - vstart, rj = j - vstart;
      if (ri / fd2 == rj / fd2) v += (T)0.5 * w.cj_r[ri] * w.dsig[ri] * w.dsig[rj];
    }
    if (i >= vstart && j >= neq && j < vstart) {
      const int ri = i - vstart, c = j - neq;
      if (ri / fd2 == c) v += w.dsig[ri] * (w.dc[c] * w.mu[c] * ((T)1 - w.cj[c] * w.sj[c]));
    }
    w.aug[i * ld + j] = v;
    w.aug[i * ld + m2 + j] = (i == j) ? (T)1 : (T)0;
  }
  __syncwarp();
  // pivot-free Gauss-Jordan on [K | I] with the tiny-pivot guard
  const T tiny = (T)1e-30;
  for (int kk = 0; kk < m2; ++kk) {
    T pv = w.aug[kk * ld + kk];
    if (fabs(pv) < tiny) pv = tiny;
    for (int j = lane; j < ld; j += WARP) w.rhs2[j] = w.aug[kk * ld + j] / pv;  // pivot row
    for (int i = lane; i < m2; i += WARP) w.w2[i] = w.aug[i * ld + kk];  // pivot column
    __syncwarp();
    for (int e = lane; e < m2 * ld; e += WARP) {
      const int i = e / ld, j = e % ld;
      w.aug[e] = (i == kk) ? w.rhs2[j] : w.aug[e] - w.w2[i] * w.rhs2[j];
    }
    __syncwarp();
  }
}

// per-contact Sherman-Morrison (sigma + 2C)^-1 x, from x into out
template <typename T>
__device__ void sm_apply(const Dims& S, Work<T>& w, const T* x, T* out, int lane) {
  const int fd2 = S.fd / 2, nf2 = S.k * fd2;
  for (int r = lane; r < nf2; r += WARP) out[r] = w.sig_inv[r] * x[r];
  __syncwarp();
  for (int c = lane; c < S.k; c += WARP) {
    T acc = 0;
    for (int j = 0; j < fd2; ++j) acc += out[c * fd2 + j];
    w.tk2[c] = acc;
  }
  __syncwarp();
  for (int r = lane; r < nf2; r += WARP) out[r] = out[r] - w.cj_r[r] * w.sig_inv[r] * w.tk2[r / fd2];
  __syncwarp();
}

// w = S^-1 hvec (JAX _make_fric_ops.solve_S_fac); hvec and out have m rows
template <typename T>
__device__ void solve_S(const Dims& S, Work<T>& w, const T* hvec, T* out, int lane) {
  const int k = S.k, fd = S.fd, fd2 = fd / 2, nf2 = k * fd2;
  const int neq = S.neq, m2 = neq + k + nf2, vstart = neq + k, m = neq + S.nineq;
  const T* hf = hvec + neq + k;
  const T* hc = hvec + m - k;
  // t2a = rp, t2b = rm, t2c = q
  for (int r = lane; r < nf2; r += WARP) {
    const int c = r / fd2, src = c * fd + r % fd2;
    const T rp = hf[src], rm = hf[src + fd2];
    w.t2a[r] = rp;
    w.t2b[r] = rm;
    w.t2c[r] = rp + rm - (T)2 * (w.dc[c] * hc[c]);
  }
  __syncwarp();
  sm_apply(S, w, w.t2c, w.t2d, lane);  // t2d = SM(q)
  for (int i = lane; i < m2; i += WARP) {
    T v;
    if (i < neq + k) v = hvec[i];
    else {
      const int r = i - vstart;
      v = (T)0.5 * (w.t2a[r] - w.t2b[r] - w.delta[r] * w.t2d[r]);
    }
    w.rhs_red[i] = v;
  }
  __syncwarp();
  const int ld = 2 * m2;
  for (int i = lane; i < m2; i += WARP) {
    T acc = 0;
    for (int j = 0; j < m2; ++j) acc += w.aug[i * ld + m2 + j] * w.rhs_red[j];
    w.w2[i] = acc;
  }
  __syncwarp();
  const T* wn = w.w2 + neq;
  const T* v = w.w2 + vstart;
  for (int r = lane; r < nf2; r += WARP) {
    const int c = r / fd2;
    w.t2d[r] = w.t2c[r] + (T)2 * (w.dc[c] * w.mu[c] * wn[c]) - w.delta[r] * v[r];
  }
  __syncwarp();
  sm_apply(S, w, w.t2d, w.t2a, lane);  // t2a = u
  for (int i = lane; i < neq + k; i += WARP) out[i] = w.w2[i];
  for (int r = lane; r < nf2; r += WARP) {
    const int c = r / fd2, src = c * fd + r % fd2;
    out[neq + k + src] = (T)0.5 * (w.t2a[r] + v[r]);
    out[neq + k + src + fd2] = (T)0.5 * (w.t2a[r] - v[r]);
  }
  for (int c = lane; c < k; c += WARP) {
    T acc = 0;
    for (int j = 0; j < fd2; ++j) acc += w.t2a[c * fd2 + j];
    out[m - k + c] = w.dc[c] * (hc[c] - w.mu[c] * wn[c] + acc);
  }
  __syncwarp();
}

}  // namespace fric
