// Reduced friction-structure Schur solve shared by K1 (pdipm_fwd.cu) and K2
// (kkt_bwd.cu): the device code of the JAX package's `_make_fric_ops`
// (diffsdfsim_tpu/ops/qp_pallas.py:107-244), one block of NT threads per
// problem.
//
// For the physics mixed LCP (G = [Jc; Jf; 0], Jf laid out per contact as
// [+dirs | -dirs], F the E/mu cone coupling) the Schur complement
//
//   S = [[A Q^-1 A', A Q^-1 G'], [G Q^-1 A', G Q^-1 G' + F + D^-1]]
//
// is solved without ever forming it: the k cone rows are eliminated, each
// +/- friction pair is folded into sum/difference variables (a per-contact
// Sherman-Morrison), and the remaining m2 = neq + k + k*fd/2 rows (26 on the
// bench, 46 in the shape-space scene) are inverted by pivot-free
// Gauss-Jordan with the JAX kernel's tiny-pivot guard (safe_pv).
//
// What bounds it on an H100: the chain of dependent steps, not bytes or
// FLOPs (a problem is ~10-70 KB and ~0.1-1 MFLOP). The design shortens that
// chain:
//
// - `setup` forms, once per launch, [A; G] Q^-1 and from it the reduced
//   base block base_red (m2 x m2), and reads the cone coefficients mu from
//   F, so the wrapper runs no tensor ops before a launch.
// - `factor` keeps [K | I] in registers, in place as an m2 x m2 array: the
//   block is a TR x TC thread grid and thread (tr, tc) owns rows tr + TR a
//   and columns tc + TC b. Per pivot the owners publish the pivot row and
//   column to a double-buffered shared strip, one __syncthreads, and every
//   thread updates its own registers (m2 + 1 barriers per factor). The
//   arithmetic is the [K | I] Gauss-Jordan's, except that the pivot row is
//   scaled by one correctly rounded reciprocal of the pivot instead of a
//   division per element: a float64 division is a dependent sequence of
//   ~130 cycles on the H100, ~440 when the dividend is zero (its slow
//   path, common in the sparse K); with two per thread a pivot took ~2000
//   cycles, with one reciprocal ~1000.
// - The KKT solve keeps the reference's formula order (hvec = [A; G]
//   (Q^-1 rx), dx = Q^-1 (-rx - [A; G]' w)) and plain strided sums: the
//   bench rollout's tangential state is decided by rounding at touchdowns
//   (ROADMAP queue 3), and the 100-frame gradient moves by up to 1.8 %
//   between equally valid orders.
// - S^-1 hvec multiplies by the register-resident inverse: per-thread
//   partial sums over its columns and a half-warp shuffle per row.
// - Every other product is spread over the block, a group of G lanes per
//   row with a shuffle reduction (`rows`); block reductions are warp
//   shuffles plus one shared step, each costing one barrier.
//
// `Shape<NZ, NEQ, K, FD>` fixes the sizes at compile time for the two
// shapes that run (12, 6, 4, 8) and (12, 6, 8, 8), so loop bounds and the
// register arrays are static; Shape<0, 0, 0, 0> is the same code with the
// sizes read at run time and m2 <= M2_MAX.
//
// Everything here computes in the inputs' type T, as the Pallas kernels do.
// In float32 the iteration's KKT residual stops at the arithmetic's own
// floor: on 576 bench LCPs (k = 4) a CPU emulation of these kernels reads a
// median 1.7e-4 and a tail up to 7.8e-3, whatever the lane's conditioning
// (d = z / s spans 1e-13 to 1e14 at every solution). How close that tail
// comes to a fixed bound is a matter of rounding order (ROADMAP queue 3).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace fric {

constexpr int WARP = 32;
constexpr int NT = 128;  // threads per problem: 5 blocks per SM at k = 4 fit B = 576 in one wave
constexpr int NW = NT / WARP;
constexpr int TC = 16;       // Gauss-Jordan thread grid: TR x TC, a row of it in half a warp
constexpr int TR = NT / TC;
constexpr int M2_MAX = 64;   // the runtime-sized instantiation's largest reduced system
constexpr int RED_N = 4;     // values one block reduction combines at most

struct Dims {
  int nz, neq, neq_real, nineq, k, fd;
};

__host__ __device__ constexpr int odd(int n) { return n | 1; }  // row strides: odd, so a column walk hits every bank

// the problem's sizes; a template argument > 0 fixes one at compile time
template <int NZ, int NEQ, int K, int FD>
struct Shape {
  Dims d;
  static constexpr int M2S = (NEQ > 0 && K > 0 && FD > 0) ? NEQ + K + K * (FD / 2) : 0;
  static constexpr int M2CAP = M2S ? M2S : M2_MAX;
  static constexpr int NR = (M2CAP + TR - 1) / TR;  // rows a thread owns in the Gauss-Jordan
  static constexpr int NC = (M2CAP + TC - 1) / TC;  // columns a thread owns
  static constexpr int RS = M2CAP + 1;              // one pivot strip
  // blocks per SM the registers must allow: 5 at the bench's m2 = 26, so
  // that B = 576 problems (64 seeds x 9 rungs) run in one wave on 132 SMs
  static constexpr int MIN_BLOCKS = (M2S > 0 && M2S <= 32) ? 5 : 1;
  __host__ __device__ int nz() const { return NZ ? NZ : d.nz; }
  __host__ __device__ int neq() const { return NEQ ? NEQ : d.neq; }
  __host__ __device__ int k() const { return K ? K : d.k; }
  __host__ __device__ int fd() const { return FD ? FD : d.fd; }
  __host__ __device__ int neq_real() const { return d.neq_real; }
  __host__ __device__ int nineq() const { return k() * (2 + fd()); }
  __host__ __device__ int fd2() const { return fd() / 2; }
  __host__ __device__ int nf() const { return k() * fd(); }
  __host__ __device__ int nf2() const { return k() * fd2(); }
  __host__ __device__ int vstart() const { return neq() + k(); }
  __host__ __device__ int m2() const { return M2S ? M2S : vstart() + nf2(); }
  __host__ __device__ int m() const { return neq() + nineq(); }
  __host__ __device__ int ldz() const { return odd(nz()); }  // rows of length nz
  __host__ __device__ int ldb() const { return odd(m2()); }  // rows of length m2
  // row of the Schur frame behind reduced row i: [eq, n, f+]
  __host__ __device__ int red(int i) const {
    if (i < vstart()) return i;
    const int r = i - vstart();
    return vstart() + (r / fd2()) * fd() + r % fd2();
  }
};

template <typename T>
__device__ __forceinline__ T shfl(T v, int o) { return __shfl_xor_sync(0xffffffffu, v, o); }

// 1 / x, correctly rounded (bitwise the quotient 1 / x)
__device__ __forceinline__ double recip(double x) { return __drcp_rn(x); }
__device__ __forceinline__ float recip(float x) { return __frcp_rn(x); }

// the block's barriers, counted (K1 and K2 report the count)
template <typename T>
struct Ctx {
  int t;        // threadIdx.x
  T* red;       // 2 x NW x RED_N reduction slots (ping-pong)
  int phase;
  int nsync;

  __device__ void sync() {
    __syncthreads();
    ++nsync;
  }
  __device__ bool any(bool p) {
    ++nsync;
    return __syncthreads_or(p) != 0;
  }
  // combine N values over the block with op; every thread gets the result,
  // summed in the same order (one barrier: the slots alternate, so the next
  // reduction cannot overwrite slots still being read)
  template <int N, typename Op>
  __device__ void reduce(T (&v)[N], Op op) {
#pragma unroll
    for (int o = WARP / 2; o > 0; o >>= 1)
#pragma unroll
      for (int n = 0; n < N; ++n) v[n] = op(v[n], shfl(v[n], o));
    T* r = red + (phase & 1) * NW * RED_N;
    if ((t & (WARP - 1)) == 0)
#pragma unroll
      for (int n = 0; n < N; ++n) r[(t / WARP) * RED_N + n] = v[n];
    sync();
#pragma unroll
    for (int n = 0; n < N; ++n) {
      T a = r[n];
#pragma unroll
      for (int w = 1; w < NW; ++w) a = op(a, r[w * RED_N + n]);
      v[n] = a;
    }
    ++phase;
  }
};

struct Sum {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a + b; }
};
struct Min {
  template <typename T>
  __device__ T operator()(T a, T b) const { return fmin(a, b); }
};

// this lane's share of sum_j a[j sa] b[j] when G lanes split the terms:
// every G-th term from l, summed in order
template <int G, typename T>
__device__ __forceinline__ T gdot(int l, int n, const T* a, int sa, const T* b) {
  T s0 = 0;
  for (int j = l; j < n; j += G) s0 += a[j * sa] * b[j];
  return s0;
}

// out(r, part(r, 0) + ... + part(r, G - 1)) for r < nrows: a group of G
// lanes per row, lane l's share part(r, l) (gdot), then a shuffle
// reduction. The passes are uniform over the block, so every lane reaches
// every shuffle.
template <typename T, int G, typename Part, typename Out>
__device__ __forceinline__ void rows(int t, int nrows, Part part, Out out) {
  static_assert(G <= WARP && (WARP % G) == 0, "a row group lies within one warp");
  const int g = t / G, l = t % G;
  for (int base = 0; base < nrows; base += NT / G) {
    const int r = base + g;
    T acc = r < nrows ? part(r, l) : (T)0;
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) acc += shfl(acc, o);
    if (r < nrows && l == 0) out(r, acc);
  }
}

template <typename T>
__host__ __device__ T* carve(T*& p, size_t n) {
  T* out = p;
  p += n;
  return out;
}

// shared-memory arrays of the reduced solve and the KKT solve around it
template <typename T>
struct Work {
  T *AG, *invQ;                       // (m, ldz) [A; G] (A padded to >= 1 row), (nz, ldz)
  T *AGiQ;                            // (m, ldz) [A; G] Q^-1
  T *base_red, *mu;                   // (m2, ldb), (k)
  T *d, *dinv;                        // (nineq): the diagonal d = z / s and 1 / d
  T *sig_inv, *delta, *dsig, *diagv;  // per folded friction row (k fd / 2)
  T *cj_r, *vn, *q;
  T *dc;                              // per contact (k): the cone rows' d
  T *hvec, *wvec, *iQrx, *rhs_red, *w2;
  T *rowbuf, *colbuf;                 // Gauss-Jordan pivot strips, 2 x RS each
  T *zero;                            // max(nz, nineq) zeros
  T *red;                             // block-reduction slots
};

template <class S, typename T>
__host__ __device__ Work<T> carve_work(T*& p, const S& D) {
  const int nz = D.nz(), m = D.m(), m2 = D.m2(), nf2 = D.nf2(), k = D.k(), nineq = D.nineq();
  Work<T> w;
  w.AG = carve(p, (size_t)m * D.ldz());
  w.invQ = carve(p, (size_t)nz * D.ldz());
  w.AGiQ = carve(p, (size_t)m * D.ldz());
  w.base_red = carve(p, (size_t)m2 * D.ldb());
  w.mu = carve(p, k);
  w.d = carve(p, nineq);
  w.dinv = carve(p, nineq);
  w.sig_inv = carve(p, nf2); w.delta = carve(p, nf2); w.dsig = carve(p, nf2); w.diagv = carve(p, nf2);
  w.cj_r = carve(p, nf2); w.vn = carve(p, nf2); w.q = carve(p, nf2);
  w.dc = carve(p, k);
  w.hvec = carve(p, m); w.wvec = carve(p, m); w.iQrx = carve(p, nz);
  w.rhs_red = carve(p, m2); w.w2 = carve(p, m2);
  w.rowbuf = carve(p, 2 * S::RS); w.colbuf = carve(p, 2 * S::RS);
  w.zero = carve(p, nineq > nz ? nineq : nz);
  w.red = carve(p, 2 * NW * RED_N);
  return w;
}

// the inverse of the reduced system, in registers: slot [a][b] holds row
// tr + TR a, column tc + TC b of the thread (tr, tc) = (t / TC, t % TC)
template <class S, typename T>
struct Inv {
  T a[S::NR][S::NC];
};

// load the problem's [A; G], Q^-1 and mu (from F's cone rows) into shared
// memory; the caller syncs before `setup`
template <class S, typename T>
__device__ void load(const S& D, Work<T>& w, int t, const T* __restrict__ gA, const T* __restrict__ gG,
                     const T* __restrict__ ginvQ, const T* __restrict__ gF) {
  const int nz = D.nz(), neq = D.neq(), nineq = D.nineq(), k = D.k(), ldz = D.ldz();
  for (int e = t; e < neq * nz; e += NT) w.AG[(e / nz) * ldz + e % nz] = gA[e];
  for (int e = t; e < nineq * nz; e += NT) w.AG[(neq + e / nz) * ldz + e % nz] = gG[e];
  for (int e = t; e < nz * nz; e += NT) w.invQ[(e / nz) * ldz + e % nz] = ginvQ[e];
  for (int c = t; c < k; c += NT) w.mu[c] = gF[(size_t)(k * (1 + D.fd()) + c) * nineq + c];
  for (int i = t; i < (nineq > nz ? nineq : nz); i += NT) w.zero[i] = 0;
}

// [A; G] Q^-1 and base_red = ([A; G] Q^-1) [A; G]' on the reduced rows (the
// JAX wrapper's base[:, idx][:, :, idx]); base_red is complete at the
// caller's next barrier
template <class S, typename T>
__device__ void setup(const S& D, Work<T>& w, Ctx<T>& c) {
  const int nz = D.nz(), m = D.m(), m2 = D.m2(), ldz = D.ldz(), ldb = D.ldb();
  for (int e = c.t; e < m * nz; e += NT) {
    const int i = e / nz, l = e % nz;
    T a = 0;
    for (int q = 0; q < nz; ++q) a += w.AG[i * ldz + q] * w.invQ[q * ldz + l];
    w.AGiQ[i * ldz + l] = a;
  }
  c.sync();
  for (int e = c.t; e < m2 * m2; e += NT) {
    const int i = e / m2, j = e % m2;
    const T* ri = w.AGiQ + D.red(i) * ldz;
    const T* rj = w.AG + D.red(j) * ldz;
    T a = 0;
    for (int q = 0; q < nz; ++q) a += ri[q] * rj[q];
    w.base_red[i * ldb + j] = a;
  }
}

// the reduced factorization for the diagonal whose inverse is w.dinv (JAX
// _make_fric_ops.factor): K assembled and inverted in registers. The caller
// syncs between writing w.dinv (and, on the first call, `setup`) and this.
template <class S, typename T>
__device__ void factor(const S& D, Work<T>& w, Inv<S, T>& K, Ctx<T>& c) {
  const int k = D.k(), fd = D.fd(), fd2 = D.fd2(), nf = D.nf(), nf2 = D.nf2();
  const int neq = D.neq(), vs = D.vstart(), m2 = D.m2(), ldb = D.ldb();
  const T* dinv = w.dinv;
  // per folded row r (one thread each): the pair's sigma/delta and its
  // contact's Sherman-Morrison coefficient, the contact sum recomputed per
  // row in the same order
  if (c.t < nf2) {
    const int r = c.t, cc = r / fd2, jj = r % fd2;
    const T dc = recip(dinv[k + nf + cc]);
    T sj = 0, sig_inv = 0, delta = 0;
    for (int j = 0; j < fd2; ++j) {
      const int src = cc * fd + j;
      const T dpi = dinv[k + src], dmi = dinv[k + src + fd2];
      const T si = recip((T)0.5 * (dpi + dmi));
      sj += si;
      if (j == jj) {
        sig_inv = si;
        delta = (T)0.5 * (dpi - dmi);
      }
    }
    const int src = cc * fd + jj;
    const T sigma = (T)0.5 * (dinv[k + src] + dinv[k + src + fd2]);
    const T dsig = delta * sig_inv;
    const T cj = (T)2 * dc / ((T)1 + (T)2 * dc * sj);
    w.sig_inv[r] = sig_inv;
    w.delta[r] = delta;
    w.dsig[r] = dsig;
    w.diagv[r] = (T)0.5 * sigma - (T)0.5 * delta * dsig;  // diag add on v rows
    w.cj_r[r] = cj;
    w.vn[r] = dsig * (dc * w.mu[cc] * ((T)1 - cj * sj));  // (v, n) coupling
    if (jj == 0) w.dc[cc] = dc;
  }
  c.sync();
  const int tr = c.t / TC, tc = c.t % TC;
  // K = base_red + diagonal adds + rank-1 v-blocks + (v, n) coupling
#pragma unroll
  for (int a = 0; a < S::NR; ++a) {
    const int i = tr + TR * a;
#pragma unroll
    for (int b = 0; b < S::NC; ++b) {
      const int j = tc + TC * b;
      T v = 0;
      if (i < m2 && j < m2) {
        T diag = 0;
        if (i == j) {
          if (j >= D.neq_real() && j < neq) diag = 1;  // pad_reg: pins a padded y to 0
          else if (j >= neq && j < vs) diag = dinv[j - neq];
          else if (j >= vs) diag = w.diagv[j - vs];
        }
        v = w.base_red[i * ldb + j] + diag;
        if (i >= vs && j >= vs) {
          const int ri = i - vs, rj = j - vs;
          if (ri / fd2 == rj / fd2) v += (T)0.5 * w.cj_r[ri] * w.dsig[ri] * w.dsig[rj];
        }
        if (i >= vs && j >= neq && j < vs && (i - vs) / fd2 == j - neq) v += w.vn[i - vs];
      }
      K.a[a][b] = v;
      if (i == 0 && j < m2) w.rowbuf[j] = v;
      if (j == 0 && i < m2) w.colbuf[i] = v;
    }
  }
  c.sync();
  // pivot-free Gauss-Jordan with the tiny-pivot guard, in place: after
  // pivot kk, column kk holds the inverse's column kk
  const T tiny = (T)1e-30;
#pragma unroll 1
  for (int kk = 0; kk < m2; ++kk) {
    const T* rw = w.rowbuf + (kk & 1) * S::RS;
    const T* cl = w.colbuf + (kk & 1) * S::RS;
    T pv = rw[kk];
    if (fabs(pv) < tiny) pv = tiny;
    const T rinv = recip(pv);
    T pr[S::NC];  // the scaled pivot row at this thread's columns
#pragma unroll
    for (int b = 0; b < S::NC; ++b) {
      const int j = tc + TC * b;
      pr[b] = j == kk ? rinv : (j < m2 ? rw[j] * rinv : (T)0);
    }
    const int nx = kk + 1;
    T* nrw = w.rowbuf + (nx & 1) * S::RS;
    T* ncl = w.colbuf + (nx & 1) * S::RS;
#pragma unroll
    for (int a = 0; a < S::NR; ++a) {
      const int i = tr + TR * a;
      if (i < m2) {
        const T f = cl[i];
#pragma unroll
        for (int b = 0; b < S::NC; ++b) {
          const int j = tc + TC * b;
          const T v = i == kk ? pr[b] : (j == kk ? (T)0 : K.a[a][b]) - f * pr[b];
          K.a[a][b] = v;
          if (i == nx && j < m2) nrw[j] = v;
          if (j == nx) ncl[i] = v;
        }
      }
    }
    c.sync();
  }
}

// The KKT solve with the factored Schur complement (JAX kernel solve_kkt;
// reference batch.py:380-410) in three parts: `kkt_hvec` forms the Schur
// right-hand side, `schur_solve` w = -S^-1 hvec, `kkt_out` the outputs.

// hvec = [A; G] (Q^-1 rx) - [ry; rz - rs / d]; two barriers
template <class S, typename T>
__device__ void kkt_hvec(const S& D, Work<T>& w, Ctx<T>& c, const T* rx, const T* rs, const T* rz, const T* ry) {
  const int nz = D.nz(), neq = D.neq(), m = D.m(), ldz = D.ldz();
  const T* d = w.d;
  rows<T, 4>(c.t, nz, [&](int r, int l) { return gdot<4>(l, nz, w.invQ + r * ldz, 1, rx); },
             [&](int r, T acc) { w.iQrx[r] = acc; });
  c.sync();
  rows<T, 4>(
      c.t, m, [&](int r, int l) { return gdot<4>(l, nz, w.AG + r * ldz, 1, w.iQrx); },
      [&](int r, T acc) {
        if (r < neq) w.hvec[r] = acc - ry[r];
        else w.hvec[r] = acc + rs[r - neq] / d[r - neq] - rz[r - neq];
      });
  c.sync();
}

// w.wvec = -S^-1 w.hvec by the reduced system (the factor K in registers);
// three barriers
template <class S, typename T>
__device__ void schur_solve(const S& D, Work<T>& w, const Inv<S, T>& K, Ctx<T>& c) {
  const int neq = D.neq(), k = D.k(), fd = D.fd(), fd2 = D.fd2();
  const int nf2 = D.nf2(), vs = D.vstart(), m = D.m(), m2 = D.m2();
  // the reduced right-hand side: [he, hn, 0.5 (rp - rm - delta SM(q))]
  const T* hf = w.hvec + vs;
  const T* hc = w.hvec + m - k;
  if (c.t < nf2) {
    const int r = c.t, cc = r / fd2, jj = r % fd2;
    const T g = (T)2 * (w.dc[cc] * hc[cc]);
    T tk = 0, q = 0;
    for (int j = 0; j < fd2; ++j) {
      const int src = cc * fd + j;
      const T qj = hf[src] + hf[src + fd2] - g;
      tk += w.sig_inv[cc * fd2 + j] * qj;
      if (j == jj) q = qj;
    }
    const int src = cc * fd + jj;
    const T sm = w.sig_inv[r] * q - w.cj_r[r] * w.sig_inv[r] * tk;  // SM(q), the per-contact Sherman-Morrison
    w.q[r] = q;
    w.rhs_red[vs + r] = (T)0.5 * (hf[src] - hf[src + fd2] - w.delta[r] * sm);
  } else if (c.t < m2) {
    w.rhs_red[c.t - nf2] = w.hvec[c.t - nf2];
  }
  c.sync();
  // w2 = K^-1 rhs_red from the registers
  {
    const int tr = c.t / TC, tc = c.t % TC;
    T rv[S::NC];
#pragma unroll
    for (int b = 0; b < S::NC; ++b) {
      const int j = tc + TC * b;
      rv[b] = j < m2 ? w.rhs_red[j] : (T)0;
    }
#pragma unroll
    for (int a = 0; a < S::NR; ++a) {
      T acc = 0;
#pragma unroll
      for (int b = 0; b < S::NC; ++b) acc += K.a[a][b] * rv[b];
#pragma unroll
      for (int o = TC / 2; o > 0; o >>= 1) acc += shfl(acc, o);
      const int i = tr + TR * a;
      if (tc == 0 && i < m2) w.w2[i] = acc;
    }
  }
  c.sync();
  // recover (wf+, wf-, wc); wvec = -S^-1 hvec
  if (c.t < nf2) {
    const int r = c.t, cc = r / fd2, jj = r % fd2;
    const T wn = w.w2[neq + cc];
    const T* v = w.w2 + vs;
    const T g = (T)2 * (w.dc[cc] * w.mu[cc] * wn);
    T tk = 0;
    for (int j = 0; j < fd2; ++j) {
      const int rr = cc * fd2 + j;
      tk += w.sig_inv[rr] * (w.q[rr] + g - w.delta[rr] * v[rr]);
    }
    T usum = 0, u = 0;
    for (int j = 0; j < fd2; ++j) {
      const int rr = cc * fd2 + j;
      const T uj = w.sig_inv[rr] * (w.q[rr] + g - w.delta[rr] * v[rr]) - w.cj_r[rr] * w.sig_inv[rr] * tk;
      usum += uj;
      if (j == jj) u = uj;
    }
    const int src = vs + cc * fd + jj;
    w.wvec[src] = -((T)0.5 * (u + v[r]));
    w.wvec[src + fd2] = -((T)0.5 * (u - v[r]));
    if (jj == 0) w.wvec[m - k + cc] = -(w.dc[cc] * (hc[cc] - w.mu[cc] * wn + usum));
  } else if (c.t < m2) {
    w.wvec[c.t - nf2] = -w.w2[c.t - nf2];
  }
  c.sync();
}

// from w.wvec: dx = Q^-1 (-rx - [A; G]' w), ds = (-rs - w_ineq) / d,
// dz = w_ineq, dy = w_eq (ds, dz, dy may be null); two barriers
template <class S, typename T, typename O>
__device__ void kkt_out(const S& D, Work<T>& w, Ctx<T>& c, const T* rx, const T* rs, O* dx, O* ds, O* dz,
                        O* dy) {
  const int nz = D.nz(), neq = D.neq(), nineq = D.nineq(), m = D.m(), ldz = D.ldz();
  const T* d = w.d;
  rows<T, 16>(
      c.t, nz, [&](int r, int l) { return gdot<16>(l, m, w.AG + r, ldz, w.wvec); },
      [&](int r, T acc) { w.iQrx[r] = -rx[r] - acc; });
  c.sync();
  rows<T, 4>(c.t, nz, [&](int r, int l) { return gdot<4>(l, nz, w.invQ + r * ldz, 1, w.iQrx); },
             [&](int r, T acc) { dx[r] = (O)acc; });
  for (int i = c.t; i < nineq; i += NT) {
    const T wi = w.wvec[neq + i];
    if (ds) ds[i] = (O)((-rs[i] - wi) / d[i]);
    if (dz) dz[i] = (O)wi;
  }
  if (dy)
    for (int i = c.t; i < neq; i += NT) dy[i] = (O)w.wvec[i];
  c.sync();
}

// one KKT solve: given rx, rs, rz, ry (shared arrays; w.zero for a zero
// right-hand side) returns dx, ds, dz, dy. ds may be null. Seven barriers;
// the outputs (of type O: shared arrays, or a kernel's device outputs) are
// complete when it returns.
template <class S, typename T, typename O>
__device__ void solve_kkt(const S& D, Work<T>& w, const Inv<S, T>& K, Ctx<T>& c, const T* rx, const T* rs,
                          const T* rz, const T* ry, O* dx, O* ds, O* dz, O* dy) {
  kkt_hvec(D, w, c, rx, rs, rz, ry);
  schur_solve(D, w, K, c);
  kkt_out(D, w, c, rx, rs, dx, ds, dz, dy);
}

// f(shape) with the compile-time shape that matches these sizes, else the
// runtime-sized one (m2 <= M2_MAX); cudaErrorInvalidValue beyond that
template <typename F>
int with_shape(const Dims& d, F&& f) {
  if (d.nz == 12 && d.neq == 6 && d.k == 4 && d.fd == 8) return f(Shape<12, 6, 4, 8>{d});
  if (d.nz == 12 && d.neq == 6 && d.k == 8 && d.fd == 8) return f(Shape<12, 6, 8, 8>{d});
  if (d.neq + d.k + d.k * (d.fd / 2) <= M2_MAX) return f(Shape<0, 0, 0, 0>{d});
  return (int)cudaErrorInvalidValue;
}

// a kernel's launch resources at `bytes` of shared memory: threads, shared
// bytes, registers and local (spill) bytes per thread, blocks per SM, the
// static m2 (0: sizes read at run time)
template <class S, typename K>
int resources(K kernel, size_t bytes, long long* out) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, NT, bytes);
  if (err != cudaSuccess) return (int)err;
  out[0] = NT;
  out[1] = (long long)bytes;
  out[2] = attr.numRegs;
  out[3] = (long long)attr.localSizeBytes;
  out[4] = blocks;
  out[5] = S::M2S;
  return 0;
}

}  // namespace fric
