// K1: batched PDIPM forward for the physics mixed LCP, one problem per block.
//
// Replaces the Pallas TPU kernel diffsdfsim_tpu/ops/qp_pallas.py
// `_make_kernel` (launched by `_pdipm_pallas_flat`, public `pdipm_pallas`)
// on its friction-structure path (`_make_fric_ops`). Per problem it runs the
// whole Mehrotra predictor-corrector loop of the reference solver
// (lcp_physics/lcp/solvers/batch.py:70-231):
//
//   min 1/2 z'Qz + p'z  s.t.  Gz <= h + Fz,  Az = b
//
// with the initialization at d = 1 and the slack shift, best-iterate
// tracking, the NaN freeze, and per-lane not-improved / eps / mu stopping.
// The Schur complement is solved on the reduced system of the JAX kernel:
// the k cone rows are eliminated, the +/- friction-direction pairs are
// folded into sum/difference variables (a per-contact Sherman-Morrison), and
// the remaining m2 = neq + k + k*fd/2 rows (26 on the bench) are inverted by
// pivot-free Gauss-Jordan with the same tiny-pivot guard (safe_pv). That
// reduced solve is shared with the backward kernel K2 (kkt_bwd.cu) through
// fric_schur.cuh.
//
// What bounds it on an H100: neither bytes nor FLOPs. At the main path's
// shapes (B = 3 or 6 problems) one launch reads ~50-100 KB and does
// ~0.5 MFLOP per problem, so the card's roofline time is tens of
// nanoseconds; the kernel is latency-bound on the serial chain of ~11
// iterations x (26 Gauss-Jordan pivots + two KKT solves), each step a few
// dependent shared-memory passes. The design answers that by keeping every
// operand and iterate of a problem in shared memory for the whole loop (no
// device-memory traffic after the first load), using one warp per problem
// so that every reduction is a register shuffle and every barrier a
// __syncwarp, and spreading problems over blocks (B = 576 fills the card).
//
// Loop semantics match the plain version (ops/qp.py `_pdipm_forward`, the
// JAX XLA path) exactly: a lane keeps the step taken in the iteration in
// which it stops; whether that last iterate may still replace the best one
// depends on whether the batch's loop runs one more iteration, which only
// the whole batch knows. The kernel therefore returns both the best and
// the current iterate plus the stop iteration; the wrapper
// (ops/qp_cuda.py) makes that final choice.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fric_schur.cuh"

namespace {

using fric::WARP;
using fric::carve;
using fric::copy;
using fric::dot;
using fric::mtv;
using fric::mv;
using fric::warp_any;
using fric::warp_min;
using fric::warp_sum;

template <typename T>
struct Sizes : fric::Dims {
  int max_iter, nil;
  T eps;
};

template <typename T>
__device__ __forceinline__ T big_value();
template <>
__device__ __forceinline__ float big_value<float>() { return 3.402823466e38f; }
template <>
__device__ __forceinline__ double big_value<double>() { return 1.7976931348623157e308; }

// max step in [0, inf) keeping v + a dv > 0 (reference get_step)
template <typename T>
__device__ T get_step(const T* v, const T* dv, int n, int lane) {
  T a = (T)INFINITY;
  for (int i = lane; i < n; i += WARP)
    if (dv[i] < 0) a = fmin(a, -v[i] / dv[i]);
  return warp_min(a);
}

template <typename T>
struct Work {
  // problem data (base_red and mu live in the reduced-solve work f)
  T *Q, *invQ, *G, *A, *F, *p, *h, *b;
  // iterates and best iterates
  T *x, *s, *z, *y, *bx, *bs, *bz, *by;
  // residuals and directions
  T *rx, *rz, *ry, *dxa, *dsa, *dza, *dya, *dxc, *dsc, *dzc, *dyc, *rs, *d, *dinv;
  // scratch
  T *t_nz, *t_nz2, *hvec, *wvec, *zero;
  // the reduced Schur solve (fric_schur.cuh)
  fric::Work<T> f;
};

// one KKT solve with the factored Schur complement (JAX kernel solve_kkt)
template <typename T>
__device__ void solve_kkt(const Sizes<T>& S, Work<T>& w, const T* d, const T* rx, const T* rs,
                          const T* rz, const T* ry, T* dx, T* ds, T* dz, T* dy, int lane) {
  const int nz = S.nz, neq = S.neq, nineq = S.nineq;
  mv(w.t_nz, w.invQ, rx, nz, nz, lane);  // invQ rx
  __syncwarp();
  mv(w.hvec, w.A, w.t_nz, neq, nz, lane);
  mv(w.hvec + neq, w.G, w.t_nz, nineq, nz, lane);
  __syncwarp();
  for (int i = lane; i < neq; i += WARP) w.hvec[i] = w.hvec[i] - ry[i];
  for (int i = lane; i < nineq; i += WARP) w.hvec[neq + i] = w.hvec[neq + i] + rs[i] / d[i] - rz[i];
  __syncwarp();
  fric::solve_S(S, w.f, w.hvec, w.wvec, lane);
  for (int i = lane; i < neq + nineq; i += WARP) w.wvec[i] = -w.wvec[i];
  __syncwarp();
  const T* w_eq = w.wvec;
  const T* w_in = w.wvec + neq;
  mtv(w.t_nz, w.G, w_in, nineq, nz, lane);
  mtv(w.t_nz2, w.A, w_eq, neq, nz, lane);
  __syncwarp();
  for (int i = lane; i < nz; i += WARP) w.t_nz[i] = -rx[i] - w.t_nz[i] - w.t_nz2[i];
  __syncwarp();
  mv(dx, w.invQ, w.t_nz, nz, nz, lane);
  for (int i = lane; i < nineq; i += WARP) {
    ds[i] = (-rs[i] - w_in[i]) / d[i];
    dz[i] = w_in[i];
  }
  for (int i = lane; i < neq; i += WARP) dy[i] = w_eq[i];
  __syncwarp();
}

// residuals of the current iterate; returns (mu, resid)
template <typename T>
__device__ void residuals(const Sizes<T>& S, Work<T>& w, const T* x, const T* s, const T* z,
                          const T* y, T& mu, T& res, int lane) {
  const int nz = S.nz, neq = S.neq, nineq = S.nineq;
  // rx = G'z + Q'x + p + A'y
  for (int j = lane; j < nz; j += WARP) {
    T gz = 0, qx = 0, ay = 0;
    for (int i = 0; i < nineq; ++i) gz += w.G[i * nz + j] * z[i];
    for (int i = 0; i < nz; ++i) qx += w.Q[i * nz + j] * x[i];
    for (int i = 0; i < neq; ++i) ay += w.A[i * nz + j] * y[i];
    w.rx[j] = gz + qx + w.p[j] + ay;
  }
  // rz = Gx + s - h - Fz
  for (int i = lane; i < nineq; i += WARP) {
    T gx = 0, fz = 0;
    for (int j = 0; j < nz; ++j) gx += w.G[i * nz + j] * x[j];
    for (int j = 0; j < nineq; ++j) fz += w.F[i * nineq + j] * z[j];
    w.rz[i] = gx + s[i] - w.h[i] - fz;
  }
  for (int i = lane; i < neq; i += WARP) {
    T ax = 0;
    for (int j = 0; j < nz; ++j) ax += w.A[i * nz + j] * x[j];
    w.ry[i] = ax - w.b[i];
  }
  __syncwarp();
  mu = fabs(dot(s, z, nineq, lane) / (T)nineq);
  const T pri = sqrt(dot(w.rz, w.rz, nineq, lane)) + sqrt(dot(w.ry, w.ry, neq, lane));
  res = pri + sqrt(dot(w.rx, w.rx, nz, lane)) + (T)nineq * mu;
}

template <typename T>
__global__ void pdipm_fwd_kernel(Sizes<T> S, const T* __restrict__ gQ, const T* __restrict__ ginvQ,
                                 const T* __restrict__ gG, const T* __restrict__ gA,
                                 const T* __restrict__ gF, const T* __restrict__ gbase_red,
                                 const T* __restrict__ gmu, const T* __restrict__ gp,
                                 const T* __restrict__ gh, const T* __restrict__ gb, T* out_best,
                                 T* out_cur, int32_t* out_done_it, int32_t* out_cur_improves) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x;
  const int prob = blockIdx.x;
  const int nz = S.nz, neq = S.neq, nineq = S.nineq, k = S.k, fd2 = S.fd / 2;
  const int nf2 = k * fd2, m2 = neq + k + nf2, m = neq + nineq;
  const int nsol = nz + 2 * nineq + neq;

  T* p = reinterpret_cast<T*>(smem_raw);
  Work<T> w;
  w.Q = carve(p, nz * nz);
  w.invQ = carve(p, nz * nz);
  w.G = carve(p, nineq * nz);
  w.A = carve(p, neq * nz);
  w.F = carve(p, nineq * nineq);
  w.p = carve(p, nz);
  w.h = carve(p, nineq);
  w.b = carve(p, neq);
  w.x = carve(p, nz); w.s = carve(p, nineq); w.z = carve(p, nineq); w.y = carve(p, neq);
  w.bx = carve(p, nz); w.bs = carve(p, nineq); w.bz = carve(p, nineq); w.by = carve(p, neq);
  w.rx = carve(p, nz); w.rz = carve(p, nineq); w.ry = carve(p, neq);
  w.dxa = carve(p, nz); w.dsa = carve(p, nineq); w.dza = carve(p, nineq); w.dya = carve(p, neq);
  w.dxc = carve(p, nz); w.dsc = carve(p, nineq); w.dzc = carve(p, nineq); w.dyc = carve(p, neq);
  w.rs = carve(p, nineq);
  w.d = carve(p, nineq);
  w.dinv = carve(p, nineq);
  w.t_nz = carve(p, nz);
  w.t_nz2 = carve(p, nz);
  w.hvec = carve(p, m); w.wvec = carve(p, m);
  w.zero = carve(p, nineq > nz ? nineq : nz);
  w.f = fric::carve_work(p, S);

  copy(w.Q, gQ + (size_t)prob * nz * nz, nz * nz, lane);
  copy(w.invQ, ginvQ + (size_t)prob * nz * nz, nz * nz, lane);
  copy(w.G, gG + (size_t)prob * nineq * nz, nineq * nz, lane);
  copy(w.A, gA + (size_t)prob * neq * nz, neq * nz, lane);
  copy(w.F, gF + (size_t)prob * nineq * nineq, nineq * nineq, lane);
  copy(w.f.base_red, gbase_red + (size_t)prob * m2 * m2, m2 * m2, lane);
  copy(w.f.mu, gmu + (size_t)prob * k, k, lane);
  copy(w.p, gp + (size_t)prob * nz, nz, lane);
  copy(w.h, gh + (size_t)prob * nineq, nineq, lane);
  copy(w.b, gb + (size_t)prob * neq, neq, lane);
  for (int i = lane; i < (nineq > nz ? nineq : nz); i += WARP) w.zero[i] = 0;
  __syncwarp();

  // initialization: one KKT solve at d = 1 (batch.py:84-90)
  T* d = w.d;  // the diagonal d = z / s
  T* dinv = w.dinv;
  for (int i = lane; i < nineq; i += WARP) {
    d[i] = 1;
    dinv[i] = 1;
    w.rs[i] = -w.h[i];  // rz = -h
  }
  for (int i = lane; i < neq; i += WARP) w.ry[i] = -w.b[i];
  __syncwarp();
  fric::factor(S, w.f, dinv, lane);
  solve_kkt(S, w, d, w.p, w.zero, w.rs, w.ry, w.x, w.s, w.z, w.y, lane);
  // shift slacks and duals to >= 1 (batch.py:100-110)
  {
    T ms = (T)INFINITY, mz = (T)INFINITY;
    for (int i = lane; i < nineq; i += WARP) {
      ms = fmin(ms, w.s[i]);
      mz = fmin(mz, w.z[i]);
    }
    ms = warp_min(ms);
    mz = warp_min(mz);
    for (int i = lane; i < nineq; i += WARP) {
      if (ms < 0) w.s[i] = w.s[i] - ms + (T)1;
      if (mz < 0) w.z[i] = w.z[i] - mz + (T)1;
    }
  }
  copy(w.bx, w.x, nz, lane);
  copy(w.bs, w.s, nineq, lane);
  copy(w.bz, w.z, nineq, lane);
  copy(w.by, w.y, neq, lane);
  __syncwarp();

  T bres = big_value<T>();
  int nni = 0;
  bool done = false;
  int done_it = S.max_iter;
  int it = 0;
  while (it < S.max_iter && !done) {
    T mu, res;
    residuals(S, w, w.x, w.s, w.z, w.y, mu, res, lane);
    const bool improved = res < bres;
    if (improved) {
      copy(w.bx, w.x, nz, lane);
      copy(w.bs, w.s, nineq, lane);
      copy(w.bz, w.z, nineq, lane);
      copy(w.by, w.y, neq, lane);
      bres = res;
      nni = 0;
    } else {
      nni += 1;
    }
    const bool stop = (nni >= S.nil) || (bres < S.eps) || (mu > (T)1e32);

    for (int i = lane; i < nineq; i += WARP) {
      d[i] = w.z[i] / w.s[i];
      dinv[i] = (T)1 / d[i];
    }
    __syncwarp();
    fric::factor(S, w.f, dinv, lane);
    solve_kkt(S, w, d, w.rx, w.z, w.rz, w.ry, w.dxa, w.dsa, w.dza, w.dya, lane);

    // centering-corrector (batch.py:184-211)
    T alpha = fmin(fmin(get_step(w.z, w.dza, nineq, lane), get_step(w.s, w.dsa, nineq, lane)), (T)1);
    T num = 0, den = 0;
    for (int i = lane; i < nineq; i += WARP) {
      num += (w.s[i] + alpha * w.dsa[i]) * (w.z[i] + alpha * w.dza[i]);
      den += w.s[i] * w.z[i];
    }
    const T ratio = warp_sum(num) / warp_sum(den);
    const T sig = ratio * ratio * ratio;
    for (int i = lane; i < nineq; i += WARP) w.rs[i] = (-(mu * sig) + w.dsa[i] * w.dza[i]) / w.s[i];
    __syncwarp();
    solve_kkt(S, w, d, w.zero, w.rs, w.zero, w.zero, w.dxc, w.dsc, w.dzc, w.dyc, lane);
    // combined direction: dx in dxa, ds in dsa, dz in dza, dy in dya
    for (int i = lane; i < nz; i += WARP) w.dxa[i] += w.dxc[i];
    for (int i = lane; i < nineq; i += WARP) {
      w.dsa[i] += w.dsc[i];
      w.dza[i] += w.dzc[i];
    }
    for (int i = lane; i < neq; i += WARP) w.dya[i] += w.dyc[i];
    __syncwarp();
    alpha = fmin((T)0.999 * fmin(get_step(w.z, w.dza, nineq, lane), get_step(w.s, w.dsa, nineq, lane)), (T)1);

    int bad = 0;
    for (int i = lane; i < nz; i += WARP) bad |= !isfinite(w.x[i] + alpha * w.dxa[i]);
    for (int i = lane; i < nineq; i += WARP)
      bad |= !isfinite(w.s[i] + alpha * w.dsa[i]) | !isfinite(w.z[i] + alpha * w.dza[i]);
    const bool finite = !warp_any(bad);
    if (finite) {
      for (int i = lane; i < nz; i += WARP) w.x[i] = w.x[i] + alpha * w.dxa[i];
      for (int i = lane; i < nineq; i += WARP) {
        w.s[i] = w.s[i] + alpha * w.dsa[i];
        w.z[i] = w.z[i] + alpha * w.dza[i];
      }
      for (int i = lane; i < neq; i += WARP) w.y[i] = w.y[i] + alpha * w.dya[i];
    }
    __syncwarp();
    if (stop || !finite) {
      done = true;
      done_it = it;
    }
    it += 1;
  }

  // would the current iterate replace the best one? (final check / the
  // next iteration's check; the wrapper decides which applies)
  T mu, res;
  residuals(S, w, w.x, w.s, w.z, w.y, mu, res, lane);
  const size_t off = (size_t)prob * nsol;
  copy(out_best + off, w.bx, nz, lane);
  copy(out_best + off + nz, w.bs, nineq, lane);
  copy(out_best + off + nz + nineq, w.bz, nineq, lane);
  copy(out_best + off + nz + 2 * nineq, w.by, neq, lane);
  copy(out_cur + off, w.x, nz, lane);
  copy(out_cur + off + nz, w.s, nineq, lane);
  copy(out_cur + off + nz + nineq, w.z, nineq, lane);
  copy(out_cur + off + nz + 2 * nineq, w.y, neq, lane);
  if (lane == 0) {
    out_done_it[prob] = done_it;
    out_cur_improves[prob] = res < bres ? 1 : 0;
  }
}

template <typename T>
size_t smem_elems(const Sizes<T>& S) {
  const int nz = S.nz, neq = S.neq, nineq = S.nineq, m = neq + nineq;
  size_t n = 0;
  n += 2 * nz * nz + nineq * nz + neq * nz + nineq * nineq + nz + nineq + neq;  // problem data
  n += 2 * (nz + 2 * nineq + neq);               // iterates, best
  n += nz + nineq + neq;                         // residuals
  n += 2 * (nz + 2 * nineq + neq) + 3 * nineq;   // directions, rs, d, dinv
  n += 2 * nz + 2 * m + (nineq > nz ? nineq : nz);  // scratch
  return n + fric::work_elems(S);
}

template <typename T>
int launch(int B, int nz, int neq, int neq_real, int nineq, int k, int fd, int max_iter, int nil,
           double eps, const void* Q, const void* invQ, const void* G, const void* A,
           const void* F, const void* base_red, const void* mu, const void* p, const void* h,
           const void* b, void* out_best, void* out_cur, void* done_it, void* cur_improves,
           void* stream) {
  Sizes<T> S{{nz, neq, neq_real, nineq, k, fd}, max_iter, nil, (T)eps};
  const size_t bytes = smem_elems(S) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(pdipm_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  pdipm_fwd_kernel<T><<<B, WARP, bytes, (cudaStream_t)stream>>>(
      S, (const T*)Q, (const T*)invQ, (const T*)G, (const T*)A, (const T*)F, (const T*)base_red,
      (const T*)mu, (const T*)p, (const T*)h, (const T*)b, (T*)out_best, (T*)out_cur,
      (int32_t*)done_it, (int32_t*)cur_improves);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64. Returns cudaGetLastError() of the launch.
int pdipm_fwd(int dtype, int B, int nz, int neq, int neq_real, int nineq, int k, int fd,
              int max_iter, int not_improved_lim, double eps, const void* Q, const void* invQ,
              const void* G, const void* A, const void* F, const void* base_red, const void* mu,
              const void* p, const void* h, const void* b, void* out_best, void* out_cur,
              void* done_it, void* cur_improves, void* stream) {
  if (dtype == 1)
    return launch<double>(B, nz, neq, neq_real, nineq, k, fd, max_iter, not_improved_lim, eps, Q,
                          invQ, G, A, F, base_red, mu, p, h, b, out_best, out_cur, done_it,
                          cur_improves, stream);
  return launch<float>(B, nz, neq, neq_real, nineq, k, fd, max_iter, not_improved_lim, eps, Q,
                       invQ, G, A, F, base_red, mu, p, h, b, out_best, out_cur, done_it,
                       cur_improves, stream);
}

// shared-memory bytes one problem needs (the wrapper refuses what the card cannot hold)
long long pdipm_fwd_smem_bytes(int dtype, int nz, int neq, int nineq, int k, int fd) {
  if (dtype == 1) {
    Sizes<double> S{{nz, neq, neq, nineq, k, fd}, 0, 0, 0.0};
    return (long long)(smem_elems(S) * sizeof(double));
  }
  Sizes<float> S{{nz, neq, neq, nineq, k, fd}, 0, 0, 0.0f};
  return (long long)(smem_elems(S) * sizeof(float));
}

}  // extern "C"
