// K1: batched PDIPM forward for the physics mixed LCP, one block per problem.
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
// The Schur complement is solved on the reduced system of the JAX kernel
// (fric_schur.cuh, shared with the backward kernel K2): the k cone rows
// eliminated, the +/- friction-direction pairs folded (a per-contact
// Sherman-Morrison), and the remaining m2 = neq + k + k*fd/2 rows inverted
// by pivot-free Gauss-Jordan with the same tiny-pivot guard (safe_pv). The
// kernel forms that system's base block and the cone coefficients from Q^-1,
// G, A and F itself.
//
// What bounds it on an H100: neither bytes nor FLOPs. At the main path's
// shapes (B = 3 or 6 problems) one launch reads ~20-100 KB and does
// ~0.5 MFLOP per problem, so the card's roofline time is tens of
// nanoseconds; the kernel is latency-bound on the serial chain of ~11
// iterations, each a Gauss-Jordan inverse of m2 pivots and two KKT solves.
// The design shortens each link of the chain: a block of NT = 128 threads
// per problem; every operand and iterate in shared memory for the whole
// loop; the Gauss-Jordan matrix in registers with one barrier per pivot;
// every product spread over the block (fric_schur.cuh). One
// Mehrotra iteration costs m2 + 24 barriers (50 at k = 4), counted at run
// time and returned beside the stop iteration.
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

using fric::carve;
using fric::Ctx;
using fric::NT;

template <typename T>
__device__ __forceinline__ T big_value();
template <>
__device__ __forceinline__ float big_value<float>() { return 3.402823466e38f; }
template <>
__device__ __forceinline__ double big_value<double>() { return 1.7976931348623157e308; }

// the loop's shared arrays beside the reduced solve's
template <typename T>
struct Iter {
  T *Q, *F, *p, *h, *b;
  T *x, *s, *z, *y, *bx, *bs, *bz, *by;                          // iterates, best iterates
  T *rx, *rz, *ry, *rs, *hneg, *bneg;                            // residuals, rs, -h, -b
  T *dxa, *dsa, *dza, *dya, *dxc, *dsc, *dzc, *dyc;              // directions
};

template <class S, typename T>
__host__ __device__ Iter<T> carve_iter(T*& p, const S& D) {
  const int nz = D.nz(), neq = D.neq(), nineq = D.nineq();
  Iter<T> v;
  v.Q = carve(p, (size_t)nz * D.ldz());
  v.F = carve(p, (size_t)nineq * fric::odd(nineq));
  v.p = carve(p, nz); v.h = carve(p, nineq); v.b = carve(p, neq);
  v.x = carve(p, nz); v.s = carve(p, nineq); v.z = carve(p, nineq); v.y = carve(p, neq);
  v.bx = carve(p, nz); v.bs = carve(p, nineq); v.bz = carve(p, nineq); v.by = carve(p, neq);
  v.rx = carve(p, nz); v.rz = carve(p, nineq); v.ry = carve(p, neq);
  v.rs = carve(p, nineq); v.hneg = carve(p, nineq); v.bneg = carve(p, neq);
  v.dxa = carve(p, nz); v.dsa = carve(p, nineq); v.dza = carve(p, nineq); v.dya = carve(p, neq);
  v.dxc = carve(p, nz); v.dsc = carve(p, nineq); v.dzc = carve(p, nineq); v.dyc = carve(p, neq);
  return v;
}

template <class S, typename T>
__host__ __device__ size_t smem_elems(const S& D) {
  T* p = nullptr;
  fric::carve_work(p, D);
  carve_iter(p, D);
  return (size_t)(p - (T*)nullptr);
}

// residuals of the current iterate (one barrier); returns (mu, resid)
template <class S, typename T>
__device__ void residuals(const S& D, fric::Work<T>& w, Iter<T>& v, Ctx<T>& c, T& mu, T& res) {
  using fric::gdot;
  const int nz = D.nz(), neq = D.neq(), nineq = D.nineq(), ldz = D.ldz(), ldf = fric::odd(nineq);
  const T* A = w.AG;
  const T* G = w.AG + neq * ldz;
  T acc[4] = {0, 0, 0, 0};  // s'z, |rz|^2, |ry|^2, |rx|^2
  // rx = G'z + Q'x + A'y + p,  rz = Gx - Fz + s - h,  ry = Ax - b
  fric::rows<T, 8>(
      c.t, nz + nineq + neq,
      [&](int r, int l) -> T {
        if (r < nz)
          return gdot<8>(l, nineq, G + r, ldz, v.z) + gdot<8>(l, nz, v.Q + r, ldz, v.x) +
                 gdot<8>(l, neq, A + r, ldz, v.y);
        if (r < nz + nineq) {
          const int i = r - nz;
          return gdot<8>(l, nz, G + i * ldz, 1, v.x) - gdot<8>(l, nineq, v.F + i * ldf, 1, v.z);
        }
        return gdot<8>(l, nz, A + (r - nz - nineq) * ldz, 1, v.x);
      },
      [&](int r, T a) {
        if (r < nz) {
          const T t = a + v.p[r];
          v.rx[r] = t;
          acc[3] += t * t;
        } else if (r < nz + nineq) {
          const int i = r - nz;
          const T t = a + v.s[i] - v.h[i];
          v.rz[i] = t;
          acc[1] += t * t;
        } else {
          const int i = r - nz - nineq;
          const T t = a - v.b[i];
          v.ry[i] = t;
          acc[2] += t * t;
        }
      });
  for (int i = c.t; i < nineq; i += NT) acc[0] += v.s[i] * v.z[i];
  c.reduce(acc, fric::Sum());
  mu = fabs(acc[0] / (T)nineq);
  res = sqrt(acc[1]) + sqrt(acc[2]) + sqrt(acc[3]) + (T)nineq * mu;
}

// max step in [0, inf) keeping val + a dv > 0 over this thread's entries
template <typename T>
__device__ T own_step(int t, const T* val, const T* dv, int n) {
  T a = (T)INFINITY;
  for (int i = t; i < n; i += NT)
    if (dv[i] < 0) a = fmin(a, -val[i] / dv[i]);
  return a;
}

template <typename T, class S>
__global__ void __launch_bounds__(NT, S::MIN_BLOCKS) pdipm_fwd_kernel(
    S D, int max_iter, int nil, T eps, const T* __restrict__ gQ, const T* __restrict__ ginvQ,
    const T* __restrict__ gG, const T* __restrict__ gA, const T* __restrict__ gF, const T* __restrict__ gp,
    const T* __restrict__ gh, const T* __restrict__ gb, T* out_sol, int32_t* out_int, int B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int prob = blockIdx.x;
  const int nz = D.nz(), neq = D.neq(), nineq = D.nineq(), ldz = D.ldz();
  const int nsol = nz + 2 * nineq + neq;

  T* p = reinterpret_cast<T*>(smem_raw);
  fric::Work<T> w = fric::carve_work(p, D);
  Iter<T> v = carve_iter(p, D);
  Ctx<T> c{(int)threadIdx.x, w.red, 0, 0};
  const int t = c.t;
  const T* F = gF + (size_t)prob * nineq * nineq;

  fric::load(D, w, t, gA + (size_t)prob * neq * nz, gG + (size_t)prob * nineq * nz, ginvQ + (size_t)prob * nz * nz, F);
  for (int e = t; e < nineq * nineq; e += NT) v.F[(e / nineq) * fric::odd(nineq) + e % nineq] = F[e];
  for (int e = t; e < nz * nz; e += NT) v.Q[(e / nz) * ldz + e % nz] = gQ[(size_t)prob * nz * nz + e];
  for (int i = t; i < nz; i += NT) v.p[i] = gp[(size_t)prob * nz + i];
  for (int i = t; i < nineq; i += NT) {
    v.h[i] = gh[(size_t)prob * nineq + i];
    v.hneg[i] = -v.h[i];
    w.d[i] = 1;  // initialization: one KKT solve at d = 1 (batch.py:84-90)
    w.dinv[i] = 1;
  }
  for (int i = t; i < neq; i += NT) {
    v.b[i] = gb[(size_t)prob * neq + i];
    v.bneg[i] = -v.b[i];
  }
  c.sync();
  fric::setup(D, w, c);
  c.sync();

  fric::Inv<S, T> K;
  fric::factor(D, w, K, c);
  fric::solve_kkt(D, w, K, c, v.p, w.zero, v.hneg, v.bneg, v.x, v.s, v.z, v.y);
  // shift slacks and duals to >= 1 (batch.py:100-110)
  {
    T mn[2] = {(T)INFINITY, (T)INFINITY};
    for (int i = t; i < nineq; i += NT) {
      mn[0] = fmin(mn[0], v.s[i]);
      mn[1] = fmin(mn[1], v.z[i]);
    }
    c.reduce(mn, fric::Min());
    for (int i = t; i < nineq; i += NT) {
      if (mn[0] < 0) v.s[i] = v.s[i] - mn[0] + (T)1;
      if (mn[1] < 0) v.z[i] = v.z[i] - mn[1] + (T)1;
      v.bs[i] = v.s[i];
      v.bz[i] = v.z[i];
    }
    for (int i = t; i < nz; i += NT) v.bx[i] = v.x[i];
    for (int i = t; i < neq; i += NT) v.by[i] = v.y[i];
  }
  c.sync();

  T bres = big_value<T>();
  int nni = 0;
  bool done = false;
  int done_it = max_iter;
  int iter_syncs = 0;
  int it = 0;
  while (it < max_iter && !done) {
    const int n0 = c.nsync;
    T mu, res;
    residuals(D, w, v, c, mu, res);
    const bool improved = res < bres;
    if (improved) {  // each thread copies the entries it owns
      for (int i = t; i < nz; i += NT) v.bx[i] = v.x[i];
      for (int i = t; i < nineq; i += NT) {
        v.bs[i] = v.s[i];
        v.bz[i] = v.z[i];
      }
      for (int i = t; i < neq; i += NT) v.by[i] = v.y[i];
      bres = res;
      nni = 0;
    } else {
      nni += 1;
    }
    const bool stop = (nni >= nil) || (bres < eps) || (mu > (T)1e32);

    for (int i = t; i < nineq; i += NT) {
      w.d[i] = v.z[i] / v.s[i];
      w.dinv[i] = fric::recip(w.d[i]);
    }
    c.sync();
    fric::factor(D, w, K, c);
    fric::solve_kkt(D, w, K, c, v.rx, v.z, v.rz, v.ry, v.dxa, v.dsa, v.dza, v.dya);

    // centering-corrector (batch.py:184-211)
    T st[1] = {fmin(own_step(t, v.z, v.dza, nineq), own_step(t, v.s, v.dsa, nineq))};
    c.reduce(st, fric::Min());
    T alpha = fmin(st[0], (T)1);
    T nd[2] = {0, 0};
    for (int i = t; i < nineq; i += NT) {
      nd[0] += (v.s[i] + alpha * v.dsa[i]) * (v.z[i] + alpha * v.dza[i]);
      nd[1] += v.s[i] * v.z[i];
    }
    c.reduce(nd, fric::Sum());
    const T ratio = nd[0] / nd[1];
    const T sig = ratio * ratio * ratio;
    for (int i = t; i < nineq; i += NT) v.rs[i] = (-(mu * sig) + v.dsa[i] * v.dza[i]) / v.s[i];
    c.sync();
    fric::solve_kkt(D, w, K, c, w.zero, v.rs, w.zero, w.zero, v.dxc, v.dsc, v.dzc, v.dyc);
    // combined direction (each thread its own entries): dx in dxa, ds in dsa, dz in dza, dy in dya
    for (int i = t; i < nz; i += NT) v.dxa[i] += v.dxc[i];
    for (int i = t; i < nineq; i += NT) {
      v.dsa[i] += v.dsc[i];
      v.dza[i] += v.dzc[i];
    }
    for (int i = t; i < neq; i += NT) v.dya[i] += v.dyc[i];
    st[0] = fmin(own_step(t, v.z, v.dza, nineq), own_step(t, v.s, v.dsa, nineq));
    c.reduce(st, fric::Min());
    alpha = fmin((T)0.999 * st[0], (T)1);

    bool bad = false;
    for (int i = t; i < nz; i += NT) bad |= !isfinite(v.x[i] + alpha * v.dxa[i]);
    for (int i = t; i < nineq; i += NT)
      bad |= !isfinite(v.s[i] + alpha * v.dsa[i]) || !isfinite(v.z[i] + alpha * v.dza[i]);
    const bool finite = !c.any(bad);
    if (finite) {
      for (int i = t; i < nz; i += NT) v.x[i] = v.x[i] + alpha * v.dxa[i];
      for (int i = t; i < nineq; i += NT) {
        v.s[i] = v.s[i] + alpha * v.dsa[i];
        v.z[i] = v.z[i] + alpha * v.dza[i];
      }
      for (int i = t; i < neq; i += NT) v.y[i] = v.y[i] + alpha * v.dya[i];
    }
    c.sync();
    if (stop || !finite) {
      done = true;
      done_it = it;
    }
    if (it == 0) iter_syncs = c.nsync - n0;
    it += 1;
  }

  // would the current iterate replace the best one? (final check / the
  // next iteration's check; the wrapper decides which applies)
  T mu, res;
  residuals(D, w, v, c, mu, res);
  T* best = out_sol + (size_t)prob * nsol;
  T* cur = out_sol + ((size_t)B + prob) * nsol;
  for (int i = t; i < nz; i += NT) {
    best[i] = (T)v.bx[i];
    cur[i] = (T)v.x[i];
  }
  for (int i = t; i < nineq; i += NT) {
    best[nz + i] = (T)v.bs[i];
    best[nz + nineq + i] = (T)v.bz[i];
    cur[nz + i] = (T)v.s[i];
    cur[nz + nineq + i] = (T)v.z[i];
  }
  for (int i = t; i < neq; i += NT) {
    best[nz + 2 * nineq + i] = (T)v.by[i];
    cur[nz + 2 * nineq + i] = (T)v.y[i];
  }
  if (t == 0) {
    int32_t* o = out_int + (size_t)prob * 4;
    o[0] = done_it;
    o[1] = res < bres ? 1 : 0;
    o[2] = iter_syncs;
    o[3] = c.nsync;
  }
}

template <typename T>
int launch(const fric::Dims& dims, int B, int max_iter, int nil, double eps, const void* Q, const void* invQ,
           const void* G, const void* A, const void* F, const void* p, const void* h, const void* b,
           void* out_sol, void* out_int, void* stream) {
  return fric::with_shape(dims, [&](auto D) {
    using S = decltype(D);
    const size_t bytes = smem_elems<S, T>(D) * sizeof(T);
    cudaError_t err = cudaFuncSetAttribute(pdipm_fwd_kernel<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)bytes);
    if (err != cudaSuccess) return (int)err;
    pdipm_fwd_kernel<T, S><<<B, NT, bytes, (cudaStream_t)stream>>>(
        D, max_iter, nil, (T)eps, (const T*)Q, (const T*)invQ, (const T*)G, (const T*)A, (const T*)F,
        (const T*)p, (const T*)h, (const T*)b, (T*)out_sol, (int32_t*)out_int, B);
    return (int)cudaGetLastError();
  });
}

template <typename T>
int info(const fric::Dims& dims, long long* out) {
  return fric::with_shape(dims, [&](auto D) {
    using S = decltype(D);
    return fric::resources<S>(pdipm_fwd_kernel<T, S>, smem_elems<S, T>(D) * sizeof(T), out);
  });
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64. out_sol: (2, B, nz + 2 nineq + neq), the
// best then the current iterate; out_int: (B, 4) stop iteration, current
// improves best, barriers in the first Mehrotra iteration, barriers in all.
// Returns cudaGetLastError() of the launch.
int pdipm_fwd(int dtype, int B, int nz, int neq, int neq_real, int nineq, int k, int fd, int max_iter,
              int not_improved_lim, double eps, const void* Q, const void* invQ, const void* G, const void* A,
              const void* F, const void* p, const void* h, const void* b, void* out_sol, void* out_int,
              void* stream) {
  const fric::Dims dims{nz, neq, neq_real, nineq, k, fd};
  if (dtype == 1)
    return launch<double>(dims, B, max_iter, not_improved_lim, eps, Q, invQ, G, A, F, p, h, b, out_sol, out_int,
                          stream);
  return launch<float>(dims, B, max_iter, not_improved_lim, eps, Q, invQ, G, A, F, p, h, b, out_sol, out_int,
                       stream);
}

// the launch's resources: threads, shared bytes, registers per thread,
// local (spill) bytes per thread, blocks per SM, static m2 (0: runtime sizes)
int pdipm_fwd_info(int dtype, int nz, int neq, int nineq, int k, int fd, long long* out) {
  const fric::Dims dims{nz, neq, neq, nineq, k, fd};
  return dtype == 1 ? info<double>(dims, out) : info<float>(dims, out);
}

}  // extern "C"
