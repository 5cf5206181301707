// K2: batched backward KKT solve of the physics mixed LCP, one problem per block.
//
// Replaces the Pallas TPU kernel diffsdfsim_tpu/ops/qp_pallas.py
// `_make_grad_kernel` (launched by `_kkt_grad_flat`, public
// `kkt_grad_pallas`) on its friction-structure path (`fric=(k, fd)`). It is
// the only linear algebra in the LCP's implicit-differentiation backward
// (reference lcp_physics/lcp/lcp.py:184-198): one KKT solve with right-hand
// side (dL/dz, 0, 0, 0) at the solution's diagonal d = lam / slack,
//
//   hvec = [A; G] Q^-1 rx,   w = -S^-1 hvec,
//   dx = Q^-1 (-rx - G' w_ineq - A' w_eq),   dlam = w_ineq,   dnu = w_eq,
//
// with S the Schur complement, solved on the reduced system that K1 uses
// (fric_schur.cuh: cone rows eliminated, +/- friction pairs folded, an
// m2 = neq + k + k*fd/2 Gauss-Jordan inverse, 26 rows on the bench).
//
// What bounds it on an H100: neither bytes nor FLOPs. One problem reads
// ~10 KB and does ~80 kFLOP (the 26-pivot Gauss-Jordan is most of it), so
// the card's roofline time for the bench's one problem per launch is a few
// nanoseconds; the kernel is latency-bound on the serial chain of 26
// Gauss-Jordan pivots and a dozen dependent matrix-vector passes. As in K1,
// each problem's operands stay in shared memory, one warp per problem makes
// every barrier a __syncwarp, and a batch of problems (hundreds for a seed
// sweep) spreads over blocks.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <math.h>

#include "fric_schur.cuh"

namespace {

using fric::WARP;
using fric::carve;
using fric::copy;
using fric::mtv;
using fric::mv;

template <typename T>
__global__ void kkt_bwd_kernel(fric::Dims S, const T* __restrict__ ginvQ, const T* __restrict__ gG,
                               const T* __restrict__ gA, const T* __restrict__ gbase_red,
                               const T* __restrict__ gmu, const T* __restrict__ gd,
                               const T* __restrict__ grx, T* out_dx, T* out_dlam, T* out_dnu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x;
  const int prob = blockIdx.x;
  const int nz = S.nz, neq = S.neq, nineq = S.nineq, k = S.k;
  const int m2 = fric::m2_of(S), m = neq + nineq;

  T* p = reinterpret_cast<T*>(smem_raw);
  T* invQ = carve(p, nz * nz);
  T* G = carve(p, nineq * nz);
  T* A = carve(p, neq * nz);
  T* rx = carve(p, nz);
  T* dinv = carve(p, nineq);
  T* hvec = carve(p, m);
  T* wvec = carve(p, m);
  T* t_nz = carve(p, nz);
  T* t_nz2 = carve(p, nz);
  fric::Work<T> w = fric::carve_work(p, S);

  copy(invQ, ginvQ + (size_t)prob * nz * nz, nz * nz, lane);
  copy(G, gG + (size_t)prob * nineq * nz, nineq * nz, lane);
  copy(A, gA + (size_t)prob * neq * nz, neq * nz, lane);
  copy(w.base_red, gbase_red + (size_t)prob * m2 * m2, m2 * m2, lane);
  copy(w.mu, gmu + (size_t)prob * k, k, lane);
  copy(rx, grx + (size_t)prob * nz, nz, lane);
  const T* d = gd + (size_t)prob * nineq;
  for (int i = lane; i < nineq; i += WARP) dinv[i] = (T)1 / d[i];
  __syncwarp();

  fric::factor(S, w, dinv, lane);

  // hvec = [A; G] Q^-1 rx
  mv(t_nz, invQ, rx, nz, nz, lane);
  __syncwarp();
  mv(hvec, A, t_nz, neq, nz, lane);
  mv(hvec + neq, G, t_nz, nineq, nz, lane);
  __syncwarp();
  fric::solve_S(S, w, hvec, wvec, lane);
  for (int i = lane; i < m; i += WARP) wvec[i] = -wvec[i];
  __syncwarp();
  const T* w_eq = wvec;
  const T* w_in = wvec + neq;
  mtv(t_nz, G, w_in, nineq, nz, lane);
  mtv(t_nz2, A, w_eq, neq, nz, lane);
  __syncwarp();
  for (int i = lane; i < nz; i += WARP) t_nz[i] = -rx[i] - t_nz[i] - t_nz2[i];
  __syncwarp();
  mv(out_dx + (size_t)prob * nz, invQ, t_nz, nz, nz, lane);
  copy(out_dlam + (size_t)prob * nineq, w_in, nineq, lane);
  copy(out_dnu + (size_t)prob * neq, w_eq, neq, lane);
}

size_t smem_elems(const fric::Dims& S) {
  const int nz = S.nz, neq = S.neq, nineq = S.nineq;
  return (size_t)nz * nz + nineq * nz + neq * nz + 3 * nz + nineq + 2 * (neq + nineq) +
         fric::work_elems(S);
}

template <typename T>
int launch(int B, const fric::Dims& S, const void* invQ, const void* G, const void* A,
           const void* base_red, const void* mu, const void* d, const void* rx, void* dx,
           void* dlam, void* dnu, void* stream) {
  const size_t bytes = smem_elems(S) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(kkt_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kkt_bwd_kernel<T><<<B, WARP, bytes, (cudaStream_t)stream>>>(
      S, (const T*)invQ, (const T*)G, (const T*)A, (const T*)base_red, (const T*)mu, (const T*)d,
      (const T*)rx, (T*)dx, (T*)dlam, (T*)dnu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64. Returns cudaGetLastError() of the launch.
int kkt_bwd(int dtype, int B, int nz, int neq, int neq_real, int nineq, int k, int fd,
            const void* invQ, const void* G, const void* A, const void* base_red, const void* mu,
            const void* d, const void* rx, void* dx, void* dlam, void* dnu, void* stream) {
  const fric::Dims S{nz, neq, neq_real, nineq, k, fd};
  if (dtype == 1)
    return launch<double>(B, S, invQ, G, A, base_red, mu, d, rx, dx, dlam, dnu, stream);
  return launch<float>(B, S, invQ, G, A, base_red, mu, d, rx, dx, dlam, dnu, stream);
}

// shared-memory bytes one problem needs (the wrapper refuses what the card cannot hold)
long long kkt_bwd_smem_bytes(int dtype, int nz, int neq, int nineq, int k, int fd) {
  const fric::Dims S{nz, neq, neq, nineq, k, fd};
  return (long long)(smem_elems(S) * (dtype == 1 ? sizeof(double) : sizeof(float)));
}

}  // extern "C"
