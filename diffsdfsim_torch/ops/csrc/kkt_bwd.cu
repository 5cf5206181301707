// K2: batched backward KKT solve of the physics mixed LCP, one block per problem.
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
// m2 = neq + k + k*fd/2 Gauss-Jordan inverse, 26 rows on the bench). The
// kernel forms the reduced base block from Q^-1, G and A and reads F only
// at its k cone coefficients.
//
// What bounds it on an H100: neither bytes nor FLOPs. One problem reads
// ~10 KB and does ~80 kFLOP, so the card's roofline time for the bench's
// one problem per launch is a few nanoseconds; the kernel is latency-bound
// on its chain: the setup products, m2 Gauss-Jordan pivots and one KKT
// solve. As in K1, a block of NT = 128 threads per problem keeps the
// inverse in registers (one barrier per pivot) and spreads every product
// over the block; a batch of problems (hundreds for a seed sweep) spreads
// over blocks. m2 + 12 barriers per launch, counted at run time.
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

template <class S, typename T>
__host__ __device__ size_t smem_elems(const S& D) {
  T* p = nullptr;
  fric::carve_work(p, D);
  carve(p, D.nz());  // rx
  return (size_t)(p - (T*)nullptr);
}

template <typename T, class S>
__global__ void __launch_bounds__(NT, S::MIN_BLOCKS) kkt_bwd_kernel(S D, const T* __restrict__ ginvQ, const T* __restrict__ gG,
                                                     const T* __restrict__ gA, const T* __restrict__ gF,
                                                     const T* __restrict__ gd, const T* __restrict__ grx, T* out_dx,
                                                     T* out_dlam, T* out_dnu, int32_t* out_syncs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int prob = blockIdx.x;
  const int nz = D.nz(), neq = D.neq(), nineq = D.nineq();

  T* p = reinterpret_cast<T*>(smem_raw);
  fric::Work<T> w = fric::carve_work(p, D);
  T* rx = carve(p, nz);
  Ctx<T> c{(int)threadIdx.x, w.red, 0, 0};
  const int t = c.t;

  fric::load(D, w, t, gA + (size_t)prob * neq * nz, gG + (size_t)prob * nineq * nz, ginvQ + (size_t)prob * nz * nz,
             gF + (size_t)prob * nineq * nineq);
  for (int i = t; i < nz; i += NT) rx[i] = grx[(size_t)prob * nz + i];
  for (int i = t; i < nineq; i += NT) {
    const T d = gd[(size_t)prob * nineq + i];
    w.d[i] = d;
    w.dinv[i] = fric::recip(d);
  }
  c.sync();
  fric::setup(D, w, c);
  c.sync();
  fric::Inv<S, T> K;
  fric::factor(D, w, K, c);
  fric::solve_kkt(D, w, K, c, rx, w.zero, w.zero, w.zero, out_dx + (size_t)prob * nz, (T*)nullptr,
                  out_dlam + (size_t)prob * nineq, out_dnu + (size_t)prob * neq);
  if (t == 0) out_syncs[prob] = c.nsync;
}

template <typename T>
int launch(const fric::Dims& dims, int B, const void* invQ, const void* G, const void* A, const void* F,
           const void* d, const void* rx, void* dx, void* dlam, void* dnu, void* syncs, void* stream) {
  return fric::with_shape(dims, [&](auto D) {
    using S = decltype(D);
    const size_t bytes = smem_elems<S, T>(D) * sizeof(T);
    cudaError_t err =
        cudaFuncSetAttribute(kkt_bwd_kernel<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    kkt_bwd_kernel<T, S><<<B, NT, bytes, (cudaStream_t)stream>>>(
        D, (const T*)invQ, (const T*)G, (const T*)A, (const T*)F, (const T*)d, (const T*)rx, (T*)dx, (T*)dlam,
        (T*)dnu, (int32_t*)syncs);
    return (int)cudaGetLastError();
  });
}

template <typename T>
int info(const fric::Dims& dims, long long* out) {
  return fric::with_shape(dims, [&](auto D) {
    using S = decltype(D);
    return fric::resources<S>(kkt_bwd_kernel<T, S>, smem_elems<S, T>(D) * sizeof(T), out);
  });
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64. syncs: (B,) barriers of each block.
// Returns cudaGetLastError() of the launch.
int kkt_bwd(int dtype, int B, int nz, int neq, int neq_real, int nineq, int k, int fd, const void* invQ,
            const void* G, const void* A, const void* F, const void* d, const void* rx, void* dx, void* dlam,
            void* dnu, void* syncs, void* stream) {
  const fric::Dims dims{nz, neq, neq_real, nineq, k, fd};
  if (dtype == 1) return launch<double>(dims, B, invQ, G, A, F, d, rx, dx, dlam, dnu, syncs, stream);
  return launch<float>(dims, B, invQ, G, A, F, d, rx, dx, dlam, dnu, syncs, stream);
}

// the launch's resources, as pdipm_fwd_info
int kkt_bwd_info(int dtype, int nz, int neq, int nineq, int k, int fd, long long* out) {
  const fric::Dims dims{nz, neq, neq, nineq, k, fd};
  return dtype == 1 ? info<double>(dims, out) : info<float>(dims, out);
}

}  // extern "C"
