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
// over blocks. NREFINE steps of iterative refinement follow the first solve
// (below): the reduced algorithm loses a tight friction cone's digits, which
// the residual of the unreduced system restores. m2 + 12 + 7 NREFINE
// barriers per launch, counted at run time.
//
// The kernel computes in float64 whatever its inputs' type (`Real` below):
// float32 inputs are widened as they are loaded and the outputs rounded as
// they are stored. In float32 the reduced factor of a tight cone (d at the
// backward's float32 cap 1e5) is too far from the unreduced system for
// refinement to converge (370x the answer off the exact solution after the
// first solve, 4.2x after two steps), while in float64 two steps reach it.
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

// refinement steps after the first solve: on the sysid friction sweep's
// replays one step takes the cone rows from 1.8e-5 to 1.4e-13 of the exact
// solution; where a whole contact's cone is tight at d = 3e8 (the emulator's
// "tight" case) the first solve's cone rows are off by O(1) and two steps
// take them to 5e-10
constexpr int NREFINE = 2;

template <class S, typename T>
__host__ __device__ size_t smem_elems(const S& D) {
  T* p = nullptr;
  fric::carve_work(p, D);
  carve(p, D.nz());  // rx
  carve(p, D.nz());  // dx0
  carve(p, D.m());   // w0
  return (size_t)(p - (T*)nullptr);
}

// the type every shared array, the factor and each solve are computed in
using Real = double;

template <typename T, class S>
__global__ void __launch_bounds__(NT, S::MIN_BLOCKS) kkt_bwd_kernel(S D, const T* __restrict__ ginvQ, const T* __restrict__ gG,
                                                     const T* __restrict__ gA, const T* __restrict__ gF,
                                                     const T* __restrict__ gd, const T* __restrict__ grx, T* out_dx,
                                                     T* out_dlam, T* out_dnu, int32_t* out_syncs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int prob = blockIdx.x;
  const int nz = D.nz(), neq = D.neq(), nineq = D.nineq();

  Real* p = reinterpret_cast<Real*>(smem_raw);
  fric::Work<Real> w = fric::carve_work(p, D);
  Real* rx = carve(p, nz);
  Real* dx0 = carve(p, nz);
  Real* w0 = carve(p, D.m());
  Ctx<Real> c{(int)threadIdx.x, w.red, 0, 0};
  const int t = c.t;

  fric::load(D, w, t, gA + (size_t)prob * neq * nz, gG + (size_t)prob * nineq * nz, ginvQ + (size_t)prob * nz * nz,
             gF + (size_t)prob * nineq * nineq);
  for (int i = t; i < nz; i += NT) rx[i] = (Real)grx[(size_t)prob * nz + i];
  for (int i = t; i < nineq; i += NT) {
    const Real d = (Real)gd[(size_t)prob * nineq + i];
    w.d[i] = d;
    w.dinv[i] = fric::recip(d);
  }
  c.sync();
  fric::setup(D, w, c);
  c.sync();
  fric::Inv<S, Real> K;
  fric::factor(D, w, K, c);
  // w = -S^-1 hvec, then NREFINE steps of iterative refinement. Where a
  // friction cone is tight (d ~1e8) the reduced solve recovers its cone row
  // as d times a difference of its outputs, which loses that row's digits;
  // each step forms the residual of the unreduced KKT rows at (dx0, w),
  // rho = [A; G] dx0 - [P w_eq; (F + D^-1) w_ineq] (dx0 = Q^-1 (-rx - [A; G]'
  // w) meets the first row by construction; P pins a padded equality row),
  // in float64 from F's structure (a friction row couples to its contact's
  // cone multiplier; cone row c reads mu_c wn_c - the sum of c's friction
  // multipliers), solves S delta = rho with the factor in registers and adds
  // delta to w.
  fric::kkt_hvec(D, w, c, rx, w.zero, w.zero, w.zero);
  fric::schur_solve(D, w, K, c);
  const int k = D.k(), fd = D.fd(), nf = D.nf(), m = D.m(), ldz = D.ldz(), neq_real = D.neq_real();
  for (int step = 0; step < NREFINE; ++step) {
    fric::kkt_out(D, w, c, rx, w.zero, dx0, (Real*)nullptr, (Real*)nullptr, (Real*)nullptr);
    fric::rows<double, 4>(
        t, m,
        [&](int r, int l) {
          double s0 = 0;
          for (int j = l; j < nz; j += 4) s0 += (double)w.AG[r * ldz + j] * (double)dx0[j];
          return s0;
        },
        [&](int r, double acc) {
          const Real* wv = w.wvec;
          double pin = 0;
          if (r < neq) {
            if (r >= neq_real) pin = wv[r];
          } else {
            const int i = r - neq;
            if (i >= k + nf) {
              const int cc = i - k - nf;
              double fs = 0;
              for (int j = 0; j < fd; ++j) fs += (double)wv[neq + k + cc * fd + j];
              pin = (double)w.mu[cc] * (double)wv[neq + cc] - fs;
            } else if (i >= k) {
              pin = wv[neq + k + nf + (i - k) / fd];
            }
            pin += (double)wv[r] / (double)w.d[i];
          }
          w.hvec[r] = (Real)(pin - acc);  // -rho
          w0[r] = wv[r];
        });
    c.sync();
    fric::schur_solve(D, w, K, c);  // w.wvec = S^-1 rho
    for (int i = t; i < m; i += NT) w.wvec[i] += w0[i];
    c.sync();
  }
  fric::kkt_out(D, w, c, rx, w.zero, out_dx + (size_t)prob * nz, (T*)nullptr, out_dlam + (size_t)prob * nineq,
                out_dnu + (size_t)prob * neq);
  if (t == 0) out_syncs[prob] = c.nsync;
}

template <typename T>
int launch(const fric::Dims& dims, int B, const void* invQ, const void* G, const void* A, const void* F,
           const void* d, const void* rx, void* dx, void* dlam, void* dnu, void* syncs, void* stream) {
  return fric::with_shape(dims, [&](auto D) {
    using S = decltype(D);
    const size_t bytes = smem_elems<S, Real>(D) * sizeof(Real);
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
    return fric::resources<S>(kkt_bwd_kernel<T, S>, smem_elems<S, Real>(D) * sizeof(Real), out);
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
