// K5: trilinear sampling of a C-channel voxel grid at N fractional voxel
// coordinates, grid (C, X, Y, Z), inds (N, 3) -> out (C, N).
//
// Replaces the Pallas TPU kernel diffsdfsim_tpu/ops/pallas_kernels.py
// `grid_interp_pallas`, the Pallas form of ops/sdf.grid_interp (the
// reference's ev_sdf_utils.grid_interp CUDA op). The voxel-grid bodies
// (GridShape) call it for every SDF value (C = 1) and for the sampled
// central-difference gradient volume (C = 3).
//
// One thread per (channel, point): the base corner is floor(ind) clamped to
// [0, dim - 2] on each axis, the fraction is ind - corner (so a point on the
// upper face interpolates to the last sample; an out-of-bounds point
// extrapolates, and its caller masks it), and the eight corners are blended
// x, then y, then z, with the same products and sums as the plain version.
// The products and sums use round-to-nearest intrinsics, which keep nvcc
// from contracting them into FMAs, so the result is bitwise the plain
// PyTorch version's. The gather is the cost: eight scattered reads per
// output, from a grid that the L2 holds up to ~50 MB.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

template <typename T>
__device__ __forceinline__ T lerp(T g0, T g1, T f) {
  return add(mul(g0, sub((T)1, f)), mul(g1, f));
}

template <typename T>
__device__ __forceinline__ int corner(T f, int dim, T* frac) {
  const T c = fmin(fmax(floor(f), (T)0), (T)(dim - 2));
  *frac = sub(f, c);
  return (int)c;
}

template <typename T>
__global__ void grid_interp_kernel(int C, int X, int Y, int Z, int N, const T* __restrict__ grid,
                                   const T* __restrict__ inds, T* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)C * N) return;
  const int c = (int)(idx / N), n = (int)(idx % N);
  T fx, fy, fz;
  const int x0 = corner(inds[3 * (size_t)n], X, &fx);
  const int y0 = corner(inds[3 * (size_t)n + 1], Y, &fy);
  const int z0 = corner(inds[3 * (size_t)n + 2], Z, &fz);
  const T* g = grid + (size_t)c * X * Y * Z;
  auto at = [&](int dx, int dy, int dz) {
    return g[((size_t)(x0 + dx) * Y + (y0 + dy)) * Z + (z0 + dz)];
  };
  const T c00 = lerp(at(0, 0, 0), at(1, 0, 0), fx);
  const T c10 = lerp(at(0, 1, 0), at(1, 1, 0), fx);
  const T c01 = lerp(at(0, 0, 1), at(1, 0, 1), fx);
  const T c11 = lerp(at(0, 1, 1), at(1, 1, 1), fx);
  const T c0 = lerp(c00, c10, fy);
  const T c1 = lerp(c01, c11, fy);
  out[idx] = lerp(c0, c1, fz);
}

template <typename T>
int launch(int C, int X, int Y, int Z, int N, const void* grid, const void* inds, void* out,
           void* stream) {
  const long long total = (long long)C * N;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  grid_interp_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      C, X, Y, Z, N, (const T*)grid, (const T*)inds, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64. Returns cudaGetLastError() of the launch,
// or -1 on a grid with an axis shorter than 2.
int grid_interp(int dtype, int C, int X, int Y, int Z, int N, const void* grid, const void* inds,
                void* out, void* stream) {
  if (X < 2 || Y < 2 || Z < 2 || C < 1) return -1;
  if (N <= 0) return 0;
  if (dtype == 1) return launch<double>(C, X, Y, Z, N, grid, inds, out, stream);
  return launch<float>(C, X, Y, Z, N, grid, inds, out, stream);
}

}  // extern "C"
