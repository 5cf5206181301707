// K5: the voxel-grid SDF on the card. Two entry points:
//
// - grid_query: one whole SDF query of a voxel-grid body per launch. Per
//   point: the bounding-scale overlap mask, the normalized point, its voxel
//   index and in-bounds mask, the trilinear value (1 outside), the metric
//   value, and the gradient: the central differences of the grid at the 8
//   corners, interpolated, normalized and masked, once (what grid_sdf_grad
//   returns, the value's vector-Jacobian product needs it) and twice (what
//   query_sdfs returns). This is physics/shapes.py's query_sdfs on a
//   GridShape, composed of ops/sdf.py's _grid_inds, grid_sdf_raw,
//   grid_grad_volume, grid_sdf_grad and utils/spherical.normalize, in their
//   order and rounding; ops/sdf.grid_query is that composition, the plain
//   version.
// - grid_interp: trilinear sampling of a C-channel grid (C, X, Y, Z) at N
//   fractional voxel coordinates -> (C, N), base corner floor(ind) clamped to
//   [0, dim - 2] (ops/sdf.grid_interp).
//
// Replaces the Pallas TPU kernel diffsdfsim_tpu/ops/pallas_kernels.py
// `grid_interp_pallas` (the trilinear sampler; the JAX package serves its
// GridShape through an XLA gather instead, ops/sdf.py grid_sdf_raw /
// grid_sdf_grad / grid_grad_volume, which grid_query fuses).
//
// What bounds it on an H100: at the grid path's ~10^3 points per query,
// latency (one launch of a few microseconds); the query's cost used to be
// around the sampler's launch: a second launch for the gradient, the
// (3, X, Y, Z) gradient volume rebuilt by ~15 tensor ops on every gradient
// query, host-built index tensors and ~25 small tensor ops. grid_query does
// all of it in one thread per point: the grid (2 MB at 64^3 float64) stays
// in the 50 MB L2, and a point reads the 32 grid values its 8 corners and
// their central-difference stencils touch (the 2 x 2 x 2 corner block and
// its 24 face neighbours). Beyond that its bound is bytes: the points, the
// outputs and at most the grid once.
//
// Rounding: every product, sum, quotient and square root is the
// correctly rounded intrinsic (__dmul_rn, __ddiv_rn, __dsqrt_rn, ...), which
// nvcc never contracts into an FMA, in the order the plain version's tensor
// ops take on the card; the value and the interpolated gradient are bitwise
// the plain version's. normalize's sum of squares is (v0^2 + v1^2) + v2^2.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double quo(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }

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

// the 8 corners c[dx][dy][dz] blended x, then y, then z (ops/sdf.grid_interp)
template <typename T>
__device__ __forceinline__ T trilinear(const T (&c)[2][2][2], T fx, T fy, T fz) {
  const T c00 = lerp(c[0][0][0], c[1][0][0], fx);
  const T c10 = lerp(c[0][1][0], c[1][1][0], fx);
  const T c01 = lerp(c[0][0][1], c[1][0][1], fx);
  const T c11 = lerp(c[0][1][1], c[1][1][1], fx);
  return lerp(lerp(c00, c10, fy), lerp(c01, c11, fy), fz);
}

// v / sqrt(max(sum v^2, 1e-24)) in place (utils/spherical.normalize; its
// clamp keeps a NaN)
template <typename T>
__device__ __forceinline__ void normalize3(T (&v)[3]) {
  const T eps2 = (T)(1e-12 * 1e-12);
  const T n2 = add(add(mul(v[0], v[0]), mul(v[1], v[1])), mul(v[2], v[2]));
  const T n = root(n2 < eps2 ? eps2 : n2);
  for (int c = 0; c < 3; ++c) v[c] = quo(v[c], n);
}

// ---------------------------------------------------------------- the sampler

template <typename T>
__global__ void grid_interp_kernel(int C, int X, int Y, int Z, int N, const T* __restrict__ grid,
                                   const T* __restrict__ inds, T* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)C * N) return;
  const int ch = (int)(idx / N), n = (int)(idx % N);
  T fx, fy, fz;
  const int x0 = corner(inds[3 * (size_t)n], X, &fx);
  const int y0 = corner(inds[3 * (size_t)n + 1], Y, &fy);
  const int z0 = corner(inds[3 * (size_t)n + 2], Z, &fz);
  const T* g = grid + (size_t)ch * X * Y * Z;
  T c[2][2][2];
  for (int dx = 0; dx < 2; ++dx)
    for (int dy = 0; dy < 2; ++dy)
      for (int dz = 0; dz < 2; ++dz) c[dx][dy][dz] = g[((size_t)(x0 + dx) * Y + (y0 + dy)) * Z + (z0 + dz)];
  out[idx] = trilinear(c, fx, fy, fz);
}

// ---------------------------------------------------------------- the query

template <typename T>
struct QueryOut {
  T* sdf;       // (N,) metric value (normalized-frame value without a scale)
  T* grad;      // (N, 3) twice normalized, overlap-masked gradient (with a scale), or null
  T* grad_in;   // (N, 3) once normalized, in-bounds-masked gradient of the normalized point, or null
  T* grad_raw;  // (N, 3) the interpolated central differences before normalize and masks, or null
};

// one point per thread. SCALED: pts are metric (query_sdfs with scale =
// *scale_p); else they are already in the grid's normalized frame (grid_sdf /
// grid_sdf_grad). GRADS: any gradient output is asked for.
template <typename T, bool SCALED, bool GRADS>
__global__ void grid_query_kernel(int X, int Y, int Z, int N, const T* __restrict__ grid,
                                  const T* __restrict__ pts, const T* __restrict__ scale_p, QueryOut<T> o) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int dims[3] = {X, Y, Z};
  T p[3] = {pts[3 * (size_t)n], pts[3 * (size_t)n + 1], pts[3 * (size_t)n + 2]};
  bool overlap = true;
  T scale = 1;
  if (SCALED) {
    scale = *scale_p;
    overlap = fabs(p[0]) <= scale && fabs(p[1]) <= scale && fabs(p[2]) <= scale;
    for (int c = 0; c < 3; ++c) p[c] = quo(p[c], scale);
  }
  // voxel index ((p + 1) * 0.5) * (dim - 1), in bounds on every axis, else 0
  bool valid = true;
  T ind[3];
  for (int c = 0; c < 3; ++c) {
    const T top = (T)(dims[c] - 1);
    ind[c] = mul(mul(add(p[c], (T)1), (T)0.5), top);
    valid = valid && ind[c] <= top && ind[c] >= (T)0;
  }
  T f[3];
  int i0[3];
  for (int c = 0; c < 3; ++c) i0[c] = corner(valid ? ind[c] : (T)0, dims[c], &f[c]);
  auto at = [&](int x, int y, int z) { return grid[((size_t)x * Y + y) * Z + z]; };

  T c[2][2][2];
  for (int dx = 0; dx < 2; ++dx)
    for (int dy = 0; dy < 2; ++dy)
      for (int dz = 0; dz < 2; ++dz) c[dx][dy][dz] = at(i0[0] + dx, i0[1] + dy, i0[2] + dz);
  T v = trilinear(c, f[0], f[1], f[2]);
  v = valid && overlap ? v : (T)1;
  o.sdf[n] = SCALED ? mul(v, scale) : v;
  if (!GRADS) return;

  // the central difference along `axis` at corner (dx, dy, dz): one-sided on
  // the boundary slabs, (g[i + 1] - g[i - 1]) / 2 inside (grid_grad_volume)
  auto diff = [&](int axis, int dx, int dy, int dz) {
    int q[3] = {i0[0] + dx, i0[1] + dy, i0[2] + dz};
    const int i = q[axis], top = dims[axis] - 1;
    int lo[3] = {q[0], q[1], q[2]}, hi[3] = {q[0], q[1], q[2]};
    lo[axis] = i == 0 ? 0 : (i == top ? top - 1 : i - 1);
    hi[axis] = i == 0 ? 1 : (i == top ? top : i + 1);
    const T d = sub(at(hi[0], hi[1], hi[2]), at(lo[0], lo[1], lo[2]));
    return i == 0 || i == top ? d : mul(d, (T)0.5);
  };
  T g[3];
  for (int axis = 0; axis < 3; ++axis) {
    for (int dx = 0; dx < 2; ++dx)
      for (int dy = 0; dy < 2; ++dy)
        for (int dz = 0; dz < 2; ++dz) c[dx][dy][dz] = diff(axis, dx, dy, dz);
    g[axis] = trilinear(c, f[0], f[1], f[2]);
  }
  if (o.grad_raw)
    for (int k = 0; k < 3; ++k) o.grad_raw[3 * (size_t)n + k] = g[k];
  normalize3(g);
  for (int k = 0; k < 3; ++k) g[k] = valid ? g[k] : (T)0;
  if (o.grad_in)
    for (int k = 0; k < 3; ++k) o.grad_in[3 * (size_t)n + k] = g[k];
  if (SCALED && o.grad) {
    normalize3(g);
    for (int k = 0; k < 3; ++k) o.grad[3 * (size_t)n + k] = overlap ? g[k] : (T)0;
  }
}

constexpr int THREADS = 128;

template <typename T>
int launch_interp(int C, int X, int Y, int Z, int N, const void* grid, const void* inds, void* out,
                  void* stream) {
  const long long total = (long long)C * N;
  const long long blocks = (total + THREADS - 1) / THREADS;
  grid_interp_kernel<T><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      C, X, Y, Z, N, (const T*)grid, (const T*)inds, (T*)out);
  return (int)cudaGetLastError();
}

template <typename T, bool SCALED, bool GRADS>
int launch_query(int X, int Y, int Z, int N, const void* grid, const void* pts, const void* scale,
                 const QueryOut<T>& o, void* stream) {
  const unsigned blocks = (unsigned)((N + THREADS - 1) / THREADS);
  grid_query_kernel<T, SCALED, GRADS><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      X, Y, Z, N, (const T*)grid, (const T*)pts, (const T*)scale, o);
  return (int)cudaGetLastError();
}

template <typename T>
int query(int X, int Y, int Z, int N, const void* grid, const void* pts, const void* scale, void* sdf, void* grad,
          void* grad_in, void* grad_raw, void* stream) {
  const QueryOut<T> o{(T*)sdf, (T*)grad, (T*)grad_in, (T*)grad_raw};
  const bool grads = grad || grad_in || grad_raw;
  if (scale)
    return grads ? launch_query<T, true, true>(X, Y, Z, N, grid, pts, scale, o, stream)
                 : launch_query<T, true, false>(X, Y, Z, N, grid, pts, scale, o, stream);
  return grads ? launch_query<T, false, true>(X, Y, Z, N, grid, pts, scale, o, stream)
               : launch_query<T, false, false>(X, Y, Z, N, grid, pts, scale, o, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64. Returns cudaGetLastError() of the launch,
// or -1 on a grid with an axis shorter than 2.
int grid_interp(int dtype, int C, int X, int Y, int Z, int N, const void* grid, const void* inds,
                void* out, void* stream) {
  if (X < 2 || Y < 2 || Z < 2 || C < 1) return -1;
  if (N <= 0) return 0;
  if (dtype == 1) return launch_interp<double>(C, X, Y, Z, N, grid, inds, out, stream);
  return launch_interp<float>(C, X, Y, Z, N, grid, inds, out, stream);
}

// One grid-SDF query of N points pts (N, 3) on grid (X, Y, Z), all
// contiguous, in one launch. scale: a device scalar (query_sdfs: metric
// points, overlap mask, metric value), or null (points in the normalized
// frame: grid_sdf's value, grad_in is grid_sdf_grad). sdf (N,) is always
// written; grad, grad_in and grad_raw (N, 3) where not null (grad needs a
// scale); with none of them only the value is computed. Returns the launch's
// CUDA error, or -1 on a grid with an axis shorter than 2 or a grad without
// a scale.
int grid_query(int dtype, int X, int Y, int Z, int N, const void* grid, const void* pts, const void* scale,
               void* sdf, void* grad, void* grad_in, void* grad_raw, void* stream) {
  if (X < 2 || Y < 2 || Z < 2 || (grad && !scale)) return -1;
  if (N <= 0) return 0;
  if (dtype == 1) return query<double>(X, Y, Z, N, grid, pts, scale, sdf, grad, grad_in, grad_raw, stream);
  return query<float>(X, Y, Z, N, grid, pts, scale, sdf, grad, grad_in, grad_raw, stream);
}

}  // extern "C"
