// K4: the fused IGR shape-space decoder, x (N, d_in) -> (N,).
//
// Replaces the Pallas TPU kernel diffsdfsim_tpu/ops/pallas_kernels.py
// `igr_mlp_pallas`. It computes what models/igr.implicit_net_apply computes:
// a stack of linear layers with Softplus(beta) between them (linear where
// beta*a > 20, torch's threshold), and at every skip layer the network input
// re-concatenated to the activation and the result divided by sqrt(2). The
// shape-space bodies (LatentShape) query it for every SDF value: template
// projection (~10^2 points), the Frank-Wolfe contact search and its polish
// (10^3-10^4 points per call).
//
// Design (simple and exact first): one block of 128 threads per tile of
// TILE = 32 points. The tile's input and its activations stay in shared
// memory (two ping-pong buffers of TILE x max_width); the weights are
// streamed layer by layer from global memory, where the L2 holds the whole
// net (~0.93 MB in float64 at width 128 x 8), stored transposed (in, out) so
// that the threads of a block, one output neuron each, read consecutive
// addresses. A thread keeps TILE accumulators in registers and does TILE
// FMAs per weight it loads; the activation it multiplies is a shared-memory
// broadcast. Narrow layers (the last, one output) give each thread one
// (output, point) pair instead. Accumulation is in the input's dtype, in
// input order: float64 inputs accumulate in float64.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAXL = 32;
constexpr int TILE = 32;
constexpr int THREADS = 128;

struct Net {
  int n_layers, d_in, max_w;
  int in[MAXL], out[MAXL], skip[MAXL];
  long long w_off[MAXL], b_off[MAXL];  // offsets of W' (in, out) and b (out) in the packed buffer
  double beta;
};

__device__ __forceinline__ double softplus(double v, double beta) {
  const double bx = beta * v;
  return bx > 20.0 ? v : log1p(exp(bx)) / beta;
}
__device__ __forceinline__ float softplus(float v, double beta) {
  const float b = (float)beta;
  const float bx = b * v;
  return bx > 20.0f ? v : log1pf(expf(bx)) / b;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) igr_mlp_kernel(Net net, int N, const T* __restrict__ x,
                                                          const T* __restrict__ prm,
                                                          T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d_in = net.d_in, mw = net.max_w;
  T* inp = reinterpret_cast<T*>(smem_raw);  // TILE x d_in
  T* a = inp + TILE * d_in;                  // TILE x mw, the current layer's input
  T* b = a + TILE * mw;                      // TILE x mw, its output
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * TILE;
  const int np = min(TILE, N - p0);

  for (int e = tid; e < TILE * d_in; e += THREADS) {
    const int t = e / d_in, j = e % d_in;
    const T v = t < np ? x[(size_t)(p0 + t) * d_in + j] : (T)0;
    inp[e] = v;
    a[t * mw + j] = v;
  }
  __syncthreads();

  const T sqrt2 = (T)1.4142135623730951;
  int width = d_in;
  for (int L = 0; L < net.n_layers; ++L) {
    if (net.skip[L]) {
      // a <- [a, inp] / sqrt(2)
      const int w2 = width + d_in;
      for (int e = tid; e < TILE * w2; e += THREADS) {
        const int t = e / w2, j = e % w2;
        b[t * mw + j] = (j < width ? a[t * mw + j] : inp[t * d_in + j - width]) / sqrt2;
      }
      __syncthreads();
      T* s = a; a = b; b = s;
      width = w2;
    }
    const int nin = net.in[L], nout = net.out[L];
    const bool last = L == net.n_layers - 1;
    const T* W = prm + net.w_off[L];
    const T* bias = prm + net.b_off[L];
    if (nout * TILE <= THREADS) {
      // narrow layer: one (output, point) pair per thread
      const int o = tid % nout, t = tid / nout;
      if (t < TILE) {
        T acc = 0;
        for (int i = 0; i < nin; ++i) acc = fma(a[t * mw + i], W[(size_t)i * nout + o], acc);
        T v = acc + bias[o];
        if (last) {
          if (t < np) out[(size_t)(p0 + t) * nout + o] = v;
        } else {
          b[t * mw + o] = softplus(v, net.beta);
        }
      }
    } else {
      for (int o = tid; o < nout; o += THREADS) {
        T acc[TILE];
#pragma unroll
        for (int t = 0; t < TILE; ++t) acc[t] = 0;
        for (int i = 0; i < nin; ++i) {
          const T w = W[(size_t)i * nout + o];
#pragma unroll
          for (int t = 0; t < TILE; ++t) acc[t] = fma(a[t * mw + i], w, acc[t]);
        }
        const T bo = bias[o];
#pragma unroll
        for (int t = 0; t < TILE; ++t) {
          const T v = acc[t] + bo;
          if (last) {
            if (t < np) out[(size_t)(p0 + t) * nout + o] = v;
          } else {
            b[t * mw + o] = softplus(v, net.beta);
          }
        }
      }
    }
    __syncthreads();
    T* s = a; a = b; b = s;
    width = nout;
  }
}

template <typename T>
int launch(const Net& net, int N, const void* x, const void* prm, void* out, void* stream) {
  const size_t bytes = (size_t)TILE * (net.d_in + 2 * net.max_w) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(igr_mlp_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + TILE - 1) / TILE;
  igr_mlp_kernel<T><<<blocks, THREADS, bytes, (cudaStream_t)stream>>>(
      net, N, (const T*)x, (const T*)prm, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64. dims: per layer (in, out, skip) triples;
// offs: per layer (w_off, b_off) into prm. Returns cudaGetLastError() of the
// launch, or -1 on dimensions the kernel does not take.
int igr_mlp(int dtype, int N, int n_layers, int d_in, int max_w, double beta, const int* dims,
            const long long* offs, const void* x, const void* prm, void* out, void* stream) {
  if (n_layers < 1 || n_layers > MAXL) return -1;
  Net net;
  net.n_layers = n_layers;
  net.d_in = d_in;
  net.max_w = max_w;
  net.beta = beta;
  for (int L = 0; L < n_layers; ++L) {
    net.in[L] = dims[3 * L];
    net.out[L] = dims[3 * L + 1];
    net.skip[L] = dims[3 * L + 2];
    net.w_off[L] = offs[2 * L];
    net.b_off[L] = offs[2 * L + 1];
  }
  if (N <= 0) return 0;
  if (dtype == 1) return launch<double>(net, N, x, prm, out, stream);
  return launch<float>(net, N, x, prm, out, stream);
}

}  // extern "C"
