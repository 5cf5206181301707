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
// What bounds it on an H100: at the sizes that run (10^2-10^4 points) not
// FLOPs (0.23 MFLOP per point, 8 us at N = 2304 on the FP64 tensor cores) but
// latency: nine dependent layers, each a chain of dependent products and a
// float64 softplus (exp, log1p) per output. The design keeps every product
// on a tensor core or an FMA pipe with the weights already in shared memory,
// spreads a point tile over a cluster, and gives each SM sub-partition
// several independent chains:
//
// - A tile of TILE = 8 MT points (MT = 4 or 5 m-tiles of 8 rows: 32 or 40
//   points, whichever takes fewer waves of clusters at this N; 40 puts
//   N = 2304 in one wave of 58 clusters) is handled by a thread-block
//   cluster of CS CTAs of 8 warps. CTA `rank` computes output columns
//   [32 rank, 32 rank + 32) of every layer; CS = ceil(widest padded layer /
//   32), 4 at the reference's width 128, so a tile runs on 4 SMs and each
//   CTA streams a quarter of every layer's weights. Warps w and w + 4 share
//   the 8-column output tile w % 4: each sums over alternate input chunks.
// - Layers wider than 8 x 32 = 256 (IGR's shape-space decoders are 512
//   wide): the cluster stays at 8 CTAs (a portable size) and CTA `rank`
//   computes the 32-column slices rank, rank + 8, ... of each layer, one
//   after the other, with an exchange buffer of its own for the epilogue
//   (the layer's input is still needed by the next slice). Two TILE-row
//   activation buffers of a 512-wide layer fill a block's shared memory at
//   32 points, so the tile shrinks to 16 (or 8) points. Each tile then
//   streams all the net's weights from L2 for fewer points (14.7 MB per 16
//   points at 512 wide, float64), which bounds this path. A net whose
//   8-point tile does not fit (float64: ~1,500 wide) is refused.
// - Products: float64 on the FP64 tensor cores through
//   mma.sync.aligned.m8n8k4.row.col.f64 (DMMA), two accumulator chains per
//   m-tile (even and odd steps of k); float32 on FFMA (no TF32, as the
//   Pallas kernel's float32 products), each thread the same two columns of
//   each m-tile a DMMA fragment would give it, operands as 16-byte vectors.
// - Weights: `_pack` (ops/igr_cuda.py) tiles each layer once per net into
//   chunks of 32 output rows x KC = 16 inputs, zero-padded (the first
//   layer's 5 inputs to 16, an output count like layer 3's 123 to a multiple
//   of 32), chunk after chunk in the order a rank reads them. Each warp
//   copies its own 8 rows of its own chunks with cp.async (16 bytes a lane
//   per copy) into a private 2-stage ring that runs across layer
//   boundaries, so the next chunk, and the next layer's first one during
//   this layer's epilogue, is in flight while the tensor cores work. A warp
//   reads only its own copies: a chunk costs a __syncwarp, not a barrier.
// - Activations stay in shared memory for the whole depth, in two buffers
//   (this layer's input, its output) of TILE rows. Epilogue: the two warps
//   of an output tile swap the partial sums of half their m-tiles through
//   the input buffer (read by then) at two barriers, each finishes its half
//   (bias; softplus over its values at once, so their float64 exp and log1p
//   chains overlap; zero for padded columns) and writes it into the output
//   buffer of every CTA of the cluster through distributed shared memory;
//   one cluster barrier per layer then makes the activation whole in all
//   (one more at the start: no CTA writes into another before all have
//   started). At a skip layer each CTA rewrites its own input buffer in the
//   plain version's order: [a, x] / sqrt(2), as x * (1 / sqrt(2)) like the
//   card's division by a scalar.
// - The last layer (one output) is a warp-level dot product: each warp of
//   the cluster takes whole rows, its lanes strided over the inputs and a
//   shuffle reduction.
//
// Sums are in the input's dtype; their order differs from cuBLAS's, within
// 1e-12 (float64) and 1e-5 (float32) relative of the plain version.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAXL = 32;
constexpr int NTILES = 4;             // 8-column output tiles per CTA
constexpr int NS = 8 * NTILES;        // output columns per CTA and layer
constexpr int KH = 2;                 // warps per output tile, each every KH-th chunk of the inputs
constexpr int WARPS = NTILES * KH;
constexpr int THREADS = 32 * WARPS;
constexpr int KC = 16;                // inputs per weight chunk
constexpr int WS = KC + 4;            // a chunk row in shared memory (padded against bank conflicts)
constexpr int STAGES = 2;             // chunks in each warp's ring
constexpr int SS = WARPS * 8 * WS;    // elements of one ring stage
constexpr int MAX_CS = 8;      // portable cluster size; a wider layer gives each CTA several NS-column slices
constexpr size_t MAX_SMEM = 232448;  // shared bytes a block can use

struct Net {
  int n_layers, d_in, cs, aw;  // aw: activation row stride (widest padded input + 4)
  int ns;                      // NS-column slices per CTA of the widest layer: rank, rank + cs, ...
  int in[MAXL], out[MAXL], kp[MAXL], np[MAXL], skip[MAXL];  // kp, np: padded inputs, outputs
  long long w_off[MAXL], b_off[MAXL];
  double beta;
};

// ---------------------------------------------------------------- device primitives

// D = A B + D on an 8x8x4 float64 tile (PTX ISA, mma.m8n8k4 .f64): lane l
// holds a = A[l / 4][l % 4], b = B[l % 4][l / 4] and d[i] = D[l / 4][2 (l % 4) + i].
__device__ __forceinline__ void dmma_8x8x4(double (&d)[2], double a, double b) {
#ifdef CUDA_EMU
  emu::mma_m8n8k4_f64(d, a, b);
#else
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(d[0]), "+d"(d[1])
               : "d"(a), "d"(b));
#endif
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
#ifdef CUDA_EMU
  emu::cp_async16(smem, gmem);
#else
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifndef CUDA_EMU
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// wait until at most STAGES - 2 committed groups are still in flight
__device__ __forceinline__ void cp_async_wait_ring() {
#ifndef CUDA_EMU
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
#endif
}

// softplus_beta of n independent values in place, as the plain version on
// the card computes it: log1p(exp(min(beta v, 20))) * (1 / beta), v where
// beta v > 20. Each step runs over all n values before the next, so the
// long float64 exp and log1p chains of different values overlap.
template <int n>
__device__ __forceinline__ void softplus(double (&v)[n], double beta) {
  const double inv_beta = 1.0 / beta;
  double e[n];
#pragma unroll
  for (int i = 0; i < n; ++i) e[i] = exp(fmin(beta * v[i], 20.0));
#pragma unroll
  for (int i = 0; i < n; ++i) e[i] = log1p(e[i]) * inv_beta;
#pragma unroll
  for (int i = 0; i < n; ++i) v[i] = beta * v[i] > 20.0 ? v[i] : e[i];
}
template <int n>
__device__ __forceinline__ void softplus(float (&v)[n], double beta) {
  const float b = (float)beta, inv_b = 1.0f / b;
  float e[n];
#pragma unroll
  for (int i = 0; i < n; ++i) e[i] = expf(fminf(b * v[i], 20.0f));
#pragma unroll
  for (int i = 0; i < n; ++i) e[i] = log1pf(e[i]) * inv_b;
#pragma unroll
  for (int i = 0; i < n; ++i) v[i] = b * v[i] > 20.0f ? v[i] : e[i];
}

// ---------------------------------------------------------------- weight stream

// The chunks a warp reads, in order: layer by layer (the last layer, a dot
// product, reads its weights from global memory), slice by slice of the
// rank's output columns (rank, rank + cs, ...), chunks kh, kh + KH, ... of
// KC inputs each, skipping layers where the rank has no output columns or
// the warp no chunk.
struct Cursor {
  int L, sl, j;
};

__device__ __forceinline__ bool has_cols(const Net& net, int sl, int L) { return sl * NS < net.np[L]; }

__device__ __forceinline__ void next_layer(const Net& net, int rank, int kh, Cursor& c) {
  do {
    ++c.L;
  } while (c.L < net.n_layers - 1 && (!has_cols(net, rank, c.L) || kh >= net.kp[c.L] / KC));
  c.sl = rank;
  c.j = kh;
}

// start copying this warp's 8 rows (output tile nt) of the cursor's chunk
// into its ring buffer `buf` (8 x WS) and advance; one commit group per
// call, empty once the stream is exhausted. A warp reads only its own
// copies, so they need no block barrier.
template <typename T>
__device__ void issue_chunk(const Net& net, int rank, int nt, int kh, Cursor& c, const T* __restrict__ prm,
                            T* buf) {
  if (c.L < net.n_layers - 1) {
    const int nchunk = net.kp[c.L] / KC;
    const T* src = prm + net.w_off[c.L] + (((size_t)c.sl * nchunk + c.j) * NS + 8 * nt) * KC;
    constexpr int SEG = 16 / sizeof(T);  // elements per 16-byte copy
    for (int s = threadIdx.x & 31; s < 8 * KC / SEG; s += 32) {
      const int n = s / (KC / SEG), k = (s % (KC / SEG)) * SEG;
      cp_async16(buf + n * WS + k, src + n * KC + k);
    }
    if ((c.j += KH) >= nchunk) {
      c.j = kh;
      if (!has_cols(net, c.sl += net.cs, c.L)) next_layer(net, rank, kh, c);
    }
  }
  cp_async_commit();
}

// ---------------------------------------------------------------- products on one chunk

// acc[h][m][i] += sum over the chunk's k of A[8 m + lane / 4][k0 + k]
// W[2 (lane % 4) + i][k], W the warp's 8 rows; even 4-steps of k into h = 0,
// odd into h = 1 (two independent accumulator chains per m-tile)
template <int MT>
__device__ __forceinline__ void chunk_product(double (&acc)[2][MT][2], const double* A, int aw, int k0,
                                              const double* W) {
  const int lane = threadIdx.x & 31;
  const double* a_row = A + (lane >> 2) * aw + k0 + (lane & 3);
  const double* w_row = W + (lane >> 2) * WS + (lane & 3);
#pragma unroll
  for (int k = 0; k < KC; k += 4) {
    const double b = w_row[k];
#pragma unroll
    for (int m = 0; m < MT; ++m) dmma_8x8x4(acc[(k >> 2) & 1][m], a_row[8 * m * aw + k], b);
  }
}

template <int MT>
__device__ __forceinline__ void chunk_product(float (&acc)[2][MT][2], const float* A, int aw, int k0,
                                              const float* W) {
  const int lane = threadIdx.x & 31;
  const float* a_row = A + (lane >> 2) * aw + k0;
  const float* w0 = W + 2 * (lane & 3) * WS;
#pragma unroll
  for (int k = 0; k < KC; k += 4) {
    const float4 b0 = *reinterpret_cast<const float4*>(w0 + k);
    const float4 b1 = *reinterpret_cast<const float4*>(w0 + WS + k);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float4 a = *reinterpret_cast<const float4*>(a_row + 8 * m * aw + k);
      float(&c)[2] = acc[(k >> 2) & 1][m];
      c[0] = fmaf(a.x, b0.x, c[0]);
      c[0] = fmaf(a.y, b0.y, c[0]);
      c[0] = fmaf(a.z, b0.z, c[0]);
      c[0] = fmaf(a.w, b0.w, c[0]);
      c[1] = fmaf(a.x, b1.x, c[1]);
      c[1] = fmaf(a.y, b1.y, c[1]);
      c[1] = fmaf(a.z, b1.z, c[1]);
      c[1] = fmaf(a.w, b1.w, c[1]);
    }
  }
}

template <typename T>
struct Vec2;
template <>
struct Vec2<double> {
  using type = double2;
};
template <>
struct Vec2<float> {
  using type = float2;
};

// ---------------------------------------------------------------- the kernel

// the epilogue's exchange of partial sums, [warp][m][lane][2]: in the
// layer's input buffer, which every warp has read by then, unless the CTA
// has another slice of the layer still to compute from it
size_t xch_elems(int mt, int ns) { return ns > 1 ? (size_t)WARPS * mt * 64 : 0; }

template <typename T>
size_t smem_elems(int mt, int aw, int d_in, int ns) {
  const int tile = 8 * mt;
  return (size_t)tile * (2 * aw + d_in) + (size_t)STAGES * SS + xch_elems(mt, ns);
}

template <typename T, int MT>
__global__ void __launch_bounds__(THREADS) igr_mlp_kernel(Net net, int N, const T* __restrict__ x,
                                                          const T* __restrict__ prm, T* __restrict__ out) {
  constexpr int TILE = 8 * MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = net.cs, aw = net.aw, d_in = net.d_in;
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = warp % NTILES, kh = warp / NTILES;  // output tile, input chunk phase
  T* a = reinterpret_cast<T*>(smem_raw);  // this layer's input, TILE x aw
  T* b = a + TILE * aw;                    // its output, TILE x aw
  T* inp = b + TILE * aw;                  // the network input, TILE x d_in
  T* ring = inp + TILE * d_in;  // 16-byte aligned: TILE is a multiple of 8
  T* xch_own = ring + STAGES * SS;  // the exchange buffer when ns > 1
  const int p0 = (blockIdx.x / cs) * TILE;
  const int np = min(TILE, N - p0);

  // start the weight stream, then load the tile (zero past N and d_in)
  Cursor cur{-1, rank, 0};
  next_layer(net, rank, kh, cur);
  T* wring = ring + warp * 8 * WS;  // this warp's part of each stage
  for (int s = 0; s < STAGES - 1; ++s) issue_chunk(net, rank, nt, kh, cur, prm, wring + s * SS);
  for (int e = tid; e < TILE * net.kp[0]; e += THREADS) {
    const int t = e / net.kp[0], j = e % net.kp[0];
    const T v = (t < np && j < d_in) ? x[(size_t)(p0 + t) * d_in + j] : (T)0;
    a[t * aw + j] = v;
    if (j < d_in) inp[t * d_in + j] = v;
  }
  // every CTA of the cluster has started before any writes into another's
  // shared memory (and this CTA's tile is loaded)
  cluster.sync();

  // x / sqrt(2) as the card's division by a scalar computes it: x * (1 / sqrt(2))
  const T inv_sqrt2 = (T)1 / (T)1.4142135623730951;
  int width = d_in;  // real columns of `a`
  int g = 0;         // chunks consumed
  for (int L = 0; L < net.n_layers; ++L) {
    if (net.skip[L]) {
      // a <- [a, inp] / sqrt(2), zero up to the padded width
      __syncthreads();
      const int w2 = width + d_in;
      for (int e = tid; e < TILE * net.kp[L]; e += THREADS) {
        const int t = e / net.kp[L], j = e % net.kp[L];
        a[t * aw + j] = j < width ? a[t * aw + j] * inv_sqrt2 : j < w2 ? inp[t * d_in + j - width] * inv_sqrt2 : (T)0;
      }
      width = w2;
      __syncthreads();
    }
    if (L == net.n_layers - 1) break;
    for (int sl = rank; has_cols(net, sl, L); sl += cs) {
      T acc[2][MT][2];
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[0][m][0] = acc[0][m][1] = acc[1][m][0] = acc[1][m][1] = (T)0;
      const int nchunk = net.kp[L] / KC;
      for (int j = kh; j < nchunk; j += KH, ++g) {
        cp_async_wait_ring();
        __syncwarp();  // chunk g is in for the warp; the warp is done with chunk g - 1
        issue_chunk(net, rank, nt, kh, cur, prm, wring + ((g + STAGES - 1) % STAGES) * SS);
        chunk_product<MT>(acc, a, aw, j * KC, wring + (g % STAGES) * SS);
      }
      // epilogue. The KH = 2 warps of an output tile hold partial sums over
      // alternate chunks; each finishes half of the m-tiles: it hands the
      // partials of the other half over through `a` (every warp is done
      // reading it; or the own exchange buffer, if a slice of this layer is
      // still to come), adds the partner's, then bias, softplus (zero in
      // padded columns) and the store to every CTA's b
      constexpr int MH = (MT + 1) / 2;
      T part[MT][2];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        for (int i = 0; i < 2; ++i) part[m][i] = acc[0][m][i] + acc[1][m][i];
      const int m0 = kh == 0 ? 0 : MH, m1 = kh == 0 ? MH : MT;
      __syncthreads();
      T* xch = net.ns > 1 ? xch_own : a;  // [warp][m][lane][2]
#pragma unroll
      for (int m = 0; m < MT; ++m)
        if (m < m0 || m >= m1)
          for (int i = 0; i < 2; ++i) xch[((warp * MT + m) * 32 + lane) * 2 + i] = part[m][i];
      __syncthreads();
      const int partner = warp ^ NTILES;
      const int col = sl * NS + 8 * nt + 2 * (lane & 3);
      const T* bias = prm + net.b_off[L];
      const T b0 = bias[col], b1 = bias[col + 1];
      T v[2 * MH];
#pragma unroll
      for (int h = 0; h < MH; ++h) {
        const int m = m0 + h < MT ? m0 + h : MT - 1;
        const T* o = xch + ((partner * MT + m) * 32 + lane) * 2;
        v[2 * h] = (part[m][0] + o[0]) + b0;
        v[2 * h + 1] = (part[m][1] + o[1]) + b1;
      }
      softplus(v, net.beta);
      using V2 = typename Vec2<T>::type;
      for (int h = 0; h < m1 - m0; ++h) {
        V2 o;
        o.x = col < net.out[L] ? v[2 * h] : (T)0;
        o.y = col + 1 < net.out[L] ? v[2 * h + 1] : (T)0;
        const int r = 8 * (m0 + h) + (lane >> 2);
        for (int q = 0; q < cs; ++q) *reinterpret_cast<V2*>(cluster.map_shared_rank(b, q) + r * aw + col) = o;
      }
    }
    cluster.sync();  // layer L's output complete in every CTA
    T* s = a;
    a = b;
    b = s;
    width = net.out[L];
  }
  __syncthreads();

  // the last layer, one output: a warp per row, lanes strided over the inputs
  const int L = net.n_layers - 1;
  const T* w = prm + net.w_off[L];
  const T bias = prm[net.b_off[L]];
  for (int r = rank * WARPS + warp; r < np; r += cs * WARPS) {
    T sum = 0;
    for (int k = lane; k < net.kp[L]; k += 32) sum = fma(a[r * aw + k], w[k], sum);
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) out[p0 + r] = sum + bias;
  }
}

// ---------------------------------------------------------------- launch

int round_up(int v, int m) { return (v + m - 1) / m * m; }

// fill the padded sizes, the cluster size and the slices per CTA from (in,
// out, skip, offsets); false on a net the kernel does not take
bool plan(Net& net) {
  int widest = 0, aw = 0;
  for (int L = 0; L < net.n_layers; ++L) {
    net.kp[L] = round_up(net.in[L], KC);
    net.np[L] = round_up(net.out[L], NS);
    aw = aw > net.kp[L] ? aw : net.kp[L];
    if (L < net.n_layers - 1) widest = widest > net.np[L] ? widest : net.np[L];
  }
  const int slices = widest / NS > 0 ? widest / NS : 1;
  net.cs = slices < MAX_CS ? slices : MAX_CS;
  net.ns = (slices + net.cs - 1) / net.cs;
  net.aw = (aw > 64 ? aw : 64) + 4;  // at least 64 wide: the epilogue's exchange may live in a tile of it
  return net.out[net.n_layers - 1] == 1;
}

template <typename T>
size_t smem_bytes(const Net& net, int mt) {
  return smem_elems<T>(mt, net.aw, net.d_in, net.ns) * sizeof(T);
}

// the launch configuration of a cluster per 8 MT points (attr: its cluster
// dimension); sets the kernel's shared-memory limit
template <typename T, int MT>
cudaError_t configure(const Net& net, int N, cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr) {
  const size_t bytes = smem_bytes<T>(net, MT);
  cudaError_t err = cudaFuncSetAttribute(igr_mlp_kernel<T, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  cfg = {};
  cfg.gridDim = dim3((unsigned)(((N + 8 * MT - 1) / (8 * MT)) * net.cs), 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)net.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return err;
}

// clusters of this net the card runs at once (0 on an error), asked once
// per shared-memory size and cluster size
template <typename T, int MT>
int max_clusters(const Net& net) {
  static size_t key_bytes = 0;
  static int key_cs = 0, value = 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  if (configure<T, MT>(net, 8 * MT, cfg, attr) != cudaSuccess) return 0;
  if (cfg.dynamicSmemBytes != key_bytes || net.cs != key_cs) {
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, igr_mlp_kernel<T, MT>, &cfg) != cudaSuccess) n = 0;
    key_bytes = cfg.dynamicSmemBytes;
    key_cs = net.cs;
    value = n;
  }
  return value;
}

template <typename T, int MT>
int launch(const Net& net, int N, const void* x, const void* prm, void* out, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t err = configure<T, MT>(net, N, cfg, attr);
  if (err != cudaSuccess) return (int)err;
  cfg.stream = (cudaStream_t)stream;
  err = cudaLaunchKernelEx(&cfg, igr_mlp_kernel<T, MT>, net, N, (const T*)x, (const T*)prm, (T*)out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// points per cluster: 32 or 40 where a tile of 32 fits a block's shared
// memory, 40 where that takes fewer waves of clusters than 32 (at N = 2304:
// 58 clusters, one wave, against 72); else 16, else 8 (wide layers: their
// activations fill a block's shared memory at fewer points); 0 where not
// even 8 fit
template <typename T>
int auto_tile(const Net& net, int N) {
  if (smem_bytes<T>(net, 4) > MAX_SMEM) return smem_bytes<T>(net, 2) <= MAX_SMEM ? 16 : smem_bytes<T>(net, 1) <= MAX_SMEM ? 8 : 0;
  if (smem_bytes<T>(net, 5) > MAX_SMEM) return 32;
  const int c32 = max_clusters<T, 4>(net), c40 = max_clusters<T, 5>(net);
  if (c32 <= 0 || c40 <= 0) return 32;
  const int w32 = ((N + 31) / 32 + c32 - 1) / c32, w40 = ((N + 39) / 40 + c40 - 1) / c40;
  return w40 < w32 ? 40 : 32;
}

// run op<T, MT>(x...) for a tile of 8, 16, 32 or 40 points
template <typename T, template <typename, int> class Op, class... X>
int by_tile(int tile, X... x) {
  switch (tile) {
    case 8:
      return Op<T, 1>::run(x...);
    case 16:
      return Op<T, 2>::run(x...);
    case 32:
      return Op<T, 4>::run(x...);
    case 40:
      return Op<T, 5>::run(x...);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, int MT>
int resources(const Net& net, long long* out) {
  const size_t bytes = smem_bytes<T>(net, MT);
  cudaError_t err = cudaFuncSetAttribute(igr_mlp_kernel<T, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, igr_mlp_kernel<T, MT>);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, igr_mlp_kernel<T, MT>, THREADS, bytes);
  if (err != cudaSuccess) return (int)err;
  out[0] = THREADS;
  out[1] = net.cs;
  out[2] = (long long)bytes;
  out[3] = attr.numRegs;
  out[4] = (long long)attr.localSizeBytes;
  out[5] = blocks;
  out[6] = 8 * MT;
  out[7] = max_clusters<T, MT>(net);
  out[8] = net.ns;
  return 0;
}

template <typename T, int MT>
struct Launch {
  static int run(const Net& net, int N, const void* x, const void* prm, void* out, void* stream) {
    return smem_bytes<T>(net, MT) > MAX_SMEM ? (int)cudaErrorInvalidValue : launch<T, MT>(net, N, x, prm, out, stream);
  }
};
template <typename T, int MT>
struct Resources {
  static int run(const Net& net, long long* out) { return resources<T, MT>(net, out); }
};

bool make_net(Net& net, int n_layers, int d_in, double beta, const int* dims, const long long* offs) {
  if (n_layers < 1 || n_layers > MAXL) return false;
  net.n_layers = n_layers;
  net.d_in = d_in;
  net.beta = beta;
  for (int L = 0; L < n_layers; ++L) {
    net.in[L] = dims[3 * L];
    net.out[L] = dims[3 * L + 1];
    net.skip[L] = dims[3 * L + 2];
    net.w_off[L] = offs[2 * L];
    net.b_off[L] = offs[2 * L + 1];
  }
  return plan(net);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64. tile: points per cluster, 8, 16, 32 or
// 40 (0: auto_tile's choice). dims: per layer (in, out, skip) triples; offs:
// per layer (w_off, b_off) into prm, laid out by ops/igr_cuda.pack_params.
// Returns the launch's CUDA error, or cudaErrorInvalidValue on a net the
// kernel does not take (a last layer with more than one output, more than
// MAXL layers) or a tile whose activations do not fit a block's shared
// memory (float64: hidden layers up to ~1,500 wide at 8 points).
int igr_mlp(int dtype, int tile, int N, int n_layers, int d_in, double beta, const int* dims,
            const long long* offs, const void* x, const void* prm, void* out, void* stream) {
  Net net;
  if (!make_net(net, n_layers, d_in, beta, dims, offs)) return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  if (dtype == 1) {
    if (tile == 0) tile = auto_tile<double>(net, N);
    return by_tile<double, Launch>(tile, net, N, x, prm, out, stream);
  }
  if (tile == 0) tile = auto_tile<float>(net, N);
  return by_tile<float, Launch>(tile, net, N, x, prm, out, stream);
}

// the launch's resources: threads per CTA, cluster size, shared bytes per
// CTA, registers and local (spill) bytes per thread, CTAs per SM, points per
// cluster, clusters the card runs at once, column slices per CTA. tile 0:
// auto_tile's choice at N.
int igr_mlp_info(int dtype, int tile, int N, int n_layers, int d_in, const int* dims, long long* out) {
  Net net;
  long long offs[2 * MAXL] = {0};
  if (!make_net(net, n_layers, d_in, 100.0, dims, offs)) return (int)cudaErrorInvalidValue;
  if (dtype == 1) return by_tile<double, Resources>(tile ? tile : auto_tile<double>(net, N), net, out);
  return by_tile<float, Resources>(tile ? tile : auto_tile<float>(net, N), net, out);
}

}  // extern "C"
