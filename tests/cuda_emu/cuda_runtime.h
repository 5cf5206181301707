// A CPU stand-in for the parts of the CUDA runtime the kernel sources use,
// so they compile with g++ (C++20) and run with one OS thread per CUDA
// thread, one thread-block cluster at a time (a plain launch is a cluster of
// one block):
//
// - __syncthreads is a std::barrier over the block, cluster.sync() one over
//   the cluster (cooperative_groups.h beside this file);
// - warp shuffles, votes and the DMMA tile product exchange values through a
//   per-warp buffer between two warp-wide barriers; the product follows the
//   PTX ISA's fragment layout of mma.m8n8k4 .f64;
// - every block has its own shared memory, filled with NaN bytes before the
//   cluster starts (a read of an unwritten entry shows up as NaN);
//   distributed shared memory maps a pointer into another block's buffer;
// - cp.async copies at once (commit and wait are no-ops).
//
// A barrier, shuffle or product that some thread of a block, warp or cluster
// does not reach deadlocks, as it would hang on the card. Timing, occupancy
// and asynchrony are not emulated. The sources read CUDA_EMU to pick these
// stand-ins for their inline PTX.
//
// Used by tests/cuda_emu/emu_check.py; see there for how to run it.

#pragma once

#define CUDA_EMU 1

#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <array>
#include <atomic>
#include <barrier>
#include <cmath>
#include <memory>
#include <thread>
#include <vector>

#define __host__
#define __device__
#define __global__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))

using std::isfinite;
using std::max;
using std::min;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize, cudaFuncAttributeNonPortableClusterSizeAllowed };
struct cudaFuncAttributes {
  int numRegs;
  size_t localSizeBytes;
};
struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  struct {
    struct {
      unsigned x, y, z;
    } clusterDim;
  } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};

namespace emu {
struct Idx {
  unsigned x, y, z;
};
constexpr size_t SMEM_BYTES = 232448;

struct Block {
  std::unique_ptr<unsigned char[]> smem;
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
  std::vector<std::array<double, 32>> warp_a, warp_b;
  std::atomic<int> or_flag{0};
};
struct Cluster {
  std::vector<std::unique_ptr<Block>> blocks;
  std::unique_ptr<std::barrier<>> bar;
};

inline thread_local Idx thread_idx, block_idx;
inline thread_local Block* blk = nullptr;
inline thread_local Cluster* clu = nullptr;
inline thread_local unsigned rank = 0;
inline size_t max_smem = 0;

inline unsigned char* smem() { return blk->smem.get(); }
inline unsigned warp() { return thread_idx.x >> 5; }
inline unsigned lane() { return thread_idx.x & 31u; }
inline void warp_sync() { blk->warp_bars[warp()]->arrive_and_wait(); }
}  // namespace emu

#define threadIdx emu::thread_idx
#define blockIdx emu::block_idx
// a variable, not a macro: cudaLaunchConfig_t has a member of that name
inline thread_local emu::Idx blockDim, gridDim;

inline void __syncthreads() { emu::blk->bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu::warp_sync(); }

inline int __syncthreads_or(int p) {
  if (p) emu::blk->or_flag.store(1);
  __syncthreads();
  const int r = emu::blk->or_flag.load();
  __syncthreads();
  if (threadIdx.x == 0) emu::blk->or_flag.store(0);
  __syncthreads();
  return r;
}

template <typename T>
T __shfl_xor_sync(unsigned, T v, int o) {
  auto& buf = emu::blk->warp_a[emu::warp()];
  buf[emu::lane()] = (double)v;
  emu::warp_sync();
  const T r = (T)buf[emu::lane() ^ (unsigned)o];
  emu::warp_sync();
  return r;
}

inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  auto& buf = emu::blk->warp_a[emu::warp()];
  buf[emu::lane()] = (double)v;
  emu::warp_sync();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= (unsigned)buf[i];
  emu::warp_sync();
  return r;
}

inline int atomicOr(int* p, int v) { return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST); }

inline double __drcp_rn(double x) { return 1.0 / x; }
inline float __frcp_rn(float x) { return 1.0f / x; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline double __dsqrt_rn(double a) { return std::sqrt(a); }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }

template <typename T>
T __ldg(const T* p) {
  return *p;
}

struct double2 {
  double x, y;
};
struct float2 {
  float x, y;
};
struct float4 {
  float x, y, z, w;
};

namespace emu {
// D = A B + D on an 8x8x4 float64 tile, the fragments of PTX's
// mma.m8n8k4.row.col.f64: lane l holds a = A[l/4][l%4], b = B[l%4][l/4],
// d[i] = D[l/4][2 (l%4) + i]
inline void mma_m8n8k4_f64(double (&d)[2], double a, double b) {
  auto& fa = blk->warp_a[warp()];
  auto& fb = blk->warp_b[warp()];
  const unsigned l = lane();
  fa[l] = a;
  fb[l] = b;
  warp_sync();
  const unsigned row = l >> 2;
  for (int i = 0; i < 2; ++i) {
    const unsigned col = 2 * (l & 3) + i;
    double s = d[i];
    for (int k = 0; k < 4; ++k) s = std::fma(fa[row * 4 + k], fb[col * 4 + k], s);
    d[i] = s;
  }
  warp_sync();
}

inline void cp_async16(void* dst, const void* src) { memcpy(dst, src, 16); }
}  // namespace emu

template <class F>
int cudaFuncSetAttribute(F, cudaFuncAttribute attr, int value) {
  if (attr == cudaFuncAttributeNonPortableClusterSizeAllowed) return cudaSuccess;
  return (size_t)value <= emu::SMEM_BYTES ? cudaSuccess : cudaErrorInvalidValue;
}
template <class F>
int cudaFuncGetAttributes(cudaFuncAttributes* a, F) {
  a->numRegs = 0;
  a->localSizeBytes = 0;
  return cudaSuccess;
}
template <class F>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 0;
  return cudaSuccess;
}
template <class F>
int cudaOccupancyMaxActiveClusters(int* n, F, const cudaLaunchConfig_t*) {
  *n = 64;
  return cudaSuccess;
}
inline int cudaGetLastError() { return cudaSuccess; }

namespace emu {
// grid blocks of `block` threads in clusters of `cs`, one cluster after another
template <class K, class... A>
void launch_clusters(int grid, int block, size_t bytes, int cs, K kernel, A... args) {
  max_smem = bytes > max_smem ? bytes : max_smem;
  const int nw = (block + 31) / 32;
  for (int c0 = 0; c0 < grid; c0 += cs) {
    Cluster cl;
    cl.bar.reset(new std::barrier<>(cs * block));
    for (int r = 0; r < cs; ++r) {
      auto b = std::make_unique<Block>();
      b->smem.reset(new unsigned char[SMEM_BYTES]);
      memset(b->smem.get(), 0xff, SMEM_BYTES);
      b->bar.reset(new std::barrier<>(block));
      for (int w = 0; w < nw; ++w) b->warp_bars.emplace_back(new std::barrier<>(32));
      b->warp_a.resize(nw);
      b->warp_b.resize(nw);
      cl.blocks.push_back(std::move(b));
    }
    std::vector<std::thread> threads;
    for (int r = 0; r < cs; ++r)
      for (int t = 0; t < block; ++t)
        threads.emplace_back([=, &cl] {
          thread_idx = {(unsigned)t, 0, 0};
          block_idx = {(unsigned)(c0 + r), 0, 0};
          ::blockDim = {(unsigned)block, 1, 1};
          ::gridDim = {(unsigned)grid, 1, 1};
          blk = cl.blocks[r].get();
          clu = &cl;
          rank = (unsigned)r;
          kernel(args...);
        });
    for (auto& th : threads) th.join();
  }
}

// kernel<<<grid, block, bytes>>>(args...)
template <class K, class... A>
void launch(int grid, int block, size_t bytes, K kernel, A... args) {
  launch_clusters(grid, block, bytes, 1, kernel, args...);
}
}  // namespace emu

template <class... P, class... A>
int cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(P...), A&&... args) {
  int cs = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) cs = (int)cfg->attrs[i].val.clusterDim.x;
  if (cs < 1 || cfg->gridDim.x % (unsigned)cs != 0) return cudaErrorInvalidValue;
  emu::launch_clusters((int)cfg->gridDim.x, (int)cfg->blockDim.x, cfg->dynamicSmemBytes, cs, kernel, (P)args...);
  return cudaSuccess;
}
