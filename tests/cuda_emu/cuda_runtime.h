// A CPU stand-in for the parts of the CUDA runtime the K1/K2 sources use,
// so they compile with g++ (C++20) and run one block at a time with one OS
// thread per CUDA thread: __syncthreads is a std::barrier over the block,
// warp shuffles exchange through a per-warp buffer between two warp-wide
// barriers, shared memory is one buffer filled with NaN before each block
// (a read of an unwritten entry shows up as NaN). A barrier or shuffle that
// some thread of a block or warp does not reach deadlocks, as it would hang
// on the card. Timing and occupancy are not emulated.
//
// Used by tests/cuda_emu/emu_check.py; see there for how to run it.

#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

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

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
struct cudaFuncAttributes {
  int numRegs;
  size_t localSizeBytes;
};

namespace emu {
struct Idx {
  unsigned x, y, z;
};
inline thread_local Idx thread_idx, block_idx;
constexpr size_t SMEM_BYTES = 232448;
inline std::barrier<>* block_barrier = nullptr;
inline std::vector<std::unique_ptr<std::barrier<>>> warp_barriers;
inline double warp_buf[64][32];
inline std::atomic<int> or_flag{0};
inline size_t max_smem = 0;
}  // namespace emu

#define threadIdx emu::thread_idx
#define blockIdx emu::block_idx

namespace {
__attribute__((aligned(16))) unsigned char smem_raw[emu::SMEM_BYTES];
}

inline void __syncthreads() { emu::block_barrier->arrive_and_wait(); }

inline int __syncthreads_or(int p) {
  if (p) emu::or_flag.store(1);
  __syncthreads();
  const int r = emu::or_flag.load();
  __syncthreads();
  if (threadIdx.x == 0) emu::or_flag.store(0);
  __syncthreads();
  return r;
}

template <typename T>
T __shfl_xor_sync(unsigned, T v, int o) {
  const unsigned lane = threadIdx.x & 31u, w = threadIdx.x >> 5;
  emu::warp_buf[w][lane] = (double)v;
  emu::warp_barriers[w]->arrive_and_wait();
  const T r = (T)emu::warp_buf[w][lane ^ (unsigned)o];
  emu::warp_barriers[w]->arrive_and_wait();
  return r;
}

inline double __drcp_rn(double x) { return 1.0 / x; }
inline float __frcp_rn(float x) { return 1.0f / x; }

template <typename T>
T __ldg(const T* p) {
  return *p;
}

template <class F>
int cudaFuncSetAttribute(F, cudaFuncAttribute, int bytes) {
  return (size_t)bytes <= emu::SMEM_BYTES ? cudaSuccess : cudaErrorInvalidValue;
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
inline int cudaGetLastError() { return cudaSuccess; }

namespace emu {
// kernel<<<grid, block, bytes>>>(args...), one block after another
template <class K, class... A>
void launch(int grid, int block, size_t bytes, K kernel, A... args) {
  max_smem = bytes > max_smem ? bytes : max_smem;
  for (int b = 0; b < grid; ++b) {
    memset(smem_raw, 0xff, SMEM_BYTES);
    std::barrier<> bar(block);
    block_barrier = &bar;
    warp_barriers.clear();
    for (int w = 0; w < (block + 31) / 32; ++w) warp_barriers.emplace_back(new std::barrier<>(32));
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([=] {
        thread_idx = {(unsigned)t, 0, 0};
        block_idx = {(unsigned)b, 0, 0};
        kernel(args...);
      });
    for (auto& th : threads) th.join();
  }
}
}  // namespace emu
