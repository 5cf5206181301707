// The thread-block-cluster part of cooperative_groups for the CPU stand-in
// (cuda_runtime.h beside this file): block rank, cluster size, the cluster
// barrier and distributed shared memory (a pointer into this block's shared
// memory mapped to the same offset in another block's).

#pragma once

#include "cuda_runtime.h"

namespace cooperative_groups {

struct cluster_group {
  unsigned block_rank() const { return emu::rank; }
  unsigned num_blocks() const { return (unsigned)emu::clu->blocks.size(); }
  void sync() const { emu::clu->bar->arrive_and_wait(); }
  template <class T>
  T* map_shared_rank(T* p, unsigned r) const {
    const ptrdiff_t off = reinterpret_cast<unsigned char*>(p) - emu::blk->smem.get();
    return reinterpret_cast<T*>(emu::clu->blocks[r]->smem.get() + off);
  }
};

inline cluster_group this_cluster() { return {}; }

}  // namespace cooperative_groups
