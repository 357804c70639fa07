// One-launch finish of the port's statistic kernels (stat_sums.cu,
// conv1x1_stats.cu): the last block to finish a column tile adds that
// tile's partial rows.
//
// Each block of the first pass leaves one row of per-column partial sums
// for the column tile it covered: `width` contiguous floats at
// partial + tile_base + row * row_stride. It then calls
// last_block_of_tile(): after a barrier, one thread draws a ticket from the
// tile's counter with an atomic increment that is a release (publishing the
// block's row, which the barrier ordered before it) and an acquire (seeing
// every row published before it), the pattern of CUTLASS's semaphores;
// cheaper than a __threadfence in every writer. inc with limit k - 1 wraps
// the counter back to 0 on the k-th ticket, so the counter is ready for the
// next call without a reset. The block that draws ticket k - 1 has seen
// every other block's row and adds the k rows with add_partial_rows():
//
//   out(v) = sum over g of ( sum over i = g, g+G, g+2G, ... < k of
//            partial[tile_base + (first + i) * row_stride + v] )
//
// G row groups are summed in registers in row order, then the G group sums
// in group order: a fixed order, so the same input gives bit-identical
// statistics on every call. Only integer atomics are used.
//
// The counters belong to one kernel and one device; calls that share them
// must not overlap, so they assume the calls run on one stream (the port
// runs on one stream).

#pragma once

#include <cuda_runtime.h>

// True in every thread of the `threads` (a multiple of 32, starting at
// thread 0) that take part, for the block that draws the last of `k`
// tickets of `counter`; all of them must have finished writing the block's
// partial row. `flag` is one int of shared memory; `bar_id`/`threads` name
// the barrier that joins those threads (bar_id 0 with all of the block's
// threads is __syncthreads()).
__device__ __forceinline__ bool last_block_of_tile(unsigned int* counter, unsigned int k,
                                                   int* flag, int bar_id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(bar_id), "r"(threads) : "memory");
  if (threadIdx.x == 0) {
    unsigned int ticket;
    asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
                 : "=r"(ticket)
                 : "l"(counter), "r"(k - 1)
                 : "memory");
    *flag = ticket == k - 1;
  }
  asm volatile("bar.sync %0, %1;" ::"r"(bar_id), "r"(threads) : "memory");
  return *flag != 0;
}

template <int V>
struct FloatVec {
  float v[V];
};

template <int V>
__device__ __forceinline__ FloatVec<V> load_cg(const float* p) {
  FloatVec<V> r;
  if constexpr (V == 4) {
    const float4 t = __ldcg(reinterpret_cast<const float4*>(p));
    r.v[0] = t.x, r.v[1] = t.y, r.v[2] = t.z, r.v[3] = t.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) r.v[i] = __ldcg(p + i);
  }
  return r;
}

// Adds k rows of `width` floats, rows first .. first + k - 1, and
// calls store(v, total) once for each v < width. V = 4 reads float4s and
// needs width, row_stride and the base 4-float aligned; V = 1 takes any.
// `threads` threads (ids 0..threads-1) take part, each with U loads in
// flight; `red` is shared scratch of at least threads * V floats. Loads go
// through L2 (__ldcg): the rows were written by other SMs.
template <int V, int U, typename Store>
__device__ __forceinline__ void add_partial_rows(const float* partial, long long row_stride,
                                                 int first, int k, int width,
                                                 Store store, float* red, int bar_id,
                                                 int threads) {
  const int tid = threadIdx.x;
  const int vecs = width / V;
  for (int c0 = 0; c0 < vecs; c0 += threads) {
    const int lanes = min(vecs - c0, threads);  // vectors in this chunk
    const int groups = threads / lanes;         // row groups
    const int col = tid % lanes, g = tid / lanes;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;
    if (g < groups) {
      const float* base = partial + (long long)(c0 + col) * V;
      int i = g;
      for (; i + (U - 1) * groups < k; i += U * groups) {
        FloatVec<V> t[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          t[u] = load_cg<V>(base + (long long)(first + i + u * groups) * row_stride);
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int j = 0; j < V; ++j) acc[j] += t[u].v[j];
      }
      for (; i < k; i += groups) {
        const FloatVec<V> t = load_cg<V>(base + (long long)(first + i) * row_stride);
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] += t.v[j];
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) red[j * threads + tid] = acc[j];
    asm volatile("bar.sync %0, %1;" ::"r"(bar_id), "r"(threads) : "memory");
    for (int e = tid; e < lanes * V; e += threads) {
      const int vec = e / V, j = e % V;
      float total = 0.0f;
      for (int gg = 0; gg < groups; ++gg) total += red[j * threads + gg * lanes + vec];
      store((c0 + vec) * V + j, total);
    }
    asm volatile("bar.sync %0, %1;" ::"r"(bar_id), "r"(threads) : "memory");
  }
}
