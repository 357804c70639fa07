// BatchNorm statistics in one pass for Hopper (sm_90a): per-channel [sum x, sum x^2].
//
// Replaces the TPU kernel multimodal_active_ai_tpu/ops/pallas_bn.py:
// _stat_sums_fwd (body _sums_kernel). Same function:
//
//   out[0][c] = sum_r x[r][c],   out[1][c] = sum_r x[r][c]^2
//
// over the rows of a row-major (N, C) bf16 or float32 array (an NHWC
// activation flattened), accumulated in float32.
//
// Bound. It reads x once (N*C*2 bytes in bf16) and does 3 flops per
// element: bound by memory bandwidth. At the ResNet-50 shapes a call moves
// 2-15 MB, 0.6-4.4 us at 3.35 TB/s, so a launch's fixed cost counts as much
// as the bytes.
//
// Design: one launch.
// * The grid is at most one wave (the caller sizes it: one block of 1024
//   threads per SM). blockIdx.y picks a tile of up to 64 channels,
//   blockIdx.x a run of rows_per_block rows. A block lays `cols` 16-byte
//   vectors of a row (8 bf16 or 4 float channels each) side by side and
//   1024 / cols rows on top of each other, so a warp reads whole 128-byte
//   row segments (C = 64 bf16: 8 vectors, a warp covers 4 rows).
// * Each thread keeps four independent 16-byte loads in flight (a row loop
//   unrolled by 4, the loads past the block's rows predicated off) and its
//   channels' s and s^2 in float32 registers.
// * In the block, lanes of a warp that share channels are added by warp
//   shuffles, then one shared-memory step adds the 32 warps in order.
// * The block writes one (2, tile) partial row; the last block of its
//   channel tile to finish (integer ticket, stat_finish.cuh) adds the
//   tile's rows in a fixed order. No float atomics: the same input gives
//   the same statistics on every call.
// Channels that do not fit 16-byte loads (C not a multiple of the vector,
// or a base address that is not 16-byte aligned) take the scalar variant.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stat_finish.cuh"

#define SS_THREADS 1024
#define SS_TILE_C 64      // channels per column tile
#define SS_UNROLL 4       // independent row loads in flight per thread

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// V consecutive elements from p as floats: one 16-byte load when V
// elements fill 16 bytes, else V scalar loads.
template <typename T, int V>
__device__ __forceinline__ void load_row_vector(const T* p, float (&f)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = to_float(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = to_float(p[i]);
  }
}

template <int V>
__device__ __forceinline__ void accumulate(const float (&f)[V], float (&s)[V], float (&q)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    s[i] += f[i];
    q[i] = fmaf(f[i], f[i], q[i]);
  }
}

// Block (bx, by) sums rows [bx * rows_per_block, +rows_per_block) of the
// channel tile [by * cols * V, +cols * V) into the partial row
// partial[(by * gridDim.x + bx) * 2 * W ...] (W = cols * V: W sums, W sums
// of squares); the last block of the tile writes out (2, C).
template <typename T, int V>
__global__ void __launch_bounds__(SS_THREADS, 1)
stat_sums_kernel(const T* __restrict__ x, long long n, int c, int cols,
                 long long rows_per_block, float* __restrict__ partial,
                 unsigned int* __restrict__ tickets, float* __restrict__ out) {
  // per-group sums (cols divides 32: 32 warps x 2 x <= 64 channels; else
  // cols = 64 scalar channels: 16 slots x 2 x 64), and add_partial_rows'
  // scratch (SS_THREADS x 4)
  __shared__ __align__(16) float red[4 * SS_THREADS];
  __shared__ int last_flag;
  const int tid = threadIdx.x;
  const int slots = SS_THREADS / cols;
  const int tx = tid % cols, ty = tid / cols;
  const int w = cols * V;
  const int vcol = blockIdx.y * cols + tx;
  const bool active = ty < slots && vcol < c / V;
  float s[V], q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = q[i] = 0.0f;
  if (active) {
    const long long r0 = (long long)blockIdx.x * rows_per_block;
    const long long r1 = min(r0 + rows_per_block, n);
    const long long step = (long long)slots * c;
    const T* p = x + (r0 + ty) * c + (long long)vcol * V;
    for (long long r = r0 + ty; r < r1; r += SS_UNROLL * slots, p += SS_UNROLL * step) {
      float f[SS_UNROLL][V];
#pragma unroll
      for (int u = 0; u < SS_UNROLL; ++u) {
        if (r + u * slots < r1) {
          load_row_vector<T, V>(p + u * step, f[u]);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) f[u][i] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < SS_UNROLL; ++u) accumulate<V>(f[u], s, q);
    }
  }

  // in-block sum over the row slots, fixed order
  int groups, group;
  bool writer;
  if (32 % cols == 0) {  // lanes l, l + cols, ... of a warp share channels
    for (int off = cols; off < 32; off <<= 1) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
        q[i] += __shfl_xor_sync(0xffffffffu, q[i], off);
      }
    }
    groups = SS_THREADS / 32;
    group = tid / 32;
    writer = tid % 32 < cols;
  } else {
    groups = slots;
    group = ty;
    writer = ty < slots;
  }
  if (writer) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red[(group * 2 + 0) * w + tx * V + i] = s[i];
      red[(group * 2 + 1) * w + tx * V + i] = q[i];
    }
  }
  __syncthreads();
  float* row = partial + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * 2 * w;
  for (int e = tid; e < 2 * w; e += SS_THREADS) {  // e = stat * w + channel
    float total = 0.0f;
    for (int g = 0; g < groups; ++g) total += red[g * 2 * w + e];
    row[e] = total;
  }

  // the last block of this channel tile adds the tile's partial rows
  if (!last_block_of_tile(tickets + blockIdx.y, gridDim.x, &last_flag, 0, SS_THREADS)) return;
  const int c0 = blockIdx.y * w;
  auto store = [&](int e, float total) {
    const int stat = e / w, ch = c0 + e % w;
    if (ch < c) out[(long long)stat * c + ch] = total;
  };
  const float* tile = partial + (long long)blockIdx.y * gridDim.x * 2 * w;
  if ((2 * w) % 4 == 0)
    add_partial_rows<4, 8>(tile, 2 * w, 0, gridDim.x, 2 * w, store, red, 0, SS_THREADS);
  else
    add_partial_rows<1, 8>(tile, 2 * w, 0, gridDim.x, 2 * w, store, red, 0, SS_THREADS);
}

template <typename T, int V>
void launch(const void* x, long long n, int c, int cols, int row_blocks, int tiles_c,
            long long rows_per_block, float* partial, unsigned int* tickets, float* out,
            cudaStream_t stream) {
  const dim3 grid((unsigned int)row_blocks, (unsigned int)tiles_c);
  stat_sums_kernel<T, V><<<grid, SS_THREADS, 0, stream>>>(
      static_cast<const T*>(x), n, c, cols, rows_per_block, partial, tickets, out);
}

}  // namespace

// Plain C entry point, loaded with ctypes. The plan comes from
// ops/stat_sums.py:stat_sums_plan and is checked here:
//   x: (n, c) row-major, bf16 (is_bf16 = 1) or float32 (is_bf16 = 0)
//   vec: 1 for 16-byte loads (c a multiple of 16 / element size, x 16-byte
//        aligned), 0 for scalar loads
//   cols: vectors per channel tile, the largest power of two <= min(64 / V,
//        c / V) with V the vector length (1 when vec = 0); tiles_c =
//        ceil(c / V / cols)
//   rows_per_block: a multiple of 1024 / cols; row_blocks =
//        ceil(n / rows_per_block)
//   partial: (tiles_c, row_blocks, 2, cols * V) float32 scratch
//   tickets: >= tiles_c unsigned counters, 0 before the first call (each
//        call leaves them 0); calls sharing them must run on one stream
//   out: (2, c) float32
// Launches on `stream`, returns cudaGetLastError() (0 on success) or
// cudaErrorInvalidValue for an inconsistent plan; does not synchronise.
extern "C" int stat_sums_launch(const void* x, long long n, int c, int is_bf16, int vec,
                                int cols, int row_blocks, int tiles_c, long long rows_per_block,
                                float* partial, unsigned int* tickets, int n_tickets,
                                float* out, void* stream) {
  const int v = vec ? (is_bf16 ? 8 : 4) : 1;
  if (n < 1 || c < 1 || c % v != 0) return (int)cudaErrorInvalidValue;
  const int vcols = c / v;
  const int slots = cols > 0 ? SS_THREADS / cols : 0;
  int want = 1;  // the largest power of two <= min(vcols, SS_TILE_C / v)
  while (want * 2 <= vcols && want * 2 <= SS_TILE_C / v) want *= 2;
  if (cols != want ||
      tiles_c != (vcols + cols - 1) / cols || tiles_c > n_tickets || tiles_c > 65535 ||
      rows_per_block < 1 || rows_per_block % slots != 0 ||
      row_blocks != (n + rows_per_block - 1) / rows_per_block)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (vec) launch<__nv_bfloat16, 8>(x, n, c, cols, row_blocks, tiles_c, rows_per_block, partial, tickets, out, s);
    else launch<__nv_bfloat16, 1>(x, n, c, cols, row_blocks, tiles_c, rows_per_block, partial, tickets, out, s);
  } else {
    if (vec) launch<float, 4>(x, n, c, cols, row_blocks, tiles_c, rows_per_block, partial, tickets, out, s);
    else launch<float, 1>(x, n, c, cols, row_blocks, tiles_c, rows_per_block, partial, tickets, out, s);
  }
  return (int)cudaGetLastError();
}
