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
// Design. The TPU kernel keeps a (2, TC) accumulator in VMEM while its
// sequential grid sweeps the rows. Blocks of a GPU run in parallel and in no
// order, so the rows are split over `groups` blocks (enough to fill the
// SMs several times over) and the reduction takes two passes:
//   1. stat_partials_kernel: a block of 256 threads covers `cols` 16-byte
//      vectors of a row (8 bf16 or 4 float channels per thread) and
//      256/cols rows at a time, so a warp reads whole rows even when C is
//      small (C = 64 bf16 is one 128-byte row: a warp covers 4 rows). Each
//      thread accumulates its channels' s and s^2 in float32 registers over
//      its rows; a shared-memory tree over the block's row slots, in fixed
//      order, leaves one (2, C) partial per block.
//   2. column_sums_kernel (column_sums.cuh) adds the partials in a fixed
//      order. No float atomics: the same input gives the same statistics.
// Rows or channels that do not fit 16-byte loads (C not a multiple of the
// vector, or a base address that is not 16-byte aligned) take the scalar
// variant of the same kernel.
//
// Bound. It reads x once (N*C*2 bytes in bf16) and does 3 flops per
// element: bound by memory bandwidth.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "column_sums.cuh"

#define SS_THREADS 256

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

// Block (blockIdx.x, blockIdx.y) sums rows [blockIdx.x * rows_per_group, +rows_per_group)
// of the vector columns [blockIdx.y * cols, +cols) into partial[blockIdx.x] (2, C).
template <typename T, int V>
__global__ void __launch_bounds__(SS_THREADS)
stat_partials_kernel(const T* __restrict__ x, long long n, int c, int cols,
                     int rows_per_iter, long long rows_per_group,
                     float* __restrict__ partial) {
  __shared__ float red[2][SS_THREADS * V];
  const int tx = threadIdx.x % cols;
  const int ty = threadIdx.x / cols;
  const int vcol = blockIdx.y * cols + tx;
  const bool in_cols = vcol < c / V;
  float s[V], q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = q[i] = 0.0f;
  if (in_cols && ty < rows_per_iter) {
    const long long r0 = (long long)blockIdx.x * rows_per_group;
    const long long r1 = min(r0 + rows_per_group, n);
    const long long stride = (long long)rows_per_iter * c;
    const T* p = x + (r0 + ty) * c + (long long)vcol * V;
    for (long long r = r0 + ty; r < r1; r += rows_per_iter, p += stride) {
      float f[V];
      load_row_vector<T, V>(p, f);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s[i] += f[i];
        q[i] = fmaf(f[i], f[i], q[i]);
      }
    }
  }
  const int slot = threadIdx.x * V;  // (ty * cols + tx) * V
#pragma unroll
  for (int i = 0; i < V; ++i) {
    red[0][slot + i] = s[i];
    red[1][slot + i] = q[i];
  }
  __syncthreads();
  // tree over the row slots ty = 0..rows_per_iter-1, fixed pairing
  int span = 1;
  while (span < rows_per_iter) span <<= 1;
  for (int h = span >> 1; h > 0; h >>= 1) {
    if (ty < h && ty + h < rows_per_iter) {
      const int other = slot + h * cols * V;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        red[0][slot + i] += red[0][other + i];
        red[1][slot + i] += red[1][other + i];
      }
    }
    __syncthreads();
  }
  if (ty == 0 && in_cols) {
    float* out = partial + (long long)blockIdx.x * 2 * c + (long long)vcol * V;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      out[i] = red[0][slot + i];
      out[c + i] = red[1][slot + i];
    }
  }
}

template <typename T, int V>
void launch_partials(const void* x, long long n, int c, int cols, int rows_per_iter,
                     int groups, float* partial, cudaStream_t stream) {
  const long long rows_per_group =
      ((n + groups - 1) / groups + rows_per_iter - 1) / rows_per_iter * rows_per_iter;
  const int vcols = c / V;
  const dim3 grid((unsigned int)groups, (unsigned int)((vcols + cols - 1) / cols));
  stat_partials_kernel<T, V><<<grid, SS_THREADS, 0, stream>>>(
      static_cast<const T*>(x), n, c, cols, rows_per_iter, rows_per_group, partial);
}

}  // namespace

// Plain C entry point, loaded with ctypes.
//   x: (n, c) row-major, bf16 (is_bf16 = 1) or float32 (is_bf16 = 0)
//   vec: 1 for 16-byte loads (c a multiple of 16 / element size, x 16-byte
//        aligned), 0 for scalar loads
//   cols, rows_per_iter: the block's vector columns and row slots
//        (cols * rows_per_iter <= 256), chosen by the caller
//   groups: row blocks; partial: (groups, 2, c) float32 scratch
//   out: (2, c) float32
// Launches on `stream`, returns cudaGetLastError() (0 on success); does not
// synchronise.
extern "C" int stat_sums_launch(const void* x, long long n, int c, int is_bf16,
                                int vec, int cols, int rows_per_iter, int groups,
                                float* partial, float* out, void* stream) {
  const int v = vec ? (is_bf16 ? 8 : 4) : 1;
  if (n < 1 || c < 1 || c % v != 0 || cols < 1 || rows_per_iter < 1 ||
      cols * rows_per_iter > SS_THREADS || groups < 1 || groups > 65535 ||
      (c / v + cols - 1) / cols > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (vec) launch_partials<__nv_bfloat16, 8>(x, n, c, cols, rows_per_iter, groups, partial, s);
    else launch_partials<__nv_bfloat16, 1>(x, n, c, cols, rows_per_iter, groups, partial, s);
  } else {
    if (vec) launch_partials<float, 4>(x, n, c, cols, rows_per_iter, groups, partial, s);
    else launch_partials<float, 1>(x, n, c, cols, rows_per_iter, groups, partial, s);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launch_column_sums(partial, groups, 2 * c, out, s);
  return (int)cudaGetLastError();
}
