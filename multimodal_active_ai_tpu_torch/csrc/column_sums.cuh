// Second pass of the port's statistic kernels (stat_sums.cu, conv1x1_stats.cu).
//
// The first pass of each leaves one row of per-column partial sums per
// block of rows: partial is (groups, width) float32, row-major. This kernel
// adds them up, column by column, in a fixed order, so the same input gives
// bit-identical statistics on every run (no float atomics):
//
//   out[j] = sum over t = 0..7 of ( sum over g = t, t+8, t+16, ... of partial[g][j] )
//
// A 32x8 block covers 32 columns: threadIdx.y strides over the groups, then
// the eight per-row sums are added in threadIdx.y order. Loads of one row of
// the block touch 32 consecutive floats.

#pragma once

#include <cuda_runtime.h>

#define COLUMN_SUMS_ROWS 8

__global__ void column_sums_kernel(const float* __restrict__ partial, int groups,
                                   int width, float* __restrict__ out) {
  __shared__ float red[COLUMN_SUMS_ROWS][33];
  const int j = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.0f;
  if (j < width)
    for (int g = threadIdx.y; g < groups; g += COLUMN_SUMS_ROWS)
      acc += partial[(long long)g * width + j];
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && j < width) {
    float total = 0.0f;
#pragma unroll
    for (int t = 0; t < COLUMN_SUMS_ROWS; ++t) total += red[t][threadIdx.x];
    out[j] = total;
  }
}

static inline void launch_column_sums(const float* partial, int groups, int width,
                                      float* out, cudaStream_t stream) {
  const dim3 block(32, COLUMN_SUMS_ROWS);
  const unsigned int blocks = (unsigned int)((width + 31) / 32);
  column_sums_kernel<<<blocks, block, 0, stream>>>(partial, groups, width, out);
}
