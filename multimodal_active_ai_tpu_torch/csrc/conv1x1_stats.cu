// 1x1 convolution with its BatchNorm statistics taken in the epilogue, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel multimodal_active_ai_tpu/ops/pallas_conv_bn.py:
// _conv1x1_stats_fwd (body _conv_stats_kernel). Same function:
//
//   acc = x @ w^T                     (f32 accumulation)
//   y   = acc cast to x's type        (M, N)
//   s[n] = sum_m acc[m][n],  q[n] = sum_m acc[m][n]^2      (from acc, before the cast)
//
// with x (M, K) the NHWC activation flattened to pixels x channels and w the
// conv's own (N, K, 1, 1) weight as an (N, K) row-major matrix, so no call
// pays for a transpose.
//
// Design. The TPU kernel keeps a (2, TN) stat block in VMEM while its
// sequential grid walks the row tiles. Here the row tiles run in parallel:
// each CTA writes the column sums of its own tile rows as one (2, N)
// partial, and column_sums_kernel (column_sums.cuh) adds the (tiles_m, 2, N)
// partials in a fixed order (no float atomics: the same input gives the same
// statistics on every run).
// * bf16: a CTA computes a 128 x 128 tile with 8 warps (2 x 4, each 64 x 32
//   = 4 x 2 wmma 16x16x16 bf16 fragments on the tensor cores, f32
//   accumulators). K streams through shared memory in 32-wide slices; the
//   next slice is loaded into registers (16-byte loads) while the tensor
//   cores work on the current one. The epilogue stages the f32 tile in
//   shared memory (reusing the operand buffers), writes y as bf16 with
//   16-byte stores and takes each column's sum and sum of squares over the
//   tile's rows from the staged f32 values.
// * float32: a 64 x 64 tile per CTA of 16 x 16 threads, 4 x 4 outputs per
//   thread with FMA (no TF32), same epilogue order.
// Tails in M, N and K are zero-filled on load (a zero row adds nothing to
// the sums) and masked on store. Operands that are not 16-byte aligned, or
// K not a multiple of 8, take element loads.
//
// Bound. A 1x1 conv of the main path does 2*M*N*K flops and moves
// (M*K + N*K + M*N)*2 bytes; at the ResNet-50 shapes it is bound by bytes
// for the wide-M early layers and by tensor-core operations for layer4.
// This first version uses mma.sync through wmma with register prefetch:
// wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "column_sums.cuh"

using namespace nvcuda;

namespace {

// ---- bf16 tensor-core path --------------------------------------------------
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int THREADS = 256;
constexpr int LDS = BK + 8;  // operand tile row stride in bf16 (80 bytes)
constexpr int LDC = BN + 4;  // staged accumulator row stride in floats
constexpr int OPERAND_BYTES = (BM + BN) * LDS * 2;
constexpr int STAGE_BYTES = BM * LDC * 4;
constexpr int SMEM_BYTES = STAGE_BYTES > OPERAND_BYTES ? STAGE_BYTES : OPERAND_BYTES;
constexpr int CHUNKS = BM * BK / 8 / THREADS;  // 16-byte chunks per thread per operand

// 8 consecutive bf16 of row `row` from column k, zero outside rows x k_total.
__device__ __forceinline__ uint4 load_chunk(const __nv_bfloat16* __restrict__ base,
                                            int rows, int k_total, int row, int k,
                                            bool vec) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (row < rows && k < k_total) {
    const __nv_bfloat16* p = base + (long long)row * k_total + k;
    if (vec) {  // k_total % 8 == 0 and k % 8 == 0: the chunk is whole
      v = *reinterpret_cast<const uint4*>(p);
    } else {
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
      for (int i = 0; i < 8 && k + i < k_total; ++i) e[i] = p[i];
    }
  }
  return v;
}

__global__ void __launch_bounds__(THREADS)
conv1x1_stats_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ w, int m, int n, int k,
                          int vec_in, int vec_out, __nv_bfloat16* __restrict__ y,
                          float* __restrict__ partial) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [BM][LDS]
  __nv_bfloat16* Bs = As + BM * LDS;                            // [BN][LDS]
  float* Cs = reinterpret_cast<float*>(smem);                   // [BM][LDC], epilogue
  __shared__ float col_red[2][2][BN];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 4;  // rows wm*64 .. +64
  const int wn = warp % 4;  // cols wn*32 .. +32
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const bool vec = vec_in != 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  uint4 ra[CHUNKS], rb[CHUNKS];
  // chunk c of a tile: row c / (BK/8), columns (c % (BK/8)) * 8 .. +8
#define FETCH(k0)                                                            \
  _Pragma("unroll") for (int i = 0; i < CHUNKS; ++i) {                       \
    const int c = tid + i * THREADS;                                         \
    const int r = c / (BK / 8), kk = (c % (BK / 8)) * 8;                     \
    ra[i] = load_chunk(x, m, k, m0 + r, (k0) + kk, vec);                     \
    rb[i] = load_chunk(w, n, k, n0 + r, (k0) + kk, vec);                     \
  }
#define STASH()                                                              \
  _Pragma("unroll") for (int i = 0; i < CHUNKS; ++i) {                       \
    const int c = tid + i * THREADS;                                         \
    const int r = c / (BK / 8), kk = (c % (BK / 8)) * 8;                     \
    *reinterpret_cast<uint4*>(As + r * LDS + kk) = ra[i];                    \
    *reinterpret_cast<uint4*>(Bs + r * LDS + kk) = rb[i];                    \
  }

  const int ktiles = (k + BK - 1) / BK;
  FETCH(0);
  STASH();
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    if (kt + 1 < ktiles) { FETCH((kt + 1) * BK); }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 64 + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + (wn * 32 + j * 16) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (kt + 1 < ktiles) {
      STASH();
      __syncthreads();
    }
  }
#undef FETCH
#undef STASH

  // epilogue: stage the f32 tile (the operand buffers are no longer read)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 64 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  // y = acc as bf16, 8 columns per chunk
  for (int c = tid; c < BM * BN / 8; c += THREADS) {
    const int r = c / (BN / 8), cc = (c % (BN / 8)) * 8;
    const int row = m0 + r, col = n0 + cc;
    if (row >= m || col >= n) continue;
    const float* src = Cs + r * LDC + cc;
    __nv_bfloat16* dst = y + (long long)row * n + col;
    if (vec_out && col + 8 <= n) {
      uint4 packed;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(src[2 * i], src[2 * i + 1]);
      *reinterpret_cast<uint4*>(dst) = packed;
    } else {
      for (int i = 0; i < 8 && col + i < n; ++i) dst[i] = __float2bfloat16(src[i]);
    }
  }

  // column sums of the tile's rows from the f32 values (rows past m are 0)
  const int col = tid % BN, half = tid / BN;
  float s = 0.0f, q = 0.0f;
  for (int r = half * (BM / 2); r < (half + 1) * (BM / 2); ++r) {
    const float v = Cs[r * LDC + col];
    s += v;
    q = fmaf(v, v, q);
  }
  col_red[0][half][col] = s;
  col_red[1][half][col] = q;
  __syncthreads();
  if (half == 0 && n0 + col < n) {
    float* out = partial + (long long)blockIdx.y * 2 * n + n0 + col;
    out[0] = col_red[0][0][col] + col_red[0][1][col];
    out[n] = col_red[1][0][col] + col_red[1][1][col];
  }
}

// ---- float32 FMA path -------------------------------------------------------
constexpr int FM = 64, FN = 64, FK = 16;

__global__ void __launch_bounds__(THREADS)
conv1x1_stats_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                         int m, int n, int k, float* __restrict__ y,
                         float* __restrict__ partial) {
  __shared__ float As[FK][FM + 4];  // As[kk][r] = x[m0 + r][k0 + kk]
  __shared__ float Bs[FK][FN + 4];  // Bs[kk][c] = w[n0 + c][k0 + kk]
  __shared__ float red[2][16][FN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * FM, n0 = blockIdx.x * FN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += FK) {
#pragma unroll
    for (int i = 0; i < FM * FK / THREADS; ++i) {
      const int e = threadIdx.x + i * THREADS;
      const int r = e / FK, kk = e % FK;
      const bool kin = k0 + kk < k;
      As[kk][r] = (kin && m0 + r < m) ? x[(long long)(m0 + r) * k + k0 + kk] : 0.0f;
      Bs[kk][r] = (kin && n0 + r < n) ? w[(long long)(n0 + r) * k + k0 + kk] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + tx + 16 * j;
    float s = 0.0f, q = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty + 16 * i;
      if (row < m && col < n) y[(long long)row * n + col] = acc[i][j];
      s += acc[i][j];  // rows past m hold 0
      q = fmaf(acc[i][j], acc[i][j], q);
    }
    red[0][ty][tx + 16 * j] = s;
    red[1][ty][tx + 16 * j] = q;
  }
  __syncthreads();
  if (threadIdx.x < FN && n0 + threadIdx.x < n) {
    float s = 0.0f, q = 0.0f;
    for (int t = 0; t < 16; ++t) {
      s += red[0][t][threadIdx.x];
      q += red[1][t][threadIdx.x];
    }
    float* out = partial + (long long)blockIdx.y * 2 * n + n0 + threadIdx.x;
    out[0] = s;
    out[n] = q;
  }
}

}  // namespace

// Row tile of each path: the caller sizes the (tiles_m, 2, n) partials with it.
extern "C" int conv1x1_stats_tile_m(int is_bf16) { return is_bf16 ? BM : FM; }

// Plain C entry point, loaded with ctypes.
//   x: (m, k) row-major; w: (n, k) row-major; both bf16 (is_bf16 = 1) or
//   float32 (is_bf16 = 0). y: (m, n) in the same type.
//   vec_in: x and w 16-byte aligned and k % 8 == 0 (bf16 path)
//   vec_out: y 16-byte aligned and n % 8 == 0 (bf16 path)
//   partial: (tiles_m, 2, n) float32 scratch, tiles_m = ceil(m / tile_m)
//   out: (2, n) float32 [sum y, sum y^2]
// Launches on `stream`, returns cudaGetLastError() (0 on success); does not
// synchronise.
extern "C" int conv1x1_stats_launch(const void* x, const void* w, int m, int n, int k,
                                    int is_bf16, int vec_in, int vec_out, void* y,
                                    int tiles_m, float* partial, float* out,
                                    void* stream) {
  const int tm = is_bf16 ? BM : FM, tn = is_bf16 ? BN : FN;
  if (m < 1 || n < 1 || k < 1 || tiles_m != (m + tm - 1) / tm || tiles_m > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned int)((n + tn - 1) / tn), (unsigned int)tiles_m);
  if (is_bf16) {
    cudaError_t err = cudaFuncSetAttribute(conv1x1_stats_bf16_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    conv1x1_stats_bf16_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), m, n,
        k, vec_in, vec_out, static_cast<__nv_bfloat16*>(y), partial);
  } else {
    conv1x1_stats_f32_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), m, n, k,
        static_cast<float*>(y), partial);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launch_column_sums(partial, tiles_m, 2 * n, out, s);
  return (int)cudaGetLastError();
}
