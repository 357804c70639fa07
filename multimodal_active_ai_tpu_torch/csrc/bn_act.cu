// BatchNorm (training mode, flax semantics) + optional residual add + optional
// ReLU for Hopper (sm_90a), forward and backward, over the channels-last
// (rows, C) view of an activation.
//
// Replaces no TPU kernel: on the TPU the JAX package's `bn` is flax
// BatchNorm, whose chain of elementwise ops and reductions XLA fuses. These
// kernels are the port's counterpart of that fusion
// (ops/bn_act.py:batch_norm_act). With mean/rstd per channel:
//
//   forward   mean = sum(x) / n, raw = sum(x^2) / n - mean^2,
//             rstd = rsqrt(max(raw, 0) + eps),
//             r_mean <- m * r_mean + (1 - m) * mean (and r_var with max(raw, 0)),
//             y = relu?((x - mean) * (rstd * w) + b [+ identity])
//   backward  gy = g where y > 0, else 0 (g without ReLU),
//             db = sum(gy), dw = rstd * sum(gy * (x - mean)),
//             dx = k * gy - k * db / n - k * rstd * dw' / n * (x - mean),
//             k = w * rstd, dw' = dw (0 where raw < 0: the clamp cut the
//             variance's gradient), d identity = gy
//
// with the sums and n over this call's rows, or over every rank's rows for
// SyncBatchNorm (NCCL sums the per-channel sums between the kernels),
// in float32 whatever the storage type (bf16 or float32), outputs stored once
// in that type.
//
// Bound. Every pass is a few flops per element over 2-byte elements: bound by
// memory bandwidth. A forward moves about 6 bytes an element in bf16 (x read
// for the statistics, read again and y written; +2 with a residual), a
// backward about 14 (g, y and x read twice, dx written; +2 with a residual).
//
// Design: four kernels, two a pass.
// * One grid plan (ops/bn_act.py:bn_act_plan, the stat_sums plan at 512
//   threads a block): blockIdx.y picks a tile of up to 64 channels,
//   blockIdx.x a run of rows_per_block rows. A block lays `cols` 16-byte
//   vectors of a row (8 bf16 or 4 float channels) side by side and 512 / cols
//   rows on top of each other, so a warp reads whole 128-byte row segments,
//   and each thread keeps the per-channel constants of its vector in
//   registers for all of its rows.
// * bn_act_sums / bn_act_grad_sums: per-channel float32 sums of the block's
//   rows (warp shuffles, then one shared-memory step in a fixed order), one
//   partial row per block; the last block of each channel tile (integer
//   ticket, stat_finish.cuh) adds the tile's partial rows in a fixed order
//   and writes [sum x, sum x^2] and the row count into one float32 buffer
//   (the buffer NCCL sums over ranks), or dw and db (and their copy for
//   NCCL). No float atomics: the same input gives the same bits on every
//   call.
// * bn_act_apply / bn_act_grad_apply: one elementwise pass, each thread over
//   the rows of its block's run, several 16-byte loads in flight.
//   bn_act_apply finishes mean, rstd and the clamp flag of its channels from
//   the sums in its prologue (its first row of blocks also writes stats and
//   the running update); bn_act_grad_apply divides dw and db by the count
//   that the sums buffer holds.
// Channels that do not fit 16-byte vectors (C not a multiple of the vector,
// or a pointer not 16-byte aligned) take the scalar variant.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stat_finish.cuh"

#define BN_THREADS 512
#define BN_TILE_C 64     // channels per column tile
#define BN_UNROLL 4      // rows in flight per thread, forward
#define BN_BWD_UNROLL 2  // rows in flight per thread, backward (three inputs a row)

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V consecutive elements at p as floats: one 16-byte load when V elements
// fill 16 bytes, else V scalar loads.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&f)[V]) {
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

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&f)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_float<T>(f[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = from_float<T>(f[i]);
  }
}

// The thread's place in the plan: tx its vector column in the tile, ty its
// row slot, vcol its vector column in the row (active when < c / V).
struct Place {
  int tx, ty, slots, vcol;
  long long r0, r1;
};

__device__ __forceinline__ Place place(long long n, int c, int cols, long long rows_per_block) {
  Place p;
  p.slots = BN_THREADS / cols;
  p.tx = threadIdx.x % cols;
  p.ty = threadIdx.x / cols;
  p.vcol = blockIdx.y * cols + p.tx;
  p.r0 = (long long)blockIdx.x * rows_per_block;
  p.r1 = min(p.r0 + rows_per_block, n);
  return p;
}

// The statistics of models/norm.py:BatchNorm, op for op, from a channel's
// [sum x, sum x^2] over `count` rows.
struct ChannelStats {
  float mean, var, rstd, clamped;
};

__device__ __forceinline__ ChannelStats channel_stats(float s, float q, float count, float eps) {
  ChannelStats st;
  st.mean = __fdiv_rn(s, count);
  const float raw = __fsub_rn(__fdiv_rn(q, count), __fmul_rn(st.mean, st.mean));
  st.var = fmaxf(raw, 0.0f);
  st.rstd = rsqrtf(__fadd_rn(st.var, eps));
  st.clamped = raw < 0.0f ? 1.0f : 0.0f;
  return st;
}

// stats = (mean, rstd, clamp flag) of channel ch, and its running update
// r <- momentum * r + keep_new * batch.
__device__ __forceinline__ void write_channel(int ch, int c, const ChannelStats& st,
                                              float momentum, float keep_new,
                                              float* __restrict__ stats,
                                              float* __restrict__ running_mean,
                                              float* __restrict__ running_var) {
  stats[ch] = st.mean;
  stats[c + ch] = st.rstd;
  stats[2 * c + ch] = st.clamped;
  running_mean[ch] = __fadd_rn(__fmul_rn(running_mean[ch], momentum), __fmul_rn(st.mean, keep_new));
  running_var[ch] = __fadd_rn(__fmul_rn(running_var[ch], momentum), __fmul_rn(st.var, keep_new));
}

// Adds the block's per-thread (s, q) over its row slots in a fixed order,
// writes the block's partial row (W sums of s, W of q; W = cols * V), and
// in the last block of the channel tile to finish adds the tile's partial
// rows into tot[0 .. 2W) (s totals, then q totals) and returns true there.
// `red` is shared scratch of 4 * BN_THREADS floats.
template <int V>
__device__ __forceinline__ bool reduce_tile(float (&s)[V], float (&q)[V], int cols, float* red,
                                            float* tot, int* last_flag, float* partial,
                                            unsigned int* tickets) {
  const int tid = threadIdx.x;
  const int w = cols * V;
  const int tx = tid % cols;
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
    groups = BN_THREADS / 32;
    group = tid / 32;
    writer = tid % 32 < cols;
  } else {  // cols = 64 scalar channels: a row slot per 64 threads
    groups = BN_THREADS / cols;
    group = tid / cols;
    writer = true;
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
  for (int e = tid; e < 2 * w; e += BN_THREADS) {  // e = stat * w + channel
    float total = 0.0f;
    for (int g = 0; g < groups; ++g) total += red[g * 2 * w + e];
    row[e] = total;
  }
  if (!last_block_of_tile(tickets + blockIdx.y, gridDim.x, last_flag, 0, BN_THREADS)) return false;
  const float* tile = partial + (long long)blockIdx.y * gridDim.x * 2 * w;
  auto store = [&](int e, float total) { tot[e] = total; };
  if ((2 * w) % 4 == 0)
    add_partial_rows<4, 8>(tile, 2 * w, 0, gridDim.x, 2 * w, store, red, 0, BN_THREADS);
  else
    add_partial_rows<1, 8>(tile, 2 * w, 0, gridDim.x, 2 * w, store, red, 0, BN_THREADS);
  __syncthreads();
  return true;
}

// ---------------------------------------------------------------- forward

// Per-channel [sum x, sum x^2] of rows [r0, r1) of the block's channel tile;
// the last block of the tile writes sums[ch] = sum x and sums[c + ch] = sum x^2
// for the tile's channels, and the tile-0 one also the row count sums[2c] = n.
template <typename T, int V>
__global__ void __launch_bounds__(BN_THREADS, 2)
bn_act_sums_kernel(const T* __restrict__ x, long long n, int c, int cols, long long rows_per_block,
                   float* __restrict__ partial, unsigned int* __restrict__ tickets,
                   float* __restrict__ sums) {
  __shared__ __align__(16) float red[4 * BN_THREADS];
  __shared__ float tot[2 * BN_TILE_C];
  __shared__ int last_flag;
  const Place p = place(n, c, cols, rows_per_block);
  float s[V], q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = q[i] = 0.0f;
  if (p.vcol < c / V) {
    const long long step = (long long)p.slots * c;
    const T* xp = x + (p.r0 + p.ty) * c + (long long)p.vcol * V;
    for (long long r = p.r0 + p.ty; r < p.r1; r += BN_UNROLL * p.slots, xp += BN_UNROLL * step) {
      float f[BN_UNROLL][V];
#pragma unroll
      for (int u = 0; u < BN_UNROLL; ++u) {
        if (r + u * p.slots < p.r1) {
          load_vec<T, V>(xp + u * step, f[u]);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) f[u][i] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < BN_UNROLL; ++u)
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s[i] += f[u][i];
          q[i] = fmaf(f[u][i], f[u][i], q[i]);
        }
    }
  }
  if (!reduce_tile<V>(s, q, cols, red, tot, &last_flag, partial, tickets)) return;
  const int w = cols * V, c0 = blockIdx.y * w;
  for (int j = threadIdx.x; j < w && c0 + j < c; j += BN_THREADS) {
    sums[c0 + j] = tot[j];
    sums[c + c0 + j] = tot[w + j];
  }
  if (blockIdx.y == 0 && threadIdx.x == 0) sums[2 * c] = (float)n;
}

// y = relu?((x - mean) * mul + b [+ identity]) over the block's rows, the
// thread's per-channel constants given.
template <typename T, int V>
__device__ __forceinline__ void apply_rows(const T* __restrict__ x, const T* __restrict__ identity,
                                           T* __restrict__ y, const float (&mean)[V],
                                           const float (&mul)[V], const float (&b)[V],
                                           const Place& p, int ch0, int c, int relu) {
  const long long step = (long long)p.slots * c;
  const long long first = (p.r0 + p.ty) * c + ch0;
  for (long long r = p.r0 + p.ty, o = first; r < p.r1;
       r += BN_UNROLL * p.slots, o += BN_UNROLL * step) {
    float f[BN_UNROLL][V], id[BN_UNROLL][V];
#pragma unroll
    for (int u = 0; u < BN_UNROLL; ++u) {
      if (r + u * p.slots < p.r1) {
        load_vec<T, V>(x + o + u * step, f[u]);
        if (identity != nullptr) load_vec<T, V>(identity + o + u * step, id[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < BN_UNROLL; ++u) {
      if (r + u * p.slots >= p.r1) continue;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float v = __fadd_rn(__fmul_rn(__fsub_rn(f[u][i], mean[i]), mul[i]), b[i]);
        if (identity != nullptr) v = __fadd_rn(v, id[u][i]);
        if (relu && v <= 0.0f) v = 0.0f;
        f[u][i] = v;
      }
      store_vec<T, V>(y + o + u * step, f[u]);
    }
  }
}

// y = relu?((x - mean) * (rstd * w) + b [+ identity]) over the block's rows,
// the statistics finished in the prologue from sums = [sum x (c), sum x^2
// (c), count] (this call's rows, or every rank's). Every thread finishes its
// own channels; the row of blocks with blockIdx.x == 0 also writes stats and
// the running update, and block (0, 0) counts the batch.
template <typename T, int V>
__global__ void __launch_bounds__(BN_THREADS, 1)
bn_act_apply_kernel(const T* __restrict__ x, const T* __restrict__ identity, T* __restrict__ y,
                    const float* __restrict__ sums, const float* __restrict__ weight,
                    const float* __restrict__ bias, float* __restrict__ stats,
                    float* __restrict__ running_mean, float* __restrict__ running_var,
                    long long* __restrict__ batches, long long n, int c, int cols,
                    long long rows_per_block, int relu, float momentum, float keep_new,
                    float eps) {
  const Place p = place(n, c, cols, rows_per_block);
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) *batches += 1;
  if (p.vcol >= c / V) return;
  const int ch0 = p.vcol * V;
  const bool writer = blockIdx.x == 0 && p.ty == 0;
  float mean[V], mul[V], b[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int ch = ch0 + i;
    const ChannelStats st = channel_stats(sums[ch], sums[c + ch], sums[2 * c], eps);
    if (writer) write_channel(ch, c, st, momentum, keep_new, stats, running_mean, running_var);
    mean[i] = st.mean;
    mul[i] = __fmul_rn(st.rstd, weight[ch]);
    b[i] = bias[ch];
  }
  apply_rows<T, V>(x, identity, y, mean, mul, b, p, ch0, c, relu);
}

// --------------------------------------------------------------- backward

// Per-channel [sum gy, sum gy * (x - mean)] (gy = 0 where y <= 0 with ReLU,
// else g); the last block of the tile writes db and dw = rstd * the second sum,
// and also copy[ch] = dw, copy[c + ch] = db when copy is given.
template <typename T, int V>
__global__ void __launch_bounds__(BN_THREADS, 1)
bn_act_grad_sums_kernel(const T* __restrict__ g, const T* __restrict__ y, const T* __restrict__ x,
                    const float* __restrict__ stats, long long n, int c, int cols,
                    long long rows_per_block, float* __restrict__ partial,
                    unsigned int* __restrict__ tickets, float* __restrict__ dw,
                    float* __restrict__ db, float* __restrict__ copy) {
  __shared__ __align__(16) float red[4 * BN_THREADS];
  __shared__ float tot[2 * BN_TILE_C];
  __shared__ int last_flag;
  const Place p = place(n, c, cols, rows_per_block);
  float s[V], q[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s[i] = q[i] = 0.0f;
  if (p.vcol < c / V) {
    const int ch0 = p.vcol * V;
    float mean[V];
#pragma unroll
    for (int i = 0; i < V; ++i) mean[i] = stats[ch0 + i];
    const long long step = (long long)p.slots * c;
    const long long first = (p.r0 + p.ty) * c + ch0;
    for (long long r = p.r0 + p.ty, o = first; r < p.r1;
         r += BN_BWD_UNROLL * p.slots, o += BN_BWD_UNROLL * step) {
      float gf[BN_BWD_UNROLL][V], yf[BN_BWD_UNROLL][V], xf[BN_BWD_UNROLL][V];
#pragma unroll
      for (int u = 0; u < BN_BWD_UNROLL; ++u) {
        if (r + u * p.slots < p.r1) {
          load_vec<T, V>(g + o + u * step, gf[u]);
          if (y != nullptr) load_vec<T, V>(y + o + u * step, yf[u]);
          load_vec<T, V>(x + o + u * step, xf[u]);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) gf[u][i] = yf[u][i] = xf[u][i] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < BN_BWD_UNROLL; ++u)
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float gy = (y != nullptr && yf[u][i] <= 0.0f) ? 0.0f : gf[u][i];
          s[i] += gy;
          q[i] = fmaf(gy, __fsub_rn(xf[u][i], mean[i]), q[i]);
        }
    }
  }
  if (!reduce_tile<V>(s, q, cols, red, tot, &last_flag, partial, tickets)) return;
  const int w = cols * V, c0 = blockIdx.y * w;
  for (int j = threadIdx.x; j < w && c0 + j < c; j += BN_THREADS) {
    const int ch = c0 + j;
    const float dwc = __fmul_rn(tot[w + j], stats[c + ch]);
    db[ch] = tot[j];
    dw[ch] = dwc;
    if (copy != nullptr) {
      copy[ch] = dwc;
      copy[c + ch] = tot[j];
    }
  }
}

// dx = k * gy - k * db / count - k * rstd * dw' / count * (x - mean) and, when
// d_identity is given, d_identity = gy; *count is the rows that dw and db sum
// over (the forward's sums buffer holds it: n, or every rank's rows).
template <typename T, int V>
__global__ void __launch_bounds__(BN_THREADS, 1)
bn_act_grad_apply_kernel(const T* __restrict__ g, const T* __restrict__ y, const T* __restrict__ x,
                     const float* __restrict__ stats, const float* __restrict__ weight,
                     const float* __restrict__ dw, const float* __restrict__ db,
                     const float* __restrict__ count, T* __restrict__ dx,
                     T* __restrict__ d_identity, long long n, int c, int cols,
                     long long rows_per_block) {
  const Place p = place(n, c, cols, rows_per_block);
  if (p.vcol >= c / V) return;
  const int ch0 = p.vcol * V;
  const float fn = *count;
  float mean[V], k[V], c0[V], c1[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int ch = ch0 + i;
    const float rstd = stats[c + ch];
    mean[i] = stats[ch];
    k[i] = __fmul_rn(rstd, weight[ch]);
    c0[i] = __fmul_rn(k[i], __fdiv_rn(db[ch], fn));
    c1[i] = stats[2 * c + ch] != 0.0f ? 0.0f
                                      : __fmul_rn(__fmul_rn(k[i], rstd), __fdiv_rn(dw[ch], fn));
  }
  const long long step = (long long)p.slots * c;
  const long long first = (p.r0 + p.ty) * c + ch0;
  for (long long r = p.r0 + p.ty, o = first; r < p.r1;
       r += BN_BWD_UNROLL * p.slots, o += BN_BWD_UNROLL * step) {
    float gf[BN_BWD_UNROLL][V], yf[BN_BWD_UNROLL][V], xf[BN_BWD_UNROLL][V];
#pragma unroll
    for (int u = 0; u < BN_BWD_UNROLL; ++u) {
      if (r + u * p.slots < p.r1) {
        load_vec<T, V>(g + o + u * step, gf[u]);
        if (y != nullptr) load_vec<T, V>(y + o + u * step, yf[u]);
        load_vec<T, V>(x + o + u * step, xf[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < BN_BWD_UNROLL; ++u) {
      if (r + u * p.slots >= p.r1) continue;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float gy = (y != nullptr && yf[u][i] <= 0.0f) ? 0.0f : gf[u][i];
        gf[u][i] = gy;
        xf[u][i] = __fsub_rn(__fsub_rn(__fmul_rn(k[i], gy), c0[i]),
                             __fmul_rn(c1[i], __fsub_rn(xf[u][i], mean[i])));
      }
      if (dx != nullptr) store_vec<T, V>(dx + o + u * step, xf[u]);
      if (d_identity != nullptr) store_vec<T, V>(d_identity + o + u * step, gf[u]);
    }
  }
}

// The plan of ops/bn_act.py:bn_act_plan, checked: cols the largest power of
// two <= min(c / v, 64 / v), tiles_c = ceil(c / v / cols), rows_per_block a
// multiple of 512 / cols, row_blocks = ceil(n / rows_per_block).
bool plan_ok(long long n, int c, int v, int cols, int row_blocks, int tiles_c,
             long long rows_per_block) {
  if (n < 1 || c < 1 || c % v != 0 || cols < 1) return false;
  const int vcols = c / v;
  int want = 1;
  while (want * 2 <= vcols && want * 2 <= BN_TILE_C / v) want *= 2;
  return cols == want && tiles_c == (vcols + cols - 1) / cols && tiles_c <= 65535 &&
         rows_per_block >= 1 && rows_per_block % (BN_THREADS / cols) == 0 &&
         row_blocks == (n + rows_per_block - 1) / rows_per_block;
}

int vec_len(int is_bf16, int vec) { return vec ? (is_bf16 ? 8 : 4) : 1; }

// Runs the statement(s) with T the storage type and V the vector length.
#define BN_DISPATCH(is_bf16, vec, ...)                                   \
  do {                                                                   \
    if (is_bf16) {                                                       \
      using T = __nv_bfloat16;                                           \
      if (vec) { constexpr int V = 8; __VA_ARGS__; }                     \
      else { constexpr int V = 1; __VA_ARGS__; }                         \
    } else {                                                             \
      using T = float;                                                   \
      if (vec) { constexpr int V = 4; __VA_ARGS__; }                     \
      else { constexpr int V = 1; __VA_ARGS__; }                         \
    }                                                                    \
  } while (0)

}  // namespace

// Plain C entry points, loaded with ctypes (ops/bn_act.py). Common arguments:
//   n, c: rows and channels of the row-major (n, c) views, all of one type,
//     bf16 (is_bf16 = 1) or float32 (is_bf16 = 0)
//   vec: 1 for 16-byte vectors (c a multiple of 16 / element size and every
//     tensor pointer 16-byte aligned), 0 for scalar loads
//   cols, row_blocks, tiles_c, rows_per_block: the plan (plan_ok)
//   stats: (3, c) float32: mean, rstd, clamp flag (1 where raw var < 0)
// The two reductions also take partial: (tiles_c, row_blocks, 2, cols * v)
// float32 scratch, and tickets: >= tiles_c unsigned counters, 0 before the
// first call (each call leaves them 0); calls sharing them run on one stream.
// Each launches one kernel on `stream`, returns cudaGetLastError() (0 on
// success) or cudaErrorInvalidValue for an inconsistent plan, and does not
// synchronise.

// sums (2c + 1) float32: [sum x (c), sum x^2 (c), n] of this call's rows.
extern "C" int bn_act_sums_launch(const void* x, long long n, int c, int is_bf16, int vec,
                                  int cols, int row_blocks, int tiles_c, long long rows_per_block,
                                  float* partial, unsigned int* tickets, int n_tickets,
                                  float* sums, void* stream) {
  if (!plan_ok(n, c, vec_len(is_bf16, vec), cols, row_blocks, tiles_c, rows_per_block) ||
      tiles_c > n_tickets)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)row_blocks, (unsigned int)tiles_c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BN_DISPATCH(is_bf16, vec,
      bn_act_sums_kernel<T, V><<<grid, BN_THREADS, 0, s>>>(
      static_cast<const T*>(x), n, c, cols, rows_per_block, partial, tickets, sums););
  return (int)cudaGetLastError();
}

// y = relu?(normalised x [+ identity]) (identity may be null), the
// statistics finished from sums (2c + 1) float32, [sum x, sum x^2, count]
// (bn_act_sums's, or their sum over ranks): writes stats (3, c) and updates
// running_mean/var (c,) float32 and batches (int64):
// r <- momentum * r + keep_new * batch (keep_new = 1 - momentum, rounded once).
extern "C" int bn_act_apply_launch(const void* x, const void* identity, void* y,
                                   const float* sums, const float* weight, const float* bias,
                                   float* stats, float* running_mean, float* running_var,
                                   long long* batches, long long n, int c, int is_bf16, int vec,
                                   int cols, int row_blocks, int tiles_c,
                                   long long rows_per_block, int relu, float momentum,
                                   float keep_new, float eps, void* stream) {
  if (!plan_ok(n, c, vec_len(is_bf16, vec), cols, row_blocks, tiles_c, rows_per_block))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)row_blocks, (unsigned int)tiles_c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BN_DISPATCH(is_bf16, vec,
      bn_act_apply_kernel<T, V><<<grid, BN_THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(identity), static_cast<T*>(y), sums,
      weight, bias, stats, running_mean, running_var, batches, n, c, cols, rows_per_block, relu,
      momentum, keep_new, eps););
  return (int)cudaGetLastError();
}

// dw, db (c,) float32 from g, y (null without ReLU) and x; with copy
// (2, c) float32 (null for none), [dw, db] written there too.
extern "C" int bn_act_grad_sums_launch(const void* g, const void* y, const void* x,
                                   const float* stats, long long n, int c, int is_bf16, int vec,
                                   int cols, int row_blocks, int tiles_c,
                                   long long rows_per_block, float* partial,
                                   unsigned int* tickets, int n_tickets, float* dw, float* db,
                                   float* copy, void* stream) {
  if (!plan_ok(n, c, vec_len(is_bf16, vec), cols, row_blocks, tiles_c, rows_per_block) ||
      tiles_c > n_tickets)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)row_blocks, (unsigned int)tiles_c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BN_DISPATCH(is_bf16, vec,
      bn_act_grad_sums_kernel<T, V><<<grid, BN_THREADS, 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(y), static_cast<const T*>(x), stats, n,
      c, cols, rows_per_block, partial, tickets, dw, db, copy););
  return (int)cudaGetLastError();
}

// dx and d_identity (either may be null) from g, y (null without ReLU), x,
// stats, weight and the grad sums' dw, db over *count rows (a float on the
// card: the row count of the forward's sums).
extern "C" int bn_act_grad_apply_launch(const void* g, const void* y, const void* x,
                                    const float* stats, const float* weight, const float* dw,
                                    const float* db, const float* count, void* dx,
                                    void* d_identity, long long n, int c, int is_bf16, int vec,
                                    int cols, int row_blocks, int tiles_c,
                                    long long rows_per_block, void* stream) {
  if (!plan_ok(n, c, vec_len(is_bf16, vec), cols, row_blocks, tiles_c, rows_per_block))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned int)row_blocks, (unsigned int)tiles_c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  BN_DISPATCH(is_bf16, vec,
      bn_act_grad_apply_kernel<T, V><<<grid, BN_THREADS, 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(y), static_cast<const T*>(x), stats,
      weight, dw, db, count, static_cast<T*>(dx), static_cast<T*>(d_identity), n, c, cols,
      rows_per_block););
  return (int)cudaGetLastError();
}
