// 1x1 convolution with its BatchNorm statistics taken from the accumulator,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel multimodal_active_ai_tpu/ops/pallas_conv_bn.py:
// _conv1x1_stats_fwd (body _conv_stats_kernel). Same function:
//
//   acc = x @ w^T                     (f32 accumulation)
//   y   = acc cast to x's type        (M, N)
//   s[n] = sum_m acc[m][n],  q[n] = sum_m acc[m][n]^2      (from acc, before the cast)
//
// with x (M, K) the NHWC activation flattened to pixels x channels and w the
// conv's own (N, K, 1, 1) weight as an (N, K) row-major matrix. Both are
// K-major, the layout wgmma reads for both operands, so no call transposes.
//
// Bound. A 1x1 conv of the main path does 2*M*N*K flops and moves
// (M*K + N*K + M*N)*2 bytes: bound by bytes for the wide-M layer1/2 shapes
// (K = 64-256), by tensor-core operations for layer3/4.
//
// Routes, chosen by shape in ops/conv1x1_stats.py (never on failure):
// * wgmma (bf16, K and N multiples of 8, 16-byte aligned bases, at most one
//   N tile per CTA: every main-path shape). A persistent CTA of 1-2 consumer warpgroups (BM = 64
//   or 128 rows, 64 each) and one producer warp walks a static list of
//   BM x BN output tiles: the CTAs split into one run per N tile and each
//   CTA takes a contiguous run of that N tile's M tiles, so it stays in one
//   N tile and the same tiles go to the same CTAs on every call.
//   - The producer warp keeps TMA loads of 64-wide K slices of x and w (one
//     128-byte row, 128-byte swizzle) in flight through a ring of
//     full/empty mbarriers, so one tile's epilogue overlaps the next tile's
//     loads. (w's slices come from L2; keeping the CTA's w block resident
//     in shared memory measured no faster and stalled the ring whenever a
//     CTA changed N tile.)
//   - Consumers run wgmma m64nBNk16 (bf16 in, f32 accumulators in
//     registers), keeping one group in flight.
//   - Epilogue: y is rounded to bf16 in registers, staged swizzled in
//     shared memory (two buffers) and written with TMA stores (clipped at M
//     and N). The statistics come from the accumulator registers: each
//     thread adds rows r and r + 8 of its columns, a reduce-scatter of warp
//     shuffles over the 8 lanes holding the same columns leaves each lane
//     BN/32 columns, which it carries in registers across the CTA's M
//     tiles. The f32 tile is never staged.
//   - At its end, one shared-memory step over the warps leaves one (2, BN)
//     partial row per CTA. The last CTA of the N tile to finish (integer
//     ticket, stat_finish.cuh) adds the N tile's rows in CTA order. One
//     launch, no float atomics: the statistics are the same bits on every
//     call.
// * wmma (the other bf16 shapes) and fma (float32): one 128x128 (64x64)
//   tile per CTA, statistics from the staged f32 tile (fma: from
//   registers), the same ticketed finish over the row tiles.
// Tails in M, N and K are zero-filled on load (TMA does it for the wgmma
// route): a zero row adds nothing to the sums. Stores are clipped.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "stat_finish.cuh"

using namespace nvcuda;

namespace {

// ---- wgmma route ---------------------------------------------------------
namespace hop {

constexpr int BK = 64;               // K per slice: 64 bf16 = one 128-byte row
constexpr int SLICE_ROW_BYTES = 128;
constexpr int MAX_STAGES = 8;

__host__ __device__ constexpr int consumer_threads(int bm) { return bm / 64 * 128; }
__host__ __device__ constexpr int block_threads(int bm) { return consumer_threads(bm) + 32; }

// Statistics scratch: the warps' (2, BN) rows, or add_partial_rows'
// consumer threads x 4 floats.
__host__ __device__ constexpr int red_floats(int bm, int bn) {
  return bm / 16 * 2 * bn > 8 * bm ? bm / 16 * 2 * bn : 8 * bm;
}
// Dynamic shared memory of one CTA, 1024 bytes of alignment slack first:
// [x ring: stages x BM rows][w ring: stages x BN rows]
// [y staging: 2 x BM x BN bf16][statistics scratch][mbarriers full, empty][flag]
// ops/conv1x1_stats.py:wgmma_smem_bytes mirrors it.
__host__ __device__ constexpr int smem_bytes(int bm, int bn, int stages) {
  return 1024 + stages * (bm + bn) * SLICE_ROW_BYTES + 2 * bm * bn * 2 +
         red_floats(bm, bn) * 4 + 2 * stages * 8 + 16;
}

// The static schedule. The grid's CTAs split into one run per N tile
// (tiles_n <= grid): CTAs [first_cta(tn), first_cta(tn + 1)) work in N tile
// tn, each on a contiguous run of its M tiles. A CTA thus stays in one N
// tile and leaves it once, at its end, and the same tiles go to the same
// CTAs on every call.
__host__ __device__ inline int first_cta(int tn, int tiles_n, int grid) {
  return (int)((long long)tn * grid / tiles_n);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count));
}

// Returns once the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// TMA: box at element coordinates (c0 innermost, c1) of `map` into shared
// memory, completing `bytes` on `bar`.
__device__ __forceinline__ void tma_load(const CUtensorMap* map, void* dst, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0,
                                          int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// wgmma operand descriptor: K-major tile of 128-byte rows with 128-byte
// swizzle (8-row atoms of 1024 bytes: stride byte offset 1024, leading byte
// offset unused). Advancing K by 16 elements adds 32 bytes to the start.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across a
// wgmma wait or issue.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_bn(float (&d)[BN / 2], uint64_t a, uint64_t b,
                                         int scale_d) {
  if constexpr (BN == 64) wgmma_m64n64(d, a, b, scale_d);
  else wgmma_m64n128(d, a, b, scale_d);
}

// One step of reduce_scatter: lanes that differ in bit MASK swap halves of
// v[0 .. 2 * HALF); each keeps its half (the upper one if its bit is set)
// plus the partner's copy of it in v[0 .. HALF).
template <int HALF, int MASK, int N>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[N], int lane) {
  const bool upper = (lane & MASK) != 0;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? v[i] : v[i + HALF];
    const float keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, MASK);
  }
}

// Sums v over the 8 lanes of a warp that differ in lane bits 4, 3 and 2,
// scattered: afterwards v[0 .. N/8) of lane l holds the sums of its entries
// (i + offset(l)), offset(l) = bit4 * N/2 + bit3 * N/4 + bit2 * N/8:
// N/2 + N/4 + N/8 shuffles, in a fixed order. (Each step is its own
// template so that every index is a compile-time constant and v stays in
// registers.)
template <int N>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane) {
  reduce_scatter_step<N / 2, 16>(v, lane);
  reduce_scatter_step<N / 4, 8>(v, lane);
  reduce_scatter_step<N / 8, 4>(v, lane);
}

// Accumulator fragment of wgmma m64nN (f32), per thread of a warpgroup:
// d[4j + e] holds row 16 * warp + lane / 4 + 8 * (e / 2) and column
// 8j + 2 * (lane % 4) + e % 2. Lanes with the same lane % 4 hold the same
// columns.
template <int BM, int BN>
__global__ void __launch_bounds__(block_threads(BM), BM == 64 ? 2 : 1)
conv1x1_stats_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                           const __grid_constant__ CUtensorMap w_map,
                           const __grid_constant__ CUtensorMap y_map, int m, int n, int k,
                           int stages, float* __restrict__ partial,
                           unsigned int* __restrict__ tickets, float* __restrict__ out) {
  constexpr int CONSUMERS = consumer_threads(BM);
  constexpr int CONSUMER_WARPS = CONSUMERS / 32;
  constexpr int A_BYTES = BM * SLICE_ROW_BYTES;  // one x slice
  constexpr int B_BYTES = BN * SLICE_ROW_BYTES;  // one w slice
  constexpr int R = BN / 2;                      // accumulators per thread
  constexpr int C = BN / 4;                      // columns per thread

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int k_slices = (k + BK - 1) / BK;
  unsigned char* sa = base;
  unsigned char* sb = sa + stages * A_BYTES;
  unsigned char* sy = sb + stages * B_BYTES;
  float* red = reinterpret_cast<float*>(sy + 2 * BM * BN * 2);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + red_floats(BM, BN));
  uint64_t* empty = full + stages;
  int* flag = reinterpret_cast<int*>(empty + stages);

  const int tiles_m = (m + BM - 1) / BM, tiles_n = (n + BN - 1) / BN;
  const int grid = gridDim.x;
  // this CTA's N tile tn and M tiles [tm_begin, tm_end)
  const int tn = (int)(((long long)(blockIdx.x + 1) * tiles_n - 1) / grid);
  const int first = first_cta(tn, tiles_n, grid);
  const int visitors = first_cta(tn + 1, tiles_n, grid) - first;
  const int tm_begin = (int)((long long)(blockIdx.x - first) * tiles_m / visitors);
  const int tm_end = (int)((long long)(blockIdx.x - first + 1) * tiles_m / visitors);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    // ---- producer warp: one thread issues every TMA load ----
    if (lane != 0) return;
    int stage = 0, phase = 0;
    for (int tm = tm_begin; tm < tm_end; ++tm) {
      for (int ks = 0; ks < k_slices; ++ks) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], A_BYTES + B_BYTES);
        tma_load(&x_map, sa + stage * A_BYTES, &full[stage], ks * BK, tm * BM);
        tma_load(&w_map, sb + stage * B_BYTES, &full[stage], ks * BK, tn * BN);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  const int wg = warp / 4, wwarp = warp % 4;
  float acc[R];
  float cs[C / 8], cq[C / 8];  // this lane's share of the column sums, carried
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < C / 8; ++i) cs[i] = cq[i] = 0.0f;
  int stage = 0, phase = 0, ybuf = 0;

  for (int tm = tm_begin; tm < tm_end; ++tm) {
    // main loop: one wgmma group in flight, the slice before it released
    int prev = 0;
    for (int ks = 0; ks < k_slices; ++ks) {
      mbar_wait(&full[stage], phase);
      const uint32_t a = smem_u32(sa + stage * A_BYTES + wg * 64 * SLICE_ROW_BYTES);
      const uint32_t b = smem_u32(sb + stage * B_BYTES);
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_bn<BN>(acc, smem_desc(a + kk * 32), smem_desc(b + kk * 32), ks > 0 || kk > 0);
      wgmma_commit();
      fence_operands(acc);
      if (ks > 0) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = stage;
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_operands(acc);
    if (lane == 0) mbar_arrive(&empty[prev]);

    // statistics: this thread's rows r and r + 8 of each of its C columns,
    // then a reduce-scatter over the 8 lanes that hold the same columns
    // (lane bits 4, 3, 2): each keeps C / 8 of them and adds them to its
    // carry
    {
      float ts[C], tq[C];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float lo = acc[4 * j + e], hi = acc[4 * j + 2 + e];
          ts[2 * j + e] = lo + hi;
          tq[2 * j + e] = fmaf(hi, hi, lo * lo);
        }
      }
      reduce_scatter<C>(ts, lane);
      reduce_scatter<C>(tq, lane);
#pragma unroll
      for (int i = 0; i < C / 8; ++i) {
        cs[i] += ts[i];
        cq[i] += tq[i];
      }
    }

    // y: bf16 in registers, staged in 64x64 blocks with the 128-byte
    // swizzle of y_map, then TMA stores of this warpgroup's 64 rows; two
    // staging buffers, so one tile's stores overlap the next tile
    unsigned char* stage_y = sy + (ybuf * BM + wg * 64) * BN * 2;
    ybuf ^= 1;
    const bool issuer = threadIdx.x % 128 == 0;
    if (issuer) asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
    bar_sync(2 + wg, 128);
    const int r0 = wwarp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int blk = j / 8, grp = j % 8;  // 64-column block, 16-byte group in it
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        unsigned char* dst = stage_y + blk * 64 * SLICE_ROW_BYTES + r * SLICE_ROW_BYTES +
                             ((grp ^ (r % 8)) * 16) + (lane % 4) * 4;
        *reinterpret_cast<__nv_bfloat162*>(dst) = v;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    bar_sync(2 + wg, 128);
    if (issuer) {
      const int row0 = tm * BM + wg * 64;
      if (row0 < m) {
#pragma unroll
        for (int blk = 0; blk < BN / 64; ++blk)
          if (tn * BN + blk * 64 < n)
            tma_store(&y_map, stage_y + blk * 64 * SLICE_ROW_BYTES, tn * BN + blk * 64, row0);
      }
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
  }

  // The CTA's (2, BN) partial row, then the ticket. Lane l holds columns
  // (i + offset(l)) of its lane % 4 column set, i < C / 8.
  const int offset =
      ((lane >> 4) & 1) * (C / 2) + ((lane >> 3) & 1) * (C / 4) + ((lane >> 2) & 1) * (C / 8);
#pragma unroll
  for (int i = 0; i < C / 8; ++i) {
    const int j = offset + i;  // index into the thread's C columns
    const int col = (j / 2) * 8 + (lane % 4) * 2 + j % 2;
    red[(warp * 2 + 0) * BN + col] = cs[i];
    red[(warp * 2 + 1) * BN + col] = cq[i];
  }
  bar_sync(1, CONSUMERS);
  float* row = partial + (long long)blockIdx.x * 2 * BN;
  for (int e = threadIdx.x; e < 2 * BN; e += CONSUMERS) {  // e = stat * BN + column
    float total = 0.0f;
    for (int w = 0; w < CONSUMER_WARPS; ++w) total += red[w * 2 * BN + e];
    row[e] = total;
  }
  if (last_block_of_tile(tickets + tn, visitors, flag, 1, CONSUMERS)) {
    auto store = [&](int e, float total) {
      const int stat = e / BN, col = tn * BN + e % BN;
      if (col < n) out[(long long)stat * n + col] = total;
    };
    add_partial_rows<4, 16>(partial, 2 * BN, first, visitors, 2 * BN, store, red, 1,
                            CONSUMERS);
  }
  if (threadIdx.x % 128 == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

}  // namespace hop

// ---- wmma route: bf16 shapes TMA cannot address ---------------------------
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

// The last CTA of a column tile: out[.][n0 .. n0+tn) = the sums of the
// tile's tiles_m partial rows, (tiles_m, 2, n) float32, in row order.
__device__ __forceinline__ void finish_column_tile(const float* partial, int n, int n0, int tn,
                                                   int tiles_m, float* out, float* scratch) {
  const int width = min(tn, n - n0);
  for (int stat = 0; stat < 2; ++stat) {
    float* dst = out + (long long)stat * n + n0;
    auto store = [dst](int v, float total) { dst[v] = total; };
    add_partial_rows<1, 8>(partial + (long long)stat * n + n0, 2LL * n, 0, tiles_m, width,
                        store, scratch, 0, THREADS);
  }
}

__global__ void __launch_bounds__(THREADS)
conv1x1_stats_wmma_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ w, int m, int n, int k,
                          int vec_in, int vec_out, __nv_bfloat16* __restrict__ y,
                          float* __restrict__ partial, unsigned int* __restrict__ tickets,
                          float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [BM][LDS]
  __nv_bfloat16* Bs = As + BM * LDS;                            // [BN][LDS]
  float* Cs = reinterpret_cast<float*>(smem);                   // [BM][LDC], epilogue
  __shared__ float col_red[2][2][BN];
  __shared__ int last_flag;

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
    float* row = partial + (long long)blockIdx.y * 2 * n + n0 + col;
    row[0] = col_red[0][0][col] + col_red[0][1][col];
    row[n] = col_red[1][0][col] + col_red[1][1][col];
  }
  if (!last_block_of_tile(tickets + blockIdx.x, gridDim.y, &last_flag, 0, THREADS)) return;
  finish_column_tile(partial, n, n0, BN, gridDim.y, out, Cs);
}

// ---- float32 FMA path -------------------------------------------------------
constexpr int FM = 64, FN = 64, FK = 16;

__global__ void __launch_bounds__(THREADS)
conv1x1_stats_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                         int m, int n, int k, float* __restrict__ y,
                         float* __restrict__ partial, unsigned int* __restrict__ tickets,
                         float* __restrict__ out) {
  __shared__ float As[FK][FM + 4];  // As[kk][r] = x[m0 + r][k0 + kk]
  __shared__ float Bs[FK][FN + 4];  // Bs[kk][c] = w[n0 + c][k0 + kk]
  __shared__ float red[2][16][FN];
  __shared__ int last_flag;
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
    float* row = partial + (long long)blockIdx.y * 2 * n + n0 + threadIdx.x;
    row[0] = s;
    row[n] = q;
  }
  if (!last_block_of_tile(tickets + blockIdx.x, gridDim.y, &last_flag, 0, THREADS)) return;
  finish_column_tile(partial, n, n0, FN, gridDim.y, out, &red[0][0][0]);
}


// cuTensorMapEncodeTiled from the driver, found at run time (no -lcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 row-major (rows, cols) matrix read or written in boxes of
// box_rows x 64 columns (128 bytes, 128-byte swizzle); elements outside
// the matrix load as zero and are not stored.
bool bf16_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)hop::BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM, int BN>
int launch_wgmma(const CUtensorMap& xm, const CUtensorMap& wm, const CUtensorMap& ym, int m,
                 int n, int k, int stages, int grid, int smem, float* partial,
                 unsigned int* tickets, float* out, cudaStream_t s) {
  auto kernel = hop::conv1x1_stats_wgmma_kernel<BM, BN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, hop::block_threads(BM), smem, s>>>(xm, wm, ym, m, n, k, stages,
                                                    partial, tickets, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes. Both launch on `stream` and
// return cudaGetLastError() (0 on success) or cudaErrorInvalidValue for
// arguments they do not take; neither synchronises. out is (2, n) float32
// [sum y, sum y^2]. tickets: n_tickets unsigned counters, 0 before the
// first call (each call leaves them 0); calls sharing them must run on one
// stream.

// wgmma route. x (m, k), w (n, k), y (m, n): bf16, row-major, 16-byte
// aligned, k and n multiples of 8. The plan comes from
// ops/conv1x1_stats.py:conv1x1_plan and is checked here: bm in {64, 128},
// bn in {64, 128}, 2 <= stages <= 8,
// ceil(n/bn) <= grid <= tiles, smem_bytes as hop::smem_bytes computes it.
// partial: (grid, 2, bn) float32 scratch.
extern "C" int conv1x1_stats_wgmma_launch(const void* x, const void* w, void* y, int m, int n,
                                          int k, int bm, int bn, int stages,
                                          int grid, int smem_bytes, float* partial,
                                          unsigned int* tickets, int n_tickets, float* out,
                                          void* stream) {
  if (m < 1 || n < 1 || k < 1 || k % 8 != 0 || n % 8 != 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(y)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if ((bm != 64 && bm != 128) || (bn != 64 && bn != 128) || stages < 2 ||
      stages > hop::MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)((m + bm - 1) / bm) * ((n + bn - 1) / bn);
  if (grid < (n + bn - 1) / bn || grid > tiles || (n + bn - 1) / bn > n_tickets ||
      smem_bytes != hop::smem_bytes(bm, bn, stages) ||
      smem_bytes > 232448)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xm, wm, ym;
  if (!bf16_map(&xm, x, m, k, bm) || !bf16_map(&wm, w, n, k, bn) || !bf16_map(&ym, y, m, n, 64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 128 && bn == 128)
    return launch_wgmma<128, 128>(xm, wm, ym, m, n, k, stages, grid, smem_bytes,
                                  partial, tickets, out, s);
  if (bm == 128)
    return launch_wgmma<128, 64>(xm, wm, ym, m, n, k, stages, grid, smem_bytes,
                                 partial, tickets, out, s);
  if (bn == 128)
    return launch_wgmma<64, 128>(xm, wm, ym, m, n, k, stages, grid, smem_bytes,
                                 partial, tickets, out, s);
  return launch_wgmma<64, 64>(xm, wm, ym, m, n, k, stages, grid, smem_bytes,
                              partial, tickets, out, s);
}

// wmma (is_bf16 = 1) and fma (is_bf16 = 0) routes.
//   x: (m, k) row-major; w: (n, k) row-major; both bf16 or float32.
//   y: (m, n) in the same type.
//   vec_in: x and w 16-byte aligned and k % 8 == 0 (bf16)
//   vec_out: y 16-byte aligned and n % 8 == 0 (bf16)
//   partial: (tiles_m, 2, n) float32 scratch, tiles_m = ceil(m / tile_m)
extern "C" int conv1x1_stats_launch(const void* x, const void* w, int m, int n, int k,
                                    int is_bf16, int vec_in, int vec_out, void* y,
                                    int tiles_m, float* partial, unsigned int* tickets,
                                    int n_tickets, float* out, void* stream) {
  const int tm = is_bf16 ? BM : FM, tn = is_bf16 ? BN : FN;
  const int tiles_n = (n + tn - 1) / tn;
  if (m < 1 || n < 1 || k < 1 || tiles_m != (m + tm - 1) / tm || tiles_m > 65535 ||
      tiles_n > n_tickets)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned int)tiles_n, (unsigned int)tiles_m);
  if (is_bf16) {
    cudaError_t err = cudaFuncSetAttribute(conv1x1_stats_wmma_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    conv1x1_stats_wmma_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), m, n,
        k, vec_in, vec_out, static_cast<__nv_bfloat16*>(y), partial, tickets, out);
  } else {
    conv1x1_stats_f32_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), m, n, k,
        static_cast<float*>(y), partial, tickets, out);
  }
  return (int)cudaGetLastError();
}
