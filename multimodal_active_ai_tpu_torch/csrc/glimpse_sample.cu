// Multi-level windowed bilinear glimpse sampler for Hopper (sm_90a), and its
// one-level form hat_sample (at the end of this file).
//
// Replaces the TPU kernel multimodal_active_ai_tpu/ops/pallas_retina.py:
// glimpse_sample (body _glimpse_kernel_pipelined). Same function:
//
//   for each plan row b (source image b % src_batch), level l, point p:
//     ry  = clamp(rel_y[b,l,p], 0, win_l - 1)                (window-relative)
//     rxa = clamp(rel_x[b,l,p] + sx, sx, sx + win_l - 1)     (absolute)
//     out[b, 3l+c, p] = scale[b,l,p] *
//         sum_{u,v} hat(ry - u) * hat(rxa - v) * mip_l[b % src_batch, sy+u, 3v+c]
//
// with hat(t) = max(0, 1 - |t|), bf16 mip taps and f32 accumulation.
//
// Design. The TPU kernel contracts dense hat-weight matrices on the matrix
// unit over 128-lane column windows that it DMAs in ping-pong; all of that
// exists to fit Mosaic. Here the same function is at most 2x2 taps per
// sample, gathered straight from the channel-interleaved mip (the window
// start is clamped to [0, M - win] as XLA's dynamic_slice does).
//
// Work split. A block samples one chunk of at most
// GS_K * GS_MAX_THREADS = 256 points of one window: plan row b = blockIdx.x,
// level l = blockIdx.y (hat_sample: 0), chunk blockIdx.z. A thread finds its
// window origin, source image b % src_batch and row pointers from blockIdx
// once, in 32-bit integers (the row pointers by one 64-bit multiply); no
// per-point code divides. Each thread samples GS_K = 4 points. The wrapper
// chooses the routes by shape (ops/glimpse_sample.py:glimpse_sample_plan):
//   * coordinates and output, 16-byte route (P % 4 == 0, 16-byte-aligned
//     rows): the thread's points are consecutive; rel_y, rel_x and scale
//     come in as one ld.global.nc.L1::no_allocate.v4 each and each channel
//     plane goes out as one 16-byte store (hat_sample: two 16-byte loads of
//     rel, three 16-byte stores of the interleaved (P, 3) output, so a warp
//     writes 1.5 KB contiguous). Scalar route (any P): the points lie
//     blockDim.x apart, so neighbouring threads touch neighbouring words.
//   * gathers, pixel pairs (every M even, mips 4-byte aligned): the two
//     pixels (x0, x0 + 1) of a tap row are 12 bytes, read as three or four
//     aligned 32-bit words and aligned by a funnel shift, 8 loads a point.
//     2-byte taps (any M): 12 loads a point.
// A thread locates its four points, then issues all their tap loads before
// any arithmetic. No load leaves the mip and none waits on a branch: a tap
// row whose hat weight is zero re-reads row y0 (at ry = win - 1 with sy + win
// = M the row below lies outside the mip), and so does a 2-byte tap column;
// the pixel pair at x0 = M - 1 starts one pixel left. A pair's second pixel,
// weighted 0 where fx = 0, may lie just past the window but never past the
// row, and a finite mip pixel times 0 adds 0. The pixel loads carry an
// evict-last L2 policy: neighbouring points read the same pixels again, and
// the coordinate and output streams would otherwise push them out of L2
// first. __launch_bounds__ holds a thread to 64 registers, so that the main
// path's 2,048 blocks are all resident at once and the loads stay in flight
// together. tools/glimpse_kernel_costs.py times each of these parts against a
// copy without it; the numbers, and the designs that were tried and dropped,
// are in PERF.md (section 6).
//
// Bound. Per launch on the main path (B=128, L=4, P=900) the function must
// write 5.5 MB of f32 output and read 5.5 MB of f32 rel_y/rel_x/scale plus
// the mip pixels its taps touch (at most 4 pixels x 6 bytes per point): it
// moves bytes and does about 30 flops per point, so it is bound by memory
// bandwidth. All levels run in one launch; their pointers, sizes and
// windows travel in a by-value struct read in place from the parameter
// space (__grid_constant__).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define GS_MAX_LEVELS 8
#define GS_K 4              // points a thread
#define GS_MAX_THREADS 64   // threads a block
#define GS_MIN_BLOCKS 16    // blocks an SM holds at once: 64 registers a thread

struct GlimpseLevels {
  const uint16_t* mip[GS_MAX_LEVELS];  // bf16 bits, (src_batch, M, 3M) row-major
  int msize[GS_MAX_LEVELS];
  int win[GS_MAX_LEVELS];
};

__device__ __forceinline__ float bf16_bits(uint32_t v) { return __uint_as_float(v << 16); }

// Coordinates: read once, so not kept in L1; 16 or 4 bytes.
__device__ __forceinline__ float4 load_once4(const float* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ float load_once(const float* p) {
  float v;
  asm("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// Mip pixels, which neighbouring points read again: kept in L1 and, under
// an evict-last L2 policy, in L2 while the coordinate and output streams
// pass through it.
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

// 32-bit words or 2-byte taps of the mip, under L2 policy ``pol``.
__device__ __forceinline__ uint32_t load_word(const uint32_t* p, uint64_t pol) {
  uint32_t v;
  asm("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ uint32_t load_tap(const uint16_t* p, uint64_t pol) {
  uint16_t v;
  asm("ld.global.nc.L2::cache_hint.u16 %0, [%1], %2;" : "=h"(v) : "l"(p), "l"(pol));
  return v;
}

// One point's taps in its mip image: the element offset o of tap (y0, x0)
// (PAIRS: of the pixel pair that holds columns x0 and x0 + 1), the steps
// dx to column x0 + 1 and dy to row y0 + 1, and the fractions fy, fx. A
// step is 0 where that tap's weight is 0, so the tap re-reads (y0, x0) and
// nothing outside the mip is read. PAIRS: where x0 = M - 1 (then fx = 0)
// the pair starts one pixel left, dx = 1 says so, and x0 is its second
// pixel.
struct Taps {
  int o, dx, dy;
  float fy, fx;
};

template <bool PAIRS>
__device__ __forceinline__ Taps locate(float ry, float rx, int sy, float sxf, int win, int m) {
  ry = fminf(fmaxf(ry, 0.0f), (float)(win - 1));
  const float rxa = fminf(fmaxf(rx + sxf, sxf), sxf + (float)(win - 1));
  const float y0f = floorf(ry);
  const float x0f = floorf(rxa);
  const int x0 = (int)x0f, xs = PAIRS ? min(x0, m - 2) : x0;
  Taps t;
  t.fy = ry - y0f;
  t.fx = rxa - x0f;
  t.o = (sy + (int)y0f) * 3 * m + 3 * xs;
  t.dx = PAIRS ? x0 - xs : (t.fx > 0.0f ? 3 : 0);
  t.dy = t.fy > 0.0f ? 3 * m : 0;
  return t;
}

// Pixels xs and xs + 1 of one row (6 bf16 from element e) as 32-bit words:
// the words that hold them, aligned by a funnel shift where e is odd. The
// fourth word is read only where e is odd (else the third again), and then
// holds element e + 6, inside the mip because its element count is even.
__device__ __forceinline__ void pixel_pair(const uint16_t* __restrict__ img, int e,
                                           uint64_t pol, uint32_t (&a)[3]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(img) + (e >> 1);
  const int odd = e & 1;
  const uint32_t w0 = load_word(w, pol), w1 = load_word(w + 1, pol);
  const uint32_t w2 = load_word(w + 2, pol), w3 = load_word(w + 2 + odd, pol);
  a[0] = __funnelshift_r(w0, w1, 16 * odd);
  a[1] = __funnelshift_r(w1, w2, 16 * odd);
  a[2] = __funnelshift_r(w2, w3, 16 * odd);
}

// The 12 bf16 taps of one point, v[3 * tap + channel] (bits in the low
// half), taps (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1).
// PAIRS: two pixel pairs of 32-bit words (8 loads); else 12 2-byte loads.
template <bool PAIRS>
__device__ __forceinline__ void gather(const uint16_t* __restrict__ img, const Taps& t,
                                       uint64_t pol, uint32_t (&v)[12]) {
  if (PAIRS) {
    uint32_t p[2][3];
    pixel_pair(img, t.o, pol, p[0]);
    pixel_pair(img, t.o + t.dy, pol, p[1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the pair's elements 0..5 are p[r][0] lo, hi, p[r][1] lo, hi, p[r][2] lo, hi
      const uint32_t e[6] = {p[r][0] & 0xffff, p[r][0] >> 16, p[r][1] & 0xffff,
                             p[r][1] >> 16,    p[r][2] & 0xffff, p[r][2] >> 16};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        v[6 * r + c] = t.dx ? e[3 + c] : e[c];
        v[6 * r + 3 + c] = e[3 + c];
      }
    }
  } else {
    const uint16_t* r0 = img + t.o;
    const uint16_t* r1 = r0 + t.dy;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v[c] = load_tap(r0 + c, pol);
      v[3 + c] = load_tap(r0 + t.dx + c, pol);
      v[6 + c] = load_tap(r1 + c, pol);
      v[9 + c] = load_tap(r1 + t.dx + c, pol);
    }
  }
}

// A thread's points: the 16-byte route takes GS_K consecutive points (all
// inside the plan or all past its end, since P % 4 == 0), the scalar route
// GS_K points blockDim.x apart. The first is inside the plan (else the
// thread returns at once). On the scalar route a point past the end loads
// the first's coordinates (an address that exists: the loads are not
// branched around, and an asm load may be hoisted past a branch) and is not
// stored.
template <bool VEC>
__device__ __forceinline__ int first_point() {
  return blockIdx.z * (GS_K * blockDim.x) + (VEC ? GS_K * threadIdx.x : threadIdx.x);
}

template <bool VEC>
__device__ __forceinline__ int point_step() {
  return VEC ? 1 : blockDim.x;
}

template <bool VEC, bool PAIRS>
__global__ void __launch_bounds__(GS_MAX_THREADS, GS_MIN_BLOCKS)
    glimpse_sample_kernel(const __grid_constant__ GlimpseLevels lv, int levels, int src_batch,
                          int points, const float* __restrict__ rel_y,
                          const float* __restrict__ rel_x, const int* __restrict__ start,
                          const float* __restrict__ scale, float* __restrict__ out) {
  const int first = first_point<VEC>(), step = point_step<VEC>();
  if (first >= points) return;
  const int b = blockIdx.x, l = blockIdx.y;
  const size_t bl = (size_t)b * levels + l;  // the (B, L, P) row of this window

  const int m = lv.msize[l], win = lv.win[l];
  const int sy = min(max(__ldg(start + 2 * bl), 0), m - win);
  const int sx = min(max(__ldg(start + 2 * bl + 1), 0), m - win);
  const uint16_t* img = lv.mip[l] + (size_t)(b % src_batch) * m * (3 * m);
  const float* yp = rel_y + bl * points + first;
  const float* xp = rel_x + bl * points + first;
  const float* sp = scale + bl * points + first;
  const uint64_t keep = l2_evict_last();

  float ry[GS_K], rx[GS_K], s[GS_K];
  if (VEC) {
    const float4 y4 = load_once4(yp), x4 = load_once4(xp), s4 = load_once4(sp);
    ry[0] = y4.x, ry[1] = y4.y, ry[2] = y4.z, ry[3] = y4.w;
    rx[0] = x4.x, rx[1] = x4.y, rx[2] = x4.z, rx[3] = x4.w;
    s[0] = s4.x, s[1] = s4.y, s[2] = s4.z, s[3] = s4.w;
  } else {
#pragma unroll
    for (int k = 0; k < GS_K; ++k) {
      const int at = first + k * step < points ? k * step : 0;
      ry[k] = load_once(yp + at);
      rx[k] = load_once(xp + at);
      s[k] = load_once(sp + at);
    }
  }

  Taps tp[GS_K];
  uint32_t v[GS_K][12];
#pragma unroll
  for (int k = 0; k < GS_K; ++k) tp[k] = locate<PAIRS>(ry[k], rx[k], sy, (float)sx, win, m);
#pragma unroll
  for (int k = 0; k < GS_K; ++k) gather<PAIRS>(img, tp[k], keep, v[k]);

  float o[3][GS_K];
#pragma unroll
  for (int k = 0; k < GS_K; ++k) {
    const float fy = tp[k].fy, fx = tp[k].fx;
    const float w00 = (1.0f - fy) * (1.0f - fx), w01 = (1.0f - fy) * fx;
    const float w10 = fy * (1.0f - fx), w11 = fy * fx;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float a = w00 * bf16_bits(v[k][c]);
      a += w01 * bf16_bits(v[k][3 + c]);
      a += w10 * bf16_bits(v[k][6 + c]);
      a += w11 * bf16_bits(v[k][9 + c]);
      o[c][k] = a * s[k];
    }
  }

  float* op = out + 3 * bl * points + first;  // out[b, 3l + c, p]
  if (VEC) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      *reinterpret_cast<float4*>(op + c * points) =
          make_float4(o[c][0], o[c][1], o[c][2], o[c][3]);
  } else {
#pragma unroll
    for (int k = 0; k < GS_K; ++k) {
      if (first + k * step < points) {
#pragma unroll
        for (int c = 0; c < 3; ++c) op[c * points + k * step] = o[c][k];
      }
    }
  }
}

// The launch plan's own checks (ops/glimpse_sample.py:_plan makes it):
// blocks of a whole number of warps, and chunks that cover the P points
// with no chunk empty.
static bool plan_ok(int points, int vec, int threads, int chunks) {
  const long long per_block = (long long)GS_K * threads;
  return threads >= 32 && threads <= GS_MAX_THREADS && threads % 32 == 0 && chunks >= 1 &&
         chunks <= 65535 && per_block * chunks >= points &&
         per_block * (chunks - 1) < points && (!vec || points % 4 == 0);
}

static bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// Pixel pairs need 4-byte-aligned images with an even element count (M
// even) and a pair in every row (M >= 2).
static bool pairs_ok(const void* mip, int m) { return aligned(mip, 4) && m % 2 == 0; }

// Plain C entry point, loaded with ctypes. ``mips`` is a host array of
// ``levels`` device pointers; ``vec``, ``pairs``, ``threads`` and
// ``chunks`` are the wrapper's plan. Launches on ``stream`` and returns
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int glimpse_sample_launch(const void* const* mips, const int* msizes,
                                     const int* wins, int levels, int batch,
                                     int src_batch, int points, int vec, int pairs,
                                     int threads, int chunks, const float* rel_y,
                                     const float* rel_x, const int* start,
                                     const float* scale, float* out, void* stream) {
  if (levels < 1 || levels > GS_MAX_LEVELS || batch < 1 || src_batch < 1 ||
      points < 1 || batch % src_batch != 0 || !plan_ok(points, vec, threads, chunks))
    return (int)cudaErrorInvalidValue;
  if (vec && !(aligned(rel_y, 16) && aligned(rel_x, 16) && aligned(scale, 16) &&
               aligned(out, 16)))
    return (int)cudaErrorMisalignedAddress;
  GlimpseLevels lv = {};
  for (int l = 0; l < levels; ++l) {
    // offsets inside one mip image are 32-bit
    if (wins[l] < 1 || wins[l] > msizes[l] || 3LL * msizes[l] * msizes[l] > 0x7fffffffLL ||
        (pairs && !pairs_ok(mips[l], msizes[l])))
      return (int)cudaErrorInvalidValue;
    lv.mip[l] = static_cast<const uint16_t*>(mips[l]);
    lv.msize[l] = msizes[l];
    lv.win[l] = wins[l];
  }
  void (*const kernels[2][2])(GlimpseLevels, int, int, int, const float*, const float*,
                              const int*, const float*, float*) = {
      {glimpse_sample_kernel<false, false>, glimpse_sample_kernel<false, true>},
      {glimpse_sample_kernel<true, false>, glimpse_sample_kernel<true, true>}};
  kernels[vec != 0][pairs != 0]<<<dim3(batch, levels, chunks), threads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      lv, levels, src_batch, points, rel_y, rel_x, start, scale, out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// hat_sample: one level, P-major output, no scale.
//
// Replaces the TPU kernel multimodal_active_ai_tpu/ops/pallas_retina.py:
// hat_sample (body _hat_sample_kernel). Same function:
//
//   out[b, p, c] = sum_v hat(rxa - v) * sum_u bf16(hat(ry - u)) * mip[b, sy+u, 3v+c]
//
// with ry = clamp(rel[b,p,0], 0, win-1) window-relative, rxa =
// clamp(rel[b,p,1] + sx, sx, sx+win-1) absolute, and the window start
// clamped to [0, M - win] as XLA's dynamic_slice does. Unlike glimpse_sample,
// the y weights are rounded to bf16 as the TPU kernel rounds them before its
// matrix-unit contraction, so the weights agree with it bit for bit.
//
// Design and bound as glimpse_sample, one level per launch (blockIdx.y = 0):
// y contracted first per column as the TPU kernel does, f32 accumulation.
// Bound by memory bandwidth, but at one level (2.3 MB of coordinates and
// output on the main path) a launch's fixed cost is larger than the time
// the bytes take.

template <bool VEC, bool PAIRS>
__global__ void __launch_bounds__(GS_MAX_THREADS, GS_MIN_BLOCKS)
    hat_sample_kernel(const uint16_t* __restrict__ mip, int m, int win, int points,
                      const float* __restrict__ rel, const int* __restrict__ start,
                      float* __restrict__ out) {
  const int first = first_point<VEC>(), step = point_step<VEC>();
  if (first >= points) return;
  const int b = blockIdx.x;
  const int sy = min(max(__ldg(start + 2 * b), 0), m - win);
  const int sx = min(max(__ldg(start + 2 * b + 1), 0), m - win);
  const uint16_t* img = mip + (size_t)b * m * (3 * m);
  const size_t bp = (size_t)b * points + first;
  const float* rp = rel + 2 * bp;
  const uint64_t keep = l2_evict_last();

  float ry[GS_K], rx[GS_K];
  if (VEC) {
    const float4 a = load_once4(rp), c = load_once4(rp + 4);
    ry[0] = a.x, rx[0] = a.y, ry[1] = a.z, rx[1] = a.w;
    ry[2] = c.x, rx[2] = c.y, ry[3] = c.z, rx[3] = c.w;
  } else {
#pragma unroll
    for (int k = 0; k < GS_K; ++k) {
      const int at = first + k * step < points ? 2 * k * step : 0;
      ry[k] = load_once(rp + at);
      rx[k] = load_once(rp + at + 1);
    }
  }

  Taps tp[GS_K];
  uint32_t v[GS_K][12];
#pragma unroll
  for (int k = 0; k < GS_K; ++k) tp[k] = locate<PAIRS>(ry[k], rx[k], sy, (float)sx, win, m);
#pragma unroll
  for (int k = 0; k < GS_K; ++k) gather<PAIRS>(img, tp[k], keep, v[k]);

  float o[GS_K][3];
#pragma unroll
  for (int k = 0; k < GS_K; ++k) {
    const float fy = tp[k].fy, fx = tp[k].fx;
    const float wy0 = __bfloat162float(__float2bfloat16(1.0f - fy));
    const float wy1 = __bfloat162float(__float2bfloat16(fy));
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      // t0, t1: the y-contracted columns x0 and x0 + 1
      float t0 = wy0 * bf16_bits(v[k][c]);
      t0 += wy1 * bf16_bits(v[k][6 + c]);
      float t1 = wy0 * bf16_bits(v[k][3 + c]);
      t1 += wy1 * bf16_bits(v[k][9 + c]);
      o[k][c] = (1.0f - fx) * t0 + fx * t1;
    }
  }

  float* op = out + 3 * bp;  // out[b, p, c]
  if (VEC) {
    float4* o4 = reinterpret_cast<float4*>(op);
    o4[0] = make_float4(o[0][0], o[0][1], o[0][2], o[1][0]);
    o4[1] = make_float4(o[1][1], o[1][2], o[2][0], o[2][1]);
    o4[2] = make_float4(o[2][2], o[3][0], o[3][1], o[3][2]);
  } else {
#pragma unroll
    for (int k = 0; k < GS_K; ++k) {
      if (first + k * step < points) {
#pragma unroll
        for (int c = 0; c < 3; ++c) op[3 * k * step + c] = o[k][c];
      }
    }
  }
}

// Plain C entry point, loaded with ctypes. mip (batch, m, 3m) bf16, rel
// (batch, points, 2) f32 window-relative (y, x), start (batch, 2) int32, out
// (batch, points, 3) f32; ``vec``, ``pairs``, ``threads`` and ``chunks`` are
// the wrapper's plan. Launches on ``stream`` and returns cudaGetLastError()
// (0 on success); does not synchronise.
extern "C" int hat_sample_launch(const void* mip, int batch, int m, int win, int points,
                                 int vec, int pairs, int threads, int chunks,
                                 const float* rel, const int* start, float* out,
                                 void* stream) {
  if (batch < 1 || points < 1 || win < 1 || win > m || 3LL * m * m > 0x7fffffffLL ||
      !plan_ok(points, vec, threads, chunks) || (pairs && !pairs_ok(mip, m)))
    return (int)cudaErrorInvalidValue;
  if (vec && !(aligned(rel, 16) && aligned(out, 16))) return (int)cudaErrorMisalignedAddress;
  void (*const kernels[2][2])(const uint16_t*, int, int, int, const float*, const int*,
                              float*) = {
      {hat_sample_kernel<false, false>, hat_sample_kernel<false, true>},
      {hat_sample_kernel<true, false>, hat_sample_kernel<true, true>}};
  kernels[vec != 0][pairs != 0]<<<dim3(batch, 1, chunks), threads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(mip), m, win, points, rel, start, out);
  return (int)cudaGetLastError();
}
