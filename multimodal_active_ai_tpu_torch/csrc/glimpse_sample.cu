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
// sample, so one thread computes one output point (b, l, p) for all three
// channels, gathering its taps straight from the channel-interleaved mip
// (the window start is clamped to [0, M - win] as XLA's dynamic_slice
// does). A tap whose hat weight is zero is never read: at ry = win - 1 with
// sy + win = M the row below lies outside the mip. All levels run in one
// launch; their pointers, sizes and windows travel in a by-value struct,
// read in place from the parameter space (__grid_constant__).
//
// Bound. Per launch on the main path (B=128, L=4, P=900) the function must
// write 5.5 MB of f32 output and read 5.5 MB of f32 rel_y/rel_x/scale plus
// the mip pixels its taps touch (at most 4 pixels x 6 bytes per point): it
// moves bytes and does about 30 flops per point, so it is bound by memory
// bandwidth. Threads with consecutive p store consecutive addresses; the
// gathers are 2-byte loads that neighbouring points mostly share in L1/L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define GS_MAX_LEVELS 8

struct GlimpseLevels {
  const __nv_bfloat16* mip[GS_MAX_LEVELS];  // (src_batch, M, 3M) row-major
  int msize[GS_MAX_LEVELS];
  int win[GS_MAX_LEVELS];
};

__device__ __forceinline__ void accumulate_tap(const __nv_bfloat16* px, float w,
                                               float& a0, float& a1, float& a2) {
  a0 += w * __bfloat162float(px[0]);
  a1 += w * __bfloat162float(px[1]);
  a2 += w * __bfloat162float(px[2]);
}

__global__ void glimpse_sample_kernel(const __grid_constant__ GlimpseLevels lv,
                                      int levels, int src_batch,
                                      int points, long long total,
                                      const float* __restrict__ rel_y,
                                      const float* __restrict__ rel_x,
                                      const int* __restrict__ start,
                                      const float* __restrict__ scale,
                                      float* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  // idx enumerates (b, l, p) with p fastest: the (B, L, P) input offset.
  const int p = (int)(idx % points);
  const long long bl = idx / points;
  const int l = (int)(bl % levels);
  const long long b = bl / levels;

  const int m = lv.msize[l];
  const int win = lv.win[l];
  const int sy = min(max(start[2 * bl], 0), m - win);
  const int sx = min(max(start[2 * bl + 1], 0), m - win);

  const float ry = fminf(fmaxf(rel_y[idx], 0.0f), (float)(win - 1));
  const float sxf = (float)sx;
  const float rxa = fminf(fmaxf(rel_x[idx] + sxf, sxf), sxf + (float)(win - 1));
  const float y0f = floorf(ry);
  const float x0f = floorf(rxa);
  const float fy = ry - y0f;
  const float fx = rxa - x0f;
  const int y0 = sy + (int)y0f;
  const int x0 = (int)x0f;

  const long long row = 3LL * m;
  const __nv_bfloat16* r0 =
      lv.mip[l] + (b % src_batch) * (long long)m * row + (long long)y0 * row + 3LL * x0;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  accumulate_tap(r0, (1.0f - fy) * (1.0f - fx), a0, a1, a2);
  if (fx > 0.0f) accumulate_tap(r0 + 3, (1.0f - fy) * fx, a0, a1, a2);
  if (fy > 0.0f) {
    const __nv_bfloat16* r1 = r0 + row;
    accumulate_tap(r1, fy * (1.0f - fx), a0, a1, a2);
    if (fx > 0.0f) accumulate_tap(r1 + 3, fy * fx, a0, a1, a2);
  }

  const float s = scale[idx];
  float* o = out + (bl * 3) * points + p;  // out[b, 3l + c, p]
  o[0] = a0 * s;
  o[points] = a1 * s;
  o[2 * points] = a2 * s;
}

// Plain C entry point, loaded with ctypes. ``mips`` is a host array of
// ``levels`` device pointers. Launches on ``stream`` and returns
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int glimpse_sample_launch(const void* const* mips, const int* msizes,
                                     const int* wins, int levels, int batch,
                                     int src_batch, int points, const float* rel_y,
                                     const float* rel_x, const int* start,
                                     const float* scale, float* out, void* stream) {
  if (levels < 1 || levels > GS_MAX_LEVELS || batch < 1 || src_batch < 1 ||
      points < 1 || batch % src_batch != 0)
    return (int)cudaErrorInvalidValue;
  GlimpseLevels lv = {};
  for (int l = 0; l < levels; ++l) {
    if (wins[l] < 1 || wins[l] > msizes[l]) return (int)cudaErrorInvalidValue;
    lv.mip[l] = static_cast<const __nv_bfloat16*>(mips[l]);
    lv.msize[l] = msizes[l];
    lv.win[l] = wins[l];
  }
  const long long total = (long long)batch * levels * points;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  glimpse_sample_kernel<<<(unsigned int)blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      lv, levels, src_batch, points, total, rel_y, rel_x, start, scale, out);
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
// Design and bound as glimpse_sample: one thread per (b, p), at most 2x2
// bf16 taps (a tap with zero weight is never read), y contracted first per
// column as the TPU kernel does, f32 accumulation. A thread stores its three
// channels next to each other, so a warp writes 384 contiguous bytes. Bound
// by memory bandwidth.

__global__ void hat_sample_kernel(const __nv_bfloat16* __restrict__ mip, int m, int win,
                                  int points, long long total,
                                  const float* __restrict__ rel,
                                  const int* __restrict__ start,
                                  float* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long b = idx / points;
  const int sy = min(max(start[2 * b], 0), m - win);
  const int sx = min(max(start[2 * b + 1], 0), m - win);

  const float ry = fminf(fmaxf(rel[2 * idx], 0.0f), (float)(win - 1));
  const float sxf = (float)sx;
  const float rxa = fminf(fmaxf(rel[2 * idx + 1] + sxf, sxf), sxf + (float)(win - 1));
  const float y0f = floorf(ry);
  const float x0f = floorf(rxa);
  const float fy = ry - y0f;
  const float fx = rxa - x0f;
  const float wy0 = __bfloat162float(__float2bfloat16(1.0f - fy));
  const float wy1 = __bfloat162float(__float2bfloat16(fy));

  const long long row = 3LL * m;
  const __nv_bfloat16* r0 =
      mip + b * (long long)m * row + (long long)(sy + (int)y0f) * row + 3LL * (int)x0f;
  // t = y-contracted column x0 (and x0 + 1 when its weight is nonzero)
  float t0[3], t1[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < 3; ++c) t0[c] = wy0 * __bfloat162float(r0[c]);
  if (fx > 0.0f) {
#pragma unroll
    for (int c = 0; c < 3; ++c) t1[c] = wy0 * __bfloat162float(r0[3 + c]);
  }
  if (fy > 0.0f) {
    const __nv_bfloat16* r1 = r0 + row;
#pragma unroll
    for (int c = 0; c < 3; ++c) t0[c] += wy1 * __bfloat162float(r1[c]);
    if (fx > 0.0f) {
#pragma unroll
      for (int c = 0; c < 3; ++c) t1[c] += wy1 * __bfloat162float(r1[3 + c]);
    }
  }
  float* o = out + 3 * idx;
#pragma unroll
  for (int c = 0; c < 3; ++c) o[c] = (1.0f - fx) * t0[c] + fx * t1[c];
}

// Plain C entry point, loaded with ctypes. mip (batch, m, 3m) bf16, rel
// (batch, points, 2) f32 window-relative (y, x), start (batch, 2) int32, out
// (batch, points, 3) f32. Launches on ``stream`` and returns
// cudaGetLastError() (0 on success); does not synchronise.
extern "C" int hat_sample_launch(const void* mip, int batch, int m, int win, int points,
                                 const float* rel, const int* start, float* out,
                                 void* stream) {
  if (batch < 1 || points < 1 || win < 1 || win > m) return (int)cudaErrorInvalidValue;
  const long long total = (long long)batch * points;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  hat_sample_kernel<<<(unsigned int)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(mip), m, win, points, total, rel, start, out);
  return (int)cudaGetLastError();
}
