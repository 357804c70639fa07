// Native host data runtime: threaded JPEG decode + resize to fixed canvases.
//
// The port's copy of the JAX package's runtime/loader.cc, unchanged in what
// it computes, so that both packages decode a file to the same pixels and a
// canvas cache written by one serves the other. It plays the part of the
// reference's DALI decode and resize (NVIDIA_DALI_Pipelines.py:
// ops.ImageDecoder / ops.Resize) on the host CPU: libjpeg with DCT-domain
// prescaling (scale_num/scale_denom, which skips most of the IDCT work for
// large images), a bilinear resample to the exact canvas, and a thread pool
// for batch decode. Plain C ABI, loaded with ctypes by
// multimodal_active_ai_tpu_torch/data/native.py, which builds it with the
// Makefile beside this file at first use.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Bilinear resample RGB u8 (h_in, w_in) -> (canvas, canvas).
// Fixed-point (8.8) with the per-column taps precomputed once: the x mapping
// is identical for every row, and integer MACs vectorize where float
// round-tripping per pixel does not.
void resize_bilinear(const uint8_t* in, int h_in, int w_in, uint8_t* out,
                     int canvas) {
  if (h_in == canvas && w_in == canvas) {  // decode landed on the canvas
    std::memcpy(out, in, static_cast<size_t>(canvas) * canvas * 3);
    return;
  }
  const float sy = static_cast<float>(h_in) / canvas;
  const float sx = static_cast<float>(w_in) / canvas;
  std::vector<int> x0s(canvas), x1s(canvas);
  std::vector<int> wxs(canvas);  // 8-bit fraction
  for (int x = 0; x < canvas; ++x) {
    float fx = (x + 0.5f) * sx - 0.5f;
    fx = std::max(0.0f, std::min(fx, static_cast<float>(w_in - 1)));
    const int x0 = static_cast<int>(fx);
    x0s[x] = x0 * 3;
    x1s[x] = std::min(x0 + 1, w_in - 1) * 3;
    wxs[x] = static_cast<int>((fx - x0) * 256.0f + 0.5f);
  }
  for (int y = 0; y < canvas; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    fy = std::max(0.0f, std::min(fy, static_cast<float>(h_in - 1)));
    const int y0 = static_cast<int>(fy);
    const int y1 = std::min(y0 + 1, h_in - 1);
    const int wy = static_cast<int>((fy - y0) * 256.0f + 0.5f);
    uint8_t* row_out = out + static_cast<size_t>(y) * canvas * 3;
    const uint8_t* r0 = in + static_cast<size_t>(y0) * w_in * 3;
    const uint8_t* r1 = in + static_cast<size_t>(y1) * w_in * 3;
    for (int x = 0; x < canvas; ++x) {
      const int a = x0s[x], b = x1s[x], wx = wxs[x];
      for (int c = 0; c < 3; ++c) {
        const int top = (r0[a + c] << 8) + (r0[b + c] - r0[a + c]) * wx;
        const int bot = (r1[a + c] << 8) + (r1[b + c] - r1[a + c]) * wx;
        const int v = (top << 8) + (bot - top) * wy;  // 16-bit fraction
        row_out[x * 3 + c] = static_cast<uint8_t>((v + (1 << 15)) >> 16);
      }
    }
  }
}

// Decode one JPEG file to an RGB canvas. Returns 0 on success.
int decode_one(const char* path, int canvas, uint8_t* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  std::vector<uint8_t> pixels;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return 2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;

  // DCT-domain prescale: pick the smallest 1/1..1/8 scale that stays >= canvas,
  // so the expensive IDCT runs at a fraction of full resolution.
  cinfo.scale_num = 1;
  cinfo.scale_denom = 1;
  for (int denom = 8; denom >= 1; --denom) {
    if (static_cast<int>(cinfo.image_width) / denom >= canvas &&
        static_cast<int>(cinfo.image_height) / denom >= canvas) {
      cinfo.scale_denom = denom;
      break;
    }
  }
  cinfo.dct_method = JDCT_IFAST;
  jpeg_start_decompress(&cinfo);

  const int w = cinfo.output_width;
  const int h = cinfo.output_height;
  const int ch = cinfo.output_components;
  pixels.resize(static_cast<size_t>(w) * h * 3);
  if (ch == 3) {  // decode straight into the pixel buffer (no row copy)
    while (cinfo.output_scanline < cinfo.output_height) {
      uint8_t* rowptr =
          pixels.data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
      jpeg_read_scanlines(&cinfo, &rowptr, 1);
    }
  } else {  // grayscale -> RGB
    std::vector<uint8_t> rowbuf(static_cast<size_t>(w) * ch);
    while (cinfo.output_scanline < cinfo.output_height) {
      uint8_t* rowptr = rowbuf.data();
      jpeg_read_scanlines(&cinfo, &rowptr, 1);
      uint8_t* dst = pixels.data() +
                     static_cast<size_t>(cinfo.output_scanline - 1) * w * 3;
      for (int x = 0; x < w; ++x) {
        dst[x * 3] = dst[x * 3 + 1] = dst[x * 3 + 2] = rowbuf[x * ch];
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);

  resize_bilinear(pixels.data(), h, w, out, canvas);
  return 0;
}

}  // namespace

extern "C" {

// Decode a single file. Returns 0 on success.
int maai_decode_resize(const char* path, int canvas, uint8_t* out) {
  return decode_one(path, canvas, out);
}

// Decode a batch with a thread pool. `out` is (n, canvas, canvas, 3) u8;
// ok[i] set to 1 on success, 0 on failure (caller falls back per-file).
void maai_decode_batch(const char** paths, int n, int canvas, uint8_t* out,
                       int* ok, int num_threads) {
  if (num_threads < 1) num_threads = 1;
  std::atomic<int> next(0);
  const size_t stride = static_cast<size_t>(canvas) * canvas * 3;
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      ok[i] = decode_one(paths[i], canvas, out + stride * i) == 0 ? 1 : 0;
    }
  };
  std::vector<std::thread> threads;
  const int t = std::min(num_threads, n);
  threads.reserve(t);
  for (int i = 0; i < t; ++i) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

int maai_runtime_version() { return 1; }

}  // extern "C"
