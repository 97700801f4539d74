// Native host-side image pipeline: threaded JPEG decode + antialiased
// resize + center crop + normalize, emitting ready-to-ship float32 (or raw
// uint8) tensors.
//
// The PyTorch port's own copy of dss_ml_at_scale_tpu/native/image_pipeline.cpp
// (the port imports nothing of the JAX package); the arithmetic is the same,
// so both decode a JPEG to the same bytes. It replaces the per-row PIL
// decode + resize + crop + normalize that the reference runs inside
// Petastorm reader workers
// (deep_learning/2.distributed-data-loading-petastorm.py:282-296). The decode
// pool is C++ (libjpeg + std::thread) so Python's GIL never serializes it;
// the ctypes caller releases the GIL for the whole batch.
//
// Resize matches PIL's BILINEAR resample (separable triangle filter with
// support widened by the downscale factor, i.e. antialiased), which is what
// torchvision Resize uses on PIL images, so the native and Python paths are
// numerically interchangeable.

#include <cstddef>  // jpeglib.h uses size_t/FILE without including them
#include <cstdio>

#include "jpeglib.h"  // vendored beside this file (README.libjpeg)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- errors --
struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

void jpeg_silent(j_common_ptr, int) {}
void jpeg_silent_msg(j_common_ptr) {}

// ---------------------------------------------------------------- decode --
// Decode JPEG bytes to RGB8. Returns false on any codec error.
// min_side_target > 0 enables DCT-domain scaling (PIL draft-mode
// equivalent): decode directly at the largest m/8 scale whose shorter
// side still covers the target, skipping most IDCT + colorspace work for
// large sources. The antialiased resize then runs on the scaled output,
// so the final tensor differs slightly from the full-decode path.
bool decode_rgb(const unsigned char* data, unsigned long size,
                std::vector<uint8_t>* out, int* w, int* h,
                int min_side_target) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_error_exit;
  err.mgr.emit_message = jpeg_silent;
  err.mgr.output_message = jpeg_silent_msg;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data), size);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  // Grayscale/YCbCr upconvert to RGB in-library; CMYK/YCCK are not
  // convertible here -> fail so the caller can fall back.
  if (cinfo.jpeg_color_space == JCS_CMYK || cinfo.jpeg_color_space == JCS_YCCK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  // Hostile-input cap must bind on the SOURCE dims: DCT scaling shrinks
  // output_width/height, but entropy-decoding a multi-gigapixel stream
  // still burns its full cost — reject before start_decompress either way.
  if (static_cast<long long>(cinfo.image_width) * cinfo.image_height >
      (512LL << 20)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  if (min_side_target > 0) {
    unsigned int min_side = std::min(cinfo.image_width, cinfo.image_height);
    if (min_side > static_cast<unsigned int>(min_side_target)) {
      // Smallest m in [1, 8] with ceil(min_side * m / 8) >= target.
      unsigned int m = 8;
      while (m > 1 &&
             (static_cast<unsigned long>(min_side) * (m - 1) + 7) / 8 >=
                 static_cast<unsigned long>(min_side_target)) {
        --m;
      }
      cinfo.scale_num = m;
      cinfo.scale_denom = 8;
    }
  }
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  // Cap decoded size at 512 MP (~1.5 GB RGB): beyond this is corrupt or
  // hostile input; flag it for the caller's fallback instead of allocating.
  if (*w <= 0 || *h <= 0 || cinfo.output_components != 3 ||
      static_cast<long long>(*w) * *h > (512LL << 20)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  out->resize(static_cast<size_t>(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out->data() + static_cast<size_t>(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ---------------------------------------------------------------- resize --
// One axis of PIL-style antialiased triangle-filter resampling:
// precomputed bounds + normalized weights per output pixel.
struct FilterAxis {
  std::vector<int> xmin, xlen;
  std::vector<float> weights;  // flattened, kmax per output pixel
  int kmax = 0;
};

FilterAxis build_axis(int in_size, int out_size) {
  FilterAxis ax;
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = filterscale;  // triangle filter support = 1.0 * filterscale
  ax.kmax = static_cast<int>(std::ceil(support)) * 2 + 1;
  ax.xmin.resize(out_size);
  ax.xlen.resize(out_size);
  ax.weights.assign(static_cast<size_t>(out_size) * ax.kmax, 0.f);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    int x0 = std::max(0, static_cast<int>(center - support + 0.5));
    int x1 = std::min(in_size, static_cast<int>(center + support + 0.5));
    double total = 0.0;
    float* w = &ax.weights[static_cast<size_t>(xx) * ax.kmax];
    for (int x = x0; x < x1; ++x) {
      double t = std::abs((x - center + 0.5) / filterscale);
      double v = t < 1.0 ? 1.0 - t : 0.0;
      w[x - x0] = static_cast<float>(v);
      total += v;
    }
    if (total > 0) {
      for (int k = 0; k < x1 - x0; ++k) w[k] = static_cast<float>(w[k] / total);
    }
    ax.xmin[xx] = x0;
    ax.xlen[xx] = x1 - x0;
  }
  return ax;
}

// Separable resize RGB8 (h×w) -> virtual (oh×ow), materializing ONLY the
// crop window [left,left+cw)×[top,top+ch) as float RGB in [0,255]. The
// reference pipeline resizes the whole image and then center-crops
// (deep_learning/2...py:282-296); restricting the resample to the pixels
// the crop keeps is output-identical and skips ~30-50% of the work.
void resize_crop(const uint8_t* src, int w, int h, int ow, int oh, int left,
                 int top, int cw, int ch, std::vector<float>* dst) {
  FilterAxis hx = build_axis(w, ow);
  FilterAxis vx = build_axis(h, oh);
  // Input-row span the vertical pass will touch for rows [top, top+ch).
  int y_in0 = vx.xmin[top];
  int y_in1 = vx.xmin[top + ch - 1] + vx.xlen[top + ch - 1];
  int th = y_in1 - y_in0;
  // Horizontal pass: rows [y_in0, y_in1), cols [left, left+cw) only.
  std::vector<float> tmp(static_cast<size_t>(th) * cw * 3);
  for (int y = 0; y < th; ++y) {
    const uint8_t* srow = src + static_cast<size_t>(y_in0 + y) * w * 3;
    float* trow = tmp.data() + static_cast<size_t>(y) * cw * 3;
    for (int xi = 0; xi < cw; ++xi) {
      int xx = left + xi;
      const float* wts = &hx.weights[static_cast<size_t>(xx) * hx.kmax];
      int x0 = hx.xmin[xx], n = hx.xlen[xx];
      float r = 0, g = 0, b = 0;
      for (int k = 0; k < n; ++k) {
        const uint8_t* p = srow + static_cast<size_t>(x0 + k) * 3;
        float wk = wts[k];
        r += wk * p[0];
        g += wk * p[1];
        b += wk * p[2];
      }
      trow[xi * 3 + 0] = r;
      trow[xi * 3 + 1] = g;
      trow[xi * 3 + 2] = b;
    }
  }
  // Vertical pass over the window.
  dst->assign(static_cast<size_t>(ch) * cw * 3, 0.f);
  for (int yi = 0; yi < ch; ++yi) {
    int yy = top + yi;
    const float* wts = &vx.weights[static_cast<size_t>(yy) * vx.kmax];
    int y0 = vx.xmin[yy], n = vx.xlen[yy];
    float* drow = dst->data() + static_cast<size_t>(yi) * cw * 3;
    for (int k = 0; k < n; ++k) {
      const float* trow = tmp.data() + static_cast<size_t>(y0 - y_in0 + k) * cw * 3;
      float wk = wts[k];
      for (int x = 0; x < cw * 3; ++x) drow[x] += wk * trow[x];
    }
  }
}

// Python-round (half to even), matching the pure-Python path's
// `round(w * scale)` output-size computation.
int round_half_even(double v) { return static_cast<int>(std::nearbyint(v)); }

// Process one image end to end into outf (float32) or out8 (uint8, raw
// quantized [0,255] — device-side normalization path); exactly one of the
// two output pointers is non-null. CHW or HWC, crop×crop.
bool process_one(const unsigned char* jpeg, unsigned long size, int resize_to,
                 int crop, bool do_norm, const float* mean, const float* stdv,
                 bool chw, bool fast_scale, float* outf, uint8_t* out8) {
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  if (!decode_rgb(jpeg, size, &rgb, &w, &h, fast_scale ? resize_to : 0))
    return false;
  double scale = static_cast<double>(resize_to) / std::min(w, h);
  int ow = std::max(1, round_half_even(w * scale));
  int oh = std::max(1, round_half_even(h * scale));
  if (ow < crop || oh < crop) {
    // Guarantee croppability (shorter side == resize_to >= crop in practice).
    ow = std::max(ow, crop);
    oh = std::max(oh, crop);
  }
  int left = (ow - crop) / 2, top = (oh - crop) / 2;
  std::vector<float> resized;
  resize_crop(rgb.data(), w, h, ow, oh, left, top, crop, crop, &resized);
  const float inv255 = 1.0f / 255.0f;
  for (int y = 0; y < crop; ++y) {
    const float* srow = resized.data() + static_cast<size_t>(y) * crop * 3;
    for (int x = 0; x < crop; ++x) {
      for (int c = 0; c < 3; ++c) {
        // PIL converts the resampled float back to uint8 (round + clamp)
        // before ToTensor's /255; reproduce that quantization exactly.
        float q = std::nearbyint(srow[x * 3 + c]);
        q = std::min(255.f, std::max(0.f, q));
        size_t idx = chw ? (static_cast<size_t>(c) * crop + y) * crop + x
                         : (static_cast<size_t>(y) * crop + x) * 3 + c;
        if (out8 != nullptr) {
          out8[idx] = static_cast<uint8_t>(q);
        } else {
          float v = q * inv255;
          if (do_norm) v = (v - mean[c]) / stdv[c];
          outf[idx] = v;
        }
      }
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Decode+transform a batch of JPEGs into a preallocated tensor of shape
// [n, 3, crop, crop] (chw=1) or [n, crop, crop, 3] (chw=0). out_u8=0
// writes float32 (optionally normalized); out_u8=1 writes raw quantized
// uint8 [0,255] (do_norm must be 0 — normalization then belongs to the
// device program, which cuts host->device transfer 4x).
// statuses[i]: 0 = ok, 1 = decode/transform failed (caller may fall back).
// Returns the number of failures.
int dsst_decode_batch(const unsigned char* const* jpegs,
                      const unsigned long* sizes, int n, int resize_to,
                      int crop, int do_norm, const float* mean,
                      const float* stdv, int chw, int out_u8,
                      int fast_scale, void* out,
                      int n_threads, int* statuses) {
  if (n <= 0) return 0;
  if (out_u8 && do_norm) {
    // Invalid combination: fail every row THROUGH the statuses contract
    // (callers derive per-row success from statuses, not the return).
    for (int i = 0; i < n; ++i) statuses[i] = 1;
    return n;
  }
  size_t per_image = static_cast<size_t>(crop) * crop * 3;
  std::atomic<int> next(0), failures(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      bool ok;
      try {
        float* outf = out_u8 ? nullptr
                             : static_cast<float*>(out) + per_image * i;
        uint8_t* out8 = out_u8
                            ? static_cast<uint8_t*>(out) + per_image * i
                            : nullptr;
        ok = process_one(jpegs[i], sizes[i], resize_to, crop, do_norm != 0,
                         mean, stdv, chw != 0, fast_scale != 0, outf, out8);
      } catch (...) {
        // Per-image failure contract: an escaped exception (e.g. bad_alloc
        // on a pathological image) must flag the row, not terminate().
        ok = false;
      }
      statuses[i] = ok ? 0 : 1;
      if (!ok) failures.fetch_add(1);
    }
  };
  int nt = std::max(1, std::min(n_threads, n));
  if (nt == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
  }
  return failures.load();
}

// Tiny ABI check so the Python binding can verify it loaded the right .so.
int dsst_abi_version() { return 3; }

}  // extern "C"
