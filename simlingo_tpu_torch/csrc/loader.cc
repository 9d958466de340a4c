// Host data-loader core of the PyTorch port: batched JPEG decode and the
// InternVL2 image preprocessing (hood crop -> closest-aspect-ratio bicubic
// resize -> ImageNet normalize -> 448x448 tiles) in C++/OpenMP.
//
// The port's own copy of simlingo_tpu/native/loader.cc, with the same C ABI
// (sl_version, sl_jpeg_dims, sl_decode_jpeg_batch, sl_preprocess_jpeg_batch,
// sl_decode_crop_batch). ctypes releases the GIL for each call, so the
// trainer's prefetch threads decode in parallel.
//
// Build: kernels/_build.py build_host("loader", ["-ljpeg"]) runs
//   g++ -O3 -march=native -ffast-math -funroll-loops -fPIC -fopenmp
//       -std=c++17 -shared loader.cc -ljpeg
// at first use. Needs libjpeg's header; data/imageio.py falls back to cv2
// where it is missing. All buffers are caller-allocated; returns 0 on
// success, negative error codes otherwise.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg, error-trapped: a corrupt file must not abort the
// process -- the dataset quality gate quarantines bad routes, it can't do
// that if the loader exits).
// ---------------------------------------------------------------------------

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void err_exit(j_common_ptr cinfo) {
  ErrMgr* e = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(e->jb, 1);
}

// Decode one JPEG from memory into out (RGB, row-major). exp_h/exp_w are the
// expected static dataset dims; a mismatch is an error (the caller sized the
// buffer for them).
int decode_one(const unsigned char* buf, size_t len, unsigned char* out,
               int exp_h, int exp_w) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;  // corrupt stream
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != exp_h ||
      static_cast<int>(cinfo.output_width) != exp_w ||
      cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -3;  // unexpected geometry
  }
  const size_t stride = static_cast<size_t>(exp_w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + stride * cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// ---------------------------------------------------------------------------
// Bicubic resize, cv2-compatible (INTER_CUBIC: Catmull-Rom-like kernel with
// a = -0.75, half-pixel coordinate mapping, edge-replicate). Separable
// two-pass with precomputed per-output-column taps; float accumulation.
// ---------------------------------------------------------------------------

inline float cubic(float x) {
  constexpr float A = -0.75f;
  x = std::fabs(x);
  if (x <= 1.f) return ((A + 2.f) * x - (A + 3.f)) * x * x + 1.f;
  if (x < 2.f) return ((A * x - 5.f * A) * x + 8.f * A) * x - 4.f * A;
  return 0.f;
}

struct Taps {
  std::vector<int> idx;    // 4 per output element, clamped
  std::vector<float> w;    // 4 per output element
};

Taps make_taps(int src, int dst) {
  Taps t;
  t.idx.resize(static_cast<size_t>(dst) * 4);
  t.w.resize(static_cast<size_t>(dst) * 4);
  const double scale = static_cast<double>(src) / dst;
  for (int o = 0; o < dst; ++o) {
    const double sc = (o + 0.5) * scale - 0.5;
    const int s0 = static_cast<int>(std::floor(sc));
    const float f = static_cast<float>(sc - s0);
    float wsum = 0.f;
    for (int k = 0; k < 4; ++k) {
      const float wk = cubic(f - (k - 1));
      t.w[o * 4 + k] = wk;
      wsum += wk;
      t.idx[o * 4 + k] = std::clamp(s0 + k - 1, 0, src - 1);
    }
    for (int k = 0; k < 4; ++k) t.w[o * 4 + k] /= wsum;  // exact partition
  }
  return t;
}

// src: [sh, sw, 3] uint8 -> dst: [dh, dw, 3] float (0..255 range, unclamped
// mid-pass like cv2's float path).
void resize_bicubic(const unsigned char* src, int sh, int sw, float* dst,
                    int dh, int dw, const Taps& tx, const Taps& ty,
                    std::vector<float>& fsrc, std::vector<float>& tmp) {
  // pass 0: uint8 -> float32 once (vectorizes; doing the convert inside the
  // gathered horizontal pass defeats auto-vectorization entirely)
  fsrc.resize(static_cast<size_t>(sh) * sw * 3);
  {
    const size_t n = fsrc.size();
    float* __restrict f = fsrc.data();
    const unsigned char* __restrict s = src;
    for (size_t i = 0; i < n; ++i) f[i] = s[i];
  }
  // pass 1: horizontal, float rows -> tmp [sh, dw, 3]. The 4 taps of one
  // output pixel read 12 consecutive-ish floats; with the channel loop
  // unrolled the compiler keeps everything in registers.
  tmp.resize(static_cast<size_t>(sh) * dw * 3);
  for (int y = 0; y < sh; ++y) {
    const float* __restrict row = fsrc.data() + static_cast<size_t>(y) * sw * 3;
    float* __restrict trow = tmp.data() + static_cast<size_t>(y) * dw * 3;
    const int* __restrict ixs = tx.idx.data();
    const float* __restrict wxs = tx.w.data();
    for (int x = 0; x < dw; ++x) {
      const int* ix = ixs + x * 4;
      const float* wx = wxs + x * 4;
      const float* p0 = row + ix[0] * 3;
      const float* p1 = row + ix[1] * 3;
      const float* p2 = row + ix[2] * 3;
      const float* p3 = row + ix[3] * 3;
      const float w0 = wx[0], w1 = wx[1], w2 = wx[2], w3 = wx[3];
      trow[x * 3 + 0] = w0 * p0[0] + w1 * p1[0] + w2 * p2[0] + w3 * p3[0];
      trow[x * 3 + 1] = w0 * p0[1] + w1 * p1[1] + w2 * p2[1] + w3 * p3[1];
      trow[x * 3 + 2] = w0 * p0[2] + w1 * p1[2] + w2 * p2[2] + w3 * p3[2];
    }
  }
  // pass 2: vertical, tmp -> dst (fully vectorizable: 4 streaming rows)
  for (int y = 0; y < dh; ++y) {
    const int* iy = &ty.idx[y * 4];
    const float* wy = &ty.w[y * 4];
    const float* __restrict r0 = tmp.data() + static_cast<size_t>(iy[0]) * dw * 3;
    const float* __restrict r1 = tmp.data() + static_cast<size_t>(iy[1]) * dw * 3;
    const float* __restrict r2 = tmp.data() + static_cast<size_t>(iy[2]) * dw * 3;
    const float* __restrict r3 = tmp.data() + static_cast<size_t>(iy[3]) * dw * 3;
    const float w0 = wy[0], w1 = wy[1], w2 = wy[2], w3 = wy[3];
    float* __restrict drow = dst + static_cast<size_t>(y) * dw * 3;
    for (int i = 0; i < dw * 3; ++i)
      drow[i] = w0 * r0[i] + w1 * r1[i] + w2 * r2[i] + w3 * r3[i];
  }
}

constexpr float kMean[3] = {0.485f, 0.456f, 0.406f};
constexpr float kStd[3] = {0.229f, 0.224f, 0.225f};

// Per-thread scratch that persists across calls. Fresh std::vectors per call
// cost ~15 ms/call in page faults alone (>M_MMAP_THRESHOLD allocations are
// mmap'd and returned to the kernel on free, so every call re-faults ~13 MB).
struct Scratch {
  std::vector<unsigned char> rgb;
  std::vector<float> fsrc, tmp, resized;
};

Scratch& scratch() {
  static thread_local Scratch s;
  return s;
}

}  // namespace

extern "C" {

int sl_version() { return 1; }

// Geometry probe (header only): h/w of a JPEG stream.
int sl_jpeg_dims(const unsigned char* buf, size_t len, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode n same-sized JPEGs into out [n, h, w, 3] uint8 RGB, OpenMP-parallel.
// Returns 0, or the first nonzero per-image error code.
int sl_decode_jpeg_batch(const unsigned char** bufs, const size_t* lens,
                         int n, unsigned char* out, int h, int w) {
  int rc = 0;
  const size_t img = static_cast<size_t>(h) * w * 3;
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < n; ++i) {
    int r = decode_one(bufs[i], lens[i], out + img * i, h, w);
    if (r != 0) {
#pragma omp critical
      if (rc == 0) rc = r;
    }
  }
  return rc;
}

// Full InternVL2 preprocess: decode -> optional hood crop (bottom 4.8/16) ->
// bicubic resize to (S*gh, S*gw) -> /255, ImageNet normalize -> row-major
// S x S tiles. out: [n, gh*gw, S, S, 3] float32. src_h/src_w are the raw
// frame dims (pre-crop).
int sl_preprocess_jpeg_batch(const unsigned char** bufs, const size_t* lens,
                             int n, int src_h, int src_w, int S, int gw,
                             int gh, int do_crop, float* out) {
  // matches image_pipe.bottom_crop exactly: h - (h*4.8)//16 (floor division)
  const int ch = do_crop
      ? src_h - static_cast<int>(std::floor(src_h * 4.8 / 16.0))
      : src_h;
  const int dh = S * gh, dw = S * gw;
  const Taps tx = make_taps(src_w, dw), ty = make_taps(ch, dh);
  const size_t raw = static_cast<size_t>(src_h) * src_w * 3;
  const size_t per_img = static_cast<size_t>(gh) * gw * S * S * 3;
  int rc = 0;
  // normalize folded to one FMA/element: clamp(v)*scale[c] - bias[c]
  float scale[3], bias[3];
  for (int c = 0; c < 3; ++c) {
    scale[c] = 1.f / (255.f * kStd[c]);
    bias[c] = kMean[c] / kStd[c];
  }
#pragma omp parallel
  {
    Scratch& s = scratch();
    s.rgb.resize(raw);
    s.resized.resize(static_cast<size_t>(dh) * dw * 3);
    std::vector<unsigned char>& rgb = s.rgb;
    std::vector<float>& resized = s.resized;
    std::vector<float>& fsrc = s.fsrc;
    std::vector<float>& tmp = s.tmp;
#pragma omp for schedule(dynamic)
    for (int i = 0; i < n; ++i) {
      int r = decode_one(bufs[i], lens[i], rgb.data(), src_h, src_w);
      if (r != 0) {
#pragma omp critical
        if (rc == 0) rc = r;
        continue;
      }
      // crop is a prefix of rows: just pass ch as the source height
      resize_bicubic(rgb.data(), ch, src_w, resized.data(), dh, dw, tx, ty,
                     fsrc, tmp);
      float* o = out + per_img * i;
      for (int ty_i = 0; ty_i < gh; ++ty_i)
        for (int tx_i = 0; tx_i < gw; ++tx_i) {
          float* tile = o + (static_cast<size_t>(ty_i) * gw + tx_i) * S * S * 3;
          for (int y = 0; y < S; ++y) {
            const float* __restrict srow =
                resized.data() +
                (static_cast<size_t>(ty_i * S + y) * dw + tx_i * S) * 3;
            float* __restrict drow = tile + static_cast<size_t>(y) * S * 3;
            for (int x = 0; x < S * 3; x += 3)
              for (int c = 0; c < 3; ++c) {
                // cv2's uint8 resize clamps to [0,255] before the /255
                const float v = std::clamp(srow[x + c], 0.f, 255.f);
                drow[x + c] = v * scale[c] - bias[c];
              }
          }
        }
    }
  }
  return rc;
}

// Decode + hood crop only (uint8 out) -- feeds the fused on-device
// preprocess path (image_pipe.preprocess_device), where resize/normalize
// run on the TPU inside the training step. out: [n, ch, w, 3] with
// ch = src_h - (src_h*4.8)//16 when do_crop.
int sl_decode_crop_batch(const unsigned char** bufs, const size_t* lens,
                         int n, int src_h, int src_w, int do_crop,
                         unsigned char* out) {
  const int ch = do_crop
      ? src_h - static_cast<int>(std::floor(src_h * 4.8 / 16.0))
      : src_h;
  const size_t raw = static_cast<size_t>(src_h) * src_w * 3;
  const size_t cropped = static_cast<size_t>(ch) * src_w * 3;
  int rc = 0;
#pragma omp parallel
  {
    std::vector<unsigned char>& rgb = scratch().rgb;
    rgb.resize(raw);
#pragma omp for schedule(dynamic)
    for (int i = 0; i < n; ++i) {
      int r = decode_one(bufs[i], lens[i], rgb.data(), src_h, src_w);
      if (r != 0) {
#pragma omp critical
        if (rc == 0) rc = r;
        continue;
      }
      std::memcpy(out + cropped * i, rgb.data(), cropped);
    }
  }
  return rc;
}

}  // extern "C"
