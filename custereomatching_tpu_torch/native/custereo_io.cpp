// Native IO / host-preprocessing library for custereomatching_tpu.
//
// The reference's native layer is a C++/CUDA extension whose host side
// validates inputs, allocates buffers and launches kernels
// (reference: custma/src/stereo_matching.cpp, bindings.cpp).  On TPU the
// kernel launches belong to XLA/Mosaic, so the native runtime work that
// remains host-side is the data path: image decode, normalization,
// channel extraction, .npy parsing and tile-padding — the per-frame CPU
// work that would otherwise bottleneck a >300 fps device pipeline if left
// to interpreted Python.  Exposed as a plain C ABI consumed via ctypes
// (no pybind11 dependency).
//
// Build: see build.py in this directory (g++ -O3 -shared -fPIC, links
// libpng + zlib).

#include <png.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// PNG decode → float32 [H, W] in [0, 1]
// ---------------------------------------------------------------------------

// Returns 0 on success. On success *height/*width hold the image size.
// If out == nullptr, only the size probe is performed.  `channel` selects
// the color channel of RGB(A) inputs (the reference takes channel 0 of
// its camera frame, examples/verify.py:149); grayscale inputs ignore it.
int cst_decode_png_gray(const char* path, int channel, float* out,
                        int64_t out_capacity, int32_t* height,
                        int32_t* width) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;

  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return -2;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return -3;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    std::fclose(fp);
    return -3;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return -4;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);

  // Normalize to 8-bit RGB or gray.
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  // Adam7 support: libpng reports the pass count; with png_read_image
  // below (whole-image row pointers) the passes are handled internally.
  png_set_interlace_handling(png);
  png_read_update_info(png, info);

  *height = static_cast<int32_t>(h);
  *width = static_cast<int32_t>(w);
  if (out == nullptr) {  // size probe
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 0;
  }
  if (out_capacity < static_cast<int64_t>(h) * w) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return -5;
  }

  const size_t rowbytes = png_get_rowbytes(png, info);
  const int channels = static_cast<int>(rowbytes / w);
  const int c = (channels > 1 && channel >= 0 && channel < channels)
                    ? channel
                    : 0;
  // Whole-image read (not row streaming) so interlaced files decode
  // correctly — libpng resolves Adam7 passes across the row pointers.
  std::vector<png_byte> pixels(static_cast<size_t>(h) * rowbytes);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y) rows[y] = pixels.data() + y * rowbytes;
  png_read_image(png, rows.data());
  constexpr float kInv255 = 1.0f / 255.0f;
  for (png_uint_32 y = 0; y < h; ++y) {
    const png_byte* row = rows[y];
    float* dst = out + static_cast<int64_t>(y) * w;
    for (png_uint_32 x = 0; x < w; ++x) {
      dst[x] = static_cast<float>(row[x * channels + c]) * kInv255;
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return 0;
}

// ---------------------------------------------------------------------------
// PNG decode → raw uint16 [H, W] (no normalization)
// ---------------------------------------------------------------------------

// Decodes a PNG's raw sample values into uint16 — the KITTI ground-truth
// convention stores disparity as a 16-bit grayscale PNG with
// value = 256·disparity_px and 0 = invalid (so normalization must NOT
// happen at decode time).  8-bit inputs yield their 0..255 values
// unscaled; `channel` selects a channel of color inputs.  Same probe /
// capacity contract as cst_decode_png_gray.
int cst_decode_png_u16(const char* path, int channel, uint16_t* out,
                       int64_t out_capacity, int32_t* height,
                       int32_t* width) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;

  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return -2;
  }
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return -3;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    std::fclose(fp);
    return -3;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return -4;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);

  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_interlace_handling(png);
  // PNG 16-bit samples are big-endian on the wire; deliver host order.
  if (depth == 16) png_set_swap(png);
  png_read_update_info(png, info);

  *height = static_cast<int32_t>(h);
  *width = static_cast<int32_t>(w);
  if (out == nullptr) {  // size probe
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 0;
  }
  if (out_capacity < static_cast<int64_t>(h) * w) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return -5;
  }

  const int out_depth = png_get_bit_depth(png, info);
  const int bps = out_depth == 16 ? 2 : 1;
  const size_t rowbytes = png_get_rowbytes(png, info);
  const int channels = static_cast<int>(rowbytes / (w * bps));
  const int c = (channels > 1 && channel >= 0 && channel < channels)
                    ? channel
                    : 0;
  std::vector<png_byte> pixels(static_cast<size_t>(h) * rowbytes);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y) rows[y] = pixels.data() + y * rowbytes;
  png_read_image(png, rows.data());
  for (png_uint_32 y = 0; y < h; ++y) {
    const png_byte* row = rows[y];
    uint16_t* dst = out + static_cast<int64_t>(y) * w;
    if (bps == 2) {
      const uint16_t* row16 = reinterpret_cast<const uint16_t*>(row);
      for (png_uint_32 x = 0; x < w; ++x) dst[x] = row16[x * channels + c];
    } else {
      for (png_uint_32 x = 0; x < w; ++x) dst[x] = row[x * channels + c];
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return 0;
}

// ---------------------------------------------------------------------------
// Minimal .npy (v1/v2) float32 reader
// ---------------------------------------------------------------------------

// Parses a .npy containing a C-contiguous float32 array with up to 4
// dims.  Returns 0 on success; fills shape (padded with 1s) and ndim.
// If out == nullptr, probes the shape only.
int cst_load_npy_f32(const char* path, float* out, int64_t out_capacity,
                     int64_t* shape /* [4] */, int32_t* ndim) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  unsigned char magic[8];
  if (std::fread(magic, 1, 8, fp) != 8 || std::memcmp(magic, "\x93NUMPY", 6)) {
    std::fclose(fp);
    return -2;
  }
  const int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    uint16_t len16;
    if (std::fread(&len16, 2, 1, fp) != 1) { std::fclose(fp); return -2; }
    header_len = len16;
  } else {
    if (std::fread(&header_len, 4, 1, fp) != 1) { std::fclose(fp); return -2; }
  }
  std::string header(header_len, '\0');
  if (std::fread(&header[0], 1, header_len, fp) != header_len) {
    std::fclose(fp);
    return -2;
  }
  if (header.find("'<f4'") == std::string::npos ||
      header.find("'fortran_order': False") == std::string::npos) {
    std::fclose(fp);
    return -3;  // only C-contiguous float32 supported
  }
  size_t lp = header.find('(');
  size_t rp = header.find(')', lp);
  if (lp == std::string::npos || rp == std::string::npos) {
    std::fclose(fp);
    return -2;
  }
  std::string dims = header.substr(lp + 1, rp - lp - 1);
  int nd = 0;
  int64_t total = 1;
  for (int i = 0; i < 4; ++i) shape[i] = 1;
  const char* s = dims.c_str();
  while (*s) {
    while (*s == ' ' || *s == ',') ++s;
    if (!*s) break;
    char* end;
    long long v = std::strtoll(s, &end, 10);
    if (end == s) break;
    // Reject hostile headers: non-positive dims, >4 dims, or a product
    // that overflows int64 (any of which could over-read the file).
    if (v <= 0 || nd >= 4 || total > INT64_MAX / v) {
      std::fclose(fp);
      return -4;
    }
    shape[nd++] = v;
    total *= v;
    s = end;
  }
  *ndim = nd;
  if (out == nullptr) {  // shape probe
    std::fclose(fp);
    return 0;
  }
  if (out_capacity < total) {
    std::fclose(fp);
    return -5;
  }
  size_t got = std::fread(out, sizeof(float), total, fp);
  std::fclose(fp);
  return got == static_cast<size_t>(total) ? 0 : -6;
}

// ---------------------------------------------------------------------------
// Host preprocessing
// ---------------------------------------------------------------------------

// uint8 [H, W, C] (or C=1) → normalized float32 [H, W] channel extract.
void cst_u8_to_f32_gray(const uint8_t* src, int64_t h, int64_t w,
                        int32_t channels, int32_t channel, float* dst) {
  constexpr float kInv255 = 1.0f / 255.0f;
  const int32_t c =
      (channels > 1 && channel >= 0 && channel < channels) ? channel : 0;
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* row = src + y * w * channels;
    float* out = dst + y * w;
    for (int64_t x = 0; x < w; ++x) out[x] = row[x * channels + c] * kInv255;
  }
}

// Zero-pad a float32 image into a larger staging buffer at offset
// (off_r, off_c) — the host-side equivalent of the band staging the
// Pallas wrappers do in XLA; useful to hand JAX pre-padded pinned arrays.
void cst_pad_image_f32(const float* src, int64_t h, int64_t w, float* dst,
                       int64_t dh, int64_t dw, int64_t off_r, int64_t off_c) {
  std::memset(dst, 0, sizeof(float) * dh * dw);
  for (int64_t y = 0; y < h; ++y) {
    std::memcpy(dst + (y + off_r) * dw + off_c, src + y * w,
                sizeof(float) * w);
  }
}

// v4: cst_loader_open gained n_threads (decode pool, in-order delivery).
int cst_abi_version() { return 4; }

}  // extern "C"

// ---------------------------------------------------------------------------
// Prefetching frame loader: background decode ahead of device compute
// ---------------------------------------------------------------------------
//
// The reference loads each frame synchronously on the Python thread
// (examples/verify.py:137-142).  At >400 frames/s of device throughput a
// synchronous ~1-2 ms PNG decode would dominate the serving loop; this
// loader decodes ahead on a POOL of worker threads into a bounded
// in-order window so the host data path overlaps device compute AND
// scales past one core's zlib-inflate rate (~54 fps at KITTI size —
// BENCH r4 measured the single-thread decode leg as the e2e binding
// resource).  Frames are always DELIVERED in path order: workers claim
// path indices under the lock and park finished frames in an ordered
// map the consumer drains at `next_out`.

#include <algorithm>
#include <condition_variable>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Frame {
  std::vector<float> data;
  int32_t h = 0, w = 0;
  int rc = 0;  // decode status for this frame
};

struct Loader {
  std::vector<std::string> paths;
  int channel = 0;
  size_t capacity = 4;        // max frames in flight (claimed − consumed)
  std::map<size_t, Frame> done;  // decoded, awaiting in-order delivery
  size_t next_in = 0;         // next path index a worker will claim
  size_t next_out = 0;        // next frame index the consumer delivers
  std::mutex mu;
  std::condition_variable cv_space, cv_data;
  bool closed = false;
  std::vector<std::thread> workers;
};

void loader_worker(Loader* L) {
  for (;;) {
    size_t i;
    {
      std::unique_lock<std::mutex> lk(L->mu);
      L->cv_space.wait(lk, [L] {
        return L->closed || L->next_in >= L->paths.size() ||
               L->next_in - L->next_out < L->capacity;
      });
      if (L->closed || L->next_in >= L->paths.size()) return;
      i = L->next_in++;
    }
    Frame f;
    f.rc = cst_decode_png_gray(L->paths[i].c_str(), L->channel, nullptr,
                               0, &f.h, &f.w);
    if (f.rc == 0) {
      f.data.resize(static_cast<size_t>(f.h) * f.w);
      f.rc = cst_decode_png_gray(L->paths[i].c_str(), L->channel,
                                 f.data.data(),
                                 static_cast<int64_t>(f.data.size()),
                                 &f.h, &f.w);
    }
    std::lock_guard<std::mutex> lk(L->mu);
    if (L->closed) return;
    L->done.emplace(i, std::move(f));
    L->cv_data.notify_all();
  }
}

}  // namespace

extern "C" {

// Open a loader over n PNG paths with a decode pool of n_threads
// (<= 0: one thread per hardware core, capped at 8).  Returns an opaque
// handle (never null); call cst_loader_close to stop the pool and free
// it.  Delivery order is always path order regardless of pool size.
void* cst_loader_open(const char** paths, int32_t n, int32_t channel,
                      int32_t capacity, int32_t n_threads) {
  Loader* L = new Loader();
  L->paths.reserve(n > 0 ? n : 0);
  for (int32_t i = 0; i < n; ++i) L->paths.emplace_back(paths[i]);
  L->channel = channel;
  size_t nt = n_threads > 0
                  ? static_cast<size_t>(n_threads)
                  : std::min<size_t>(
                        std::max<size_t>(
                            std::thread::hardware_concurrency(), 1),
                        8);
  // The in-flight window must admit every worker or idle threads can
  // never claim work.
  size_t cap = capacity > 0 ? static_cast<size_t>(capacity) : 1;
  L->capacity = std::max(cap, nt);
  L->workers.reserve(nt);
  for (size_t t = 0; t < nt; ++t) L->workers.emplace_back(loader_worker, L);
  return L;
}

// Peek (out == nullptr): block until a frame is ready, report its size
// and decode status without consuming it.  Consume (out != nullptr):
// copy the front frame into out and advance.
// Returns: 1 = frame available/copied, 0 = end of stream,
//          <0 = decode error for the front frame (consumed on read).
int cst_loader_next(void* handle, float* out, int64_t out_capacity,
                    int32_t* height, int32_t* width) {
  Loader* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->closed || L->next_out >= L->paths.size()) return 0;
  // The frame at next_out is either decoded already or claimed by some
  // worker (the window admits it); wait for it specifically.
  L->cv_data.wait(lk, [L] {
    return L->closed || L->done.count(L->next_out) != 0;
  });
  if (L->closed) return 0;
  auto it = L->done.find(L->next_out);
  Frame& f = it->second;
  *height = f.h;
  *width = f.w;
  if (f.rc != 0) {
    int rc = f.rc;
    if (out != nullptr) {  // consume the bad frame on a read attempt
      L->done.erase(it);
      ++L->next_out;
      L->cv_space.notify_all();
    }
    return rc;
  }
  if (out == nullptr) return 1;  // peek
  if (out_capacity < static_cast<int64_t>(f.data.size())) return -5;
  std::memcpy(out, f.data.data(), sizeof(float) * f.data.size());
  L->done.erase(it);
  ++L->next_out;
  L->cv_space.notify_all();
  return 1;
}

// Drop the front frame unconditionally, whatever its decode status —
// the explicit consume entry point for error recovery (a caller that
// hit a decode error or capacity mismatch advances past the frame with
// this, instead of relying on cst_loader_next's read-path pop order).
// Returns 1 if a frame was dropped, 0 if the stream was empty/ended.
int cst_loader_skip(void* handle) {
  Loader* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->closed || L->next_out >= L->paths.size()) return 0;
  L->cv_data.wait(lk, [L] {
    return L->closed || L->done.count(L->next_out) != 0;
  });
  if (L->closed) return 0;
  L->done.erase(L->next_out);
  ++L->next_out;
  L->cv_space.notify_all();
  return 1;
}

void cst_loader_close(void* handle) {
  Loader* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->closed = true;
    L->cv_space.notify_all();
    L->cv_data.notify_all();
  }
  for (std::thread& t : L->workers) {
    if (t.joinable()) t.join();
  }
  delete L;
}

}  // extern "C"
