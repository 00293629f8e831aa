// Host image loader and warp plan of the PyTorch port: the port's copy of
// the repo's native/dataloader.cpp with each codec library behind a define.
//
// File reading and decoding run on a worker-thread pool that prefetches
// ahead of the consumer, with an ordered hand-off, so the SLAM loop receives
// frames in sequence while N decoders work in parallel. Binary PGM is always
// decoded; PNG (libpng) with -DDL_WITH_PNG and JPEG (libjpeg) with
// -DDL_WITH_JPEG. Without a codec, a file of that kind reports a decode
// failure, and the caller falls back to another decoder. Exposed as a C ABI
// for ctypes.
//
// Build (cubemapslam_tpu_torch/native.py does it at first use):
//   g++ -O3 -std=c++17 -shared -fPIC [-DDL_WITH_PNG -DDL_WITH_JPEG]
//       dataloader.cpp -o libcubemap_dataloader.so [-lpng -ljpeg] -lpthread

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <algorithm>
#include <thread>
#include <vector>

#include <csetjmp>
#ifdef DL_WITH_JPEG
#include <jpeglib.h>
#endif
#ifdef DL_WITH_PNG
#include <png.h>
#endif

namespace {

struct Frame {
  std::vector<float> gray;  // H*W grayscale
  int width = 0;
  int height = 0;
  bool ok = false;
};

// ---------------------------------------------------------------------------
// Decoders (all output float32 grayscale via BT.601 luma)
// ---------------------------------------------------------------------------

#ifdef DL_WITH_PNG
bool decode_png(FILE* f, Frame* out) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  png_read_update_info(png, info);
  int channels = png_get_channels(png, info);
  std::vector<uint8_t> row(w * channels);
  out->gray.resize(size_t(w) * h);
  out->width = int(w);
  out->height = int(h);
  for (png_uint_32 y = 0; y < h; y++) {
    png_read_row(png, row.data(), nullptr);
    float* dst = out->gray.data() + size_t(y) * w;
    if (channels == 1) {
      for (png_uint_32 x = 0; x < w; x++) dst[x] = float(row[x]);
    } else {
      for (png_uint_32 x = 0; x < w; x++) {
        const uint8_t* p = row.data() + size_t(x) * channels;
        dst[x] = 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2];
      }
    }
  }
  png_destroy_read_struct(&png, &info, nullptr);
  out->ok = true;
  return true;
}
#endif  // DL_WITH_PNG

#ifdef DL_WITH_JPEG
struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jmp;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jmp, 1);
}

bool decode_jpeg(FILE* f, Frame* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jmp)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_GRAYSCALE;  // decoder-side luma conversion
  jpeg_start_decompress(&cinfo);
  int w = cinfo.output_width, h = cinfo.output_height;
  out->gray.resize(size_t(w) * h);
  out->width = w;
  out->height = h;
  std::vector<uint8_t> row(w);
  JSAMPROW rowp = row.data();
  while (int(cinfo.output_scanline) < h) {
    int y = cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    float* dst = out->gray.data() + size_t(y) * w;
    for (int x = 0; x < w; x++) dst[x] = float(row[x]);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  out->ok = true;
  return true;
}
#endif  // DL_WITH_JPEG

bool decode_pgm(FILE* f, Frame* out) {
  char magic[3] = {0};
  int w, h, maxv;
  if (fscanf(f, "%2s %d %d %d", magic, &w, &h, &maxv) != 4) return false;
  if (strcmp(magic, "P5") != 0 || maxv > 255 || maxv <= 0) return false;
  if (w <= 0 || h <= 0 || size_t(w) * h > (size_t(1) << 28)) return false;
  fgetc(f);  // single whitespace after header
  std::vector<uint8_t> buf(size_t(w) * h);
  if (fread(buf.data(), 1, buf.size(), f) != buf.size()) return false;
  out->gray.resize(buf.size());
  out->width = w;
  out->height = h;
  for (size_t i = 0; i < buf.size(); i++) out->gray[i] = float(buf[i]);
  out->ok = true;
  return true;
}

bool decode_file(const std::string& path, Frame* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  uint8_t sig[8] = {0};
  size_t n = fread(sig, 1, 8, f);
  rewind(f);
  static const uint8_t kPngSig[8] = {0x89, 'P', 'N', 'G', 0x0D, 0x0A, 0x1A,
                                     0x0A};
  bool ok = false;
  if (n >= 8 && memcmp(sig, kPngSig, 8) == 0) {
#ifdef DL_WITH_PNG
    ok = decode_png(f, out);
#endif
  } else if (n >= 2 && sig[0] == 0xFF && sig[1] == 0xD8) {
#ifdef DL_WITH_JPEG
    ok = decode_jpeg(f, out);
#endif
  } else if (n >= 2 && sig[0] == 'P' && sig[1] == '5') {
    ok = decode_pgm(f, out);
  }
  fclose(f);
  return ok;
}

// ---------------------------------------------------------------------------
// Prefetching loader: worker pool + ordered delivery
// ---------------------------------------------------------------------------

struct Loader {
  std::vector<std::string> paths;
  int queue_cap;
  std::atomic<int> next_to_fetch{0};  // claimed by workers
  int next_to_serve = 0;              // consumer order
  std::map<int, Frame> ready;         // decoded, awaiting hand-off
  std::mutex mu;
  std::condition_variable cv_ready;   // consumer waits for next_to_serve
  std::condition_variable cv_space;   // workers wait for queue space
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void worker() {
    while (!stop.load()) {
      int idx = next_to_fetch.fetch_add(1);
      if (idx >= int(paths.size())) return;
      Frame fr;
      decode_file(paths[idx], &fr);
      std::unique_lock<std::mutex> lk(mu);
      // bound memory: don't run further than queue_cap ahead of consumer
      cv_space.wait(lk, [&] {
        return stop.load() || idx < next_to_serve + queue_cap;
      });
      if (stop.load()) return;
      ready.emplace(idx, std::move(fr));
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* dl_create(const char** paths, int n, int n_workers, int queue_cap) {
  Loader* ld = new Loader();
  ld->paths.assign(paths, paths + n);
  ld->queue_cap = queue_cap > 0 ? queue_cap : 8;
  int nw = n_workers > 0 ? n_workers : 4;
  for (int i = 0; i < nw; i++)
    ld->workers.emplace_back([ld] { ld->worker(); });
  return ld;
}

// ---------------------------------------------------------------------------
// Fisheye->cubemap warp on the host (the reference's architecture: cv::remap
// on CPU, cubemap_lafida.cpp:143). The precomputed bilinear plan (flat
// top-left source index + 4 weights per output pixel) is applied by worker
// threads right after decode, overlapping with device compute. Random
// gathers from a ~1.4MB source sit in L2 — this is the wrong access pattern
// for the TPU's gather path (bound by its instruction rate there) and the right
// one for the CPU.
// ---------------------------------------------------------------------------

struct WarpPlan {
  std::vector<int32_t> idx00;  // n_out
  std::vector<float> w;        // n_out * 4
  int n_out = 0;
  int src_w = 0;
  int src_stride = 0;
};

void* wp_create(const int32_t* idx00, const float* w, int n_out,
                int src_w) {
  WarpPlan* p = new WarpPlan();
  p->idx00.assign(idx00, idx00 + n_out);
  p->w.assign(w, w + size_t(n_out) * 4);
  p->n_out = n_out;
  p->src_w = src_w;
  return p;
}

void wp_apply(void* plan, const float* src, float* dst, int n_threads) {
  WarpPlan* p = static_cast<WarpPlan*>(plan);
  const int W = p->src_w;
  auto run = [&](int lo, int hi) {
    const int32_t* idx = p->idx00.data();
    const float* w = p->w.data();
    for (int i = lo; i < hi; i++) {
      const int32_t k = idx[i];
      const float* ww = w + size_t(i) * 4;
      dst[i] = ww[0] * src[k] + ww[1] * src[k + 1] + ww[2] * src[k + W] +
               ww[3] * src[k + W + 1];
    }
  };
  int nt = n_threads > 0 ? n_threads : 4;
  if (nt == 1) {
    run(0, p->n_out);
    return;
  }
  std::vector<std::thread> ts;
  int chunk = (p->n_out + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    int lo = t * chunk;
    int hi = std::min(p->n_out, lo + chunk);
    if (lo < hi) ts.emplace_back(run, lo, hi);
  }
  for (auto& th : ts) th.join();
}

// u8-output variant: emits rounded/clamped uint8 directly (the device step
// consumes uint8 faces; skipping the separate float->u8 pass saves a full
// extra traversal of the output on the frame thread).
void wp_apply_u8(void* plan, const float* src, uint8_t* dst, int n_threads) {
  WarpPlan* p = static_cast<WarpPlan*>(plan);
  const int W = p->src_w;
  auto run = [&](int lo, int hi) {
    const int32_t* idx = p->idx00.data();
    const float* w = p->w.data();
    for (int i = lo; i < hi; i++) {
      const int32_t k = idx[i];
      const float* ww = w + size_t(i) * 4;
      float v = ww[0] * src[k] + ww[1] * src[k + 1] + ww[2] * src[k + W] +
                ww[3] * src[k + W + 1];
      v = v < 0.f ? 0.f : (v > 255.f ? 255.f : v);
      dst[i] = (uint8_t)(v + 0.5f);
    }
  };
  int nt = n_threads > 0 ? n_threads : 4;
  if (nt == 1) {
    run(0, p->n_out);
    return;
  }
  std::vector<std::thread> ts;
  int chunk = (p->n_out + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    int lo = t * chunk;
    int hi = std::min(p->n_out, lo + chunk);
    if (lo < hi) ts.emplace_back(run, lo, hi);
  }
  for (auto& th : ts) th.join();
}

void wp_destroy(void* plan) { delete static_cast<WarpPlan*>(plan); }

// Blocks until the NEXT in-order frame is decoded. Returns 1 on success and
// fills (*width, *height); 0 at end of sequence; -1 on decode failure.
// Call dl_copy afterwards to copy the pixels out.
int dl_next(void* handle, int* width, int* height) {
  Loader* ld = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(ld->mu);
  if (ld->next_to_serve >= int(ld->paths.size())) return 0;
  ld->cv_ready.wait(lk, [&] {
    return ld->ready.count(ld->next_to_serve) > 0;
  });
  Frame& fr = ld->ready[ld->next_to_serve];
  if (!fr.ok) {
    ld->ready.erase(ld->next_to_serve);
    ld->next_to_serve++;
    ld->cv_space.notify_all();
    return -1;
  }
  *width = fr.width;
  *height = fr.height;
  return 1;
}

void dl_copy(void* handle, float* out) {
  Loader* ld = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(ld->mu);
  Frame& fr = ld->ready[ld->next_to_serve];
  memcpy(out, fr.gray.data(), fr.gray.size() * sizeof(float));
  ld->ready.erase(ld->next_to_serve);
  ld->next_to_serve++;
  ld->cv_space.notify_all();
}

void dl_destroy(void* handle) {
  Loader* ld = static_cast<Loader*>(handle);
  ld->stop.store(true);
  {
    std::unique_lock<std::mutex> lk(ld->mu);
    ld->cv_space.notify_all();
    ld->cv_ready.notify_all();
  }
  for (auto& t : ld->workers) t.join();
  delete ld;
}

}  // extern "C"
