// Native IO runtime: threaded image decode + ordered prefetch queue.
//
// The reference's runtime is C++ end to end (ROS image transport feeding the
// tracker thread); this is the rebuild's native equivalent for the host
// side of the pipeline: a worker pool decodes PNG (libpng) / PGM frames ahead
// of the tracker and hands them over strictly in sequence order, so dataset
// IO and JPEG/PNG inflation never sit on the per-frame critical path.
//
// C ABI (used from Python via ctypes — no pybind11 dependency):
//   io_decode_gray(path, out, cap, &w, &h)        one-shot decode to float32
//   io_prefetcher_create(paths, n, w, h, depth, threads)
//   io_prefetcher_next(handle, out)  -> frame index or <0 when exhausted
//   io_prefetcher_destroy(handle)

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

bool decode_png_gray(const char* path, std::vector<float>& out, int* w, int* h) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  png_byte header[8];
  if (std::fread(header, 1, 8, fp) != 8 || png_sig_cmp(header, 0, 8)) {
    std::fclose(fp);
    return false;
  }
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_set_sig_bytes(png, 8);
  png_read_info(png, info);

  png_uint_32 width = png_get_image_width(png, info);
  png_uint_32 height = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);

  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
      color == PNG_COLOR_TYPE_PALETTE)
    png_set_rgb_to_gray_fixed(png, 1, -1, -1);
  png_read_update_info(png, info);

  std::vector<png_byte> row(png_get_rowbytes(png, info));
  out.resize(static_cast<size_t>(width) * height);
  for (png_uint_32 y = 0; y < height; ++y) {
    png_read_row(png, row.data(), nullptr);
    float* dst = out.data() + static_cast<size_t>(y) * width;
    for (png_uint_32 x = 0; x < width; ++x) dst[x] = static_cast<float>(row[x]);
  }
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  *w = static_cast<int>(width);
  *h = static_cast<int>(height);
  return true;
}

bool decode_pgm_gray(const char* path, std::vector<float>& out, int* w, int* h) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  char magic[3] = {0};
  int width = 0, height = 0, maxval = 0;
  if (std::fscanf(fp, "%2s %d %d %d", magic, &width, &height, &maxval) != 4 ||
      std::strcmp(magic, "P5") != 0 || maxval > 255) {
    std::fclose(fp);
    return false;
  }
  std::fgetc(fp);  // single whitespace after header
  std::vector<uint8_t> buf(static_cast<size_t>(width) * height);
  if (std::fread(buf.data(), 1, buf.size(), fp) != buf.size()) {
    std::fclose(fp);
    return false;
  }
  std::fclose(fp);
  out.resize(buf.size());
  for (size_t i = 0; i < buf.size(); ++i) out[i] = static_cast<float>(buf[i]);
  *w = width;
  *h = height;
  return true;
}

bool decode_gray(const char* path, std::vector<float>& out, int* w, int* h) {
  const char* ext = std::strrchr(path, '.');
  if (ext && (std::strcmp(ext, ".pgm") == 0 || std::strcmp(ext, ".PGM") == 0))
    return decode_pgm_gray(path, out, w, h);
  return decode_png_gray(path, out, w, h);
}

struct Slot {
  std::vector<float> data;
  int w = 0, h = 0;
  bool ready = false;
  bool failed = false;
};

struct Prefetcher {
  std::vector<std::string> paths;
  int width, height, depth;
  std::vector<Slot> slots;           // ring, size = depth
  std::atomic<int> next_to_decode{0};
  int next_to_consume = 0;
  std::mutex mu;
  std::condition_variable cv_ready;
  std::condition_variable cv_space;
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;

  void worker() {
    std::vector<float> buf;
    while (!stop.load()) {
      int idx = next_to_decode.fetch_add(1);
      if (idx >= static_cast<int>(paths.size())) return;
      int w = 0, h = 0;
      bool ok = decode_gray(paths[idx].c_str(), buf, &w, &h);
      std::unique_lock<std::mutex> lk(mu);
      // Wait until the ring slot for idx is free (consumer caught up).
      cv_space.wait(lk, [&] {
        return stop.load() || idx < next_to_consume + depth;
      });
      if (stop.load()) return;
      Slot& s = slots[idx % depth];
      s.failed = !ok || (width && w != width) || (height && h != height);
      if (!s.failed) s.data = buf;
      s.w = w;
      s.h = h;
      s.ready = true;
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

int io_decode_gray(const char* path, float* out, long capacity, int* w, int* h) {
  std::vector<float> buf;
  if (!decode_gray(path, buf, w, h)) return -1;
  if (static_cast<long>(buf.size()) > capacity) return -2;
  std::memcpy(out, buf.data(), buf.size() * sizeof(float));
  return 0;
}

void* io_prefetcher_create(const char** paths, int n, int width, int height,
                           int queue_depth, int n_threads) {
  auto* p = new Prefetcher();
  p->paths.assign(paths, paths + n);
  p->width = width;
  p->height = height;
  p->depth = queue_depth > 0 ? queue_depth : 8;
  p->slots.resize(p->depth);
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; ++i) p->workers.emplace_back(&Prefetcher::worker, p);
  return p;
}

// Returns the frame index written to `out`, or -1 when the sequence is
// exhausted, or -(2+index) if decoding frame `index` failed.
int io_prefetcher_next(void* handle, float* out) {
  auto* p = static_cast<Prefetcher*>(handle);
  if (p->next_to_consume >= static_cast<int>(p->paths.size())) return -1;
  int idx = p->next_to_consume;
  Slot& s = p->slots[idx % p->depth];
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_ready.wait(lk, [&] { return s.ready; });
  int rc;
  if (s.failed) {
    rc = -(2 + idx);
  } else {
    std::memcpy(out, s.data.data(), s.data.size() * sizeof(float));
    rc = idx;
  }
  s.ready = false;
  s.failed = false;
  p->next_to_consume = idx + 1;
  p->cv_space.notify_all();
  return rc;
}

void io_prefetcher_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  p->stop.store(true);
  p->cv_space.notify_all();
  p->cv_ready.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
