// Native I/O runtime for sfm_jax.
//
// Equivalent of the reference's host-side I/O layer: the
// reference uses OpenCV imread for PPM ingest (reference
// src/main.cpp:251-257) and an OpenGL viewer for output (src/main.cpp:
// 318-352).  Here: a dependency-free multi-threaded PNM decoder that
// feeds pinned host buffers for device upload, and a binary
// little-endian PLY writer for point-cloud export.
//
// C ABI only (consumed from Python via ctypes — no pybind11 in the
// image).  Build: `make -C native` -> libsfm_io.so.

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

// Parse one PNM token (skips whitespace + '#' comments).
const unsigned char* pnm_token(const unsigned char* p, const unsigned char* end,
                               long* out) {
  while (p < end) {
    if (*p == '#') {
      while (p < end && *p != '\n') ++p;
    } else if (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n') {
      ++p;
    } else {
      break;
    }
  }
  long v = 0;
  bool any = false;
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10 + (*p - '0');
    ++p;
    any = true;
  }
  if (!any) return nullptr;
  *out = v;
  return p;
}

struct PnmHeader {
  int channels;  // 1 (P5) or 3 (P6)
  long w, h, maxval;
  const unsigned char* data;
};

bool parse_pnm(const unsigned char* buf, size_t n, PnmHeader* hdr) {
  if (n < 10 || buf[0] != 'P' || (buf[1] != '5' && buf[1] != '6')) return false;
  hdr->channels = buf[1] == '6' ? 3 : 1;
  const unsigned char* end = buf + n;
  const unsigned char* p = buf + 2;
  if (!(p = pnm_token(p, end, &hdr->w))) return false;
  if (!(p = pnm_token(p, end, &hdr->h))) return false;
  if (!(p = pnm_token(p, end, &hdr->maxval))) return false;
  if (p >= end || hdr->maxval <= 0 || hdr->maxval > 65535) return false;
  // Dimension sanity bounds: with w, h <= 2^20 the byte count below
  // (<= 2^40 * 6) cannot wrap size_t, so crafted headers cannot
  // undersize `need`.
  if (hdr->w <= 0 || hdr->h <= 0 || hdr->w > (1L << 20) || hdr->h > (1L << 20))
    return false;
  hdr->data = p + 1;  // single whitespace after maxval
  size_t need = (size_t)hdr->w * (size_t)hdr->h * (size_t)hdr->channels *
                (hdr->maxval > 255 ? 2 : 1);
  return (size_t)(end - hdr->data) >= need;
}

// Decode one PNM buffer into float32 grayscale 0..255 (BT.601 weights,
// matching OpenCV's IMREAD_GRAYSCALE used by the reference).
// `expect_w`/`expect_h` > 0 bound the caller's `out` buffer: decoding
// refuses (before writing a single float) if the header dims differ,
// closing the probe-vs-decode TOCTOU the r1 advisor flagged.
bool decode_gray(const unsigned char* buf, size_t n, float* out, long* w,
                 long* h, long expect_w, long expect_h) {
  PnmHeader hd;
  if (!parse_pnm(buf, n, &hd)) return false;
  if (expect_w > 0 && (hd.w != expect_w || hd.h != expect_h)) return false;
  *w = hd.w;
  *h = hd.h;
  const size_t npix = (size_t)hd.w * hd.h;
  const float scale = hd.maxval == 255 ? 1.0f : 255.0f / (float)hd.maxval;
  if (hd.maxval <= 255) {
    const unsigned char* s = hd.data;
    if (hd.channels == 1) {
      for (size_t i = 0; i < npix; ++i) out[i] = scale * (float)s[i];
    } else {
      for (size_t i = 0; i < npix; ++i) {
        const unsigned char* px = s + 3 * i;
        out[i] = scale * (0.299f * px[0] + 0.587f * px[1] + 0.114f * px[2]);
      }
    }
  } else {
    // 16-bit big-endian samples
    const unsigned char* s = hd.data;
    if (hd.channels == 1) {
      for (size_t i = 0; i < npix; ++i)
        out[i] = scale * (float)((s[2 * i] << 8) | s[2 * i + 1]);
    } else {
      for (size_t i = 0; i < npix; ++i) {
        const unsigned char* px = s + 6 * i;
        float r = (float)((px[0] << 8) | px[1]);
        float g = (float)((px[2] << 8) | px[3]);
        float b = (float)((px[4] << 8) | px[5]);
        out[i] = scale * (0.299f * r + 0.587f * g + 0.114f * b);
      }
    }
  }
  return true;
}

bool read_file(const char* path, std::vector<unsigned char>* buf) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (n <= 0) {
    fclose(f);
    return false;
  }
  buf->resize((size_t)n);
  size_t got = fread(buf->data(), 1, (size_t)n, f);
  fclose(f);
  return got == (size_t)n;
}

}  // namespace

extern "C" {

// Probe image dimensions.  Returns 0 on success.
int sfm_pnm_size(const char* path, long* w, long* h) {
  std::vector<unsigned char> buf;
  if (!read_file(path, &buf)) return 1;
  PnmHeader hd;
  if (!parse_pnm(buf.data(), buf.size(), &hd)) return 2;
  *w = hd.w;
  *h = hd.h;
  return 0;
}

// Decode one image to float32 grayscale [h, w] (row-major, 0..255).
// `out` must hold (*w) * (*h) floats; the caller's probed dims are
// read IN via *w/*h and enforced before any write (the file may have
// changed since the probe).  Pass *w = 0 to accept any size at the
// caller's risk.  Returns 0 on success.
int sfm_load_gray(const char* path, float* out, long* w, long* h) {
  std::vector<unsigned char> buf;
  if (!read_file(path, &buf)) return 1;
  return decode_gray(buf.data(), buf.size(), out, w, h, *w, *h) ? 0 : 2;
}

// Decode a batch of same-sized images in parallel into one contiguous
// [n, h, w] float32 block.  paths: array of n C strings.  Returns the
// number of successfully decoded images (failures leave zeros).
int sfm_load_gray_batch(const char** paths, int n, float* out, long w, long h,
                        int n_threads) {
  if (n_threads <= 0) {
    n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 4;
  }
  std::atomic<int> next(0), ok(0);
  const size_t stride = (size_t)w * h;
  auto worker = [&]() {
    std::vector<unsigned char> buf;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      long gw = 0, gh = 0;
      buf.clear();
      if (!read_file(paths[i], &buf)) continue;
      // decode_gray enforces gw == w && gh == h BEFORE writing, so a
      // batch containing a larger image cannot overflow its slot.
      if (!decode_gray(buf.data(), buf.size(), out + stride * i, &gw, &gh,
                       w, h))
        continue;
      ok.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  int nt = n_threads < n ? n_threads : n;
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return ok.load();
}

// ---------------------------------------------------------------------------
// Decode-ahead prefetcher: worker threads decode frames into a bounded
// ring of float buffers while the consumer (the JAX pipeline) uploads
// and processes earlier frames.  replacement for the
// reference's synchronous per-frame cv::imread ingest (reference
// src/main.cpp:251-257): frame decode overlaps accelerator compute in
// sequence/incremental mode.  In-order delivery; decode failures are
// reported per frame without stalling the stream.

struct SfmPrefetcher {
  std::vector<std::string> paths;
  long w = 0, h = 0;
  int depth = 0;
  // ring slot s holds frame i (i % depth == s) once ready[s] == i
  std::vector<std::vector<float>> slots;
  std::vector<long> ready;      // frame id decoded into slot, -1 = empty
  std::vector<int> slot_rc;     // 0 ok, 2 decode failure
  long next_claim = 0;          // next frame index a worker takes
  long next_out = 0;            // next frame index the consumer wants
  bool closing = false;
  std::mutex mu;
  std::condition_variable cv_worker, cv_consumer;
  std::vector<std::thread> threads;
};

static void prefetch_worker(SfmPrefetcher* pf) {
  std::vector<unsigned char> buf;
  for (;;) {
    long i;
    {
      std::unique_lock<std::mutex> lk(pf->mu);
      pf->cv_worker.wait(lk, [&] {
        return pf->closing ||
               (pf->next_claim < (long)pf->paths.size() &&
                pf->next_claim < pf->next_out + pf->depth);
      });
      if (pf->closing) return;
      i = pf->next_claim++;
    }
    long gw = 0, gh = 0;
    buf.clear();
    float* out = pf->slots[i % pf->depth].data();
    int rc = 0;
    if (!read_file(pf->paths[i].c_str(), &buf) ||
        !decode_gray(buf.data(), buf.size(), out, &gw, &gh, pf->w, pf->h))
      rc = 2;
    {
      std::lock_guard<std::mutex> lk(pf->mu);
      pf->ready[i % pf->depth] = i;
      pf->slot_rc[i % pf->depth] = rc;
    }
    pf->cv_consumer.notify_all();
  }
}

// Binary little-endian PLY writer: points [n, 3] f32, optional colors
// [n, 3] u8 (pass null for white), valid mask [n] u8 (null = all).
// Returns number of vertices written, or -1 on error.
long sfm_write_ply(const char* path, const float* points, const unsigned char* colors,
                   const unsigned char* valid, long n) {
  long count = 0;
  for (long i = 0; i < n; ++i)
    if (!valid || valid[i]) ++count;
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  fprintf(f,
          "ply\nformat binary_little_endian 1.0\nelement vertex %ld\n"
          "property float x\nproperty float y\nproperty float z\n"
          "property uchar red\nproperty uchar green\nproperty uchar blue\n"
          "end_header\n",
          count);
  for (long i = 0; i < n; ++i) {
    if (valid && !valid[i]) continue;
    fwrite(points + 3 * i, sizeof(float), 3, f);
    unsigned char c[3] = {255, 255, 255};
    if (colors) memcpy(c, colors + 3 * i, 3);
    fwrite(c, 1, 3, f);
  }
  fclose(f);
  return count;
}

// Open a decode-ahead stream over `n` same-sized frames.  `depth`
// frames are decoded ahead of the consumer by `n_threads` workers.
// Returns an opaque handle, or null if the first header can't be
// parsed (all frames must match the first frame's dimensions).
void* sfm_prefetch_open(const char** paths, int n, int depth, int n_threads,
                        long* w, long* h) {
  if (n <= 0) return nullptr;
  {
    std::vector<unsigned char> buf;
    PnmHeader hd;
    if (!read_file(paths[0], &buf) ||
        !parse_pnm(buf.data(), buf.size(), &hd))
      return nullptr;
    *w = hd.w;
    *h = hd.h;
  }
  if (depth <= 0) depth = 4;
  if (depth > n) depth = n;
  if (n_threads <= 0) {
    n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 4;
  }
  if (n_threads > depth) n_threads = depth;
  SfmPrefetcher* pf = new SfmPrefetcher();
  pf->paths.assign(paths, paths + n);
  pf->w = *w;
  pf->h = *h;
  pf->depth = depth;
  pf->slots.assign(depth, std::vector<float>((size_t)*w * *h));
  pf->ready.assign(depth, -1);
  pf->slot_rc.assign(depth, 0);
  for (int t = 0; t < n_threads; ++t)
    pf->threads.emplace_back(prefetch_worker, pf);
  return pf;
}

// Copy the next frame (in order) into `out` ([h, w] f32), blocking
// until it is decoded.  Returns 0 on success, 1 at end of stream,
// 2 if that frame failed to decode (stream continues).  `index`
// receives the frame's position in the open() path list.
int sfm_prefetch_next(void* handle, float* out, long* index) {
  SfmPrefetcher* pf = (SfmPrefetcher*)handle;
  std::unique_lock<std::mutex> lk(pf->mu);
  if (pf->next_out >= (long)pf->paths.size()) return 1;
  const long i = pf->next_out;
  // `closing` escape: a close() from another thread must unblock a
  // waiting consumer or the worker join in sfm_prefetch_close deadlocks.
  pf->cv_consumer.wait(
      lk, [&] { return pf->closing || pf->ready[i % pf->depth] == i; });
  if (pf->closing) return 1;  // end of stream
  const int rc = pf->slot_rc[i % pf->depth];
  if (rc == 0)
    memcpy(out, pf->slots[i % pf->depth].data(),
           (size_t)pf->w * pf->h * sizeof(float));
  if (index) *index = i;
  pf->ready[i % pf->depth] = -1;
  pf->next_out = i + 1;
  lk.unlock();
  pf->cv_worker.notify_all();  // the freed slot unblocks a claim
  return rc;
}

// Join workers and free the stream.
void sfm_prefetch_close(void* handle) {
  SfmPrefetcher* pf = (SfmPrefetcher*)handle;
  {
    std::lock_guard<std::mutex> lk(pf->mu);
    pf->closing = true;
  }
  pf->cv_worker.notify_all();
  pf->cv_consumer.notify_all();  // wake any consumer blocked in next()
  for (auto& t : pf->threads) t.join();
  delete pf;
}

}  // extern "C"
