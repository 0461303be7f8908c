// Native depth-frame IO: 16-bit grayscale PNG codec + prefetching
// frame loader (the port's copy of the JAX package's native/src/depthio.cpp).
//
// The decode path is native because Python-level PNG unfiltering is
// orders of magnitude too slow to feed a tracker at sensor rate; a
// thread-pool prefetcher decodes frames ahead of the device step so host
// IO overlaps the card's work.
//
// Zero third-party image dependencies: PNG container parsing and
// scanline unfiltering are implemented here; DEFLATE comes from zlib.
// Exposed as a C ABI consumed via ctypes (native/__init__.py).

#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr unsigned char kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

uint32_t be32(const unsigned char* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

struct PngImage {
  std::vector<uint16_t> pixels;  // row-major
  uint32_t width = 0;
  uint32_t height = 0;
  int bit_depth = 0;
};

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return (pb <= pc) ? b : c;
}

// returns 0 on success, negative error code otherwise
int decode_png_gray(const unsigned char* blob, size_t len, PngImage* out) {
  if (len < 8 || std::memcmp(blob, kSig, 8) != 0) return -1;
  size_t pos = 8;
  uint32_t w = 0, h = 0;
  int depth = 0, color = -1, interlace = 0;
  std::vector<unsigned char> idat;
  while (pos + 12 <= len) {
    uint32_t clen = be32(blob + pos);
    const unsigned char* tag = blob + pos + 4;
    const unsigned char* payload = blob + pos + 8;
    if (pos + 12 + clen > len) return -2;
    if (!std::memcmp(tag, "IHDR", 4)) {
      if (clen < 13) return -3;
      w = be32(payload);
      h = be32(payload + 4);
      depth = payload[8];
      color = payload[9];
      interlace = payload[12];
    } else if (!std::memcmp(tag, "IDAT", 4)) {
      idat.insert(idat.end(), payload, payload + clen);
    } else if (!std::memcmp(tag, "IEND", 4)) {
      break;
    }
    pos += 12 + clen;
  }
  if (w == 0 || h == 0) return -3;
  if (color != 0) return -4;           // grayscale only
  if (interlace != 0) return -5;       // no Adam7
  if (depth != 8 && depth != 16) return -6;

  const size_t bpp = depth / 8;
  const size_t stride = size_t(w) * bpp;
  std::vector<unsigned char> raw(h * (stride + 1));
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size()) {
    return -7;
  }

  std::vector<unsigned char> img(h * stride);
  const unsigned char* prev = nullptr;
  for (uint32_t y = 0; y < h; ++y) {
    const unsigned char* src = raw.data() + y * (stride + 1);
    unsigned char* dst = img.data() + y * stride;
    int f = src[0];
    ++src;
    switch (f) {
      case 0:
        std::memcpy(dst, src, stride);
        break;
      case 1:
        for (size_t x = 0; x < stride; ++x) {
          int a = x >= bpp ? dst[x - bpp] : 0;
          dst[x] = (unsigned char)((src[x] + a) & 0xFF);
        }
        break;
      case 2:
        for (size_t x = 0; x < stride; ++x) {
          int b = prev ? prev[x] : 0;
          dst[x] = (unsigned char)((src[x] + b) & 0xFF);
        }
        break;
      case 3:
        for (size_t x = 0; x < stride; ++x) {
          int a = x >= bpp ? dst[x - bpp] : 0;
          int b = prev ? prev[x] : 0;
          dst[x] = (unsigned char)((src[x] + ((a + b) >> 1)) & 0xFF);
        }
        break;
      case 4:
        for (size_t x = 0; x < stride; ++x) {
          int a = x >= bpp ? dst[x - bpp] : 0;
          int b = prev ? prev[x] : 0;
          int c = (prev && x >= bpp) ? prev[x - bpp] : 0;
          dst[x] = (unsigned char)((src[x] + paeth(a, b, c)) & 0xFF);
        }
        break;
      default:
        return -8;
    }
    prev = dst;
  }

  out->width = w;
  out->height = h;
  out->bit_depth = depth;
  out->pixels.resize(size_t(w) * h);
  if (depth == 16) {
    for (size_t i = 0; i < out->pixels.size(); ++i) {
      out->pixels[i] = (uint16_t(img[2 * i]) << 8) | img[2 * i + 1];
    }
  } else {
    for (size_t i = 0; i < out->pixels.size(); ++i) out->pixels[i] = img[i];
  }
  return 0;
}

int read_file(const char* path, std::vector<unsigned char>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -100;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(n);
  size_t rd = std::fread(out->data(), 1, n, f);
  std::fclose(f);
  return rd == size_t(n) ? 0 : -101;
}

// ---------------------------------------------------------------------------
// Prefetching frame loader: fixed worker pool decodes paths out of order,
// frames are released to the consumer strictly in order.

struct Loader {
  std::vector<std::string> paths;
  size_t ahead;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  size_t next_to_schedule = 0;
  size_t next_to_emit = 0;
  std::deque<std::pair<size_t, PngImage>> done;  // unordered completions
  std::atomic<bool> stop{false};
  std::atomic<int> error{0};

  void worker() {
    for (;;) {
      size_t idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] {
          return stop || (next_to_schedule < paths.size() &&
                          next_to_schedule < next_to_emit + ahead);
        });
        if (stop || next_to_schedule >= paths.size()) return;
        idx = next_to_schedule++;
      }
      PngImage img;
      std::vector<unsigned char> blob;
      int rc = read_file(paths[idx].c_str(), &blob);
      if (rc == 0) rc = decode_png_gray(blob.data(), blob.size(), &img);
      {
        std::lock_guard<std::mutex> lk(mu);
        if (rc != 0) error = rc;
        done.emplace_back(idx, std::move(img));
      }
      cv_done.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// Decode one PNG into caller buffer (uint16). Returns 0 on success.
int dio_read_png16(const char* path, uint16_t* out, int64_t capacity,
                   int32_t* height, int32_t* width) {
  std::vector<unsigned char> blob;
  int rc = read_file(path, &blob);
  if (rc != 0) return rc;
  PngImage img;
  rc = decode_png_gray(blob.data(), blob.size(), &img);
  if (rc != 0) return rc;
  if (int64_t(img.pixels.size()) > capacity) return -9;
  std::memcpy(out, img.pixels.data(), img.pixels.size() * sizeof(uint16_t));
  *height = int32_t(img.height);
  *width = int32_t(img.width);
  return 0;
}

// Probe dimensions from the IHDR header alone: signature (8B) + IHDR
// length/type (8B) + width/height (8B) + bit depth (1B) = first 25 bytes;
// read 33 to keep the full IHDR in hand. Avoids pulling whole files into
// memory at loader startup (ADVICE r1).
int dio_png_dims(const char* path, int32_t* height, int32_t* width) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -100;
  unsigned char hdr[33];
  size_t rd = std::fread(hdr, 1, sizeof(hdr), f);
  std::fclose(f);
  if (rd < sizeof(hdr)) return -101;
  if (std::memcmp(hdr, kSig, 8) != 0) return -1;
  *width = int32_t(be32(hdr + 16));
  *height = int32_t(be32(hdr + 20));
  return 0;
}

void* dio_loader_create(const char** paths, int64_t n_paths, int32_t n_threads,
                        int32_t ahead) {
  auto* L = new Loader();
  L->paths.assign(paths, paths + n_paths);
  L->ahead = ahead > 0 ? size_t(ahead) : 8;
  int nt = n_threads > 0 ? n_threads : 4;
  for (int i = 0; i < nt; ++i) L->workers.emplace_back(&Loader::worker, L);
  return L;
}

// Blocking in-order fetch of the next frame. Returns 0 ok, 1 end, <0 error.
int dio_loader_next(void* handle, uint16_t* out, int64_t capacity,
                    int32_t* height, int32_t* width) {
  auto* L = static_cast<Loader*>(handle);
  size_t want;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    if (L->next_to_emit >= L->paths.size()) return 1;
    want = L->next_to_emit;
  }
  L->cv_work.notify_all();
  PngImage img;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_done.wait(lk, [&] {
      if (L->error != 0) return true;
      for (auto& kv : L->done)
        if (kv.first == want) return true;
      return false;
    });
    if (L->error != 0) return L->error.load();
    for (auto it = L->done.begin(); it != L->done.end(); ++it) {
      if (it->first == want) {
        img = std::move(it->second);
        L->done.erase(it);
        break;
      }
    }
    L->next_to_emit = want + 1;
  }
  L->cv_work.notify_all();  // emit advanced: unblock the ahead-window gate
  if (int64_t(img.pixels.size()) > capacity) return -9;
  std::memcpy(out, img.pixels.data(), img.pixels.size() * sizeof(uint16_t));
  *height = int32_t(img.height);
  *width = int32_t(img.width);
  return 0;
}

void dio_loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
  }
  L->cv_work.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
