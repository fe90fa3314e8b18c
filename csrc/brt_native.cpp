// brt_native: native runtime support for bevy_raytrace_tpu.
//
// The reference's host-side runtime is Rust (buffer marshalling, window
// output, `src/ray_trace_output.rs`); this framework's host runtime is
// C++: the image-writeback path (tone-map + encode) and multi-host tile
// assembly run natively, called from Python via ctypes (io/native.py).
//
// Components:
//   brt_tonemap_srgb   : linear f32 RGB -> gamma-2 u8 (RTiOW write_color's
//                        sqrt gamma), vectorizable tight loop.
//   brt_write_png      : dependency-free PNG encoder (stored deflate
//                        blocks + zlib/adler32 + CRC32) — no libpng/zlib.
//   brt_write_ppm      : binary P6 PPM.
//   brt_write_exr      : minimal OpenEXR 2.0 writer, single part,
//                        uncompressed float32 scanlines (linear HDR).
//   brt_assemble_tiles : gather per-host/pixel-stripe framebuffer tiles
//                        into a full image (the multi-host IO path).
//
// Build: `make -C csrc` -> build/libbrt_native.so (see csrc/Makefile).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- tonemap

// linear f32 [h*w*3] -> u8 [h*w*3] with gamma 2.0 (RTiOW sqrt).
void brt_tonemap_srgb(const float* src, uint8_t* dst, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    float v = src[i];
    v = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
    v = sqrtf(v);
    int iv = (int)(v * 255.0f + 0.5f);
    dst[i] = (uint8_t)(iv > 255 ? 255 : iv);
  }
}

// ------------------------------------------------------------------- CRC

static uint32_t crc_table[256];
static bool crc_init_done = false;

static void crc_init() {
  for (uint32_t n = 0; n < 256; n++) {
    uint32_t c = n;
    for (int k = 0; k < 8; k++)
      c = (c & 1) ? 0xedb88320u ^ (c >> 1) : c >> 1;
    crc_table[n] = c;
  }
  crc_init_done = true;
}

static uint32_t crc32_update(uint32_t crc, const uint8_t* buf, size_t len) {
  if (!crc_init_done) crc_init();
  uint32_t c = crc ^ 0xffffffffu;
  for (size_t i = 0; i < len; i++)
    c = crc_table[(c ^ buf[i]) & 0xff] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

// ------------------------------------------------------------------- PNG

static void put_u32_be(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back((x >> 24) & 0xff);
  v.push_back((x >> 16) & 0xff);
  v.push_back((x >> 8) & 0xff);
  v.push_back(x & 0xff);
}

static void png_chunk(std::vector<uint8_t>& out, const char* tag,
                      const uint8_t* data, size_t len) {
  put_u32_be(out, (uint32_t)len);
  size_t start = out.size();
  out.insert(out.end(), tag, tag + 4);
  out.insert(out.end(), data, data + len);
  uint32_t crc = crc32_update(0, out.data() + start, len + 4);
  put_u32_be(out, crc);
}

// --------------------------------------------- deflate (fixed Huffman)
// Real compression: Sub-filtered scanlines +
// greedy LZ77 + the FIXED Huffman code of RFC 1951 3.2.6 — still
// dependency-free (no zlib).  Smooth regions (sky gradients, contact-
// sheet gutters) collapse under Sub+LZ77; pure noise costs at most
// ~9/8 of stored.  Decoded by every inflater (PIL round-trip tested).

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int nbits = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void bits(uint32_t v, int n) {  // LSB-first bitstream
    acc |= v << nbits;
    nbits += n;
    while (nbits >= 8) {
      out.push_back(acc & 0xff);
      acc >>= 8;
      nbits -= 8;
    }
  }
  void flush() {
    if (nbits) out.push_back(acc & 0xff);
    acc = 0;
    nbits = 0;
  }
};

static uint32_t revbits(uint32_t v, int n) {
  uint32_t r = 0;
  for (int i = 0; i < n; i++) { r = (r << 1) | (v & 1); v >>= 1; }
  return r;
}

// Huffman codes are emitted MSB-first into the LSB-first stream.
static void put_litlen(BitWriter& bw, int sym) {
  if (sym < 144) bw.bits(revbits(0x30 + sym, 8), 8);
  else if (sym < 256) bw.bits(revbits(0x190 + (sym - 144), 9), 9);
  else if (sym < 280) bw.bits(revbits(sym - 256, 7), 7);
  else bw.bits(revbits(0xC0 + (sym - 280), 8), 8);
}

static const int LBASE[29] = {3,4,5,6,7,8,9,10,11,13,15,17,19,23,27,31,35,
                              43,51,59,67,83,99,115,131,163,195,227,258};
static const int LEXTRA[29] = {0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2,3,3,3,3,4,
                               4,4,4,5,5,5,5,0};
static const int DBASE[30] = {1,2,3,4,5,7,9,13,17,25,33,49,65,97,129,193,
                              257,385,513,769,1025,1537,2049,3073,4097,
                              6145,8193,12289,16385,24577};
static const int DEXTRA[30] = {0,0,0,0,1,1,2,2,3,3,4,4,5,5,6,6,7,7,8,8,9,
                               9,10,10,11,11,12,12,13,13};

static void put_match(BitWriter& bw, int len, int dist) {
  int lc = 28;
  while (lc > 0 && LBASE[lc] > len) lc--;
  put_litlen(bw, 257 + lc);
  if (LEXTRA[lc]) bw.bits((uint32_t)(len - LBASE[lc]), LEXTRA[lc]);
  int dc = 29;
  while (dc > 0 && DBASE[dc] > dist) dc--;
  bw.bits(revbits((uint32_t)dc, 5), 5);  // fixed 5-bit distance code
  if (DEXTRA[dc]) bw.bits((uint32_t)(dist - DBASE[dc]), DEXTRA[dc]);
}

static void deflate_fixed(const std::vector<uint8_t>& raw,
                          std::vector<uint8_t>& z) {
  BitWriter bw(z);
  bw.bits(1, 1);  // BFINAL
  bw.bits(1, 2);  // BTYPE = 01 fixed Huffman
  const size_t n = raw.size();
  const int HBITS = 15, CHAIN = 32, MINM = 3, MAXM = 258, WIN = 32768;
  std::vector<int32_t> head((size_t)1 << HBITS, -1);
  std::vector<int32_t> prev(n, -1);
  auto hash3 = [&](size_t i) {
    return (uint32_t)((raw[i] << 10) ^ (raw[i + 1] << 5) ^ raw[i + 2])
           & (((uint32_t)1 << HBITS) - 1);
  };
  size_t i = 0;
  while (i < n) {
    int best_len = 0, best_dist = 0;
    if (i + MINM <= n) {
      uint32_t hh = hash3(i);
      int32_t cand = head[hh];
      int tries = CHAIN;
      while (cand >= 0 && tries-- > 0 && i - (size_t)cand <= (size_t)WIN) {
        int len = 0;
        int maxl = (int)std::min((size_t)MAXM, n - i);
        while (len < maxl && raw[cand + len] == raw[i + len]) len++;
        if (len > best_len) {
          best_len = len;
          best_dist = (int)(i - (size_t)cand);
          if (len >= MAXM) break;
        }
        cand = prev[cand];
      }
      prev[i] = head[hh];
      head[hh] = (int32_t)i;
    }
    if (best_len >= MINM) {
      put_match(bw, best_len, best_dist);
      // Insert hash entries for the matched span (cheap, keeps later
      // matches findable); skip the last 2 (need 3 bytes of lookahead).
      for (size_t k = i + 1; k + MINM <= n && k < i + (size_t)best_len;
           k++) {
        uint32_t hh = hash3(k);
        prev[k] = head[hh];
        head[hh] = (int32_t)k;
      }
      i += (size_t)best_len;
    } else {
      put_litlen(bw, raw[i]);
      i++;
    }
  }
  put_litlen(bw, 256);  // end of block
  bw.flush();
}

// rgb8 [h][w][3] -> PNG file.  Returns 0 on success.
int brt_write_png(const char* path, const uint8_t* rgb, int w, int h) {
  // Sub-filtered scanlines (filter 1): smooth gradients become small
  // residuals that LZ77 + Huffman actually compress (filter 0 left
  // them incompressible — the r4 stored-deflate files were ~1 MB for
  // 480x320 contact sheets).
  std::vector<uint8_t> raw;  // filter byte + filtered row
  raw.reserve((size_t)h * (w * 3 + 1));
  for (int y = 0; y < h; y++) {
    const uint8_t* row = rgb + (size_t)y * w * 3;
    raw.push_back(1);  // Sub
    for (int x = 0; x < w * 3; x++)
      raw.push_back((uint8_t)(row[x] - (x >= 3 ? row[x - 3] : 0)));
  }

  // zlib stream: header + one fixed-Huffman deflate block + adler32.
  // Noise-dominated frames can cost up to ~9/8 of stored under the
  // fixed code — fall back to stored blocks when compression loses.
  std::vector<uint8_t> z;
  z.push_back(0x78);
  z.push_back(0x01);
  deflate_fixed(raw, z);
  if (z.size() > raw.size() + 5 * (raw.size() / 65535 + 1) + 2) {
    z.resize(2);
    size_t pos = 0;
    while (pos < raw.size()) {
      size_t block = std::min(raw.size() - pos, (size_t)65535);
      bool final_b = (pos + block == raw.size());
      z.push_back(final_b ? 1 : 0);
      z.push_back(block & 0xff);
      z.push_back((block >> 8) & 0xff);
      z.push_back(~block & 0xff);
      z.push_back((~block >> 8) & 0xff);
      z.insert(z.end(), raw.begin() + pos, raw.begin() + pos + block);
      pos += block;
    }
  }
  uint32_t a = 1, b = 0;  // adler32
  for (uint8_t c : raw) {
    a = (a + c) % 65521;
    b = (b + a) % 65521;
  }
  put_u32_be(z, (b << 16) | a);

  std::vector<uint8_t> out;
  const uint8_t sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  out.insert(out.end(), sig, sig + 8);
  uint8_t ihdr[13];
  ihdr[0] = (w >> 24) & 0xff; ihdr[1] = (w >> 16) & 0xff;
  ihdr[2] = (w >> 8) & 0xff;  ihdr[3] = w & 0xff;
  ihdr[4] = (h >> 24) & 0xff; ihdr[5] = (h >> 16) & 0xff;
  ihdr[6] = (h >> 8) & 0xff;  ihdr[7] = h & 0xff;
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 2;   // color type RGB
  ihdr[10] = 0; ihdr[11] = 0; ihdr[12] = 0;
  png_chunk(out, "IHDR", ihdr, 13);
  png_chunk(out, "IDAT", z.data(), z.size());
  png_chunk(out, "IEND", nullptr, 0);

  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  size_t n = fwrite(out.data(), 1, out.size(), f);
  fclose(f);
  return n == out.size() ? 0 : -2;
}

// ------------------------------------------------------------------- PPM

int brt_write_ppm(const char* path, const uint8_t* rgb, int w, int h) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  fprintf(f, "P6\n%d %d\n255\n", w, h);
  size_t n = fwrite(rgb, 1, (size_t)w * h * 3, f);
  fclose(f);
  return n == (size_t)w * h * 3 ? 0 : -2;
}

// ------------------------------------------------------------------- EXR

static void put_bytes(std::vector<uint8_t>& v, const void* p, size_t n) {
  const uint8_t* b = (const uint8_t*)p;
  v.insert(v.end(), b, b + n);
}

// little-endian host assumed (x86/arm)
static void put_i32(std::vector<uint8_t>& v, int32_t x) { put_bytes(v, &x, 4); }
static void put_u32(std::vector<uint8_t>& v, uint32_t x) { put_bytes(v, &x, 4); }
static void put_u64(std::vector<uint8_t>& v, uint64_t x) { put_bytes(v, &x, 8); }
static void put_f32(std::vector<uint8_t>& v, float x) { put_bytes(v, &x, 4); }

static void put_str(std::vector<uint8_t>& v, const char* s) {
  put_bytes(v, s, strlen(s) + 1);
}

static void exr_attr(std::vector<uint8_t>& v, const char* name,
                     const char* type, const void* data, int32_t size) {
  put_str(v, name);
  put_str(v, type);
  put_i32(v, size);
  put_bytes(v, data, size);
}

// linear f32 rgb [h][w][3] -> minimal single-part uncompressed EXR.
int brt_write_exr(const char* path, const float* rgb, int w, int h) {
  std::vector<uint8_t> out;
  put_u32(out, 20000630u);  // magic
  put_u32(out, 2u);         // version 2, no flags

  // channel list: B, G, R (alphabetical), each float (type 2).
  std::vector<uint8_t> chl;
  for (const char* cn : {"B", "G", "R"}) {
    put_str(chl, cn);
    put_i32(chl, 2);  // pixel type float
    put_u32(chl, 0); // pLinear + reserved
    put_i32(chl, 1);  // xSampling
    put_i32(chl, 1);  // ySampling
  }
  chl.push_back(0);  // end of channel list
  exr_attr(out, "channels", "chlist", chl.data(), (int32_t)chl.size());

  uint8_t comp = 0;  // no compression
  exr_attr(out, "compression", "compression", &comp, 1);
  int32_t dw[4] = {0, 0, w - 1, h - 1};
  exr_attr(out, "dataWindow", "box2i", dw, 16);
  exr_attr(out, "displayWindow", "box2i", dw, 16);
  uint8_t order = 0;  // increasing y
  exr_attr(out, "lineOrder", "lineOrder", &order, 1);
  float par = 1.0f;
  exr_attr(out, "pixelAspectRatio", "float", &par, 4);
  float swc[2] = {0.f, 0.f};
  exr_attr(out, "screenWindowCenter", "v2f", swc, 8);
  float sww = 1.0f;
  exr_attr(out, "screenWindowWidth", "float", &sww, 4);
  out.push_back(0);  // end of header

  // scanline offset table (h entries) then chunks.
  size_t table_pos = out.size();
  for (int y = 0; y < h; y++) put_u64(out, 0);

  std::vector<uint64_t> offsets(h);
  for (int y = 0; y < h; y++) {
    offsets[y] = out.size();
    put_i32(out, y);
    put_i32(out, w * 3 * 4);
    // planar by channel, B then G then R.
    for (int c : {2, 1, 0}) {
      for (int x = 0; x < w; x++) {
        put_f32(out, rgb[((size_t)y * w + x) * 3 + c]);
      }
    }
  }
  for (int y = 0; y < h; y++) {
    memcpy(out.data() + table_pos + (size_t)y * 8, &offsets[y], 8);
  }

  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  size_t n = fwrite(out.data(), 1, out.size(), f);
  fclose(f);
  return n == out.size() ? 0 : -2;
}

// --------------------------------------------------------- tile assembly

// Gather per-device pixel stripes into the full flat framebuffer.
// tiles: [n_tiles][tile_pixels*3] float; starts: absolute pixel offsets.
void brt_assemble_tiles(const float* const* tiles, const int64_t* starts,
                        const int64_t* sizes, int n_tiles, float* dst) {
  for (int t = 0; t < n_tiles; ++t) {
    memcpy(dst + starts[t] * 3, tiles[t], (size_t)sizes[t] * 3 * sizeof(float));
  }
}


// ------------------------------------------------- async frame writer

// A worker-pool executor that overlaps host-side encoding/IO with device
// rendering: the frame loop submits a frame (buffer copied immediately,
// so the caller may reuse it) and continues; workers tone-map + encode +
// write in the background.  This is the runtime piece the reference gets
// for free from its GPU presentation path (the image never leaves the
// GPU, `src/ray_trace_output.rs:65-77`); a headless renderer must
// pipeline writeback explicitly or stall the device between frames.

}  // extern "C"

#include <condition_variable>
#include <deque>
#include <mutex>
#include <string>
#include <thread>

namespace {

struct WriteJob {
  std::string path;
  std::vector<float> rgb;  // linear float, h*w*3
  int w, h;
  int fmt;  // 0=png 1=ppm 2=exr
};

struct Writer {
  std::deque<WriteJob> queue;
  std::mutex mu;
  std::condition_variable cv;       // workers wait for jobs
  std::condition_variable done_cv;  // wait() waits for drain
  std::vector<std::thread> threads;
  int in_flight = 0;
  int failed = 0;
  bool stop = false;
};

void writer_worker(Writer* wr) {
  for (;;) {
    WriteJob job;
    {
      std::unique_lock<std::mutex> lk(wr->mu);
      wr->cv.wait(lk, [&] { return wr->stop || !wr->queue.empty(); });
      if (wr->queue.empty()) return;  // stop && drained
      job = std::move(wr->queue.front());
      wr->queue.pop_front();
    }
    int rc = 0;
    const size_t n = (size_t)job.w * job.h * 3;
    if (job.fmt == 2) {
      rc = brt_write_exr(job.path.c_str(), job.rgb.data(), job.w, job.h);
    } else {
      std::vector<uint8_t> u8(n);
      brt_tonemap_srgb(job.rgb.data(), u8.data(), (int64_t)n);
      rc = job.fmt == 0
               ? brt_write_png(job.path.c_str(), u8.data(), job.w, job.h)
               : brt_write_ppm(job.path.c_str(), u8.data(), job.w, job.h);
    }
    {
      std::lock_guard<std::mutex> lk(wr->mu);
      if (rc != 0) wr->failed++;
      wr->in_flight--;
      if (wr->in_flight == 0 && wr->queue.empty()) wr->done_cv.notify_all();
    }
  }
}

}  // namespace

extern "C" {

void* brt_writer_create(int n_threads) {
  if (n_threads < 1) n_threads = 1;
  Writer* wr = new Writer();
  for (int i = 0; i < n_threads; i++) {
    wr->threads.emplace_back(writer_worker, wr);
  }
  return wr;
}

// Copies `rgb` (linear float [h, w, 3]) and enqueues; returns 0.
int brt_writer_submit(void* handle, const char* path, const float* rgb,
                      int w, int h, int fmt) {
  Writer* wr = static_cast<Writer*>(handle);
  if (!wr || !path || !rgb || w <= 0 || h <= 0 || fmt < 0 || fmt > 2)
    return -1;
  WriteJob job;
  job.path = path;
  job.rgb.assign(rgb, rgb + (size_t)w * h * 3);
  job.w = w;
  job.h = h;
  job.fmt = fmt;
  {
    std::lock_guard<std::mutex> lk(wr->mu);
    wr->queue.push_back(std::move(job));
    wr->in_flight++;
  }
  wr->cv.notify_one();
  return 0;
}

// Blocks until every submitted job has been written; returns the number
// of failed jobs since the last wait (and resets that counter).
int brt_writer_wait(void* handle) {
  Writer* wr = static_cast<Writer*>(handle);
  if (!wr) return -1;
  std::unique_lock<std::mutex> lk(wr->mu);
  wr->done_cv.wait(lk, [&] { return wr->in_flight == 0 && wr->queue.empty(); });
  int failed = wr->failed;
  wr->failed = 0;
  return failed;
}

void brt_writer_destroy(void* handle) {
  Writer* wr = static_cast<Writer*>(handle);
  if (!wr) return;
  {
    std::lock_guard<std::mutex> lk(wr->mu);
    wr->stop = true;
  }
  wr->cv.notify_all();
  for (auto& t : wr->threads) t.join();
  delete wr;
}

}  // extern "C"
