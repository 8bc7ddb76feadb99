// linrad_tpu_torch native runtime (lrt)
//
// C++ replacements for the reference's native runtime layer:
//  - 18/24-bit raw-file packing/expansion (reference csplit.c:18
//    expand_rawdat, getiq.s compress_rawdat; format notes
//    z_WAV_FORMATS.txt) with the reference's 0.5-bit dither on expand
//  - int16 -> float32 block conversion with scaling (the fused
//    conversion the reference does in SIMD assembly, simdasm.s:35-43)
//  - a single-producer / single-consumer ring buffer with condvar
//    blocking (the circular-buffer discipline of z_BUFFERS.txt) used by
//    the file prefetcher so disk I/O overlaps device compute
//
// Built with: g++ -O3 -shared -fPIC (see runtime/__init__.py); exposed
// through ctypes; every entry point has a numpy fallback.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// 18-bit packing: 4 x int32 -> 9 bytes (4 x top-16 + 1 byte of 4 x 2 bits)
// layout per reference csplit.c:20-70 / getiq.s
// ---------------------------------------------------------------------------

void lrt_pack18(const int32_t* in, uint8_t* out, int64_t n_samples) {
  for (int64_t g = 0; g < n_samples / 4; ++g) {
    const int32_t* s = in + 4 * g;
    uint8_t* o = out + 9 * g;
    uint8_t extra = 0;
    for (int k = 0; k < 4; ++k) {
      uint32_t v = (uint32_t)s[k];
      o[2 * k] = (uint8_t)(v >> 16);
      o[2 * k + 1] = (uint8_t)(v >> 24);
      // sample 0's extra bits end up at bits 7-6, matching the expand
      // order of csplit.c (first sample consumes m & 0xc0, then m <<= 2)
      extra = (uint8_t)((extra << 2) | ((v >> 14) & 3u));
    }
    o[8] = extra;
  }
}

void lrt_expand18(const uint8_t* in, int32_t* out, int64_t n_samples) {
  for (int64_t g = 0; g < n_samples / 4; ++g) {
    const uint8_t* s = in + 9 * g;
    int32_t* o = out + 4 * g;
    uint8_t m = s[8];
    for (int k = 0; k < 4; ++k) {
      // bytes: [0, (2 bits<<6)|0x20, lo16, hi16]  (csplit.c:36-56);
      // 0x20 in byte 1 is the half-bit dither that removes the DC spur
      uint32_t v = ((uint32_t)(m & 0xc0u) << 8) | 0x2000u;
      v |= ((uint32_t)s[2 * k] << 16) | ((uint32_t)s[2 * k + 1] << 24);
      o[k] = (int32_t)v;
      m = (uint8_t)(m << 2);
    }
  }
}

// ---------------------------------------------------------------------------
// 24-bit packing: int32 -> 3 bytes (top 24), and back with sign extension
// ---------------------------------------------------------------------------

void lrt_pack24(const int32_t* in, uint8_t* out, int64_t n_samples) {
  for (int64_t i = 0; i < n_samples; ++i) {
    uint32_t v = (uint32_t)in[i];
    out[3 * i] = (uint8_t)(v >> 8);
    out[3 * i + 1] = (uint8_t)(v >> 16);
    out[3 * i + 2] = (uint8_t)(v >> 24);
  }
}

void lrt_expand24(const uint8_t* in, int32_t* out, int64_t n_samples) {
  for (int64_t i = 0; i < n_samples; ++i) {
    uint32_t v = ((uint32_t)in[3 * i] << 8) |
                 ((uint32_t)in[3 * i + 1] << 16) |
                 ((uint32_t)in[3 * i + 2] << 24);
    out[i] = (int32_t)v;
  }
}

// ---------------------------------------------------------------------------
// int16 interleaved -> float32 (+ optional IQ pairing is done in numpy;
// this is the bulk conversion that feeds fft1, simdasm.s analog)
// ---------------------------------------------------------------------------

void lrt_i16_to_f32(const int16_t* in, float* out, int64_t n,
                    float scale) {
  for (int64_t i = 0; i < n; ++i) out[i] = scale * (float)in[i];
}

void lrt_i32_to_f32(const int32_t* in, float* out, int64_t n,
                    float scale) {
  for (int64_t i = 0; i < n; ++i) out[i] = scale * (float)in[i];
}


// ---------------------------------------------------------------------------
// SPSC byte ring buffer (z_BUFFERS.txt discipline: one creator advances
// pa, one consumer advances px; blocking handled with a condvar like
// lir_await_event / lir_set_event, lxsys.c:429-438)
// ---------------------------------------------------------------------------

struct LrtRing {
  std::vector<uint8_t> buf;
  size_t mask;
  std::atomic<uint64_t> pa{0};  // producer offset
  std::atomic<uint64_t> px{0};  // consumer offset
  std::mutex m;
  std::condition_variable cv;
  std::atomic<bool> closed{false};
};

void* lrt_ring_create(int64_t size_pow2) {
  auto* r = new LrtRing();
  size_t sz = 1;
  while ((int64_t)sz < size_pow2) sz <<= 1;
  r->buf.resize(sz);
  r->mask = sz - 1;
  return r;
}

void lrt_ring_destroy(void* h) { delete (LrtRing*)h; }

int64_t lrt_ring_fill(void* h) {
  auto* r = (LrtRing*)h;
  return (int64_t)(r->pa.load() - r->px.load());
}

void lrt_ring_close(void* h) {
  auto* r = (LrtRing*)h;
  r->closed.store(true);
  std::lock_guard<std::mutex> lk(r->m);
  r->cv.notify_all();
}

// blocking write; returns bytes written (0 if closed)
int64_t lrt_ring_write(void* h, const uint8_t* data, int64_t n) {
  auto* r = (LrtRing*)h;
  size_t cap = r->mask + 1;
  int64_t done = 0;
  while (done < n) {
    std::unique_lock<std::mutex> lk(r->m);
    r->cv.wait(lk, [&] {
      return r->closed.load() ||
             (r->pa.load() - r->px.load()) < cap;
    });
    if (r->closed.load()) return done;
    uint64_t pa = r->pa.load();
    int64_t space = (int64_t)(cap - (pa - r->px.load()));
    int64_t chunk = std::min(space, n - done);
    for (int64_t i = 0; i < chunk; ++i)
      r->buf[(pa + i) & r->mask] = data[done + i];
    r->pa.store(pa + chunk);
    done += chunk;
    r->cv.notify_all();
  }
  return done;
}

// blocking read; returns bytes read (may be short only when closed)
int64_t lrt_ring_read(void* h, uint8_t* data, int64_t n) {
  auto* r = (LrtRing*)h;
  int64_t done = 0;
  while (done < n) {
    std::unique_lock<std::mutex> lk(r->m);
    r->cv.wait(lk, [&] {
      return r->closed.load() || (r->pa.load() - r->px.load()) > 0;
    });
    uint64_t avail = r->pa.load() - r->px.load();
    if (avail == 0 && r->closed.load()) return done;
    uint64_t px = r->px.load();
    int64_t chunk = std::min((int64_t)avail, n - done);
    for (int64_t i = 0; i < chunk; ++i)
      data[done + i] = r->buf[(px + i) & r->mask];
    r->px.store(px + chunk);
    done += chunk;
    r->cv.notify_all();
  }
  return done;
}

// ---------------------------------------------------------------------------
// native file-reader thread feeding a ring: the data-loader of the
// framework (reference THREAD_RX_FILE_INPUT, lxsys.c / modesub.c:1022);
// the whole disk -> ring path runs off the GIL
// ---------------------------------------------------------------------------

struct LrtPrefetch {
  std::thread t;
};

void* lrt_prefetch_start(const char* path, int64_t offset,
                         int64_t block_bytes, void* ring) {
  auto* p = new LrtPrefetch();
  std::string path_s(path);
  auto* r = (LrtRing*)ring;
  p->t = std::thread([path_s, offset, block_bytes, r]() {
    FILE* f = fopen(path_s.c_str(), "rb");
    if (f != nullptr) {
      fseek(f, (long)offset, SEEK_SET);
      std::vector<uint8_t> buf((size_t)block_bytes);
      for (;;) {
        size_t got = fread(buf.data(), 1, (size_t)block_bytes, f);
        if (got == 0) break;
        if (lrt_ring_write(r, buf.data(), (int64_t)got) <
            (int64_t)got)
          break;  // consumer closed the ring
        if (got < (size_t)block_bytes) break;
      }
      fclose(f);
    }
    lrt_ring_close(r);
  });
  return p;
}

void lrt_prefetch_join(void* h) {
  auto* p = (LrtPrefetch*)h;
  if (p->t.joinable()) p->t.join();
  delete p;
}

}  // extern "C"
