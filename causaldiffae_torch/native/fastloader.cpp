// fastloader.cpp - native data-pipeline core for causaldiffae_torch: the
// port's own copy of causaldiffae_tpu/native/fastloader.cpp (the same code).
//
// The reference feeds its trainers through torch DataLoader worker processes
// (PIL decode + tensor convert per item, `image_datasets.py`). Feeding an
// accelerator at 16k+ samples/sec from Python is GIL-bound, so the hot
// host-side ops live here:
//   - whole-file gunzip (IDX archive decode) via zlib
//   - multithreaded batch gather with fused uint8->float32 normalization
//   - a double-buffered prefetch loader that assembles the next batch on
//     worker threads while the device computes
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in the image).
//
// Build (data/native_loader.py, into build/causaldiffae_torch/ at first use):
//   g++ -O3 -march=native -shared -fPIC -o libfastloader-<hash>.so fastloader.cpp -lz -lpthread

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------- gunzip
// Decompress an entire .gz file into a malloc'd buffer. Returns 0 on
// success; caller frees with fl_free.
int fl_gunzip_file(const char* path, uint8_t** out, int64_t* out_len) {
  gzFile f = gzopen(path, "rb");
  if (!f) return -1;
  size_t cap = 1 << 20, len = 0;
  uint8_t* buf = (uint8_t*)malloc(cap);
  if (!buf) { gzclose(f); return -2; }
  for (;;) {
    if (len == cap) {
      cap *= 2;
      uint8_t* nb = (uint8_t*)realloc(buf, cap);
      if (!nb) { free(buf); gzclose(f); return -2; }
      buf = nb;
    }
    int n = gzread(f, buf + len, (unsigned)(cap - len));
    if (n < 0) { free(buf); gzclose(f); return -3; }
    if (n == 0) break;
    len += (size_t)n;
  }
  gzclose(f);
  *out = buf;
  *out_len = (int64_t)len;
  return 0;
}

void fl_free(uint8_t* p) { free(p); }

// ------------------------------------------------- gather + normalize
// out[b, :] = (float)images[indices[b], :] * scale + offset
// Threads split the batch; each sample row is a contiguous memcpy-convert,
// vectorized by the compiler.
void fl_gather_u8_to_f32(const uint8_t* images, int64_t sample_elems,
                         const int64_t* indices, int64_t batch, float scale,
                         float offset, float* out, int threads) {
  if (threads < 1) threads = 1;
  auto work = [&](int64_t b0, int64_t b1) {
    for (int64_t b = b0; b < b1; ++b) {
      const uint8_t* src = images + indices[b] * sample_elems;
      float* dst = out + b * sample_elems;
      for (int64_t i = 0; i < sample_elems; ++i)
        dst[i] = (float)src[i] * scale + offset;
    }
  };
  if (threads == 1 || batch < 2 * threads) {
    work(0, batch);
    return;
  }
  std::vector<std::thread> pool;
  int64_t per = (batch + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t b0 = t * per, b1 = std::min(batch, b0 + per);
    if (b0 >= b1) break;
    pool.emplace_back(work, b0, b1);
  }
  for (auto& th : pool) th.join();
}

// float32 row gather (labels / precomputed-float images)
void fl_gather_f32(const float* src, int64_t row_elems, const int64_t* indices,
                   int64_t batch, float* out, int threads) {
  if (threads < 1) threads = 1;
  auto work = [&](int64_t b0, int64_t b1) {
    for (int64_t b = b0; b < b1; ++b)
      memcpy(out + b * row_elems, src + indices[b] * row_elems,
             (size_t)row_elems * sizeof(float));
  };
  if (threads == 1 || batch < 2 * threads) {
    work(0, batch);
    return;
  }
  std::vector<std::thread> pool;
  int64_t per = (batch + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    int64_t b0 = t * per, b1 = std::min(batch, b0 + per);
    if (b0 >= b1) break;
    pool.emplace_back(work, b0, b1);
  }
  for (auto& th : pool) th.join();
}

// int64 row gather (class labels)
void fl_gather_i64(const int64_t* src, int64_t row_elems, const int64_t* indices,
                   int64_t batch, int64_t* out) {
  for (int64_t b = 0; b < batch; ++b)
    memcpy(out + b * row_elems, src + indices[b] * row_elems,
           (size_t)row_elems * sizeof(int64_t));
}

// ------------------------------------------------- prefetching loader
// Owns shuffled-index generation and assembles normalized image batches on
// a background thread into a 2-slot ring; fl_next blocks only if the
// prefetcher is behind.
struct Loader {
  const uint8_t* images;      // borrowed, caller keeps alive
  const float* labels_c;      // may be null
  const int64_t* labels_y;    // may be null
  int64_t n, sample_elems, c_elems;
  int64_t batch;
  float scale, offset;
  int threads;
  std::mt19937_64 rng;

  static const int SLOTS = 2;
  std::vector<float> img_buf[SLOTS];
  std::vector<float> c_buf[SLOTS];
  std::vector<int64_t> y_buf[SLOTS];
  std::atomic<int> ready[SLOTS];
  int produce_slot = 0, consume_slot = 0;
  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  std::thread worker;
  std::atomic<bool> stop{false};

  std::vector<int64_t> perm;
  size_t perm_pos = 0;

  void refill_perm() {
    if (perm.empty()) {
      perm.resize((size_t)n);
      for (int64_t i = 0; i < n; ++i) perm[(size_t)i] = i;
    }
    std::shuffle(perm.begin(), perm.end(), rng);
    perm_pos = 0;
  }

  void produce_one(int slot) {
    std::vector<int64_t> idx((size_t)batch);
    for (int64_t b = 0; b < batch; ++b) {
      if (perm_pos >= perm.size()) refill_perm();
      idx[(size_t)b] = perm[perm_pos++];
    }
    fl_gather_u8_to_f32(images, sample_elems, idx.data(), batch, scale, offset,
                        img_buf[slot].data(), threads);
    if (labels_c)
      fl_gather_f32(labels_c, c_elems, idx.data(), batch, c_buf[slot].data(), 1);
    if (labels_y)
      fl_gather_i64(labels_y, 1, idx.data(), batch, y_buf[slot].data());
  }

  void run() {
    for (;;) {
      std::unique_lock<std::mutex> lk(mu);
      cv_produce.wait(lk, [&] { return stop.load() || !ready[produce_slot].load(); });
      if (stop.load()) return;
      lk.unlock();
      produce_one(produce_slot);
      ready[produce_slot].store(1);
      cv_consume.notify_one();
      produce_slot = (produce_slot + 1) % SLOTS;
    }
  }
};

void* fl_loader_create(const uint8_t* images, int64_t n, int64_t sample_elems,
                       const float* labels_c, int64_t c_elems,
                       const int64_t* labels_y, int64_t batch, float scale,
                       float offset, uint64_t seed, int threads) {
  Loader* L = new Loader();
  L->images = images;
  L->labels_c = labels_c;
  L->labels_y = labels_y;
  L->n = n;
  L->sample_elems = sample_elems;
  L->c_elems = c_elems;
  L->batch = batch;
  L->scale = scale;
  L->offset = offset;
  L->threads = threads;
  L->rng.seed(seed);
  L->refill_perm();
  for (int s = 0; s < Loader::SLOTS; ++s) {
    L->img_buf[s].resize((size_t)(batch * sample_elems));
    if (labels_c) L->c_buf[s].resize((size_t)(batch * c_elems));
    if (labels_y) L->y_buf[s].resize((size_t)batch);
    L->ready[s].store(0);
  }
  L->worker = std::thread(&Loader::run, L);
  return L;
}

// Copies the next ready batch into caller buffers (blocking).
void fl_loader_next(void* handle, float* out_images, float* out_c,
                    int64_t* out_y) {
  Loader* L = (Loader*)handle;
  int slot = L->consume_slot;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_consume.wait(lk, [&] { return L->ready[slot].load() != 0; });
  }
  memcpy(out_images, L->img_buf[slot].data(),
         L->img_buf[slot].size() * sizeof(float));
  if (L->labels_c && out_c)
    memcpy(out_c, L->c_buf[slot].data(), L->c_buf[slot].size() * sizeof(float));
  if (L->labels_y && out_y)
    memcpy(out_y, L->y_buf[slot].data(), L->y_buf[slot].size() * sizeof(int64_t));
  L->ready[slot].store(0);
  L->cv_produce.notify_one();
  L->consume_slot = (slot + 1) % Loader::SLOTS;
}

void fl_loader_destroy(void* handle) {
  Loader* L = (Loader*)handle;
  L->stop.store(true);
  L->cv_produce.notify_all();
  if (L->worker.joinable()) L->worker.join();
  delete L;
}

}  // extern "C"
