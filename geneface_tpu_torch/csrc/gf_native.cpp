// gf_native.cpp — native (C++) host runtime of geneface_tpu_torch, a copy of
// the JAX package's geneface_tpu/native/src/gf_native.cpp with the same
// functions (the port imports nothing of that package).
//
// Where the reference leans on torch's DataLoader workers for its host-side
// data plumbing (utils/commons/dataset_utils.py,
// tasks/radnerfs/dataset_utils.py:169-206), this library provides
//
//   1. a **pixel-batch assembler** for NeRF ray training: per step it samples
//      ray pixel indices, gathers gt / bg / torso pixels from uint8 frame
//      planes and composites torso-over-background in fixed point — all in a
//      worker-thread prefetch pipeline so batch assembly overlaps device
//      compute. The Python path converts whole 512x512 frames to float every
//      step; this one touches only the 65,536 sampled pixels.
//
//   2. an **mmap'd record reader** for the IndexedDataset container
//      (reference utils/commons/indexed_datasets.py:27-98): chunk files are
//      mapped once; record reads are memcpy from the page cache with
//      madvise-driven readahead. Index parsing (a Python pickle) stays on the
//      Python side; this layer serves raw byte ranges.
//
// Exposed as a plain C ABI consumed via ctypes
// (geneface_tpu_torch/native/__init__.py), built with g++ by
// geneface_tpu_torch/native/build.py.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// ----------------------------------------------------------------- RNG -----
// xoshiro128++ — small, fast, splittable enough for per-job seeding.
struct Xoshiro128 {
  uint32_t s[4];
  explicit Xoshiro128(uint64_t seed) {
    // splitmix64 expansion of the seed into the state
    uint64_t x = seed + 0x9E3779B97f4A7C15ull;
    for (int i = 0; i < 4; ++i) {
      uint64_t z = (x += 0x9E3779B97f4A7C15ull);
      z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
      z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
      s[i] = static_cast<uint32_t>((z ^ (z >> 31)) >> 16);
    }
  }
  static uint32_t rotl(uint32_t x, int k) { return (x << k) | (x >> (32 - k)); }
  uint32_t next() {
    uint32_t result = rotl(s[0] + s[3], 7) + s[0];
    uint32_t t = s[1] << 9;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 11);
    return result;
  }
  // uniform int in [0, n) without modulo bias (Lemire)
  uint32_t bounded(uint32_t n) {
    uint64_t m = static_cast<uint64_t>(next()) * n;
    uint32_t lo = static_cast<uint32_t>(m);
    if (lo < n) {
      uint32_t t = (-n) % n;
      while (lo < t) {
        m = static_cast<uint64_t>(next()) * n;
        lo = static_cast<uint32_t>(m);
      }
    }
    return static_cast<uint32_t>(m >> 32);
  }
};

// ------------------------------------------------------------- gathers -----
struct FramePlanes {
  const uint8_t* gt;     // [T, HW, 3]
  const uint8_t* torso;  // [T, HW, torso_ch] (RGBA straight alpha, or RGB)
  const uint8_t* bg;     // [HW, 3]
  int torso_ch;
  int64_t T, HW;
};

inline void gather_pixels(const FramePlanes& fp, int64_t frame,
                          const int32_t* inds, int64_t n, uint8_t* out_gt,
                          uint8_t* out_bg, uint8_t* out_bgt) {
  const uint8_t* gtf = fp.gt + frame * fp.HW * 3;
  const uint8_t* tof = fp.torso + frame * fp.HW * fp.torso_ch;
  for (int64_t k = 0; k < n; ++k) {
    const int64_t p = inds[k];
    const uint8_t* g = gtf + p * 3;
    const uint8_t* b = fp.bg + p * 3;
    uint8_t* og = out_gt + k * 3;
    uint8_t* ob = out_bg + k * 3;
    uint8_t* ot = out_bgt + k * 3;
    og[0] = g[0]; og[1] = g[1]; og[2] = g[2];
    ob[0] = b[0]; ob[1] = b[1]; ob[2] = b[2];
    if (fp.torso_ch == 4) {
      const uint8_t* t = tof + p * 4;
      const uint32_t a = t[3];
      const uint32_t ia = 255u - a;
      // straight-alpha composite with round-to-nearest; /255 via the exact
      // (x + 128 + (x+128>>8)) >> 8 trick
      for (int c = 0; c < 3; ++c) {
        uint32_t x = t[c] * a + b[c] * ia;
        x += 128u;
        ot[c] = static_cast<uint8_t>((x + (x >> 8)) >> 8);
      }
    } else {
      const uint8_t* t = tof + p * 3;
      ot[0] = t[0]; ot[1] = t[1]; ot[2] = t[2];
    }
  }
}

// ------------------------------------------------------------ pipeline -----
struct Job {
  int64_t frame;
  int64_t n;
  uint64_t seed;
  // rect sampling (lip patches): when rect_w > 0, indices form the
  // [x0, x0+rect_h) x [y0, y0+rect_w) grid instead of uniform random pixels
  int32_t x0, y0, rect_h, rect_w;
  int32_t W;  // frame width for rect index math
};

struct Batch {
  std::vector<int32_t> inds;
  std::vector<uint8_t> gt, bg, bgt;
};

struct Loader {
  FramePlanes fp;
  int depth;
  std::deque<Job> jobs;
  std::deque<Batch> done;  // completed batches, FIFO == submit order
  std::mutex mu;
  std::condition_variable cv_job, cv_done;
  std::vector<std::thread> workers;
  bool stop = false;
  // FIFO completion: jobs are executed one at a time per worker, but results
  // must come back in submit order — track a ticket per job.
  uint64_t next_ticket = 0, next_emit = 0;
  std::deque<std::pair<uint64_t, Batch>> out_of_order;

  void run_worker() {
    for (;;) {
      Job job;
      uint64_t ticket;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_job.wait(lk, [&] { return stop || !jobs.empty(); });
        if (stop && jobs.empty()) return;
        job = jobs.front();
        jobs.pop_front();
        ticket = next_ticket++;
      }
      Batch b;
      b.inds.resize(job.n);
      b.gt.resize(job.n * 3);
      b.bg.resize(job.n * 3);
      b.bgt.resize(job.n * 3);
      if (job.rect_w > 0) {
        int64_t k = 0;
        for (int32_t x = job.x0; x < job.x0 + job.rect_h; ++x)
          for (int32_t y = job.y0; y < job.y0 + job.rect_w; ++y)
            b.inds[k++] = x * job.W + y;
      } else {
        Xoshiro128 rng(job.seed);
        const uint32_t hw = static_cast<uint32_t>(fp.HW);
        for (int64_t k = 0; k < job.n; ++k)
          b.inds[k] = static_cast<int32_t>(rng.bounded(hw));
      }
      gather_pixels(fp, job.frame, b.inds.data(), job.n, b.gt.data(),
                    b.bg.data(), b.bgt.data());
      {
        std::unique_lock<std::mutex> lk(mu);
        out_of_order.emplace_back(ticket, std::move(b));
        // drain in ticket order
        for (;;) {
          bool moved = false;
          for (auto it = out_of_order.begin(); it != out_of_order.end(); ++it) {
            if (it->first == next_emit) {
              done.push_back(std::move(it->second));
              out_of_order.erase(it);
              ++next_emit;
              moved = true;
              break;
            }
          }
          if (!moved) break;
        }
        cv_done.notify_all();
      }
    }
  }
};

struct Store {
  struct Chunk {
    void* map = nullptr;
    size_t len = 0;
    int64_t begin = 0;  // absolute offset of this chunk's first byte
  };
  std::vector<Chunk> chunks;
};

}  // namespace

extern "C" {

// ------------------------------------------------------ loader C API -------
void* gf_loader_create(const uint8_t* gt, const uint8_t* torso, int torso_ch,
                       const uint8_t* bg, int64_t T, int64_t HW, int n_threads,
                       int depth) {
  auto* L = new Loader();
  L->fp = FramePlanes{gt, torso, bg, torso_ch, T, HW};
  L->depth = depth > 0 ? depth : 4;
  if (n_threads < 1) n_threads = 1;
  for (int i = 0; i < n_threads; ++i)
    L->workers.emplace_back([L] { L->run_worker(); });
  return L;
}

void gf_loader_destroy(void* h) {
  auto* L = static_cast<Loader*>(h);
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->stop = true;
  }
  L->cv_job.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

// Submit a batch job. rect_w <= 0 -> uniform random sampling of n pixels.
void gf_loader_submit(void* h, int64_t frame, int64_t n, uint64_t seed,
                      int32_t x0, int32_t y0, int32_t rect_h, int32_t rect_w,
                      int32_t W) {
  auto* L = static_cast<Loader*>(h);
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->jobs.push_back(Job{frame, n, seed, x0, y0, rect_h, rect_w, W});
  }
  L->cv_job.notify_one();
}

// Block until the oldest submitted batch is ready; copy into caller buffers.
// Returns the number of rays in the batch.
int64_t gf_loader_wait(void* h, int32_t* out_inds, uint8_t* out_gt,
                       uint8_t* out_bg, uint8_t* out_bgt) {
  auto* L = static_cast<Loader*>(h);
  Batch b;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_done.wait(lk, [&] { return !L->done.empty(); });
    b = std::move(L->done.front());
    L->done.pop_front();
  }
  const int64_t n = static_cast<int64_t>(b.inds.size());
  std::memcpy(out_inds, b.inds.data(), n * sizeof(int32_t));
  std::memcpy(out_gt, b.gt.data(), n * 3);
  std::memcpy(out_bg, b.bg.data(), n * 3);
  std::memcpy(out_bgt, b.bgt.data(), n * 3);
  return n;
}

// Synchronous single-batch assembly (no queue) for given indices.
void gf_gather(const uint8_t* gt, const uint8_t* torso, int torso_ch,
               const uint8_t* bg, int64_t HW, int64_t frame,
               const int32_t* inds, int64_t n, uint8_t* out_gt,
               uint8_t* out_bg, uint8_t* out_bgt) {
  FramePlanes fp{gt, torso, bg, torso_ch, /*T=*/frame + 1, HW};
  gather_pixels(fp, frame, inds, n, out_gt, out_bg, out_bgt);
}

// ------------------------------------------------------- store C API -------
void* gf_store_open(const char* const* paths, int n_chunks,
                    const int64_t* chunk_begin) {
  auto* S = new Store();
  S->chunks.resize(n_chunks);
  for (int i = 0; i < n_chunks; ++i) {
    int fd = ::open(paths[i], O_RDONLY);
    if (fd < 0) {
      delete S;
      return nullptr;
    }
    struct stat st;
    if (fstat(fd, &st) != 0) {
      ::close(fd);
      delete S;
      return nullptr;
    }
    void* m = ::mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
    ::close(fd);
    if (m == MAP_FAILED) {
      delete S;
      return nullptr;
    }
    ::madvise(m, st.st_size, MADV_RANDOM);
    S->chunks[i] = Store::Chunk{m, static_cast<size_t>(st.st_size),
                                chunk_begin[i]};
  }
  return S;
}

void gf_store_close(void* h) {
  auto* S = static_cast<Store*>(h);
  for (auto& c : S->chunks)
    if (c.map) ::munmap(c.map, c.len);
  delete S;
}

// Copy [abs_off, abs_off+len) into out. Returns 0 on success.
int gf_store_read(void* h, int64_t abs_off, int64_t len, uint8_t* out) {
  auto* S = static_cast<Store*>(h);
  // find the chunk containing abs_off (chunks sorted by begin)
  int lo = 0, hi = static_cast<int>(S->chunks.size()) - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) / 2;
    if (S->chunks[mid].begin <= abs_off)
      lo = mid;
    else
      hi = mid - 1;
  }
  const auto& c = S->chunks[lo];
  const int64_t local = abs_off - c.begin;
  if (local < 0 || static_cast<size_t>(local + len) > c.len) return -1;
  std::memcpy(out, static_cast<const uint8_t*>(c.map) + local, len);
  return 0;
}

// Hint the kernel to page-in a byte range ahead of use.
void gf_store_prefetch(void* h, int64_t abs_off, int64_t len) {
  auto* S = static_cast<Store*>(h);
  int lo = 0, hi = static_cast<int>(S->chunks.size()) - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) / 2;
    if (S->chunks[mid].begin <= abs_off)
      lo = mid;
    else
      hi = mid - 1;
  }
  const auto& c = S->chunks[lo];
  const int64_t local = abs_off - c.begin;
  if (local < 0 || static_cast<size_t>(local) >= c.len) return;
  const long page = sysconf(_SC_PAGESIZE);
  uint8_t* base = static_cast<uint8_t*>(c.map);
  uint8_t* p = base + (local / page) * page;
  size_t span = static_cast<size_t>(local % page + len);
  if (p + span > base + c.len) span = base + c.len - p;
  ::madvise(p, span, MADV_WILLNEED);
}

}  // extern "C"
