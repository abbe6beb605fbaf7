// Row scatter-add for Hopper (sm_90a):  out[r, c] += updates[i, c]  for
// every i with 0 <= rows[i] < n_rows; other rows are dropped. Updates may be
// float32, bfloat16 or float16 (widened in registers) and always accumulate
// in float32.
//
// Replaces the Pallas TPU kernel geneface_tpu/ops/pallas_scatter.py:79
// (scatter_add_rows_pallas / _kernel). That kernel kept P lane-packed copies
// of the accumulator in VMEM because the TPU has no atomics; it was limited
// to W | 128 and n_rows <= 16,384. None of that is carried over: there is no
// limit on W or n_rows here.
//
// The least the card must do is read M*(4 + W*s) bytes (a row index plus a
// row of s-byte updates) and write n_rows*W*4 bytes. What keeps a
// scatter-add from that bound is not bytes but the float atomics that
// resolve row collisions, and how they collide depends on the call site, so
// there are five variants behind one wrapper (ops/scatter.py picks by shape;
// every one is right for every input it accepts):
//
//  atomic  one thread per (update, column), one 4-byte atomicAdd to device
//          memory each. Bound by the L2's atomic rate: M*W operations,
//          serialised per address. Takes any W and any alignment, so it is
//          the variant for odd W and unaligned updates, and the baseline the
//          other variants are timed against.
//  vec     a warp takes 32 consecutive updates; a group of lanes, one lane
//          per 4 (or 2) columns, walks its share of them with four 16-byte
//          loads in flight, sums in registers while the row stays the same
//          and adds each finished sum with one vector atomicAdd(float4*)
//          (compute capability 9.x, device memory only). Where neighbouring
//          updates share their row (the dense grid levels: ~3 samples of a
//          ray per cell) that is one L2 operation per run in place of one
//          per update. Where they do not, it is bound by the L2's atomic
//          rate as atomic is: a quarter of the instructions, but only
//          1.0-1.4 times faster. Needs W % 2 == 0 and 16-byte aligned
//          updates.
//  sorted  for wide rows with many updates: a counting sort of the update
//          indices by row (per-block counts in shared memory with integer
//          atomics, a scan across blocks and rows, then every update takes
//          its place), after which each group of lanes walks a stretch of
//          the sorted updates with four row loads in flight, sums in
//          registers while the row stays the same, and adds each finished
//          sum with one vector atomic. No float atomic per update is left:
//          the sums run near the bytes bound, and the sort costs ~25 us
//          whatever the width. Needs W % 2 == 0, 16-byte aligned updates and
//          one int per table row in a block's shared memory.
//  runs    one lane per update row, for narrow rows (compiled for W 2 and
//          6) whose equal destinations are neighbours (the composite's
//          ray-major samples). The warp compares each row index with its neighbour's,
//          sums every run of equal rows with a segmented shuffle reduction,
//          and only a run's first lane adds to device memory, with 8-byte
//          vector atomics: a ray's 8-10 samples become one or two adds. It
//          merges only equal neighbours, so it is right for any order and
//          with unique rows it adds each row once, exactly.
//  smem    for tables that fit a block's shared memory (n_rows*W*4 up to
//          232,448 bytes, W up to 1,024) and get many updates per row: a
//          persistent grid of one 1,024-thread block per SM; each block
//          zeroes its accumulator in shared memory and walks a contiguous
//          slice of the updates, a group of threads (one per 4 columns)
//          taking two consecutive updates per batch with 16-byte loads, the
//          next batch's loads in flight while this batch is added; two
//          neighbouring updates of one row are summed in registers first.
//          The block writes its partial sums to a scratch
//          [blocks, n_rows*W]; a second kernel sums the partials in a fixed
//          order and writes every output element (no zero fill, no
//          device-memory atomics). A float atomicAdd on shared memory
//          compiles to a compare-and-swap loop, which colliding lanes
//          repeat, so a small table is kept in up to 8 copies, one per
//          thread group modulo 8: the groups of a warp then add to different
//          addresses. Copies start one bank apart and are folded at the
//          flush. Bound by the bytes it streams with one block per SM, then
//          by those compare-and-swap loops.
//
// Plain C interface for ctypes: every function returns the first
// cudaGetLastError() that is not cudaSuccess, checked after every launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemThreads = 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// 1, 2 or 4 consecutive update values starting at p (aligned to that many
// elements), widened to float32
__device__ __forceinline__ void load_vec(const float* p, float (&v)[1]) { v[0] = __ldg(p); }
__device__ __forceinline__ void load_vec(const float* p, float (&v)[2]) {
  const float2 t = __ldg(reinterpret_cast<const float2*>(p));
  v[0] = t.x; v[1] = t.y;
}
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[1]) {
  v[0] = __bfloat162float(p[0]);
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[2]) {
  const unsigned raw = __ldg(reinterpret_cast<const unsigned*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
  v[0] = a.x; v[1] = a.y;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void load_vec(const __half* p, float (&v)[1]) {
  v[0] = __half2float(p[0]);
}
__device__ __forceinline__ void load_vec(const __half* p, float (&v)[2]) {
  const unsigned raw = __ldg(reinterpret_cast<const unsigned*>(p));
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&raw));
  v[0] = a.x; v[1] = a.y;
}
__device__ __forceinline__ void load_vec(const __half* p, float (&v)[4]) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// one atomic add of 2 or 4 consecutive floats to device memory (p aligned
// to the vector)
__device__ __forceinline__ void red_add(float* p, const float (&v)[2]) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
}
__device__ __forceinline__ void red_add(float* p, const float (&v)[4]) {
  atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

// ---------------------------------------------------------------- atomic

template <typename T>
__global__ void scatter_add_rows_kernel(const int32_t* __restrict__ rows,
                                        const T* __restrict__ updates,
                                        float* __restrict__ out, int64_t total,
                                        int64_t width, int64_t n_rows) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const int64_t i = e / width;
    const int64_t c = e - i * width;
    const int32_t r = __ldg(rows + i);
    if (r >= 0 && r < n_rows) {
      atomicAdd(out + (int64_t)r * width + c, to_f32(updates[e]));
    }
  }
}

// ------------------------------------------------------------------ runs

template <typename T, int W>
__global__ void __launch_bounds__(256)
scatter_runs_kernel(const int32_t* __restrict__ rows, const T* __restrict__ updates,
                    float* __restrict__ out, int64_t M, int64_t n_rows) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  // whole warps loop together (the shuffles need every lane): the loop's
  // bound is on the warp's first update
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i - lane < M;
       i += stride) {
    int32_t r = i < M ? __ldg(rows + i) : -1;
    if (r < 0 || r >= n_rows) r = -1;  // every dropped row is one key
    float v[W];
#pragma unroll
    for (int c = 0; c < W; ++c) v[c] = 0.f;
    if (r >= 0) {
#pragma unroll
      for (int p = 0; p < W / 2; ++p) {
        float t[2];
        load_vec(updates + i * W + 2 * p, t);
        v[2 * p] = t[0];
        v[2 * p + 1] = t[1];
      }
    }
    const int32_t prev = __shfl_up_sync(kFull, r, 1);
    const bool head = lane == 0 || r != prev;
    const unsigned heads = __ballot_sync(kFull, head);
    if (heads != kFull) {
      // this lane's run ends before the next head above it; after the step
      // of distance d a lane holds the sum of its next 2d lanes of the run
      const unsigned above = heads & ~((2u << lane) - 1u);
      const int end = above ? __ffs(above) - 1 : 32;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
        for (int c = 0; c < W; ++c) {
          const float o = __shfl_down_sync(kFull, v[c], d);
          if (lane + d < end) v[c] += o;
        }
      }
    }
    if (head && r >= 0) {
#pragma unroll
      for (int p = 0; p < W / 2; ++p) {
        const float t[2] = {v[2 * p], v[2 * p + 1]};
        red_add(out + (int64_t)r * W + 2 * p, t);
      }
    }
  }
}

// ------------------------------------------------------------------ smem

template <typename T, int V>
__global__ void __launch_bounds__(kSmemThreads, 1)
scatter_smem_kernel(const int32_t* __restrict__ rows, const T* __restrict__ updates,
                    float* __restrict__ partials, int64_t M, int64_t nvec,
                    int64_t n_rows, int copies, int copy_stride) {
  extern __shared__ float acc[];
  constexpr int U = 2;
  const int64_t width = nvec * V;
  const int elems = (int)(n_rows * width);
  for (int k = threadIdx.x; k < copies * copy_stride; k += blockDim.x) acc[k] = 0.f;
  __syncthreads();

  // This block's contiguous slice of the updates. A group of nvec threads,
  // one per column vector, takes U consecutive updates per batch, so that a
  // thread sees neighbouring updates of the same columns and can merge
  // equal rows in registers before it adds.
  const int64_t per = (M + gridDim.x - 1) / gridDim.x;
  const int64_t begin = (int64_t)blockIdx.x * per;
  const int64_t end = begin + per < M ? begin + per : M;
  const int groups = blockDim.x / (int)nvec;
  const int group = threadIdx.x / (int)nvec;
  const int q = threadIdx.x - group * (int)nvec;
  const int mine = (group & (copies - 1)) * copy_stride + q * V;
  int64_t i = group < groups ? begin + (int64_t)group * U : end;

  // two batches of U (index, update vector) loads each: the next batch's
  // loads are in flight while this batch is added into shared memory
  int32_t row[2][U];
  bool on[2][U];  // false past the slice's end
  float v[2][U][V];
  auto issue = [&](const int b) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      on[b][u] = i + u < end;
      if (on[b][u]) {
        row[b][u] = __ldg(rows + i + u);
        load_vec(updates + (i + u) * width + q * V, v[b][u]);
      }
    }
    i += (int64_t)groups * U;
  };
  auto add = [&](const int b) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int32_t r = row[b][u];
      if (on[b][u] && r >= 0 && r < n_rows) {
        if (u + 1 < U && on[b][u + 1] && row[b][u + 1] == r) {
          // the next update adds to the same row: pass the sum on
#pragma unroll
          for (int t = 0; t < V; ++t) v[b][u + 1][t] += v[b][u][t];
        } else {
          float* a = acc + mine + (int)(r * width);
#pragma unroll
          for (int t = 0; t < V; ++t) atomicAdd(a + t, v[b][u][t]);
        }
      }
    }
  };
  issue(0);
  while (true) {
    issue(1);
    add(0);
    if (!on[1][0]) break;
    issue(0);
    add(1);
    if (!on[0][0]) break;
  }
  __syncthreads();

  float* dst = partials + (int64_t)blockIdx.x * elems;
  for (int k = threadIdx.x; k < elems; k += blockDim.x) {
    float s = acc[k];
    for (int c = 1; c < copies; ++c) s += acc[c * copy_stride + k];
    dst[k] = s;
  }
}

// out[k] = the sum over the blocks' partials, in a fixed order; 32 elements
// by 8 groups of partials per block
__global__ void __launch_bounds__(256)
sum_partials_kernel(const float* __restrict__ partials, float* __restrict__ out,
                    int64_t elems, int n_partials) {
  __shared__ float part[8][33];
  const int x = threadIdx.x & 31;
  const int y = threadIdx.x >> 5;
  const int64_t k = (int64_t)blockIdx.x * 32 + x;
  float s = 0.f;
  if (k < elems) {
    for (int b = y; b < n_partials; b += 8) s += partials[(int64_t)b * elems + k];
  }
  part[y][x] = s;
  __syncthreads();
  if (y == 0 && k < elems) {
    for (int j = 1; j < 8; ++j) s += part[j][x];
    out[k] = s;
  }
}

// --------------------------------------------------------- vec and sorted

constexpr int kSortThreads = 1024;

// hist[b * n_rows + r] = number of updates that block b (of B, each a
// contiguous slice of the updates) keeps for row r, counted in shared memory
__global__ void __launch_bounds__(kSortThreads)
count_rows_kernel(const int32_t* __restrict__ rows, int* __restrict__ hist, int64_t M,
                  int n_rows) {
  extern __shared__ int in_block[];
  for (int r = threadIdx.x; r < n_rows; r += blockDim.x) in_block[r] = 0;
  __syncthreads();
  const int64_t per = (M + gridDim.x - 1) / gridDim.x;
  const int64_t begin = (int64_t)blockIdx.x * per;
  const int64_t end = begin + per < M ? begin + per : M;
  for (int64_t i = begin + threadIdx.x; i < end; i += 4 * blockDim.x) {
    int32_t r[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int64_t j = i + u * blockDim.x;
      r[u] = j < end ? __ldg(rows + j) : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (r[u] >= 0 && r[u] < n_rows) atomicAdd(in_block + r[u], 1);
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < n_rows; r += blockDim.x) {
    hist[(int64_t)blockIdx.x * n_rows + r] = in_block[r];
  }
}

// hist[b * n_rows + r] becomes the number of row r's updates in the blocks
// before b, and total[r] the row's count. A block takes 32 rows; each of its
// 8 groups of 32 threads walks an eighth of the B blocks.
__global__ void __launch_bounds__(256)
scan_blocks_kernel(int* __restrict__ hist, int* __restrict__ total, int n_rows, int B) {
  __shared__ int part[8][33];
  const int x = threadIdx.x & 31;
  const int y = threadIdx.x >> 5;
  const int r = blockIdx.x * 32 + x;
  const int each = (B + 7) / 8;
  const int lo = y * each < B ? y * each : B;
  const int hi = lo + each < B ? lo + each : B;
  int mine = 0;
  if (r < n_rows) {
    for (int b = lo; b < hi; ++b) mine += hist[(int64_t)b * n_rows + r];
  }
  part[y][x] = mine;
  __syncthreads();
  if (r < n_rows) {
    int run = 0;
    for (int j = 0; j < y; ++j) run += part[j][x];
    for (int b = lo; b < hi; ++b) {
      const int c = hist[(int64_t)b * n_rows + r];
      hist[(int64_t)b * n_rows + r] = run;
      run += c;
    }
    if (y == 7) total[r] = run;
  }
}

// count[0..n) becomes its exclusive prefix sum and count[n] the total; one
// block, each thread a contiguous stretch
__global__ void __launch_bounds__(1024) scan_counts_kernel(int* __restrict__ count, int64_t n) {
  __shared__ int part[1024];
  const int64_t per = (n + 1023) / 1024;
  const int64_t lo = (int64_t)threadIdx.x * per < n ? (int64_t)threadIdx.x * per : n;
  const int64_t hi = lo + per < n ? lo + per : n;
  int mine = 0;
  for (int64_t k = lo; k < hi; ++k) mine += count[k];
  part[threadIdx.x] = mine;
  __syncthreads();
  for (int d = 1; d < 1024; d <<= 1) {
    const int below = (int)threadIdx.x >= d ? part[threadIdx.x - d] : 0;
    __syncthreads();
    part[threadIdx.x] += below;
    __syncthreads();
  }
  int run = part[threadIdx.x] - mine;
  for (int64_t k = lo; k < hi; ++k) {
    const int c = count[k];
    count[k] = run;
    run += c;
  }
  if (threadIdx.x == 1023) count[n] = part[1023];
}

// every kept update takes the next place of its row among its block's:
// sorted = (its index, its row), sorted by row. first[r] is the
// place of row r's first update, hist as scan_blocks_kernel left it; the
// grid is count_rows_kernel's.
__global__ void __launch_bounds__(kSortThreads)
place_rows_kernel(const int32_t* __restrict__ rows, const int* __restrict__ hist,
                  const int* __restrict__ first, int2* __restrict__ sorted, int64_t M,
                  int n_rows) {
  extern __shared__ int cursor[];
  for (int r = threadIdx.x; r < n_rows; r += blockDim.x) {
    cursor[r] = first[r] + hist[(int64_t)blockIdx.x * n_rows + r];
  }
  __syncthreads();
  const int64_t per = (M + gridDim.x - 1) / gridDim.x;
  const int64_t begin = (int64_t)blockIdx.x * per;
  const int64_t end = begin + per < M ? begin + per : M;
  for (int64_t i = begin + threadIdx.x; i < end; i += 4 * blockDim.x) {
    int32_t r[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int64_t j = i + u * blockDim.x;
      r[u] = j < end ? __ldg(rows + j) : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (r[u] >= 0 && r[u] < n_rows) {
        sorted[atomicAdd(cursor + r[u], 1)] = make_int2((int)(i + u * blockDim.x), r[u]);
      }
    }
  }
}

// A warp takes 32 places of the walk; each of its groups of G lanes (G a
// power of two, one lane per column vector) walks G of them, four update
// loads in flight, sums in registers while the row stays the same and adds a
// finished sum to device memory with one vector atomic (a row may go on in
// the next group's places). The walk is either the updates sorted by row
// (sorted = (index, row) pairs, *total of them) or, with sorted == nullptr,
// the M updates as they lie, where it merges neighbouring equal rows.
template <typename T, int V>
__global__ void __launch_bounds__(256)
walk_rows_kernel(const int2* __restrict__ sorted, const int* __restrict__ total,
                 const int32_t* __restrict__ rows, int64_t M, int64_t n_rows,
                 const T* __restrict__ updates, float* __restrict__ out, int nvec, int G) {
  const int lane = threadIdx.x & 31;
  const int64_t N = sorted ? *total : M;
  const int64_t W = (int64_t)nvec * V;
  const int sub = lane & (G - 1);
  const int first = lane - sub;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t c = ((((int64_t)blockIdx.x * blockDim.x) + threadIdx.x) >> 5) * 32; c < N;
       c += n_warps * 32) {
    const int64_t p = c + lane;
    int64_t my_i = p;
    int my_r = -1;
    if (p < N) {
      if (sorted) {
        const int2 mine = sorted[p];
        my_i = mine.x;
        my_r = mine.y;
      } else {
        my_r = __ldg(rows + p);
        if (my_r >= n_rows) my_r = -1;
      }
    }
    for (int q0 = 0; q0 < nvec; q0 += G) {
      const int q = q0 + sub;
      const bool on = q < nvec;
      float acc[V];
#pragma unroll
      for (int t = 0; t < V; ++t) acc[t] = 0.f;
      int cur = -1;
      for (int k0 = 0; k0 < G; k0 += 4) {
        int64_t ii[4];
        int rr[4];
        float v[4][V];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = k0 + u;
          const int src = first + (k < G ? k : 0);
          ii[u] = __shfl_sync(kFull, my_i, src);
          rr[u] = __shfl_sync(kFull, my_r, src);
          if (k >= G || !on) rr[u] = -1;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (rr[u] >= 0) load_vec(updates + ii[u] * W + q * V, v[u]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (rr[u] >= 0) {
            if (rr[u] != cur) {
              if (cur >= 0) red_add(out + (int64_t)cur * W + q * V, acc);
#pragma unroll
              for (int t = 0; t < V; ++t) acc[t] = 0.f;
              cur = rr[u];
            }
#pragma unroll
            for (int t = 0; t < V; ++t) acc[t] += v[u][t];
          }
        }
      }
      if (cur >= 0) red_add(out + (int64_t)cur * W + q * V, acc);
    }
  }
}

// ------------------------------------------------------------- launchers

int sm_count() {
  static int n = 0;
  if (n <= 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        n <= 0) {
      n = 132;
    }
  }
  return n;
}

unsigned grid_for(int64_t total, int threads, int blocks_per_sm) {
  int64_t blocks = (total + threads - 1) / threads;
  const int64_t cap = (int64_t)sm_count() * blocks_per_sm;
  return (unsigned)(blocks < cap ? blocks : cap);
}

template <typename T>
cudaError_t launch_atomic(const void* rows, const void* updates, void* out, int64_t M,
                          int64_t W, int64_t n_rows, cudaStream_t stream) {
  const int threads = 256;
  const int64_t total = M * W;
  int64_t blocks = (total + threads - 1) / threads;
  // enough blocks to fill 132 SMs many times over; the loop covers the rest
  const int64_t max_blocks = 132 * 64;
  if (blocks > max_blocks) blocks = max_blocks;
  scatter_add_rows_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const int32_t*>(rows), static_cast<const T*>(updates),
      static_cast<float*>(out), total, W, n_rows);
  return cudaGetLastError();
}

template <typename T, int W>
cudaError_t launch_runs(const void* rows, const void* updates, void* out, int64_t M,
                        int64_t n_rows, cudaStream_t stream) {
  scatter_runs_kernel<T, W><<<grid_for(M, 256, 16), 256, 0, stream>>>(
      static_cast<const int32_t*>(rows), static_cast<const T*>(updates),
      static_cast<float*>(out), M, n_rows);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_smem(const void* rows, const void* updates, void* out, void* partials,
                        int64_t M, int64_t W, int64_t n_rows, int blocks, int copies,
                        int copy_stride, cudaStream_t stream) {
  const int64_t nvec = W / V;
  const int64_t elems = n_rows * W;
  const size_t bytes = (size_t)copies * copy_stride * sizeof(float);
  auto kernel = scatter_smem_kernel<T, V>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, kSmemThreads, bytes, stream>>>(
      static_cast<const int32_t*>(rows), static_cast<const T*>(updates),
      static_cast<float*>(partials), M, nvec, n_rows, copies, copy_stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<(unsigned)((elems + 31) / 32), 256, 0, stream>>>(
      static_cast<const float*>(partials), static_cast<float*>(out), elems, blocks);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_sorted(const void* rows, const void* updates, void* out, void* scratch,
                          int64_t M, int64_t W, int64_t n_rows, int B, cudaStream_t stream) {
  const int nvec = (int)(W / V);
  const int R = (int)n_rows;
  int G = 1;
  while (G < 32 && G < nvec) G <<= 1;
  const int32_t* r = static_cast<const int32_t*>(rows);
  int* hist = static_cast<int*>(scratch);  // [B, n_rows]
  int* first = hist + (int64_t)R * B;      // [n_rows + 1]
  // [M] (index, row) pairs, on an 8-byte boundary
  int2* sorted = reinterpret_cast<int2*>(first + ((R + 2) & ~1));
  const size_t bytes = (size_t)R * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      count_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      place_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  count_rows_kernel<<<B, kSortThreads, bytes, stream>>>(r, hist, M, R);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_blocks_kernel<<<(unsigned)((R + 31) / 32), 256, 0, stream>>>(hist, first, R, B);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scan_counts_kernel<<<1, 1024, 0, stream>>>(first, n_rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  place_rows_kernel<<<B, kSortThreads, bytes, stream>>>(r, hist, first, sorted, M, R);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  walk_rows_kernel<T, V><<<grid_for(M, 256, 8), 256, 0, stream>>>(
      sorted, first + R, nullptr, M, n_rows, static_cast<const T*>(updates),
      static_cast<float*>(out), nvec, G);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_vec(const void* rows, const void* updates, void* out, int64_t M,
                        int64_t W, int64_t n_rows, cudaStream_t stream) {
  const int nvec = (int)(W / V);
  int G = 1;
  while (G < 32 && G < nvec) G <<= 1;
  walk_rows_kernel<T, V><<<grid_for(M, 256, 8), 256, 0, stream>>>(
      nullptr, nullptr, static_cast<const int32_t*>(rows), M, n_rows,
      static_cast<const T*>(updates), static_cast<float*>(out), nvec, G);
  return cudaGetLastError();
}

}  // namespace

// In every function: dtype 0 = float32, 1 = bfloat16, 2 = float16; the
// caller guarantees what the variant needs (ops/scatter.py checks it).
#define GF_DISPATCH_DTYPE(dtype, ...)                               \
  switch (dtype) {                                                  \
    case 0: { using T = float; return (int)(__VA_ARGS__); }         \
    case 1: { using T = __nv_bfloat16; return (int)(__VA_ARGS__); } \
    case 2: { using T = __half; return (int)(__VA_ARGS__); }        \
    default: return (int)cudaErrorInvalidValue;                     \
  }

// atomic: any W, any alignment; out zeroed by the caller
extern "C" int gf_scatter_add_rows(const void* rows, const void* updates,
                                   void* out, int64_t M, int64_t W,
                                   int64_t n_rows, int dtype, void* stream) {
  if (M <= 0 || W <= 0 || n_rows <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  GF_DISPATCH_DTYPE(dtype, launch_atomic<T>(rows, updates, out, M, W, n_rows, s))
}

// runs: W 2 or 6; updates 16-byte aligned; out zeroed by the caller
extern "C" int gf_scatter_add_rows_runs(const void* rows, const void* updates,
                                        void* out, int64_t M, int64_t W,
                                        int64_t n_rows, int dtype, void* stream) {
  if (M <= 0 || n_rows <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 2: GF_DISPATCH_DTYPE(dtype, launch_runs<T, 2>(rows, updates, out, M, n_rows, s))
    case 6: GF_DISPATCH_DTYPE(dtype, launch_runs<T, 6>(rows, updates, out, M, n_rows, s))
    default: return (int)cudaErrorInvalidValue;
  }
}

// smem: copies (a power of two) accumulators of copy_stride floats each in
// the block's dynamic shared memory; partials is a scratch of
// blocks * n_rows * W floats; every element of out is written. V 4, 2 or 1
// divides W (4 and 2 need 16-byte aligned updates).
extern "C" int gf_scatter_add_rows_smem(const void* rows, const void* updates,
                                        void* out, void* partials, int64_t M,
                                        int64_t W, int64_t n_rows, int dtype,
                                        int V, int blocks, int copies,
                                        int copy_stride, void* stream) {
  if (M <= 0 || W <= 0 || n_rows <= 0) return (int)cudaSuccess;
  if ((V != 4 && V != 2 && V != 1) || W % V != 0 || W / V > kSmemThreads || blocks <= 0 ||
      copies <= 0 ||
      (copies & (copies - 1)) != 0 || (int64_t)copy_stride < n_rows * W) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (V == 4) {
    GF_DISPATCH_DTYPE(dtype, launch_smem<T, 4>(rows, updates, out, partials, M, W, n_rows,
                                               blocks, copies, copy_stride, s))
  }
  if (V == 2) {
    GF_DISPATCH_DTYPE(dtype, launch_smem<T, 2>(rows, updates, out, partials, M, W, n_rows,
                                               blocks, copies, copy_stride, s))
  }
  GF_DISPATCH_DTYPE(dtype, launch_smem<T, 1>(rows, updates, out, partials, M, W, n_rows,
                                             blocks, copies, copy_stride, s))
}

// sorted: B blocks (an even number) count and place the updates; scratch,
// on an 8-byte boundary, holds n_rows * B + n_rows + 2 + 2 * M ints;
// n_rows * 4 bytes fit a block's shared memory; V 4 or 2 divides W; updates
// 16-byte aligned; M < 2^31; out zeroed by the caller
extern "C" int gf_scatter_add_rows_sorted(const void* rows, const void* updates,
                                          void* out, void* scratch, int64_t M,
                                          int64_t W, int64_t n_rows, int dtype,
                                          int V, int B, void* stream) {
  if (M <= 0 || W <= 0 || n_rows <= 0) return (int)cudaSuccess;
  if ((V != 4 && V != 2) || W % V != 0 || M >= ((int64_t)1 << 31) ||
      W / V >= ((int64_t)1 << 24) || B <= 0 || n_rows * 4 > 232448) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (V == 4) {
    GF_DISPATCH_DTYPE(dtype, launch_sorted<T, 4>(rows, updates, out, scratch, M, W, n_rows, B, s))
  }
  GF_DISPATCH_DTYPE(dtype, launch_sorted<T, 2>(rows, updates, out, scratch, M, W, n_rows, B, s))
}

// vec: V 4 or 2 divides W; updates 16-byte aligned; out zeroed by the caller
extern "C" int gf_scatter_add_rows_vec(const void* rows, const void* updates,
                                        void* out, int64_t M, int64_t W,
                                        int64_t n_rows, int dtype, int V,
                                        void* stream) {
  if (M <= 0 || W <= 0 || n_rows <= 0) return (int)cudaSuccess;
  if ((V != 4 && V != 2) || W % V != 0 || W / V >= ((int64_t)1 << 24) ||
      n_rows >= ((int64_t)1 << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (V == 4) {
    GF_DISPATCH_DTYPE(dtype, launch_vec<T, 4>(rows, updates, out, M, W, n_rows, s))
  }
  GF_DISPATCH_DTYPE(dtype, launch_vec<T, 2>(rows, updates, out, M, W, n_rows, s))
}
