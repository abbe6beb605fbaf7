// Row scatter-add for Hopper (sm_90a):  out[r, c] += updates[i, c]  for
// every i with 0 <= rows[i] < n_rows; other rows are dropped. Updates may be
// float32, bfloat16 or float16 and always accumulate in float32.
//
// Replaces the Pallas TPU kernel geneface_tpu/ops/pallas_scatter.py:79
// (scatter_add_rows_pallas / _kernel). That kernel kept P lane-packed copies
// of the accumulator in VMEM because the TPU has no atomics; it was limited
// to W | 128 and n_rows <= 16,384. On Hopper the accumulator lives in device
// memory and float32 atomicAdd resolves row collisions, so there is no limit
// on W or n_rows.
//
// What bounds it on this card: it reads M*(4 + W*s) bytes (a row index plus
// a row of s-byte updates), writes n_rows*W*4 bytes (the wrapper's zeroed
// output), and on colliding rows it is bound by the L2 atomic throughput.
// Design: a grid-stride loop over the M*W update elements, one thread per
// (row, column), so neighbouring threads read neighbouring update columns
// (coalesced loads) and atomically add to neighbouring output columns of the
// same row. No shared memory; the index is re-read by the W threads of a row
// from L1.
//
// Plain C interface for ctypes: returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

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

template <typename T>
void launch(const void* rows, const void* updates, void* out, int64_t M,
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
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16
extern "C" int gf_scatter_add_rows(const void* rows, const void* updates,
                                   void* out, int64_t M, int64_t W,
                                   int64_t n_rows, int dtype, void* stream) {
  if (M <= 0 || W <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<float>(rows, updates, out, M, W, n_rows, s); break;
    case 1: launch<__nv_bfloat16>(rows, updates, out, M, W, n_rows, s); break;
    case 2: launch<__half>(rows, updates, out, M, W, n_rows, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
