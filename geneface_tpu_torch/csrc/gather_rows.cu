// Row gather for Hopper (sm_90a):  out[m, :] = table[idx[m], :]  for
// 0 <= idx[m] < R, and a zero row for any other index (the adjoint of the
// row scatter-add's drop rule). The table may be float32, bfloat16 or
// float16; the output is always float32 (the cast is fused into the copy).
//
// Replaces the Pallas TPU kernel tools/bench_pallas_scatter2.py:67
// (bench_gather_probe -> pallas_gather / gkernel), the jnp.take row gather
// that the fused grid encoder runs once per (sample, level group)
// (geneface_tpu/ops/fused_grid.py:467). That kernel held the whole table in
// VMEM and gathered blocks of 2,048 indices per grid step; on Hopper the
// tables (at most a few MB) stay in the 50 MB L2 after the first touch, so
// device memory sees one read of the table and of idx and one write of out.
//
// What bounds it on this card: bytes. It reads M*4 bytes of indices and at
// most R*W*s bytes of table (L2-resident after the first touch) and writes
// M*W*4 bytes; it does no arithmetic. Design: a grid-stride loop over
// (row, 4-column vector) pairs, one pair per thread: the index is read once
// per vector from L1, the table row is read as one 16-byte (float32) or
// 8-byte (bfloat16/float16, widened in registers) load, and neighbouring
// threads store neighbouring 16-byte vectors of the same output row
// (coalesced stores). Rows whose width is a multiple of 2 but not of 4 (the
// composite's 6 columns) move the same way as 2-column vectors: 8-byte
// loads and stores (4-byte loads from a 16-bit table). Rows of odd width, or
// pointers that are not aligned for the vector loads, take the scalar path
// (one element per thread). No shared memory.
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

// four consecutive table values starting at p (aligned), widened to float32
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// two consecutive table values starting at p (aligned), widened to float32
__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  const unsigned raw = __ldg(reinterpret_cast<const unsigned*>(p));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
}
__device__ __forceinline__ float2 load2(const __half* p) {
  const unsigned raw = __ldg(reinterpret_cast<const unsigned*>(p));
  return __half22float2(*reinterpret_cast<const __half2*>(&raw));
}

template <typename T>
__global__ void gather_rows_vec4_kernel(const int32_t* __restrict__ idx,
                                        const T* __restrict__ table,
                                        float* __restrict__ out, int64_t M,
                                        int64_t W, int64_t R) {
  const int64_t nvec = W >> 2;
  const int64_t total = M * nvec;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const int64_t m = e / nvec;
    const int64_t c = (e - m * nvec) << 2;
    const int32_t r = __ldg(idx + m);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r >= 0 && r < R) v = load4(table + (int64_t)r * W + c);
    *reinterpret_cast<float4*>(out + m * W + c) = v;
  }
}

template <typename T>
__global__ void gather_rows_vec2_kernel(const int32_t* __restrict__ idx,
                                        const T* __restrict__ table,
                                        float* __restrict__ out, int64_t M,
                                        int64_t W, int64_t R) {
  const int64_t nvec = W >> 1;
  const int64_t total = M * nvec;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const int64_t m = e / nvec;
    const int64_t c = (e - m * nvec) << 1;
    const int32_t r = __ldg(idx + m);
    float2 v = make_float2(0.f, 0.f);
    if (r >= 0 && r < R) v = load2(table + (int64_t)r * W + c);
    *reinterpret_cast<float2*>(out + m * W + c) = v;
  }
}

template <typename T>
__global__ void gather_rows_scalar_kernel(const int32_t* __restrict__ idx,
                                          const T* __restrict__ table,
                                          float* __restrict__ out, int64_t M,
                                          int64_t W, int64_t R) {
  const int64_t total = M * W;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const int64_t m = e / W;
    const int64_t c = e - m * W;
    const int32_t r = __ldg(idx + m);
    out[e] = (r >= 0 && r < R) ? to_f32(table[(int64_t)r * W + c]) : 0.f;
  }
}

template <typename T>
void launch(const void* idx, const void* table, void* out, int64_t M,
            int64_t W, int64_t R, int vec, cudaStream_t stream) {
  const int threads = 256;
  const int64_t total = M * (W / vec);
  int64_t blocks = (total + threads - 1) / threads;
  // enough blocks to fill 132 SMs many times over; the loop covers the rest
  const int64_t max_blocks = 132 * 64;
  if (blocks > max_blocks) blocks = max_blocks;
  const int32_t* i = static_cast<const int32_t*>(idx);
  const T* t = static_cast<const T*>(table);
  float* o = static_cast<float*>(out);
  if (vec == 4) {
    gather_rows_vec4_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(i, t, o, M, W, R);
  } else if (vec == 2) {
    gather_rows_vec2_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(i, t, o, M, W, R);
  } else {
    gather_rows_scalar_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(i, t, o, M, W, R);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. vec = 4 or 2 takes the
// 4- or 2-wide path: the caller guarantees W % vec == 0 and table and output
// pointers aligned to vec values of their types; vec = 1 is the scalar path.
extern "C" int gf_gather_rows(const void* idx, const void* table, void* out,
                              int64_t M, int64_t W, int64_t R, int dtype,
                              int vec, void* stream) {
  if (M <= 0 || W <= 0) return (int)cudaSuccess;
  if ((vec != 4 && vec != 2 && vec != 1) || W % vec != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<float>(idx, table, out, M, W, R, vec, s); break;
    case 1: launch<__nv_bfloat16>(idx, table, out, M, W, R, vec, s); break;
    case 2: launch<__half>(idx, table, out, M, W, R, vec, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
