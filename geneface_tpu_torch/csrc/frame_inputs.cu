// A video frame's renderer inputs for Hopper (sm_90a), built from its pose:
//
//   rays_o[p] = t,   rays_d[p] = R . normalize(((p % W) + 0.5 - cx) / fx,
//                                              ((p / W) + 0.5 - cy) / fy, 1)
//
// for every pixel p of an H x W frame (the c2w pose's rotation R and centre
// t), and, given the frame's torso plane (uint8 or float32, 3 or 4
// channels, HWC), the head's background: the torso over the video's float
// background, as data/radnerf_dataset.py composite_torso computes it,
//
//   s = plane / 255 where the plane's largest value is above 1.5, else plane
//   bg_torso[p] = s.rgb * s.a + bg * (1 - s.a)     (4 channels)
//   bg_torso[p] = s.rgb                            (3 channels)
//
// Replaces no TPU kernel: the JAX package and the port built these inputs
// on the host in numpy (utils/camera.py get_rays and the dataset's
// composite) and copied 9 MB of them to the card every frame.
//
// Bit-identical to that host path, which the plain version in
// ops/frame_inputs.py runs: a last-bit difference in a ray direction moves
// a sample across an occupancy cell edge. So every float32 operation is the
// rounded intrinsic of numpy's operation, in numpy's order, and nvcc may
// contract none of them: the norm is sqrt((x*x + y*y) + 1) without a fused
// multiply-add; the rotation is the chain that numpy's matmul (OpenBLAS
// sgemm) runs, fma(d2, R[k][2], fma(d1, R[k][1], fma(d0, R[k][0], 0))), whose
// start from +0 also gives numpy's sign of an exact zero.
//
// What bounds it on this card: bytes. It writes 36 bytes a pixel (three
// [n, 3] float32 outputs) and reads the plane (4 bytes a pixel, uint8 RGBA)
// and the background (12 bytes): 13.6 MB at 512 x 512, ~4 us at 3.35 TB/s;
// the arithmetic (four divisions and a square root a pixel) is far below
// the card's rate. Design: a block of 256 threads takes 256 consecutive
// pixels, one a thread. Its share of each [n, 3] array (768 floats, 3 KB)
// moves between device memory and shared memory as 16-byte vectors,
// neighbouring threads on neighbouring vectors (coalesced), and each thread
// works on its pixel's three floats in shared memory. The uint8 RGBA plane
// is read as one 4-byte load a thread, a float32 RGBA plane as one 16-byte
// load. The frame's last block, when it is partial, moves its floats one
// at a time. The pose and intrinsics are kernel arguments.
//
// Plain C interface for ctypes: returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Frame {
  float r[9];  // the c2w rotation, row-major
  float t[3];  // the camera centre
  float fx, fy, cx, cy;
  uint32_t W, n;  // columns, pixels
};

enum Plane { kNone = 0, kU8 = 1, kF32 = 2 };

// the pixel's C channels as float32 (exact for uint8)
template <int P, int C>
__device__ __forceinline__ void load_pixel(const void* plane, uint32_t p, float v[4]) {
  if constexpr (P == kU8 && C == 4) {
    const uchar4 q = __ldg(static_cast<const uchar4*>(plane) + p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (P == kF32 && C == 4) {
    const float4 q = __ldg(static_cast<const float4*>(plane) + p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (P == kU8) {
    const unsigned char* q = static_cast<const unsigned char*>(plane) + (size_t)p * C;
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = __ldg(q + c);
  } else {
    const float* q = static_cast<const float*>(plane) + (size_t)p * C;
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = __ldg(q + c);
  }
}

// nf floats between device memory and shared memory; a full block's 768
// floats as 16-byte vectors (both sides 16-byte aligned)
__device__ __forceinline__ void copy_floats(float* dst, const float* src, int nf) {
  if (nf == 3 * kThreads) {
    for (int e = threadIdx.x; e < nf / 4; e += kThreads)
      reinterpret_cast<float4*>(dst)[e] = reinterpret_cast<const float4*>(src)[e];
  } else {
    for (int e = threadIdx.x; e < nf; e += kThreads) dst[e] = src[e];
  }
}

template <int P, int C>
__global__ void __launch_bounds__(kThreads)
frame_inputs_kernel(Frame f, const void* __restrict__ plane, int scale,
                    const float* __restrict__ bg, float* __restrict__ rays_o,
                    float* __restrict__ rays_d, float* __restrict__ bg_out) {
  __shared__ __align__(16) float s_o[3 * kThreads];
  __shared__ __align__(16) float s_d[3 * kThreads];
  __shared__ __align__(16) float s_b[3 * kThreads];
  const uint32_t p0 = blockIdx.x * kThreads;
  const int count = min(kThreads, (int)(f.n - p0));
  const size_t base = (size_t)p0 * 3;
  const int nf = 3 * count;
  if constexpr (P != kNone && C == 4) {
    copy_floats(s_b, bg + base, nf);
    __syncthreads();
  }
  const int k3 = 3 * threadIdx.x;
  if ((int)threadIdx.x < count) {
    const uint32_t p = p0 + threadIdx.x;
    const float i = __fadd_rn((float)(p % f.W), 0.5f);
    const float j = __fadd_rn((float)(p / f.W), 0.5f);
    const float x = __fdiv_rn(__fsub_rn(i, f.cx), f.fx);
    const float y = __fdiv_rn(__fsub_rn(j, f.cy), f.fy);
    const float norm = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), 1.f));
    const float u0 = __fdiv_rn(x, norm), u1 = __fdiv_rn(y, norm), u2 = __fdiv_rn(1.f, norm);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      s_o[k3 + k] = f.t[k];
      s_d[k3 + k] = __fmaf_rn(u2, f.r[3 * k + 2],
                              __fmaf_rn(u1, f.r[3 * k + 1], __fmaf_rn(u0, f.r[3 * k], 0.f)));
    }
    if constexpr (P != kNone) {
      float v[4];
      load_pixel<P, C>(plane, p, v);
      if (scale) {
#pragma unroll
        for (int c = 0; c < C; ++c) v[c] = __fdiv_rn(v[c], 255.f);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if constexpr (C == 4) {
          s_b[k3 + k] = __fadd_rn(__fmul_rn(v[k], v[3]),
                                  __fmul_rn(s_b[k3 + k], __fsub_rn(1.f, v[3])));
        } else {
          s_b[k3 + k] = v[k];
        }
      }
    }
  }
  __syncthreads();
  copy_floats(rays_o + base, s_o, nf);
  copy_floats(rays_d + base, s_d, nf);
  if constexpr (P != kNone) copy_floats(bg_out + base, s_b, nf);
}

template <int P, int C>
void launch(const Frame& f, const void* plane, int scale, const float* bg, float* o,
            float* d, float* b, cudaStream_t s) {
  const unsigned blocks = (f.n + kThreads - 1) / kThreads;
  frame_inputs_kernel<P, C><<<blocks, kThreads, 0, s>>>(f, plane, scale, bg, o, d, b);
}

}  // namespace

// pose: 12 host floats, the c2w's first three rows (R | t) row-major.
// plane_dtype: 0 = no plane (rays alone; plane, bg and bg_out unused),
// 1 = uint8, 2 = float32; channels 3 or 4 (bg is read for 4 only). scale:
// divide the plane by 255. The caller guarantees n = H * W < 2^31, rays_o,
// rays_d, bg and bg_out 16-byte aligned, a 4-channel plane aligned to its
// pixel (4 bytes uint8, 16 bytes float32).
extern "C" int gf_frame_inputs(const float* pose, float fx, float fy, float cx, float cy,
                               int64_t H, int64_t W, const void* plane, int plane_dtype,
                               int channels, int scale, const float* bg, float* rays_o,
                               float* rays_d, float* bg_out, void* stream) {
  if (H <= 0 || W <= 0) return (int)cudaSuccess;
  if (H * W >= ((int64_t)1 << 31)) return (int)cudaErrorInvalidValue;
  Frame f;
  for (int k = 0; k < 3; ++k) {
    for (int c = 0; c < 3; ++c) f.r[3 * k + c] = pose[4 * k + c];
    f.t[k] = pose[4 * k + 3];
  }
  f.fx = fx; f.fy = fy; f.cx = cx; f.cy = cy;
  f.W = (uint32_t)W;
  f.n = (uint32_t)(H * W);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int code = plane_dtype * 10 + (plane_dtype ? channels : 0);
  switch (code) {
    case 0: launch<kNone, 3>(f, plane, scale, bg, rays_o, rays_d, bg_out, s); break;
    case 13: launch<kU8, 3>(f, plane, scale, bg, rays_o, rays_d, bg_out, s); break;
    case 14: launch<kU8, 4>(f, plane, scale, bg, rays_o, rays_d, bg_out, s); break;
    case 23: launch<kF32, 3>(f, plane, scale, bg, rays_o, rays_d, bg_out, s); break;
    case 24: launch<kF32, 4>(f, plane, scale, bg, rays_o, rays_d, bg_out, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
