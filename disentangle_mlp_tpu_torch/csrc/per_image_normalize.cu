// per_image_normalize: y = (x − min) · 1/max(max − min, 1e-5) per image, on
// Hopper (sm_90a); float32 or bf16 in, float32 out.
//
// Replaces the TPU kernel disentangle_mlp_tpu/ops/pallas/image_ops.py:36
// (`per_image_normalize_pallas`, body `_normalize_kernel`): the same function,
// the reciprocal taken once per image and multiplied in, as the Pallas body
// does. Unlike fminf/fmaxf, the min and max here propagate NaN, as JAX's and
// PyTorch's do: an image holding a NaN comes out all NaN.
//
// What bounds it on an H100: bytes. Each element is read once and written
// once with a handful of float operations. At the FID path's
// (1000, 64, 64, 3), bf16 in and float32 out, that is 73.7 MB, a 22.0 µs
// bound at 3.35 TB/s (98.3 MB and 29.3 µs with float32 input).
//
// What the design does about it, simply:
// - One block per image. An image is one dense block of memory (contiguous
//   NHWC, or the NHWC view of a contiguous NCHW tensor), and the output has
//   the same strides, so the kernel walks input and output in memory order
//   with no copy and no index arithmetic on the layout.
// - The image is staged in shared memory on its way through the min/max
//   reduction (24 KB in bf16, 48 KB in float32 at 64×64×3), so the rescale
//   reads it from there and device memory sees one read and one write. An
//   image too large for shared memory is read a second time instead.
// - 16-byte vector loads and stores where the image's input and output
//   start 16-byte aligned; scalar accesses otherwise (odd shapes).
// - Min and max reduce through warp shuffles, then one shared-memory step
//   across the block's warps.
// The Pallas kernel's padding of each image to a multiple of 128 lanes with
// its first value is a TPU tiling artefact; here the ragged tail is handled
// by the loop bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// Largest staged image: shared memory a block may use on Hopper is 227 KB.
constexpr int64_t MAX_STAGE_BYTES = 200 * 1024;
constexpr float RANGE_FLOOR = 1e-5f;

enum DType { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// min/max that return NaN when either side is NaN (a != a only for NaN;
// built without fast-math, so the test is kept).
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

template <typename T>
struct Vec;  // one 16-byte load of T
template <>
struct Vec<float> {
  static constexpr int N = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
};

template <typename T, bool STAGE>
__global__ void __launch_bounds__(THREADS)
per_image_normalize_kernel(const T* __restrict__ x, float* __restrict__ y,
                           int64_t n_elem) {
  extern __shared__ __align__(16) unsigned char stage_raw[];
  T* stage = reinterpret_cast<T*>(stage_raw);
  __shared__ float red_lo[WARPS], red_hi[WARPS];

  const T* xi = x + (int64_t)blockIdx.x * n_elem;
  float* yi = y + (int64_t)blockIdx.x * n_elem;
  const int tid = threadIdx.x;
  constexpr int VN = Vec<T>::N;
  const bool vec = ((reinterpret_cast<uintptr_t>(xi) |
                     reinterpret_cast<uintptr_t>(yi)) & 15) == 0;

  // ---- pass 1: load (and stage), min and max ------------------------------
  float lo = CUDART_INF_F, hi = -CUDART_INF_F;
  int64_t done = 0;
  if (vec) {
    const int64_t nv = n_elem / VN;
    for (int64_t v = tid; v < nv; v += THREADS) {
      const uint4 raw = reinterpret_cast<const uint4*>(xi)[v];
      if (STAGE) reinterpret_cast<uint4*>(stage)[v] = raw;
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < VN; ++k) {
        const float f = to_f32(e[k]);
        lo = nan_min(lo, f);
        hi = nan_max(hi, f);
      }
    }
    done = nv * VN;
  }
  for (int64_t i = done + tid; i < n_elem; i += THREADS) {
    const T raw = xi[i];
    if (STAGE) stage[i] = raw;
    const float f = to_f32(raw);
    lo = nan_min(lo, f);
    hi = nan_max(hi, f);
  }

  // ---- block reduction: warp shuffles, then across warps -----------------
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = nan_min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = nan_max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  const int warp = tid / 32, lane = tid % 32;
  if (lane == 0) {
    red_lo[warp] = lo;
    red_hi[warp] = hi;
  }
  __syncthreads();  // also orders the staged image before pass 2
  lo = red_lo[0];
  hi = red_hi[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) {
    lo = nan_min(lo, red_lo[w]);
    hi = nan_max(hi, red_hi[w]);
  }
  const float range = hi - lo;
  const float scale = 1.0f / ((range > RANGE_FLOOR || range != range)
                                  ? range : RANGE_FLOOR);

  // ---- pass 2: rescale from the staged copy (or the input) ---------------
  const T* src = STAGE ? stage : xi;
  done = 0;
  if (vec) {
    const int64_t n4 = n_elem / 4;  // one float4 store per 4 elements
    for (int64_t q = tid; q < n4; q += THREADS) {
      const T* e = src + q * 4;
      float4 out;
      out.x = (to_f32(e[0]) - lo) * scale;
      out.y = (to_f32(e[1]) - lo) * scale;
      out.z = (to_f32(e[2]) - lo) * scale;
      out.w = (to_f32(e[3]) - lo) * scale;
      reinterpret_cast<float4*>(yi)[q] = out;
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n_elem; i += THREADS)
    yi[i] = (to_f32(src[i]) - lo) * scale;
}

template <typename T>
cudaError_t launch_typed(const void* x, void* y, int64_t n_images,
                         int64_t n_elem, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  float* yt = static_cast<float*>(y);
  const int64_t bytes = n_elem * (int64_t)sizeof(T);
  if (bytes <= MAX_STAGE_BYTES) {
    // static plus dynamic shared memory above 48 KB must be opted into, per
    // kernel and device; a float32 64×64×3 image alone takes 48 KB
    cudaError_t err = cudaFuncSetAttribute(
        per_image_normalize_kernel<T, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_STAGE_BYTES);
    if (err != cudaSuccess) return err;
    per_image_normalize_kernel<T, true>
        <<<(unsigned)n_images, THREADS, (size_t)bytes, stream>>>(xt, yt,
                                                                 n_elem);
  } else {
    per_image_normalize_kernel<T, false>
        <<<(unsigned)n_images, THREADS, 0, stream>>>(xt, yt, n_elem);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. x holds n_images images of n_elem
// elements each, image i at x + i * n_elem (dtype code 0 float32,
// 1 bfloat16); y is float32 with the same layout. Returns cudaGetLastError()
// after the launch, or -1 for arguments the kernel does not take.
extern "C" int per_image_normalize_launch(const void* x, int x_dtype, void* y,
                                          long long n_images,
                                          long long n_elem, void* stream) {
  if (n_images <= 0 || n_images > 0x7fffffffLL || n_elem <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == DT_F32)
    err = launch_typed<float>(x, y, n_images, n_elem, s);
  else if (x_dtype == DT_BF16)
    err = launch_typed<__nv_bfloat16>(x, y, n_images, n_elem, s);
  else
    return -1;
  return static_cast<int>(err);
}
