// fused_linear: y = act(x · w + b) on Hopper (sm_90a), bf16 tensor cores,
// float32 accumulation, bias and activation in the epilogue.
//
// Replaces the TPU kernel disentangle_mlp_tpu/ops/pallas/matmul_fused.py
// (`_matmul_kernel`, called from `fused_linear`): the same function, i.e.
// x and w rounded to bf16, products summed in float32, the float32 bias
// added, act in {none, relu, leaky_relu(0.2)}, stored as bf16 or float32.
//
// What bounds it on an H100: the β-VAE-GAN step calls it at M = 256 (the
// batch) with K = 16384, N = 2048 (encoder heads, discriminator Dis_l). There
// the weight is 16384·2048 float32 = 134 MB against 17.2 GFLOP, so the call
// is bound by the bytes of w (about 40 µs at 3.35 TB/s), not by the tensor
// cores (about 17 µs at 989 TFLOP/s).
//
// What the design does about it, simply:
// - w is read in whatever type it lives in (the float32 master weight of the
//   port's Linear) and rounded to bf16 as it is loaded, so no separate cast
//   pass writes and re-reads a bf16 copy.
// - Each block computes a 64×64 output tile with a K loop inside the block
//   (the Pallas grid ran K as a serial grid axis with a VMEM accumulator). At
//   M = 256, N = 2048 that is 128 blocks for 132 SMs, without split-K.
// - blockIdx.x walks M, so the blocks that share one 64-column slab of w are
//   launched together and the slab is read from device memory about once;
//   the other M-tiles find it in L2.
// - The next K-slice is loaded into registers while the tensor cores work on
//   the current one from shared memory.
// - Ragged M, N and K edges are masked (zero fill), not padded.
// wgmma, TMA, a deeper pipeline, split-K and a persistent schedule are left
// for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using nvcuda::wmma::accumulator;
using nvcuda::wmma::col_major;
using nvcuda::wmma::fragment;
using nvcuda::wmma::load_matrix_sync;
using nvcuda::wmma::matrix_a;
using nvcuda::wmma::matrix_b;
using nvcuda::wmma::mem_row_major;
using nvcuda::wmma::mma_sync;
using nvcuda::wmma::row_major;
using nvcuda::wmma::store_matrix_sync;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 128;          // 4 warps, each a 32×32 sub-tile
constexpr int LDS = BK + 8;           // bf16 row pitch of the A and B tiles
constexpr int LDC = BN + 4;           // float row pitch of the output tile
constexpr int A_PER_THREAD = BM * BK / THREADS;  // 16
constexpr int B_PER_THREAD = BN * BK / THREADS;  // 16

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2 };
enum DType { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// x: (M, K) row-major. w: element (k, n) at w[k * w_sk + n * w_sn], so both
// a (K, N) row-major w (w_sk = N, w_sn = 1) and the transposed view of an
// (N, K) row-major weight (w_sk = 1, w_sn = K) are read without a copy.
// W_NK selects the thread mapping that keeps the loads coalesced.
template <typename TX, typename TW, typename TO, bool W_NK>
__global__ void __launch_bounds__(THREADS)
fused_linear_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                    const float* __restrict__ b, TO* __restrict__ y,
                    int M, int N, int K, int act) {
  __shared__ __align__(32) __nv_bfloat16 As[BM][LDS];  // [m][k]
  __shared__ __align__(32) __nv_bfloat16 Bs[BN][LDS];  // [n][k]
  __shared__ __align__(32) float Cs[BM][LDC];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int warp_m = warp / 2;
  const int warp_n = warp % 2;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int64_t w_sk = W_NK ? 1 : N;
  const int64_t w_sn = W_NK ? K : 1;

  float ra[A_PER_THREAD];
  float rb[B_PER_THREAD];

  // A tile: thread owns column tid % 32, rows tid / 32 + 4 i (k fastest).
  auto load_a = [&](int k0) {
    const int kk = k0 + (tid % BK);
#pragma unroll
    for (int i = 0; i < A_PER_THREAD; ++i) {
      const int m = m0 + tid / BK + i * (THREADS / BK);
      ra[i] = (m < M && kk < K) ? load_f32(x + (int64_t)m * K + kk) : 0.f;
    }
  };
  // B tile: with W_NK the k index runs fastest across the warp, else n.
  auto load_b = [&](int k0) {
#pragma unroll
    for (int i = 0; i < B_PER_THREAD; ++i) {
      int nl, kl;
      if (W_NK) {
        kl = tid % BK;
        nl = tid / BK + i * (THREADS / BK);
      } else {
        nl = tid % BN;
        kl = tid / BN + i * (THREADS / BN);
      }
      const int n = n0 + nl, k = k0 + kl;
      rb[i] = (n < N && k < K) ? load_f32(w + k * w_sk + n * w_sn) : 0.f;
    }
  };
  auto store_tiles = [&]() {
#pragma unroll
    for (int i = 0; i < A_PER_THREAD; ++i)
      As[tid / BK + i * (THREADS / BK)][tid % BK] = __float2bfloat16_rn(ra[i]);
#pragma unroll
    for (int i = 0; i < B_PER_THREAD; ++i) {
      if (W_NK)
        Bs[tid / BK + i * (THREADS / BK)][tid % BK] = __float2bfloat16_rn(rb[i]);
      else
        Bs[tid % BN][tid / BN + i * (THREADS / BN)] = __float2bfloat16_rn(rb[i]);
    }
  };

  fragment<accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.f);

  const int n_k = (K + BK - 1) / BK;
  load_a(0);
  load_b(0);
  for (int t = 0; t < n_k; ++t) {
    store_tiles();
    __syncthreads();
    if (t + 1 < n_k) {  // next slice in flight while this one is multiplied
      load_a((t + 1) * BK);
      load_b((t + 1) * BK);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      fragment<matrix_a, 16, 16, 16, __nv_bfloat16, row_major> fa[2];
      fragment<matrix_b, 16, 16, 16, __nv_bfloat16, col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        load_matrix_sync(fa[i], &As[warp_m * 32 + i * 16][kk], LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        load_matrix_sync(fb[j], &Bs[warp_n * 32 + j * 16][kk], LDS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      store_matrix_sync(&Cs[warp_m * 32 + i * 16][warp_n * 32 + j * 16],
                        acc[i][j], LDC, mem_row_major);
  __syncthreads();

  // Epilogue: float32 bias, activation, one rounding to the output type.
#pragma unroll 4
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    float v = Cs[r][c];
    if (b != nullptr) v += b[n];
    if (act == ACT_RELU) v = v > 0.f ? v : 0.f;
    else if (act == ACT_LEAKY) v = v >= 0.f ? v : 0.2f * v;
    store_out(y + (int64_t)m * N + n, v);
  }
}

template <typename TX, typename TW, typename TO>
cudaError_t launch_typed(const void* x, const void* w, int w_nk, const float* b,
                         void* y, int M, int N, int K, int act,
                         cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  if (w_nk)
    fused_linear_kernel<TX, TW, TO, true><<<grid, THREADS, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(w), b,
        static_cast<TO*>(y), M, N, K, act);
  else
    fused_linear_kernel<TX, TW, TO, false><<<grid, THREADS, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(w), b,
        static_cast<TO*>(y), M, N, K, act);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t launch_out(const void* x, const void* w, int w_nk, const float* b,
                       void* y, int y_dtype, int M, int N, int K, int act,
                       cudaStream_t stream) {
  if (y_dtype == DT_F32)
    return launch_typed<TX, TW, float>(x, w, w_nk, b, y, M, N, K, act, stream);
  return launch_typed<TX, TW, __nv_bfloat16>(x, w, w_nk, b, y, M, N, K, act,
                                             stream);
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype codes: 0 float32, 1 bfloat16.
// w_nk = 1: w points at an (N, K) row-major weight (the transposed view);
// w_nk = 0: w is (K, N) row-major. b may be null. Returns cudaGetLastError()
// after the launch, or -1 for arguments the kernel does not take.
extern "C" int fused_linear_launch(const void* x, int x_dtype, const void* w,
                                   int w_dtype, int w_nk, const void* b,
                                   void* y, int y_dtype, int M, int N, int K,
                                   int act, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || act < ACT_NONE || act > ACT_LEAKY)
    return -1;
  if ((x_dtype != DT_F32 && x_dtype != DT_BF16) ||
      (w_dtype != DT_F32 && w_dtype != DT_BF16) ||
      (y_dtype != DT_F32 && y_dtype != DT_BF16))
    return -1;
  const float* bias = static_cast<const float*>(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == DT_F32 && w_dtype == DT_F32)
    err = launch_out<float, float>(x, w, w_nk, bias, y, y_dtype, M, N, K, act, s);
  else if (x_dtype == DT_F32)
    err = launch_out<float, __nv_bfloat16>(x, w, w_nk, bias, y, y_dtype, M, N,
                                           K, act, s);
  else if (w_dtype == DT_F32)
    err = launch_out<__nv_bfloat16, float>(x, w, w_nk, bias, y, y_dtype, M, N,
                                           K, act, s);
  else
    err = launch_out<__nv_bfloat16, __nv_bfloat16>(x, w, w_nk, bias, y,
                                                   y_dtype, M, N, K, act, s);
  return static_cast<int>(err);
}
