// fused_linear: y = act(x · w + b) on Hopper (sm_90a): x and w rounded to
// bf16 (round to nearest even), products summed in float32, the float32 bias
// added, act in {none, relu, leaky_relu(0.2)}, one rounding to the output
// type (bf16 or float32).
//
// Replaces the TPU kernel disentangle_mlp_tpu/ops/pallas/matmul_fused.py
// (`fused_linear`, body `_matmul_kernel`). The Pallas kernel ran a serial
// (M, N, K) grid with a VMEM accumulator; here three paths, chosen by the
// wrapper's `plan` (ops/fused_linear.py) from shapes, dtypes, layout and
// alignment before the launch:
//
// 1. stream: bf16 x, float32 (N, K) weight read through its transpose,
//    K a multiple of 8, 16-byte aligned bases. The β-VAE-GAN step's dense
//    layers (M = 256; K = 16384, N = 2048 above all). There the call is bound
//    by the bytes of the float32 master weight, read once: 134 MB, 40 µs at
//    3.35 TB/s, against 17 µs of bf16 tensor-core work. The design streams
//    that weight at the memory rate:
//    - operands swapped: the block computes the output transposed, so 64
//      weight rows form wgmma's 64-row side (A) and the batch, up to 256
//      rows, forms its N side (B). A block owns 128 weight rows (two
//      warpgroups) by 256 batch rows, so x is read from L2 once for every
//      128 output features;
//    - a 6-stage ring of 32-wide K slices (192 KB of shared memory) is kept
//      in flight with TMA (cp.async.bulk.tensor, mbarrier completion): the
//      float32 weight as one 128 B-swizzled box of 32 floats × 128 rows, x
//      as one 64 B-swizzled box of 32 bf16 × 256 rows; ragged M, N and K
//      edges come from TMA's zero fill. (Three 64-wide stages were a little
//      slower; a seventh stage, L2 prefetches of the weight further ahead
//      and other L2 promotions brought nothing.) Thread 0 issues the loads
//      and refills a slot as soon as both warpgroups have released it.
//      There is no producer warp: a third warpgroup would cap the block at
//      168 registers a thread, and ptxas then serialises the wgmmas (the
//      128 accumulators a thread need the 255-register cap of 256 threads);
//    - both warpgroups read the float32 weight from shared memory and round
//      it to bf16 (cvt.rn.bf16x2.f32) straight into wgmma's register
//      A-fragment, so no cast pass writes or re-reads a bf16 copy; B (x) is
//      read by wgmma from shared memory through a swizzled descriptor; the
//      next stage's fragments are converted while this stage's wgmmas run;
//    - split-K over gridDim.y so that about 132 blocks cover the card (8
//      splits of 16 weight tiles at N = 2048, 32 splits of the one tile at
//      N = 128). Each split writes float32 partials to a workspace; the
//      launch is cooperative (the whole grid resident at once), so a tile's
//      splits then meet at an integer barrier and each sums its share of
//      the tile's rows over all the splits, in split order, adds the bias,
//      activates and rounds once. No float atomics: two launches give
//      identical bits, and no second kernel is launched, which saves the
//      host a launch on calls that are host-bound. (Tried on the H100: a
//      separate reduction kernel took about the same device time, plus its
//      launch; the last split of a tile reducing it alone was slower; so
//      was a thread block cluster reducing through distributed shared
//      memory, likely because 8-block clusters of 197 KB blocks do not all
//      fit on the card at once.) With one split the block runs that epilogue
//      itself and stages the tile in shared memory, so y is written in
//      16-byte row segments.
// 2. dot: N < 64 (the discriminator's 2048 → 1 output, float32 x): one warp
//    for each output, 16-byte vector loads of x and of the weight row, a
//    fixed-order shuffle sum. Bound by the bytes of x; M·N warps spread the
//    reads over the card without a split.
// 3. generic: everything else (a (K, N) row-major weight, a row stride TMA
//    refuses, float32 x with N ≥ 64): 64×64 output tiles, a K loop in the
//    block with register-staged loads rounded to bf16 as they are stored
//    to shared memory, wmma 16×16×16, masked edges. Not on the main path.

#include <cuda.h>  // CUtensorMap and its enums (no libcuda link needed)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <mutex>

namespace {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2 };
enum DType { DT_F32 = 0, DT_BF16 = 1 };
enum Path { PATH_GENERIC = 0, PATH_STREAM = 1, PATH_DOT = 2 };

__device__ __forceinline__ float activate(float v, int act) {
  if (act == ACT_RELU) return v > 0.f ? v : 0.f;
  if (act == ACT_LEAKY) return v >= 0.f ? v : 0.2f * v;
  return v;
}
__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---------------------------------------------------------------------------
// Path 3, generic: the first port's kernel.

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

constexpr int GN_BM = 64;
constexpr int GN_BN = 64;
constexpr int GN_BK = 32;
constexpr int GN_THREADS = 128;        // 4 warps, each a 32×32 sub-tile
constexpr int GN_LDS = GN_BK + 8;      // bf16 row pitch of the A and B tiles
constexpr int GN_LDC = GN_BN + 4;      // float row pitch of the output tile
constexpr int GN_A_PER_THREAD = GN_BM * GN_BK / GN_THREADS;  // 16
constexpr int GN_B_PER_THREAD = GN_BN * GN_BK / GN_THREADS;  // 16

// x: (M, K) row-major. w: element (k, n) at w[k * w_sk + n * w_sn], so both
// a (K, N) row-major w (w_sk = N, w_sn = 1) and the transposed view of an
// (N, K) row-major weight (w_sk = 1, w_sn = K) are read without a copy.
// W_NK selects the thread mapping that keeps the loads coalesced.
template <typename TX, typename TW, typename TO, bool W_NK>
__global__ void __launch_bounds__(GN_THREADS)
fused_linear_generic_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                            const float* __restrict__ b, TO* __restrict__ y,
                            int M, int N, int K, int act) {
  __shared__ __align__(32) __nv_bfloat16 As[GN_BM][GN_LDS];  // [m][k]
  __shared__ __align__(32) __nv_bfloat16 Bs[GN_BN][GN_LDS];  // [n][k]
  __shared__ __align__(32) float Cs[GN_BM][GN_LDC];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int warp_m = warp / 2;
  const int warp_n = warp % 2;
  const int m0 = blockIdx.x * GN_BM;
  const int n0 = blockIdx.y * GN_BN;
  const int64_t w_sk = W_NK ? 1 : N;
  const int64_t w_sn = W_NK ? K : 1;

  float ra[GN_A_PER_THREAD];
  float rb[GN_B_PER_THREAD];

  // A tile: thread owns column tid % 32, rows tid / 32 + 4 i (k fastest).
  auto load_a = [&](int k0) {
    const int kk = k0 + (tid % GN_BK);
#pragma unroll
    for (int i = 0; i < GN_A_PER_THREAD; ++i) {
      const int m = m0 + tid / GN_BK + i * (GN_THREADS / GN_BK);
      ra[i] = (m < M && kk < K) ? load_f32(x + (int64_t)m * K + kk) : 0.f;
    }
  };
  // B tile: with W_NK the k index runs fastest across the warp, else n.
  auto load_b = [&](int k0) {
#pragma unroll
    for (int i = 0; i < GN_B_PER_THREAD; ++i) {
      int nl, kl;
      if (W_NK) {
        kl = tid % GN_BK;
        nl = tid / GN_BK + i * (GN_THREADS / GN_BK);
      } else {
        nl = tid % GN_BN;
        kl = tid / GN_BN + i * (GN_THREADS / GN_BN);
      }
      const int n = n0 + nl, k = k0 + kl;
      rb[i] = (n < N && k < K) ? load_f32(w + k * w_sk + n * w_sn) : 0.f;
    }
  };
  auto store_tiles = [&]() {
#pragma unroll
    for (int i = 0; i < GN_A_PER_THREAD; ++i)
      As[tid / GN_BK + i * (GN_THREADS / GN_BK)][tid % GN_BK] =
          __float2bfloat16_rn(ra[i]);
#pragma unroll
    for (int i = 0; i < GN_B_PER_THREAD; ++i) {
      if (W_NK)
        Bs[tid / GN_BK + i * (GN_THREADS / GN_BK)][tid % GN_BK] =
            __float2bfloat16_rn(rb[i]);
      else
        Bs[tid % GN_BN][tid / GN_BN + i * (GN_THREADS / GN_BN)] =
            __float2bfloat16_rn(rb[i]);
    }
  };

  fragment<accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.f);

  const int n_k = (K + GN_BK - 1) / GN_BK;
  load_a(0);
  load_b(0);
  for (int t = 0; t < n_k; ++t) {
    store_tiles();
    __syncthreads();
    if (t + 1 < n_k) {  // next slice in flight while this one is multiplied
      load_a((t + 1) * GN_BK);
      load_b((t + 1) * GN_BK);
    }
#pragma unroll
    for (int kk = 0; kk < GN_BK; kk += 16) {
      fragment<matrix_a, 16, 16, 16, __nv_bfloat16, row_major> fa[2];
      fragment<matrix_b, 16, 16, 16, __nv_bfloat16, col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        load_matrix_sync(fa[i], &As[warp_m * 32 + i * 16][kk], GN_LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        load_matrix_sync(fb[j], &Bs[warp_n * 32 + j * 16][kk], GN_LDS);
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
                        acc[i][j], GN_LDC, mem_row_major);
  __syncthreads();

  // Epilogue: float32 bias, activation, one rounding to the output type.
#pragma unroll 4
  for (int e = tid; e < GN_BM * GN_BN; e += GN_THREADS) {
    const int r = e / GN_BN, c = e % GN_BN;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    float v = Cs[r][c];
    if (b != nullptr) v += b[n];
    store_out(y + (int64_t)m * N + n, activate(v, act));
  }
}

// ---------------------------------------------------------------------------
// Path 1, stream: TMA ring, register-A wgmma, split-K.

constexpr int ST_BN = 128;                      // weight rows a block
constexpr int ST_BM = 256;                      // batch rows a block (wgmma N)
constexpr int ST_BK = 32;                       // K a stage: 32 or 64
constexpr int ST_KS = ST_BK / 16;               // wgmma k16 slices a stage
constexpr int ST_W_BOXES = ST_BK / 32;          // weight boxes a stage
constexpr int ST_W_BOX = ST_BN * 32 * 4;        // 128 rows × 32 float32: 16 KB
constexpr int ST_W_BYTES = ST_W_BOXES * ST_W_BOX;
constexpr int ST_X_ROW = ST_BK * 2;             // bytes: the x tile's swizzle
constexpr int ST_X_BYTES = ST_BM * ST_X_ROW;    // 256 rows
constexpr int ST_STAGE_BYTES = ST_W_BYTES + ST_X_BYTES;
constexpr int ST_STAGES = 3 * 65536 / ST_STAGE_BYTES;  // a 192 KB ring
constexpr int ST_THREADS = 256;                 // two warpgroups
constexpr int ST_SMEM = ST_STAGES * ST_STAGE_BYTES + 1024 + 2 * ST_STAGES * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
// Spins until the barrier's phase of this parity completes. A completion
// that never comes (a refused TMA copy) traps after about 2^30 polls, so
// the launch fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 30)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// One TMA box (c0 along the inner dimension, c1 along rows) into shared
// memory; completion is counted in bytes on the mbarrier.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of the K-major x tile in the swizzle
// layout of its row width (128 B: layout 1, 64 B: layout 2): 8-row atoms
// 8 rows apart (SBO), start >> 4.
__device__ __forceinline__ uint64_t x_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(8 * ST_X_ROW >> 4) << 32) |
         (static_cast<uint64_t>(ST_X_ROW == 128 ? 1 : 2) << 62);
}

// Two neighbouring float32 weights of one row of a weight box (128 rows of
// 32 floats, 128 B a row, TMA's 128 B swizzle: 16-byte chunk c of row r lies
// at chunk c ^ (r & 7)), rounded to bf16 and packed low = col, high = col + 1
// as wgmma's A-fragment wants them (cvt.rn.bf16x2.f32).
__device__ __forceinline__ uint32_t w_pair(const unsigned char* box, int r,
                                           int col) {
  const float2 v = *reinterpret_cast<const float2*>(
      box + r * 128 + ((((col >> 2) ^ (r & 7)) << 4) | ((col & 3) << 2)));
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_prior() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// D(64×256, float32) = A(64×16 bf16, registers) · B(16×256 bf16, shared,
// K-major, described by desc_b) + (accumulate ? D : 0).
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc_b,
                                                 uint32_t accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

// Barrier of the `splits` blocks of one output tile, which a cooperative
// launch keeps resident together: bar[0] counts arrivals, bar[1] flips when
// the last one arrives (which also puts bar[0] back to 0, so the pair is
// ready for the next launch). Called by one thread a block.
__device__ __forceinline__ void tile_barrier(int* bar, int splits) {
  volatile int* sense = bar + 1;
  const int before = atomicAdd(bar + 1, 0);
  __threadfence();
  if (atomicAdd(bar, 1) == splits - 1) {
    atomicExch(bar, 0);
    __threadfence();
    atomicExch(bar + 1, before ^ 1);
  } else {
    uint32_t polls = 0;
    while (*sense == before)
      if (++polls == (1u << 30)) __trap();
  }
  __threadfence();
}

// Grid (N tiles, splits, M tiles). w_map: the float32 (N, K) weight, boxes
// of 32 × 128; x_map: the bf16 (M, K) input, boxes of 64 × 256. With one
// split the block writes y. Else (a cooperative launch) it writes its
// float32 partial sums to ws[split][m][n], waits for the tile's other
// splits, and sums its share of the tile's rows over all the splits.
// tile_bars: two ints a tile, zero before the first launch.
template <typename TO>
__global__ void __launch_bounds__(ST_THREADS, 1)
fused_linear_stream_kernel(const __grid_constant__ CUtensorMap w_map,
                           const __grid_constant__ CUtensorMap x_map,
                           const float* __restrict__ b, TO* __restrict__ y,
                           float* __restrict__ ws, int* __restrict__ tile_bars,
                           int M, int N, int K, int act) {
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment of every tile: the swizzle atoms' base
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t bars = smem_u32(smem + ST_STAGES * ST_STAGE_BYTES);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (ST_STAGES + s); };

  const int n_tile = blockIdx.x, split = blockIdx.y, m_tile = blockIdx.z;
  const int splits = gridDim.y;
  const int k_steps = (K + ST_BK - 1) / ST_BK;
  const int t_begin = static_cast<int>(static_cast<int64_t>(split) * k_steps /
                                       splits);
  const int t_end = static_cast<int>(static_cast<int64_t>(split + 1) *
                                     k_steps / splits);
  const int n_t = t_end - t_begin;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < ST_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), ST_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Stage i's loads into slot i % ST_STAGES, by thread 0. A weight box that
  // lies wholly beyond K is not loaded (the fragments use zeros for it).
  auto issue = [&](int i) {
    const int s = i % ST_STAGES;
    const int k0 = (t_begin + i) * ST_BK;
    const int boxes = min(ST_W_BOXES, (K - k0 + 31) / 32);
    mbar_expect_tx(full(s), ST_X_BYTES + boxes * ST_W_BOX);
    unsigned char* st = smem + s * ST_STAGE_BYTES;
    for (int h = 0; h < boxes; ++h)
      tma_load_2d(smem_u32(st + h * ST_W_BOX), &w_map, full(s), k0 + 32 * h,
                  n_tile * ST_BN);
    tma_load_2d(smem_u32(st + ST_W_BYTES), &x_map, full(s), k0,
                m_tile * ST_BM);
  };
  if (tid == 0)
    for (int i = 0; i < ST_STAGES && i < n_t; ++i) issue(i);

  // Warpgroup wg owns weight rows wg·64 .. wg·64 + 63 of the tile; 128
  // float32 accumulators a thread.
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = wg * 64 + warp * 16 + g;  // and r0 + 8
  // Defined by the first wgmma (accumulate = 0): an initialisation by other
  // instructions would make ptxas serialise the wgmmas.
  float d[128];

  // A-fragments of stage i, rounded to bf16: ST_KS k16 slices × 4
  // registers.
  auto load_a = [&](int i, uint32_t (&a)[ST_KS][4]) {
    const int s = i % ST_STAGES;
    mbar_wait(full(s), (i / ST_STAGES) & 1);
    const unsigned char* st = smem + s * ST_STAGE_BYTES;
    const int k0 = (t_begin + i) * ST_BK;
#pragma unroll
    for (int j = 0; j < ST_KS; ++j) {
      const unsigned char* box = st + (j / 2) * ST_W_BOX;
      const int c = (j % 2) * 16 + 2 * t;
      if (j < 2 || k0 + 32 * (j / 2) < K) {
        a[j][0] = w_pair(box, r0, c);
        a[j][1] = w_pair(box, r0 + 8, c);
        a[j][2] = w_pair(box, r0, c + 8);
        a[j][3] = w_pair(box, r0 + 8, c + 8);
      } else {
        a[j][0] = a[j][1] = a[j][2] = a[j][3] = 0u;
      }
    }
  };
  // Stage i's wgmmas run while the next stage's fragments are read and
  // converted. Once stage i - 1's wgmmas are done its slot is released, and
  // refilled with stage i - 1 + ST_STAGES when both warpgroups have
  // released it.
  auto step = [&](int i, const uint32_t (&a)[ST_KS][4],
                  uint32_t (&a_next)[ST_KS][4]) {
    const uint32_t xs = smem_u32(smem + (i % ST_STAGES) * ST_STAGE_BYTES +
                                 ST_W_BYTES);
    __syncwarp();  // the .aligned wgmma instructions want converged warps
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < ST_KS; ++j)
      wgmma_m64n256k16(d, a[j], x_desc(xs + 32 * j), i > 0 || j > 0);
    wgmma_commit();
    wgmma_wait_prior();  // stage i - 1's wgmmas, which read a_next, are done
    if (i > 0) {
      const int prev = i - 1;
      if (lane == 0) mbar_arrive(empty(prev % ST_STAGES));
      if (tid == 0 && prev + ST_STAGES < n_t) {
        mbar_wait(empty(prev % ST_STAGES), (prev / ST_STAGES) & 1);
        issue(prev + ST_STAGES);
      }
    }
    if (i + 1 < n_t) load_a(i + 1, a_next);
  };
  uint32_t a0[ST_KS][4], a1[ST_KS][4];
  load_a(0, a0);
  for (int i = 0; i < n_t; i += 2) {
    step(i, a0, a1);
    if (i + 1 < n_t) step(i + 1, a1, a0);
  }
  wgmma_wait_all();

  // d[4i + 2q + h] holds tile row (weight row) r0 + 8q, batch row
  // 2t + 8i + h.
  const int m_base = m_tile * ST_BM;
  const int n_base = n_tile * ST_BN;
  if (splits > 1) {
    // Lanes g = 0..7 hold 8 neighbouring outputs of one batch row: every
    // store fills whole 32-byte sectors of ws.
#pragma unroll
    for (int i = 0; i < 32; ++i)
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m_base + 2 * t + 8 * i + h, n = n_base + r0 + 8 * q;
          if (m < M && n < N)
            ws[(static_cast<int64_t>(split) * M + m) * N + n] =
                d[4 * i + 2 * q + h];
        }
    // Then this split's share of the tile's rows, summed over the splits in
    // split order (the same order in every launch), bias, activation,
    // rounding.
    __threadfence();
    __syncthreads();
    if (tid == 0)
      tile_barrier(tile_bars + 2 * (m_tile * gridDim.x + n_tile), splits);
    __syncthreads();
    const int64_t mn = static_cast<int64_t>(M) * N;
    const int tile_rows = min(ST_BM, M - m_base);
    const int per = (tile_rows + splits - 1) / splits;
    const int r_lo = split * per;
    const int rows = min(per, tile_rows - r_lo);
    const int cols = min(ST_BN, N - n_base);
    const int unit = N % 4 == 0 ? 4 : 1;  // 16-byte rows of ws, or not
    const int chunks = (cols + unit - 1) / unit;
    for (int c = tid; c < rows * chunks; c += ST_THREADS) {
      const int r = r_lo + c / chunks, j = (c % chunks) * unit;
      const int64_t e = static_cast<int64_t>(m_base + r) * N + n_base + j;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (unit == 4) {
        for (int p = 0; p < splits; ++p) {
          const float4 part =
              __ldcg(reinterpret_cast<const float4*>(ws + p * mn + e));
          v[0] += part.x; v[1] += part.y; v[2] += part.z; v[3] += part.w;
        }
      } else {
        for (int p = 0; p < splits; ++p) v[0] += __ldcg(ws + p * mn + e);
      }
      for (int u = 0; u < unit; ++u)
        store_out(y + e + u, activate(v[u] + (b != nullptr ? b[n_base + j + u]
                                                           : 0.f), act));
    }
    return;
  }
  // One split: bias, activation and rounding here; the tile goes through
  // shared memory as y's rows (a 16-byte pad keeps the writes free of bank
  // conflicts), then out in 16-byte segments where y's rows allow it.
  constexpr int PITCH = ST_BN + 16 / static_cast<int>(sizeof(TO));
  TO* ys = reinterpret_cast<TO*>(smem);
  __syncthreads();  // both warpgroups are done with the ring
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int n = n_base + r0 + 8 * q;
    const float bias = (b != nullptr && n < N) ? b[n] : 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store_out(ys + (2 * t + 8 * i + h) * PITCH + r0 + 8 * q,
                  activate(d[4 * i + 2 * q + h] + bias, act));
  }
  __syncthreads();
  const int rows = min(ST_BM, M - m_base), cols = min(ST_BN, N - n_base);
  if ((static_cast<int64_t>(N) * sizeof(TO)) % 16 == 0) {
    constexpr int VEC = 16 / sizeof(TO), CHUNKS = ST_BN / VEC;
    for (int c = tid; c < rows * CHUNKS; c += ST_THREADS) {
      const int r = c / CHUNKS, j = (c % CHUNKS) * VEC;
      if (j < cols)
        *reinterpret_cast<uint4*>(y + static_cast<int64_t>(m_base + r) * N +
                                  n_base + j) =
            *reinterpret_cast<const uint4*>(ys + r * PITCH + j);
    }
  } else {
    for (int e = tid; e < rows * ST_BN; e += ST_THREADS) {
      const int r = e / ST_BN, j = e % ST_BN;
      if (j < cols)
        y[static_cast<int64_t>(m_base + r) * N + n_base + j] = ys[r * PITCH + j];
    }
  }
}

// ---------------------------------------------------------------------------
// Path 2, dot: one warp for each output element.

constexpr int DOT_WARPS = 4;

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 c = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// x (M, K) and w (N, K) row-major, K a multiple of 8, 16-byte aligned rows.
// Lane l sums k = 8l .. 8l + 7 of every 256-wide slice; the lanes' sums are
// then added in a fixed butterfly order.
template <typename TX, typename TW, typename TO>
__global__ void __launch_bounds__(DOT_WARPS * 32)
fused_linear_dot_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                        const float* __restrict__ b, TO* __restrict__ y, int M,
                        int N, int K, int act) {
  const int lane = threadIdx.x % 32;
  const int64_t o = static_cast<int64_t>(blockIdx.x) * DOT_WARPS +
                    threadIdx.x / 32;
  if (o >= static_cast<int64_t>(M) * N) return;
  const int m = static_cast<int>(o / N), n = static_cast<int>(o % N);
  const TX* xr = x + static_cast<int64_t>(m) * K;
  const TW* wr = w + static_cast<int64_t>(n) * K;
  float acc = 0.f;
#pragma unroll 4
  for (int k = lane * 8; k < K; k += 256) {
    float xv[8], wv[8];
    load8(xr + k, xv);
    load8(wr + k, wv);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = fmaf(bf16_round(xv[j]), bf16_round(wv[j]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    if (b != nullptr) acc += b[n];
    store_out(y + o, activate(acc, act));
  }
}

// ---------------------------------------------------------------------------
// Host side.

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call; take it from the driver the
// runtime already loaded rather than linking libcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A row-major (rows, cols) tensor map with boxes of box_cols × box_rows and
// the given swizzle; out-of-bounds elements read as zero. A map depends on
// nothing but these arguments, so the last few are kept and reused (the
// training step passes the same weights, and often the same activation
// buffers, again and again).
struct MapKey {
  const void* base;
  int rows, cols, type, box_cols;
};
bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
               const void* base, int rows, int cols, int box_cols,
               int box_rows, CUtensorMapSwizzle swizzle) {
  constexpr int SLOTS = 32;
  static MapKey keys[SLOTS];
  static CUtensorMap maps[SLOTS];
  static int next = 0;
  static std::mutex mu;
  const std::lock_guard<std::mutex> lock(mu);
  const MapKey key = {base, rows, cols, static_cast<int>(type), box_cols};
  for (int i = 0; i < SLOTS; ++i)
    if (keys[i].base == key.base && keys[i].rows == rows &&
        keys[i].cols == cols && keys[i].type == key.type &&
        keys[i].box_cols == box_cols) {
      *map = maps[i];
      return true;
    }
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  if (fn(map, type, 2, const_cast<void*>(base), dims, strides, box,
         elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
         swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % SLOTS;
  return true;
}

constexpr int ERR_REFUSED = -1;
constexpr int ERR_TENSOR_MAP = -2;

template <typename TO>
int launch_stream(const void* x, const void* w, const float* b, void* y,
                  float* ws, int* bars, int M, int N, int K, int act,
                  int splits, cudaStream_t stream) {
  CUtensorMap w_map, x_map;
  if (!encode_2d(&w_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, w, N, K, 32,
                 ST_BN, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, ST_BK,
                 ST_BM, ST_X_ROW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                        : CU_TENSOR_MAP_SWIZZLE_64B))
    return ERR_TENSOR_MAP;
  static uint64_t smem_set = 0;  // devices whose attribute is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && !(smem_set >> (dev & 63) & 1)) {
    err = cudaFuncSetAttribute(fused_linear_stream_kernel<TO>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ST_SMEM);
    if (err == cudaSuccess) smem_set |= uint64_t{1} << (dev & 63);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // With splits the tile's blocks wait for each other: a cooperative launch
  // keeps the whole grid resident at once, or refuses to launch.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + ST_BN - 1) / ST_BN, splits, (M + ST_BM - 1) / ST_BM);
  cfg.blockDim = dim3(ST_THREADS);
  cfg.dynamicSmemBytes = ST_SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute cooperative;
  cooperative.id = cudaLaunchAttributeCooperative;
  cooperative.val.cooperative = 1;
  cfg.attrs = &cooperative;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, fused_linear_stream_kernel<TO>, w_map, x_map,
                           b, static_cast<TO*>(y), ws, bars, M, N, K, act);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TW, typename TO>
int launch_typed(const void* x, const void* w, int w_nk, const float* b,
                 void* y, int M, int N, int K, int act, int path,
                 cudaStream_t stream) {
  if (path == PATH_DOT) {
    const int64_t blocks = (static_cast<int64_t>(M) * N + DOT_WARPS - 1) /
                           DOT_WARPS;
    if (blocks > 0x7fffffff) return ERR_REFUSED;
    fused_linear_dot_kernel<TX, TW, TO>
        <<<static_cast<unsigned>(blocks), DOT_WARPS * 32, 0, stream>>>(
            static_cast<const TX*>(x), static_cast<const TW*>(w), b,
            static_cast<TO*>(y), M, N, K, act);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((M + GN_BM - 1) / GN_BM, (N + GN_BN - 1) / GN_BN);
  if (w_nk)
    fused_linear_generic_kernel<TX, TW, TO, true>
        <<<grid, GN_THREADS, 0, stream>>>(static_cast<const TX*>(x),
                                          static_cast<const TW*>(w), b,
                                          static_cast<TO*>(y), M, N, K, act);
  else
    fused_linear_generic_kernel<TX, TW, TO, false>
        <<<grid, GN_THREADS, 0, stream>>>(static_cast<const TX*>(x),
                                          static_cast<const TW*>(w), b,
                                          static_cast<TO*>(y), M, N, K, act);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TW>
int launch_out(const void* x, const void* w, int w_nk, const float* b, void* y,
               int y_dtype, int M, int N, int K, int act, int path,
               cudaStream_t stream) {
  if (y_dtype == DT_F32)
    return launch_typed<TX, TW, float>(x, w, w_nk, b, y, M, N, K, act, path,
                                       stream);
  return launch_typed<TX, TW, __nv_bfloat16>(x, w, w_nk, b, y, M, N, K, act,
                                             path, stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int launch_path(const void* x, int x_dtype, const void* w, int w_dtype,
                int w_nk, const void* b, void* y, int y_dtype, int M, int N,
                int K, int act, int path, int splits, void* ws,
                void* bars, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || act < ACT_NONE || act > ACT_LEAKY)
    return ERR_REFUSED;
  if ((x_dtype != DT_F32 && x_dtype != DT_BF16) ||
      (w_dtype != DT_F32 && w_dtype != DT_BF16) ||
      (y_dtype != DT_F32 && y_dtype != DT_BF16))
    return ERR_REFUSED;
  const float* bias = static_cast<const float*>(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == PATH_STREAM) {
    const int k_steps = (K + ST_BK - 1) / ST_BK;
    if (x_dtype != DT_BF16 || w_dtype != DT_F32 || !w_nk || K % 8 != 0 ||
        !aligned16(x) || !aligned16(w) || splits < 1 || splits > k_steps ||
        splits > 65535 || (M + ST_BM - 1) / ST_BM > 65535 ||
        (splits > 1 && (ws == nullptr || bars == nullptr)))
      return ERR_REFUSED;
    float* work = static_cast<float*>(ws);
    int* tile_bars = static_cast<int*>(bars);
    if (y_dtype == DT_F32)
      return launch_stream<float>(x, w, bias, y, work, tile_bars, M, N, K, act,
                                  splits, s);
    return launch_stream<__nv_bfloat16>(x, w, bias, y, work, tile_bars, M, N,
                                        K, act, splits, s);
  }
  if (path == PATH_DOT) {
    if (!w_nk || K % 8 != 0 || !aligned16(x) || !aligned16(w))
      return ERR_REFUSED;
  } else if (path != PATH_GENERIC) {
    return ERR_REFUSED;
  }
  if (x_dtype == DT_F32 && w_dtype == DT_F32)
    return launch_out<float, float>(x, w, w_nk, bias, y, y_dtype, M, N, K, act,
                                    path, s);
  if (x_dtype == DT_F32)
    return launch_out<float, __nv_bfloat16>(x, w, w_nk, bias, y, y_dtype, M, N,
                                            K, act, path, s);
  if (w_dtype == DT_F32)
    return launch_out<__nv_bfloat16, float>(x, w, w_nk, bias, y, y_dtype, M, N,
                                            K, act, path, s);
  return launch_out<__nv_bfloat16, __nv_bfloat16>(x, w, w_nk, bias, y, y_dtype,
                                                  M, N, K, act, path, s);
}

}  // namespace

// Plain C entry point, bound with ctypes. Its arguments come packed in one
// int64 array, since ctypes spends more host time converting arguments
// than the launch itself takes: a[0] x, a[1] x dtype, a[2] w, a[3] w dtype,
// a[4] w_nk, a[5] b, a[6] y, a[7] y dtype, a[8] M, a[9] N, a[10] K,
// a[11] act, a[12] path, a[13] splits, a[14] ws, a[15] bars, a[16] device,
// a[17] stream. dtype codes: 0 float32, 1 bfloat16. w_nk = 1: w points at
// an (N, K) row-major weight (the transposed view); w_nk = 0: w is (K, N)
// row-major. b may be null (0). path: 0 generic, 1 stream, 2 dot; splits, ws
// (float32, splits·M·N) and bars (int32, two a 128 × 256 output tile, zero
// before first use) serve the stream path, the last two only for more than
// one split. The launches go to `device`, which is made current for the
// call. Returns cudaGetLastError() after the launch, -1 for arguments the
// chosen path does not take, -2 when a TMA descriptor cannot be encoded.
extern "C" int fused_linear_launch(const int64_t* a) {
  auto ptr = [&](int i) { return reinterpret_cast<void*>(a[i]); };
  for (int i = 8; i <= 10; ++i)  // M, N, K
    if (a[i] <= 0 || a[i] > INT32_MAX) return ERR_REFUSED;
  const int device = static_cast<int>(a[16]);
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = launch_path(
      ptr(0), static_cast<int>(a[1]), ptr(2), static_cast<int>(a[3]),
      static_cast<int>(a[4]), ptr(5), ptr(6), static_cast<int>(a[7]),
      static_cast<int>(a[8]), static_cast<int>(a[9]), static_cast<int>(a[10]),
      static_cast<int>(a[11]), static_cast<int>(a[12]),
      static_cast<int>(a[13]), ptr(14), ptr(15), ptr(17));
  if (current != device) cudaSetDevice(current);
  return rc;
}
