// Depthwise k×k convolutions on Hopper (sm_90a): stride 1, "same" padding
// (k − 1) / 2, no bias, channels-last (NHWC) bf16 or float32 tensors,
// float32 sums, rounded once to the output. k is 3 or 5.
//
// Replaces no TPU kernel: the JAX package leaves its convolutions to XLA.
// In PyTorch the depthwise 5×5 of NVAE's inverted-residual cells ran
// through cuDNN's `*_c1_k1_nhwc*` kernels, about a fifth of their byte
// roofline, which read dy twice backward (once for dx, once for dw).
//
// What bounds it on an H100: bytes and FMAs alike. The function has to move
// x in and y out forward (4 B an element in bf16), x and dy in and dx out
// backward (6 B); at NVAE's step (72 calls, 5.84 G elements) that is 58.4 GB,
// 17.4 ms at 3.35 TB/s. It does k² float32 FMAs an element forward and 2k²
// backward (dx and dw): 438 G FMAs at k = 5, some 15 ms at the card's float32
// rate. So both the loads and the FMA pipe have to stay busy, and a shared
// memory load has to feed several FMAs.
//
// The design (ops/depthwise_conv.py `plan` sizes it from the shape):
// - A persistent grid, one block an SM. The work is cut into tiles of
//   (`nb` images, `th` output rows, every column, a chunk of 128 bytes of
//   channels: 64 in bf16, 32 in float32), ordered chunk by chunk, and each
//   block walks one contiguous range of them, so a block meets at most a
//   few chunks and its neighbouring tiles share their halo rows in the L2.
// - One producer warp fills a ring of shared-memory stages with TMA: a 4-D
//   tensor map over (C, W, H, N) whose out-of-bounds elements read as zero,
//   so one box starting at (c0, −p, h0 − p, n0) brings a tile with its halo
//   and the padding costs nothing. The box is `wp + k − 1` columns wide,
//   `wp` the width rounded up to whole runs, so that a ragged run, rows
//   past H and channels past C read zeros too. The consumer warps hand a
//   stage back through its `empty` mbarrier.
// - A consumer warp takes one pixel's chunk at a time, each lane 4 bytes of
//   it (a bf16 pair, or one float: one 128-byte line a warp load), and keeps
//   its channels' k² weights in float32 registers. An item is a run of RUN
//   outputs along w (two rows of them forward): for each input row the lane
//   loads the RUN + k − 1 values of the row once and adds each into every
//   output whose window holds it, so one shared-memory load feeds up to k
//   outputs a row (2k forward). Sums stay in float32 until the single
//   rounded store. A block's items are dealt to its warps in turn across
//   tiles, so that none runs more than one item beyond another.
// - Backward, fused: stride 1 with same padding makes dx the forward of dy
//   with the kernel turned 180°, and dw[i][j] = Σ x[h, w]·dy[h + p − i,
//   w + p − j] pairs each x with the same dy values. So the backward stages
//   hold the haloed dy tile and the plain x tile; a lane loads its run's x
//   into registers, and every dy value it loads goes into dx through the
//   turned weights and into the k² dw sums of its channels through those x.
//   dy is read once for both gradients.
// - dw without atomics: each block sums its warps' dw in a fixed order
//   (warp by warp through shared memory) whenever it leaves a chunk, into a
//   float32 scratch row of its own, (blocks + chunks − 1) rows of (chunk,
//   k²): block b writes chunk q's sums to row b + q, unique since a block's
//   chunks rise with b. `dmt_dwconv_bwd_finalize` adds, for each channel,
//   the rows of the blocks whose range met its chunk, in block order. Two
//   launches give the same bits.
// - Registers set the warps: the forward's 2 × RUN sums and k² weights fit
//   128 registers a thread, 15 consumer warps; the backward's sums, weights
//   and k² dw sums 168, 11 warps. What bounds it then: the FMA pipe's issue
//   rate, at about half its peak (PERF.md §5); the bytes come second.
// - The kernels' names carry `dmt_dwconv` and `conv`, never `reduce` or
//   `elementwise`, so a trace files them with the convolutions.

#include <cuda.h>  // CUtensorMap and its enums (no libcuda link needed)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// outputs a thread computes along w, and rows of them forward
// (ops/depthwise_conv.py RUN, FWD_ROWS)
constexpr int RUN = 8;
constexpr int FWD_ROWS = 2;
// V neighbouring channels a thread, 4 bytes: a bf16 pair or one float, so a
// warp's chunk of 32·V channels is one 128-byte line of a box
template <typename T> constexpr int VEC = 4 / sizeof(T);
// consumer warps a block beside the producer warp, for V channels a thread
// (ops/depthwise_conv.py WARPS): the SM's four quarters hold 16 K registers
// each, so 16 warps (4 a quarter) give a thread 128 registers, 12 warps
// 168, 24 warps 80 and 20 warps 96
template <int V> struct Warps;
template <> struct Warps<2> { static constexpr int fwd = 15, bwd = 11; };
template <> struct Warps<1> { static constexpr int fwd = 23, bwd = 19; };
// ring stages at most, the barriers' bytes, the card's 227 KB a block
// (MAX_STAGES, BAR_BYTES, SMEM_BYTES)
constexpr int MAX_STAGES = 8;
constexpr int BAR_BYTES = 2 * MAX_STAGES * 8;
constexpr int SMEM_BYTES = 227 * 1024;
// the largest box edge a tensor map takes
constexpr int MAX_BOX = 256;
constexpr int ALIGN = 128;

enum DType { DT_F32 = 0, DT_BF16 = 1 };

// a thread's V neighbouring channels as stored (one 4-byte access), and as
// float32
template <typename T, int V> struct Vec;
template <> struct Vec<__nv_bfloat16, 2> {
  using type = __nv_bfloat162;
  __device__ static void load(const type& s, float (&f)[2]) {
    const float2 v = __bfloat1622float2(s);
    f[0] = v.x;
    f[1] = v.y;
  }
  __device__ static void store(type* p, const float (&f)[2]) {
    *p = __floats2bfloat162_rn(f[0], f[1]);
  }
};
template <> struct Vec<float, 1> {
  using type = float;
  __device__ static void load(const type& s, float (&f)[1]) { f[0] = s; }
  __device__ static void store(type* p, const float (&f)[1]) { *p = f[0]; }
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---- mbarriers and TMA (as csrc/batchnorm.cu's ring) ----------------------

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(saddr(bar)),
               "r"(count)
               : "memory");
}
// this thread's arrival, and `bytes` more for the phase to wait for
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   saddr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(saddr(bar))
      : "memory");
}
__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// until the phase of parity `parity` has completed. A stage lands in
// microseconds: one that has not after WAIT_NS is a fault, and the kernel
// traps (the launch fails) instead of holding the card.
constexpr uint64_t WAIT_NS = 10000000000ull;
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  uint64_t since = 0;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(saddr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries % 1024 == 0) {
      const uint64_t t = now_ns();
      if (since == 0) since = t;
      else if (t - since > WAIT_NS) __trap();
    }
  }
}
// one box of a 4-D tensor map at (c, w, h, n) into shared memory,
// completing on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c, int w,
                                            int h, int n) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(w), "r"(h), "r"(n),
      "r"(saddr(bar))
      : "memory");
}
// the consumer warps alone (the producer warp has finished)
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// ---- the walk -------------------------------------------------------------

// x (N, C, H, W) stored [N][H][W][C]; tiles of `nb` images × `th` rows ×
// `runs`·RUN columns × a chunk of 32·V channels (a warp's, one line of a
// box), `tiles` a chunk, chunk-major; `blocks` contiguous ranges of them;
// `stages` ring stages of `stage` bytes, the haloed box first (`groups`·ROWS
// output rows), then (backward) the plain x box at `center`
struct Geo {
  int N, H, W, C;
  int nb, th, runs, groups;
  int chunks, tiles;
  int stages, blocks;
  int stage, center;  // bytes
  uint32_t tx;        // bytes a stage's boxes bring
};

__device__ __forceinline__ void tile_at(const Geo& g, long long u, int& q,
                                        int& n0, int& h0) {
  q = static_cast<int>(u / g.tiles);
  const int rem = static_cast<int>(u % g.tiles);
  const int hts = (g.H + g.th - 1) / g.th;
  n0 = rem / hts * g.nb;
  h0 = rem % hts * g.th;
}

// tiles [lo, hi) of block b
__device__ __forceinline__ void block_range(const Geo& g, int b,
                                            long long& lo, long long& hi) {
  const long long total = static_cast<long long>(g.chunks) * g.tiles;
  lo = total * b / g.blocks;
  hi = total * (b + 1) / g.blocks;
}

struct Args {
  const void* w;   // (C, 1, K, K)
  void* out;       // y or dx
  float* scratch;  // backward: (blocks + chunks − 1, CC, K²) float32
};

// The block's dw of chunk `q`, its warps added in order through `red`
// ((K², CC) floats), to scratch row blockIdx.x + q; every consumer thread
// calls it.
template <int K, int V, int THREADS>
__device__ __forceinline__ void flush(const float (&dw)[K * K][V], float* red,
                                      float* scratch, int q, int lane,
                                      int slot) {
  constexpr int KK = K * K, CC = 32 * V, SLOTS = THREADS / 32;
  consumers_sync(THREADS);  // `red` free again
  for (int sl = 0; sl < SLOTS; ++sl) {
    if (slot == sl) {
#pragma unroll
      for (int f = 0; f < KK; ++f) {  // f is turned: the tap is KK − 1 − f
        float* r = red + (KK - 1 - f) * CC + V * lane;
#pragma unroll
        for (int v = 0; v < V; ++v) r[v] = sl > 0 ? r[v] + dw[f][v] : dw[f][v];
      }
    }
    consumers_sync(THREADS);
  }
  float* dst = scratch + (static_cast<long long>(blockIdx.x) + q) * CC * KK;
  for (int idx = threadIdx.x; idx < CC * KK; idx += THREADS)
    dst[idx] = red[(idx % KK) * CC + idx / KK];
}

// One kernel for both directions. Forward: the haloed box is x, outputs y,
// ROWS rows of RUN outputs a thread. Backward (ROWS 1): the haloed box is
// dy, the plain box x; outputs dx (dy through the weights turned 180°) and
// the block's dw rows in `scratch`. A warp takes one pixel's chunk, V
// channels a lane.
template <typename T, int K, int CW, int ROWS, bool BWD>
__device__ __forceinline__ void body(const CUtensorMap* halo_map,
                                     const CUtensorMap* x_map, const Args& A,
                                     const Geo& g) {
  constexpr int V = VEC<T>;
  using VT = Vec<T, V>;
  using S = typename VT::type;
  constexpr int CC = 32 * V;  // a chunk's channels
  constexpr int PAD = K / 2, KK = K * K, SPAN = RUN + K - 1;
  constexpr int THREADS = CW * 32, SLOTS = CW;
  static_assert(!BWD || ROWS == 1, "the backward takes one row a thread");
  extern __shared__ __align__(ALIGN) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  float* red = reinterpret_cast<float*>(smem + BAR_BYTES);  // (K², CC)
  constexpr int RED_BYTES = BWD ? (CC * KK * 4 + ALIGN - 1) / ALIGN * ALIGN
                                : 0;
  unsigned char* ring = smem + BAR_BYTES + RED_BYTES;
  long long lo, hi;
  block_range(g, blockIdx.x, lo, hi);
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp == CW) {  // the producer
    if (lane == 0) {
      int i = 0;
      for (long long u = lo; u < hi; ++u, ++i) {
        const int s = i % g.stages, round = i / g.stages;
        int q, n0, h0;
        tile_at(g, u, q, n0, h0);
        if (round > 0) bar_wait(&empty[s], (round - 1) & 1);
        bar_expect(&full[s], g.tx);
        unsigned char* dst = ring + static_cast<long long>(s) * g.stage;
        tma_load_4d(dst, halo_map, &full[s], q * CC, -PAD, h0 - PAD, n0);
        if (BWD) tma_load_4d(dst + g.center, x_map, &full[s], q * CC, 0, h0,
                             n0);
      }
    }
    return;
  }

  const int slot = warp;
  const int wp = g.runs * RUN, rows_in = g.groups * ROWS + K - 1;
  // The block's items (runs of a warp's channels) in tile order, dealt to
  // the warps in turn across tiles, so that no warp runs more than one item
  // beyond another: the warp's next item as (image, row group, run) of its
  // tile, stepped SLOTS items at a time.
  const int per_img = g.groups * g.runs;
  const int step_rem = SLOTS % per_img, step_img = SLOTS / per_img;
  const int step_rg = step_rem / g.runs, step_q = step_rem % g.runs;
  int img = slot / per_img, rg = slot % per_img / g.runs, run = slot % g.runs;
  const T* wsrc = static_cast<const T*>(A.w);
  S* out = static_cast<S*>(A.out);
  float wt[KK][V];   // the lane's weights (turned 180° backward)
  float dw[KK][V];   // backward: the lane's dw sums, in the turned order
  int cur = -1;      // the chunk the weights and sums are of
  int c = 0;         // the lane's first channel

  int i = 0;
  for (long long u = lo; u < hi; ++u, ++i) {
    int q, n0, h0;
    tile_at(g, u, q, n0, h0);
    if (q != cur) {
      if (BWD && cur >= 0)
        flush<K, V, THREADS>(dw, red, A.scratch, cur, lane, slot);
      c = q * CC + V * lane;
      const T* wc = wsrc + static_cast<long long>(c) * KK;
#pragma unroll
      for (int f = 0; f < KK; ++f) {
        const int tap = BWD ? KK - 1 - f : f;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          wt[f][v] = c < g.C ? to_f32(wc[v * KK + tap]) : 0.f;
          dw[f][v] = 0.f;
        }
      }
      cur = q;
    }
    const int s = i % g.stages;
    bar_wait(&full[s], (i / g.stages) & 1);
    const unsigned char* st = ring + static_cast<long long>(s) * g.stage;
    const S* halo = reinterpret_cast<const S*>(st) + lane;
    const S* xin = reinterpret_cast<const S*>(st + g.center) + lane;
    for (; img < g.nb; img += step_img, rg += step_rg, run += step_q) {
      const int r0 = rg * ROWS, w0 = run * RUN;
      const S* hp = halo + ((img * rows_in + r0) * (wp + K - 1) + w0) * 32;
      float xc[RUN][V];
      if (BWD) {
        const S* xp = xin + ((img * g.th + r0) * wp + w0) * 32;
#pragma unroll
        for (int o = 0; o < RUN; ++o) VT::load(xp[o * 32], xc[o]);
      }
      float acc[ROWS][RUN][V];
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr)
#pragma unroll
        for (int o = 0; o < RUN; ++o)
#pragma unroll
          for (int v = 0; v < V; ++v) acc[rr][o][v] = 0.f;
      // input row kr feeds output row rr through kernel row kr − rr
#pragma unroll
      for (int kr = 0; kr < K + ROWS - 1; ++kr) {
        const S* row = hp + kr * (wp + K - 1) * 32;
#pragma unroll
        for (int t = 0; t < SPAN; ++t) {
          float x[V];
          VT::load(row[t * 32], x);
#pragma unroll
          for (int rr = 0; rr < ROWS; ++rr) {
            const int ki = kr - rr;
            if (ki < 0 || ki >= K) continue;
#pragma unroll
            for (int kj = 0; kj < K; ++kj) {
              const int o = t - kj;  // the output whose window holds x
              if (o < 0 || o >= RUN) continue;
              const int f = ki * K + kj;
#pragma unroll
              for (int v = 0; v < V; ++v) {
                acc[rr][o][v] = fmaf(x[v], wt[f][v], acc[rr][o][v]);
                if (BWD) dw[f][v] = fmaf(xc[o][v], x[v], dw[f][v]);
              }
            }
          }
        }
      }
      const int n = n0 + img;
      if (n < g.N && c < g.C) {
        const int pitch = g.C / V;  // accesses from one pixel to the next
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr) {
          const int h = h0 + r0 + rr;
          if (r0 + rr >= g.th || h >= g.H) continue;
          S* dst = out + ((static_cast<long long>(n) * g.H + h) * g.W + w0)
                             * pitch + c / V;
          if (w0 + RUN <= g.W) {  // a whole run: no column to leave out
#pragma unroll
            for (int o = 0; o < RUN; ++o, dst += pitch)
              VT::store(dst, acc[rr][o]);
          } else {
#pragma unroll
            for (int o = 0; o < RUN; ++o, dst += pitch)
              if (w0 + o < g.W) VT::store(dst, acc[rr][o]);
          }
        }
      }
      if (run + step_q >= g.runs) {  // the step's carries
        run -= g.runs;
        ++rg;
      }
      if (rg + step_rg >= g.groups) {
        rg -= g.groups;
        ++img;
      }
    }
    img -= g.nb;  // the same item of the next tile
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[s]);
  }
  if (BWD && cur >= 0)
    flush<K, V, THREADS>(dw, red, A.scratch, cur, lane, slot);
}

// ---- kernels --------------------------------------------------------------
// The names as a profiler shows them: dmt_dwconv, then the pass.

template <typename T, int K>
__global__ void __launch_bounds__((Warps<VEC<T>>::fwd + 1) * 32, 1)
dmt_dwconv_fwd(const __grid_constant__ CUtensorMap x_map, Args A, Geo g) {
  body<T, K, Warps<VEC<T>>::fwd, FWD_ROWS, false>(&x_map, &x_map, A, g);
}

template <typename T, int K>
__global__ void __launch_bounds__((Warps<VEC<T>>::bwd + 1) * 32, 1)
dmt_dwconv_bwd(const __grid_constant__ CUtensorMap dy_map,
               const __grid_constant__ CUtensorMap x_map, Args A, Geo g) {
  body<T, K, Warps<VEC<T>>::bwd, 1, true>(&dy_map, &x_map, A, g);
}

// dw[c][tap]: the scratch rows of the blocks whose tile range met c's chunk
// (cc channels), added in block order, rounded once to dw's dtype
template <typename T>
__global__ void __launch_bounds__(256)
dmt_dwconv_bwd_finalize(const float* scratch, T* dw, Geo g, int KK, int cc) {
  const int idx = blockIdx.x * 256 + threadIdx.x;
  if (idx >= g.C * KK) return;
  const int c = idx / KK, tap = idx % KK, q = c / cc, cl = c % cc;
  const long long total = static_cast<long long>(g.chunks) * g.tiles;
  const long long a = static_cast<long long>(q) * g.tiles, e = a + g.tiles;
  // blocks b with hi_b > a and lo_b < e (ops/depthwise_conv.py
  // chunk_blocks)
  const long long first = ((a + 1) * g.blocks + total - 1) / total - 1;
  const long long last = (e * g.blocks + total - 1) / total - 1;
  float s = 0.f;
  for (long long b = first; b <= last; ++b)
    s += scratch[((b + q) * cc + cl) * KK + tap];
  from_f32(dw + idx, s);
}

// ---- host -----------------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
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

constexpr int ERR_REFUSED = -1;
// a tensor map the driver refused: ERR_TENSOR_MAP − its CUresult
constexpr int ERR_TENSOR_MAP = -1000;

// a tensor map over channels-last (N, C, H, W) at `base`, boxes of a
// 128-byte chunk × bw × bh × nb; elements outside the tensor read as zero.
// Returns the driver's result (-1 without the driver's function). A thread
// that has not yet made the device's context current (autograd's backward
// thread) gets CUDA_ERROR_INVALID_CONTEXT: the runtime then makes it
// current, and the map is made again.
int encode(CUtensorMap* map, int dtype, const void* base, const Geo& g,
           int bw, int bh) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return -1;
  const cuuint64_t e = dtype == DT_F32 ? 4 : 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(g.C),
                              static_cast<cuuint64_t>(g.W),
                              static_cast<cuuint64_t>(g.H),
                              static_cast<cuuint64_t>(g.N)};
  const cuuint64_t strides[3] = {g.C * e, g.C * e * g.W, g.C * e * g.W * g.H};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(128 / e),
                             static_cast<cuuint32_t>(bw),
                             static_cast<cuuint32_t>(bh),
                             static_cast<cuuint32_t>(g.nb)};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  CUresult res = CUDA_SUCCESS;
  for (int attempt = 0; attempt < 2; ++attempt) {
    res = fn(map, dtype == DT_F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             4, const_cast<void*>(base), dims, strides, box, elem_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_ERROR_INVALID_CONTEXT) break;
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaSetDevice(device) != cudaSuccess)
      break;
  }
  return static_cast<int>(res);
}

int round_up(long long b) {
  return static_cast<int>((b + ALIGN - 1) / ALIGN * ALIGN);
}

// the geometry of a call, its stage bytes and its shared memory (the
// barriers, backward the dw buffer, the ring), or false for arguments the
// kernels do not take (ops/depthwise_conv.py Plan.smem mirrors this)
bool geometry(Geo& g, int& smem, int dtype, int N, int H, int W, int C, int K,
              int nb, int th, int stages, int blocks, bool bwd) {
  const int e = dtype == DT_F32 ? 4 : 2, V = 4 / e, cc = 32 * V;
  const int line = cc * e;
  const int rows = bwd ? 1 : FWD_ROWS, groups = (th + rows - 1) / rows;
  const int runs = (W + RUN - 1) / RUN, wp = runs * RUN;
  if ((dtype != DT_F32 && dtype != DT_BF16) || (K != 3 && K != 5) ||
      N <= 0 || H <= 0 || W <= 0 || C <= 0 ||
      nb <= 0 || th <= 0 || C * e % 16 || C % V || nb > MAX_BOX ||
      groups * rows + K - 1 > MAX_BOX || wp + K - 1 > MAX_BOX ||
      stages <= 0 || stages > MAX_STAGES || blocks <= 0)
    return false;
  const int chunks = (C + cc - 1) / cc;
  const long long halo = static_cast<long long>(nb) * (groups * rows + K - 1)
                         * (wp + K - 1) * line;
  const long long plain = bwd ? static_cast<long long>(nb) * th * wp * line
                              : 0;
  const long long tiles = static_cast<long long>((N + nb - 1) / nb)
                          * ((H + th - 1) / th);
  const long long total = tiles * chunks;
  if (total > 0x7fffffffLL || blocks > total) return false;
  const long long stage = round_up(halo) + round_up(plain);
  const long long bytes = BAR_BYTES + (bwd ? round_up(4LL * cc * K * K) : 0)
                          + stage * stages;
  if (bytes > SMEM_BYTES) return false;
  g = Geo{N, H, W, C, nb, th, runs, groups, chunks, static_cast<int>(tiles),
          stages, blocks, static_cast<int>(stage), round_up(halo),
          static_cast<uint32_t>(halo + plain)};
  smem = static_cast<int>(bytes);
  return true;
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int K>
int launch_fwd(const CUtensorMap& xm, const Args& A, const Geo& g, int smem,
               cudaStream_t s) {
  dmt_dwconv_fwd<T, K><<<g.blocks, (Warps<VEC<T>>::fwd + 1) * 32, smem, s>>>(
      xm, A, g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
int launch_bwd(const CUtensorMap& dym, const CUtensorMap& xm, const Args& A,
               const Geo& g, int smem, void* dw, cudaStream_t s) {
  dmt_dwconv_bwd<T, K><<<g.blocks, (Warps<VEC<T>>::bwd + 1) * 32, smem, s>>>(
      dym, xm, A, g);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int n = g.C * K * K;
  dmt_dwconv_bwd_finalize<T><<<(n + 255) / 256, 256, 0, s>>>(
      A.scratch, static_cast<T*>(dw), g, K * K, 32 * VEC<T>);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
int attributes() {
  const void* kernels[] = {
      reinterpret_cast<const void*>(dmt_dwconv_fwd<T, K>),
      reinterpret_cast<const void*>(dmt_dwconv_bwd<T, K>)};
  for (const void* k : kernels) {
    const cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// Plain C entry points, bound with ctypes (ops/depthwise_conv.py). Tensors
// are channels-last (N, C, H, W), 16-byte aligned; w is (C, 1, K, K)
// contiguous in the activations' dtype (code 0 float32, 1 bfloat16). Each
// returns cudaGetLastError() after its launches, -1 for arguments the
// kernels do not take, −1000 − the driver's CUresult where it refused a
// tensor map.

// Lets the kernels take SMEM_BYTES of dynamic shared memory on the current
// device; once a device, before its first call and outside any capture.
extern "C" int dmt_dwconv_init() {
  int err = attributes<float, 3>();
  if (!err) err = attributes<float, 5>();
  if (!err) err = attributes<__nv_bfloat16, 3>();
  if (!err) err = attributes<__nv_bfloat16, 5>();
  return err;
}

extern "C" int dmt_dwconv_forward(const void* x, const void* w, void* y,
                                  int dtype, int N, int H, int W, int C, int K,
                                  int nb, int th, int stages, int blocks,
                                  void* stream) {
  Geo g;
  int smem;
  if (!geometry(g, smem, dtype, N, H, W, C, K, nb, th, stages, blocks,
                false) || !aligned(x) || !aligned(y))
    return ERR_REFUSED;
  CUtensorMap xm;
  const int res = encode(&xm, dtype, x, g, g.runs * RUN + K - 1,
                         g.groups * FWD_ROWS + K - 1);
  if (res) return ERR_TENSOR_MAP - res;
  const Args A{w, y, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return K == 3 ? launch_fwd<float, 3>(xm, A, g, smem, s)
                  : launch_fwd<float, 5>(xm, A, g, smem, s);
  return K == 3 ? launch_fwd<__nv_bfloat16, 3>(xm, A, g, smem, s)
                : launch_fwd<__nv_bfloat16, 5>(xm, A, g, smem, s);
}

// dx and dw from x, dy and w in two launches: the fused pass writes dx and
// the blocks' dw rows into `scratch` ((blocks + chunks − 1) rows of a
// chunk's channels × K² floats), the finalize adds them into dw (C, 1, K, K)
// in the activations' dtype.
extern "C" int dmt_dwconv_backward(const void* x, const void* dy,
                                   const void* w, void* dx, float* scratch,
                                   void* dw, int dtype, int N, int H, int W,
                                   int C, int K, int nb, int th, int stages,
                                   int blocks, void* stream) {
  Geo g;
  int smem;
  if (!geometry(g, smem, dtype, N, H, W, C, K, nb, th, stages, blocks,
                true) || !aligned(x) || !aligned(dy) || !aligned(dx))
    return ERR_REFUSED;
  CUtensorMap dym, xm;
  int res = encode(&dym, dtype, dy, g, g.runs * RUN + K - 1, th + K - 1);
  if (!res) res = encode(&xm, dtype, x, g, g.runs * RUN, th);
  if (res) return ERR_TENSOR_MAP - res;
  const Args A{w, dx, scratch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return K == 3 ? launch_bwd<float, 3>(dym, xm, A, g, smem, dw, s)
                  : launch_bwd<float, 5>(dym, xm, A, g, smem, dw, s);
  return K == 3 ? launch_bwd<__nv_bfloat16, 3>(dym, xm, A, g, smem, dw, s)
                : launch_bwd<__nv_bfloat16, 5>(dym, xm, A, g, smem, dw, s);
}
