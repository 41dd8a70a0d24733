// JPEG decode on the card with nvJPEG, at native size: the components'
// planes, or RGB.
//
// The card's counterpart of csrc/jpeg_host.cpp (libjpeg on the host, the
// decode's plain version) for the data feed of data/pipeline.py. The JAX
// package decodes on the host (PIL, or libjpeg in native/preprocess.cpp);
// it has no TPU kernel for this. Decoding on the card sends only the
// compressed bytes over PCIe, keeps the host free, and lets the resized
// uint8 cache live in device memory. The resize is data/native.py's, on
// the decoded images, on the same stream.
//
// C interface (ctypes, data/native.py), two phases over files already read
// into host memory:
//   dmt_nvjpeg_open(backend): the handle, two decode states (batched and
//       single-image), a stream parser and an event, created once and kept
//       for the process;
//   dmt_nvjpeg_info: each file's components, chroma subsampling and the
//       height and width of each component's plane, from its header
//       (nvjpegGetImageInfo); the caller then allocates one torch uint8
//       device buffer for the batch;
//   dmt_nvjpeg_decode: every file into its slice of that buffer, in one
//       output format for the call, on the caller's stream (torch's current
//       stream). NVJPEG_OUTPUT_YUV leaves each component's plane as the IDCT
//       gives it (the caller upsamples and converts them with libjpeg's own
//       arithmetic, data/native.py::ycc_to_rgb); NVJPEG_OUTPUT_RGBI is
//       nvJPEG's own conversion, interleaved. Files that
//       nvjpegDecodeBatchedSupported accepts go through one
//       nvjpegDecodeBatched call; the others through nvjpegDecode, one at a
//       time, still on the card, and are counted.
// The bitstreams are copied into a pinned staging buffer kept across calls
// (grown as needed), so the caller's bytes may go as soon as a call
// returns; an event recorded after the decode guards the buffer's reuse.
// One mutex serialises the calls: the states are not shared-safe.
//
// Every function returns 0, an nvjpegStatus_t (1-10), or 1000 + a
// cudaError_t. A failed decode sets *failed to the file's index (a failed
// batched call is located by decoding its files one at a time on the
// card); the caller raises and names the file. Nothing is skipped.
//
// Bound: decode is the library's; this file adds a host memcpy of the
// compressed bytes (about 10 KB an image at CelebA's size).
//
// Build: nvcc ... -lnvjpeg (ops/_build.py).

#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

#include <cuda_runtime.h>
#include <nvjpeg.h>

namespace {

constexpr int kCudaBase = 1000;

struct Decoder {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t batched = nullptr;
  nvjpegJpegState_t single = nullptr;
  nvjpegJpegStream_t parser = nullptr;
  cudaEvent_t done = nullptr;
  bool pending = false;  // an event was recorded after the last decode
  int batch_size = -1;   // what `batched` is initialised for ...
  int batch_fmt = -1;    // ... and in which output format
  unsigned char* staging = nullptr;
  size_t staging_cap = 0;
};

Decoder g;
std::mutex g_mu;

int cuda_code(cudaError_t e) { return e == cudaSuccess ? 0 : kCudaBase + e; }

#define TRY(expr)                 \
  do {                            \
    const int rc_ = (expr);       \
    if (rc_ != 0) return rc_;     \
  } while (0)

// image i's planes: outs[3i..3i+2] with pitches[3i..3i+2] (unused null)
nvjpegImage_t dest(uint8_t* const* outs, const int32_t* pitches, int i) {
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  for (int p = 0; p < 3; ++p) {
    img.channel[p] = outs[3 * i + p];
    img.pitch[p] = static_cast<size_t>(pitches[3 * i + p]);
  }
  return img;
}

int decode_one(const unsigned char* data, size_t len, nvjpegOutputFormat_t fmt,
               nvjpegImage_t img, cudaStream_t stream) {
  return nvjpegDecode(g.handle, g.single, data, len, fmt, &img, stream);
}

}  // namespace

extern "C" {

int dmt_nvjpeg_open(int32_t backend) {
  std::lock_guard<std::mutex> lock(g_mu);
  if (g.handle != nullptr) return 0;
  TRY(nvjpegCreateEx(static_cast<nvjpegBackend_t>(backend), nullptr,
                     nullptr, 0, &g.handle));
  TRY(nvjpegJpegStateCreate(g.handle, &g.batched));
  TRY(nvjpegJpegStateCreate(g.handle, &g.single));
  TRY(nvjpegJpegStreamCreate(g.handle, &g.parser));
  TRY(cuda_code(cudaEventCreateWithFlags(&g.done, cudaEventDisableTiming)));
  return 0;
}

int dmt_nvjpeg_version(int32_t* major, int32_t* minor, int32_t* patch) {
  int v[3];
  TRY(nvjpegGetProperty(MAJOR_VERSION, &v[0]));
  TRY(nvjpegGetProperty(MINOR_VERSION, &v[1]));
  TRY(nvjpegGetProperty(PATCH_LEVEL, &v[2]));
  *major = v[0];
  *minor = v[1];
  *patch = v[2];
  return 0;
}

// dims: n*6 int32 (height, width of components 0-2; 0 where absent);
// c, css, status: n int32 each (status: nvjpegStatus_t per file).
int dmt_nvjpeg_info(const uint8_t* const* datas, const uint64_t* lens,
                    int32_t n, int32_t* dims, int32_t* c, int32_t* css,
                    int32_t* status) {
  if (g.handle == nullptr) return NVJPEG_STATUS_NOT_INITIALIZED;
  for (int i = 0; i < n; ++i) {
    int comps = 0;
    nvjpegChromaSubsampling_t sub = NVJPEG_CSS_UNKNOWN;
    int widths[NVJPEG_MAX_COMPONENT] = {0};
    int heights[NVJPEG_MAX_COMPONENT] = {0};
    status[i] = nvjpegGetImageInfo(g.handle, datas[i], lens[i], &comps, &sub,
                                   widths, heights);
    for (int p = 0; p < 3; ++p) {
      dims[6 * i + 2 * p] = heights[p];
      dims[6 * i + 2 * p + 1] = widths[p];
    }
    c[i] = comps;
    css[i] = sub;
  }
  return 0;
}

// fmt: an nvjpegOutputFormat_t for every file of the call; outs and
// pitches: 3 device pointers and 3 pitches a file (the planes of
// NVJPEG_OUTPUT_YUV, or one interleaved plane and two nulls); stream: a
// cudaStream_t (0 = the legacy default stream). On return *single_count is
// the number of files decoded one at a time, *failed the index of the file
// that failed (-1 if none).
int dmt_nvjpeg_decode(const uint8_t* const* datas, const uint64_t* lens,
                      int32_t n, int32_t fmt_code, uint8_t* const* outs,
                      const int32_t* pitches, void* stream_ptr,
                      int32_t* single_count, int32_t* failed) {
  std::lock_guard<std::mutex> lock(g_mu);
  *single_count = 0;
  *failed = -1;
  if (g.handle == nullptr) return NVJPEG_STATUS_NOT_INITIALIZED;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const nvjpegOutputFormat_t fmt = static_cast<nvjpegOutputFormat_t>(fmt_code);

  // the staging buffer of the previous call may still be in flight
  if (g.pending) {
    TRY(cuda_code(cudaEventSynchronize(g.done)));
    g.pending = false;
  }
  size_t total = 0;
  for (int i = 0; i < n; ++i) total += lens[i];
  if (total > g.staging_cap) {
    if (g.staging != nullptr) TRY(cuda_code(cudaFreeHost(g.staging)));
    g.staging = nullptr;
    g.staging_cap = 0;
    const size_t cap = total + total / 2 + (1 << 20);
    TRY(cuda_code(cudaHostAlloc(reinterpret_cast<void**>(&g.staging), cap,
                                cudaHostAllocDefault)));
    g.staging_cap = cap;
  }
  std::vector<const unsigned char*> data(n);
  size_t off = 0;
  for (int i = 0; i < n; ++i) {
    std::memcpy(g.staging + off, datas[i], lens[i]);
    data[i] = g.staging + off;
    off += lens[i];
  }

  // split: what the batched decoder takes, and the rest
  std::vector<int> batch, rest;
  for (int i = 0; i < n; ++i) {
    int rc = nvjpegJpegStreamParse(g.handle, data[i], lens[i], 0, 0,
                                   g.parser);
    if (rc != 0) {
      *failed = i;
      return rc;
    }
    int unsupported = 1;
    rc = nvjpegDecodeBatchedSupported(g.handle, g.parser, &unsupported);
    if (rc != 0) {
      *failed = i;
      return rc;
    }
    (unsupported == 0 ? batch : rest).push_back(i);
  }

  int rc = 0;
  int32_t singles = 0;
  if (!batch.empty()) {
    const int m = static_cast<int>(batch.size());
    std::vector<const unsigned char*> bdata(m);
    std::vector<size_t> blens(m);
    std::vector<nvjpegImage_t> bdest(m);
    for (int j = 0; j < m; ++j) {
      const int i = batch[j];
      bdata[j] = data[i];
      blens[j] = lens[i];
      bdest[j] = dest(outs, pitches, i);
    }
    if (g.batch_size != m || g.batch_fmt != fmt_code) {
      rc = nvjpegDecodeBatchedInitialize(g.handle, g.batched, m, 1, fmt);
      if (rc != 0) return rc;
      g.batch_size = m;
      g.batch_fmt = fmt_code;
    }
    rc = nvjpegDecodeBatched(g.handle, g.batched, bdata.data(), blens.data(),
                             bdest.data(), stream);
    if (rc != 0) {
      g.batch_size = -1;  // re-initialise a failed batch state
      // locate the file: decode each on its own, on the card; if none
      // fails alone, every output is written and the call succeeds
      for (int j = 0; j < m; ++j) {
        rc = decode_one(bdata[j], blens[j], fmt, bdest[j], stream);
        if (rc != 0) {
          *failed = batch[j];
          return rc;
        }
      }
      singles += m;
    }
  }
  for (int i : rest) {
    rc = decode_one(data[i], lens[i], fmt, dest(outs, pitches, i), stream);
    if (rc != 0) {
      *failed = i;
      return rc;
    }
  }
  *single_count = singles + static_cast<int32_t>(rest.size());
  TRY(cuda_code(cudaEventRecord(g.done, stream)));
  g.pending = true;
  return cuda_code(cudaGetLastError());
}

}  // extern "C"
