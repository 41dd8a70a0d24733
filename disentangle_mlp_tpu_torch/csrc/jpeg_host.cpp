// Host JPEG decoder of the port: libjpeg, RGB uint8 at native size.
//
// The port's own copy of the JAX package's libjpeg decode
// (native/preprocess.cpp:202-289), without its resize: the resize lives in
// one place, data/native.py, and serves both decoders. This is the decode's
// plain version. The CPU path (the tests, --device cpu) runs it, and for a
// valid file it gives the JAX package's native decode byte for byte (same
// library, same settings: JCS_RGB output, libjpeg's default IDCT and fancy
// upsampling).
//
// It decodes files already read into memory (the data feed reads the bytes
// ahead on a host thread), in two phases, as the card's decoder does:
//   dmt_jpeg_host_info: each file's height, width and components, from its
//       header;
//   dmt_jpeg_host_decode: each file into the caller's h*w*3 buffer, one
//       C++ thread per in-flight file.
// Each file gets a status: 0 ok, 1 not decodable (libjpeg's error), 2
// corrupt or truncated (libjpeg decoded it with a warning, filling what was
// missing: refused rather than passed on), 3 the header's size differs
// from the one the caller allocated for.
//
// Colour: greyscale decodes to R = G = B (libjpeg's JCS_RGB conversion,
// what PIL's convert("RGB") gives). CMYK and YCCK decode to CMYK, are read
// inverted as PIL reads them ("CMYK;I", Adobe's convention), and are
// converted as PIL's cmyk2rgb does: v = CLIP8(nk − nk·c/255), nk = 255 − k,
// with PIL's rounded MULDIV255.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread ... -ljpeg
// (ops/_build.py).

#include <algorithm>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1);
}

// warnings (msg_level -1) are counted, as libjpeg's default does, and not
// printed; trace messages (>= 0) are dropped
void jpeg_quiet(j_common_ptr cinfo, int msg_level) {
  if (msg_level < 0) cinfo->err->num_warnings++;
}

inline uint8_t muldiv255(int a, int b) {  // PIL's MULDIV255
  const int tmp = a * b + 128;
  return static_cast<uint8_t>(((tmp >> 8) + tmp) >> 8);
}

inline uint8_t clip8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// Header only: height, width, components. Returns a status as above.
int read_info(const uint8_t* data, uint64_t len, int32_t* h, int32_t* w,
              int32_t* c) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  jerr.mgr.emit_message = jpeg_quiet;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  *h = static_cast<int32_t>(cinfo.image_height);
  *w = static_cast<int32_t>(cinfo.image_width);
  *c = cinfo.num_components;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Full decode into out (h*w*3 RGB). Returns a status as above.
int decode(const uint8_t* data, uint64_t len, int32_t want_h, int32_t want_w,
           uint8_t* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  jerr.mgr.emit_message = jpeg_quiet;
  std::vector<uint8_t> row4;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  const bool cmyk = cinfo.jpeg_color_space == JCS_CMYK ||
                    cinfo.jpeg_color_space == JCS_YCCK;
  cinfo.out_color_space = cmyk ? JCS_CMYK : JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int h = static_cast<int>(cinfo.output_height);
  const int w = static_cast<int>(cinfo.output_width);
  if (h != want_h || w != want_w) {
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  if (cmyk) row4.resize(static_cast<size_t>(w) * 4);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* dst = out + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    JSAMPROW row = cmyk ? row4.data() : dst;
    jpeg_read_scanlines(&cinfo, &row, 1);
    if (cmyk) {
      for (int x = 0; x < w; ++x) {
        const uint8_t* p = row4.data() + 4 * x;
        const int nk = p[3];  // inverted k: 255 - (255 - raw) = raw
        for (int ch = 0; ch < 3; ++ch) {
          const int c = 255 - p[ch];
          dst[3 * x + ch] = clip8(nk - muldiv255(c, nk));
        }
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  const long warnings = jerr.mgr.num_warnings;
  jpeg_destroy_decompress(&cinfo);
  return warnings ? 2 : 0;
}

// The components' planes as libjpeg's IDCT leaves them, before upsampling
// and colour conversion (raw_data_out): dims gets each component's height
// and width; with outs null only dims are filled. Returns a status as
// above.
int decode_planes(const uint8_t* data, uint64_t len, int32_t* ncomp,
                  int32_t* dims, uint8_t* const* outs) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  jerr.mgr.emit_message = jpeg_quiet;
  std::vector<std::vector<uint8_t>> planes;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(data),
               static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.raw_data_out = TRUE;
  jpeg_start_decompress(&cinfo);
  const int nc = cinfo.num_components;
  *ncomp = nc;
  if (nc > 3) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  std::vector<int> pitch(nc), rows(nc);
  for (int ci = 0; ci < nc; ++ci) {
    const jpeg_component_info& comp = cinfo.comp_info[ci];
    dims[2 * ci] = static_cast<int32_t>(comp.downsampled_height);
    dims[2 * ci + 1] = static_cast<int32_t>(comp.downsampled_width);
    pitch[ci] = static_cast<int>(comp.width_in_blocks) * DCTSIZE;
    rows[ci] = comp.v_samp_factor * DCTSIZE;
    planes.emplace_back(static_cast<size_t>(pitch[ci]) * rows[ci] *
                        cinfo.total_iMCU_rows);
  }
  if (outs == nullptr) {
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  std::vector<std::vector<JSAMPROW>> ptrs(nc);
  std::vector<JSAMPARRAY> arrays(nc);
  for (JDIMENSION imcu = 0; cinfo.output_scanline < cinfo.output_height;
       ++imcu) {
    for (int ci = 0; ci < nc; ++ci) {
      ptrs[ci].resize(rows[ci]);
      for (int r = 0; r < rows[ci]; ++r) {
        ptrs[ci][r] = planes[ci].data() +
            (static_cast<size_t>(imcu) * rows[ci] + r) * pitch[ci];
      }
      arrays[ci] = ptrs[ci].data();
    }
    jpeg_read_raw_data(&cinfo, arrays.data(),
                       cinfo.max_v_samp_factor * DCTSIZE);
  }
  jpeg_finish_decompress(&cinfo);
  const long warnings = jerr.mgr.num_warnings;
  jpeg_destroy_decompress(&cinfo);
  for (int ci = 0; ci < nc; ++ci) {
    for (int r = 0; r < dims[2 * ci]; ++r) {
      std::copy(planes[ci].begin() + static_cast<size_t>(r) * pitch[ci],
                planes[ci].begin() + static_cast<size_t>(r) * pitch[ci] +
                    dims[2 * ci + 1],
                outs[ci] + static_cast<size_t>(r) * dims[2 * ci + 1]);
    }
  }
  return warnings ? 2 : 0;
}

template <typename Fn>
void parallel_for(int n, int num_threads, Fn fn) {
  num_threads = num_threads < 1 ? 1 : (num_threads > n ? n : num_threads);
  if (num_threads <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) {
    threads.emplace_back([=]() {
      for (int i = t; i < n; i += num_threads) fn(i);
    });
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// datas/lens: n files in memory; h, w, c, status: n int32 each.
void dmt_jpeg_host_info(const uint8_t* const* datas, const uint64_t* lens,
                        int32_t n, int32_t* h, int32_t* w, int32_t* c,
                        int32_t* status) {
  for (int i = 0; i < n; ++i) {
    status[i] = read_info(datas[i], lens[i], &h[i], &w[i], &c[i]);
  }
}

// outs: n buffers of h[i]*w[i]*3 bytes; status: n int32.
void dmt_jpeg_host_decode(const uint8_t* const* datas, const uint64_t* lens,
                          int32_t n, const int32_t* h, const int32_t* w,
                          uint8_t* const* outs, int32_t* status,
                          int32_t num_threads) {
  parallel_for(n, num_threads, [=](int i) {
    status[i] = decode(datas[i], lens[i], h[i], w[i], outs[i]);
  });
}

// One file's component planes before upsampling and colour conversion
// (what the card's decoder hands data/native.py::ycc_to_rgb): call with
// outs null for ncomp and dims (height, width per component), then with
// ncomp buffers of those sizes. Returns a status as above.
int32_t dmt_jpeg_host_planes(const uint8_t* data, uint64_t len,
                             int32_t* ncomp, int32_t* dims,
                             uint8_t* const* outs) {
  return decode_planes(data, len, ncomp, dims, outs);
}

}  // extern "C"
