// The data plane with libjpeg as its decoder (and encoder), on the host.
// C ABI for ctypes; the pixel work is pixels.h.
//
// Build: g++ -O3 -shared -fPIC -fopenmp -std=c++17 dataplane_libjpeg.cpp
//        -ljpeg (virtex_tpu_torch/native/__init__.py does it at first use).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <csetjmp>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "pixels.h"

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG buffer to RGB8 (grayscale gets three channels).
bool decode_rgb(const uint8_t* buf, size_t len, std::vector<uint8_t>* out,
                int* h, int* w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  out->resize(size_t(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() + size_t(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

}  // namespace

extern "C" {

const char* vdp_decoder_name() { return "libjpeg"; }

// libjpeg's failures are undecodable buffers, which the return codes say.
const char* vdp_last_error() { return ""; }

// (height, width) from the header. Returns 0 on success.
int vdp_jpeg_dims(const uint8_t* buf, size_t len, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  jpeg_read_header(&cinfo, TRUE);
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode into out (capacity cap bytes, RGB8 HWC). Returns 0, 1 for an
// undecodable buffer, 3 when cap is too small.
int vdp_decode(const uint8_t* buf, size_t len, uint8_t* out, size_t cap,
               int* h, int* w) {
  std::vector<uint8_t> rgb;
  if (!decode_rgb(buf, len, &rgb, h, w)) return 1;
  if (rgb.size() > cap) return 3;
  std::memcpy(out, rgb.data(), rgb.size());
  return 0;
}

int vdp_batch_transform(const uint8_t** bufs, const size_t* lens,
                        const int* rects, const int* flips,
                        const float* jitters, int n, int out_size,
                        const float* mean, const float* std, int out_u8,
                        void* out, int threads) {
  return vdp::batch_transform(decode_rgb, bufs, lens, rects, flips, jitters,
                              n, out_size, mean, std, out_u8, out, threads);
}

// Encode an RGB8 HWC image at `quality` (4:2:0, libjpeg's defaults) into
// out (capacity cap). Returns 0, 1 on a libjpeg error, 3 when cap is too
// small; *len is the encoded size.
int vdp_encode_jpeg(const uint8_t* rgb, int h, int w, int quality,
                    uint8_t* out, size_t cap, size_t* len) {
  jpeg_compress_struct cinfo;
  ErrorMgr jerr;
  unsigned char* mem = nullptr;
  unsigned long mem_len = 0;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_compress(&cinfo);
    free(mem);
    return 1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &mem, &mem_len);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(rgb) + size_t(cinfo.next_scanline) * w * 3;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  *len = mem_len;
  int rc = 0;
  if (mem_len > cap) {
    rc = 3;
  } else {
    std::memcpy(out, mem, mem_len);
  }
  free(mem);
  return rc;
}

}  // extern "C"
