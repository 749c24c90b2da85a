// The data plane with nvJPEG (the CUDA toolkit's JPEG codec) as its decoder
// and encoder. Each image is decoded on the card into interleaved RGB8,
// copied back to a pinned host buffer, and goes through the same pixel work
// as the libjpeg build (pixels.h). C ABI for ctypes.
//
// Build: g++ -O3 -shared -fPIC -fopenmp -std=c++17 dataplane_nvjpeg.cpp
//        -I$CUDA_HOME/include -L$CUDA_HOME/lib64 -lnvjpeg -lcudart
//        (virtex_tpu_torch/native/__init__.py does it at first use).
//
// One nvJPEG handle serves the process; each host thread owns its decoder
// state, a non-blocking stream (so decoding neither waits for nor holds up
// work on the legacy default stream) and its device and pinned buffers,
// which grow and are never freed.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

#include "pixels.h"

namespace {

std::mutex g_error_mu;
std::string g_error;

void record(const char* what, int code) {
  std::lock_guard<std::mutex> lock(g_error_mu);
  if (g_error.empty()) {
    char msg[160];
    std::snprintf(msg, sizeof(msg), "%s failed (status %d)", what, code);
    g_error = msg;
  }
}

nvjpegHandle_t handle() {
  static nvjpegHandle_t h = [] {
    nvjpegHandle_t out = nullptr;
    nvjpegStatus_t s = nvjpegCreateSimple(&out);
    if (s != NVJPEG_STATUS_SUCCESS) {
      record("nvjpegCreateSimple", s);
      out = nullptr;
    }
    return out;
  }();
  return h;
}

struct ThreadState {
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  uint8_t* dev = nullptr;
  uint8_t* host = nullptr;
  size_t cap = 0;
  bool ready = false;
  nvjpegEncoderState_t enc = nullptr;  // the encoder's, made at first use
  nvjpegEncoderParams_t params = nullptr;
  int quality = -1;
};

thread_local ThreadState t_state;

ThreadState* thread_state(nvjpegHandle_t h) {
  ThreadState& t = t_state;
  if (!t.ready) {
    nvjpegStatus_t s = nvjpegJpegStateCreate(h, &t.state);
    if (s != NVJPEG_STATUS_SUCCESS) {
      record("nvjpegJpegStateCreate", s);
      return nullptr;
    }
    cudaError_t e = cudaStreamCreateWithFlags(&t.stream,
                                              cudaStreamNonBlocking);
    if (e != cudaSuccess) {
      record("cudaStreamCreateWithFlags", e);
      return nullptr;
    }
    t.ready = true;
  }
  return &t;
}

bool reserve(ThreadState* t, size_t bytes) {
  if (bytes <= t->cap) return true;
  if (t->dev) cudaFree(t->dev);
  if (t->host) cudaFreeHost(t->host);
  t->dev = nullptr;
  t->host = nullptr;
  t->cap = 0;
  cudaError_t e = cudaMalloc(&t->dev, bytes);
  if (e != cudaSuccess) {
    record("cudaMalloc", e);
    return false;
  }
  e = cudaMallocHost(&t->host, bytes);
  if (e != cudaSuccess) {
    record("cudaMallocHost", e);
    return false;
  }
  t->cap = bytes;
  return true;
}

bool image_info(nvjpegHandle_t h, const uint8_t* buf, size_t len, int* height,
                int* width, bool* gray = nullptr) {
  int n_comp = 0;
  nvjpegChromaSubsampling_t css;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  nvjpegStatus_t s =
      nvjpegGetImageInfo(h, buf, len, &n_comp, &css, widths, heights);
  if (s != NVJPEG_STATUS_SUCCESS) return false;
  *width = widths[0];
  *height = heights[0];
  if (gray != nullptr) *gray = n_comp == 1;
  return true;
}

// Decode a JPEG buffer to RGB8 HWC on the host. A one-component (grayscale)
// JPEG is decoded as its Y plane and copied to all three channels, as
// libjpeg's JCS_RGB output gives it.
bool decode_rgb(const uint8_t* buf, size_t len, std::vector<uint8_t>* out,
                int* height, int* width) {
  nvjpegHandle_t h = handle();
  if (h == nullptr) return false;
  ThreadState* t = thread_state(h);
  bool gray = false;
  if (t == nullptr || !image_info(h, buf, len, height, width, &gray)) {
    return false;
  }
  const size_t pixels = size_t(*width) * *height;
  const size_t bytes = pixels * (gray ? 1 : 3);
  if (!reserve(t, bytes)) return false;
  nvjpegImage_t dst;
  std::memset(&dst, 0, sizeof(dst));
  dst.channel[0] = t->dev;
  dst.pitch[0] = size_t(*width) * (gray ? 1 : 3);
  nvjpegStatus_t s =
      nvjpegDecode(h, t->state, buf, len,
                   gray ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_RGBI, &dst,
                   t->stream);
  if (s != NVJPEG_STATUS_SUCCESS) {
    record("nvjpegDecode", s);
    return false;
  }
  cudaError_t e = cudaMemcpyAsync(t->host, t->dev, bytes,
                                  cudaMemcpyDeviceToHost, t->stream);
  if (e == cudaSuccess) e = cudaStreamSynchronize(t->stream);
  if (e != cudaSuccess) {
    record("cudaMemcpyAsync", e);
    return false;
  }
  if (!gray) {
    out->assign(t->host, t->host + bytes);
    return true;
  }
  out->resize(pixels * 3);
  uint8_t* rgb = out->data();
  for (size_t i = 0; i < pixels; ++i) {
    rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = t->host[i];
  }
  return true;
}

}  // namespace

extern "C" {

const char* vdp_decoder_name() { return "nvjpeg"; }

// The first failure's description since the library was loaded ("" if
// none).
const char* vdp_last_error() {
  std::lock_guard<std::mutex> lock(g_error_mu);
  return g_error.c_str();
}

int vdp_jpeg_dims(const uint8_t* buf, size_t len, int* h, int* w) {
  nvjpegHandle_t hd = handle();
  if (hd == nullptr) return 4;
  return image_info(hd, buf, len, h, w) ? 0 : 1;
}

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

// Encode an RGB8 HWC host image at `quality` with 4:2:0 chroma into out
// (capacity cap). Returns 0, 1 on an nvJPEG or CUDA error, 3 when cap is
// too small; *len is the encoded size.
int vdp_encode_jpeg(const uint8_t* rgb, int h, int w, int quality,
                    uint8_t* out, size_t cap, size_t* len) {
  nvjpegHandle_t hd = handle();
  if (hd == nullptr) return 1;
  ThreadState* t = thread_state(hd);
  const size_t bytes = size_t(w) * h * 3;
  if (t == nullptr || !reserve(t, bytes)) return 1;
  int rc = 1;
  do {
    nvjpegStatus_t s;
    if (t->enc == nullptr) {
      s = nvjpegEncoderStateCreate(hd, &t->enc, t->stream);
      if (s != NVJPEG_STATUS_SUCCESS) { record("nvjpegEncoderStateCreate", s); t->enc = nullptr; break; }
    }
    if (t->params == nullptr) {
      s = nvjpegEncoderParamsCreate(hd, &t->params, t->stream);
      if (s != NVJPEG_STATUS_SUCCESS) { record("nvjpegEncoderParamsCreate", s); t->params = nullptr; break; }
      s = nvjpegEncoderParamsSetSamplingFactors(t->params, NVJPEG_CSS_420,
                                                t->stream);
      if (s != NVJPEG_STATUS_SUCCESS) { record("nvjpegEncoderParamsSetSamplingFactors", s); break; }
      t->quality = -1;
    }
    if (t->quality != quality) {
      s = nvjpegEncoderParamsSetQuality(t->params, quality, t->stream);
      if (s != NVJPEG_STATUS_SUCCESS) { record("nvjpegEncoderParamsSetQuality", s); break; }
      t->quality = quality;
    }
    cudaError_t e = cudaMemcpyAsync(t->dev, rgb, bytes,
                                    cudaMemcpyHostToDevice, t->stream);
    if (e != cudaSuccess) { record("cudaMemcpyAsync", e); break; }
    nvjpegImage_t src;
    std::memset(&src, 0, sizeof(src));
    src.channel[0] = t->dev;
    src.pitch[0] = size_t(w) * 3;
    s = nvjpegEncodeImage(hd, t->enc, t->params, &src, NVJPEG_INPUT_RGBI, w,
                          h, t->stream);
    if (s != NVJPEG_STATUS_SUCCESS) { record("nvjpegEncodeImage", s); break; }
    size_t length = 0;
    s = nvjpegEncodeRetrieveBitstream(hd, t->enc, nullptr, &length,
                                      t->stream);
    if (s != NVJPEG_STATUS_SUCCESS) { record("nvjpegEncodeRetrieveBitstream", s); break; }
    e = cudaStreamSynchronize(t->stream);
    if (e != cudaSuccess) { record("cudaStreamSynchronize", e); break; }
    *len = length;
    if (length > cap) { rc = 3; break; }
    s = nvjpegEncodeRetrieveBitstream(hd, t->enc, out, &length, t->stream);
    if (s != NVJPEG_STATUS_SUCCESS) { record("nvjpegEncodeRetrieveBitstream", s); break; }
    e = cudaStreamSynchronize(t->stream);
    if (e != cudaSuccess) { record("cudaStreamSynchronize", e); break; }
    *len = length;
    rc = 0;
  } while (false);
  return rc;
}

}  // extern "C"
