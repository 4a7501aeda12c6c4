// JPEG decode on the card through nvJPEG, for the data layer
// (empirical_mvm_torch/data/jpeg.py).
//
// It replaces no TPU kernel: the JAX package decodes frames with cv2 on the
// host (empirical_mvm_tpu/data/transforms.py decode_raw_image); the port
// depends on no image library. Each frame's host bitstream is decoded to
// interleaved RGB uint8 (NVJPEG_OUTPUT_RGBI) in a device buffer that the
// caller allocated from the frame's header size, on the caller's stream.
// nvJPEG's default backend parses and Huffman-decodes on the host and runs
// the IDCT and colour conversion on the card; the host part bounds it.
//
// The library is built by nvcc into build/ apart from the kernels' library
// (linked with -lnvjpeg), so the kernels do not depend on nvJPEG. A handle
// is shared by every thread; each calling thread creates its own decoder
// state. Every entry point returns an nvjpegStatus_t (0 on success); a frame
// that fails is reported in its own status and the others are decoded.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>
#include <nvjpeg.h>

extern "C" {

int emvm_jpeg_create(void** handle) {
  nvjpegHandle_t h = nullptr;
  nvjpegStatus_t s = nvjpegCreateSimple(&h);
  *handle = h;
  return static_cast<int>(s);
}

int emvm_jpeg_destroy(void* handle) {
  return static_cast<int>(nvjpegDestroy(static_cast<nvjpegHandle_t>(handle)));
}

int emvm_jpeg_state_create(void* handle, void** state) {
  nvjpegJpegState_t st = nullptr;
  nvjpegStatus_t s = nvjpegJpegStateCreate(static_cast<nvjpegHandle_t>(handle), &st);
  *state = st;
  return static_cast<int>(s);
}

int emvm_jpeg_state_destroy(void* state) {
  return static_cast<int>(nvjpegJpegStateDestroy(static_cast<nvjpegJpegState_t>(state)));
}

// Decode n frames in order, frame i from data[i] (lens[i] bytes) into
// outs[i], a device buffer of heights[i] x widths[i] x 3 bytes (row pitch
// widths[i] * 3). status[i] receives nvJPEG's status of frame i, or -1
// where its header gives another size than the caller planned. Returns the
// CUDA runtime's last error after the launches (0 when there was none).
int emvm_jpeg_decode_batch(void* handle, void* state, int n, const unsigned char* const* data,
                           const size_t* lens, unsigned char* const* outs, const int* heights,
                           const int* widths, int* status, void* stream) {
  auto h = static_cast<nvjpegHandle_t>(handle);
  auto st = static_cast<nvjpegJpegState_t>(state);
  auto s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < n; ++i) {
    int w[NVJPEG_MAX_COMPONENT] = {0};
    int hh[NVJPEG_MAX_COMPONENT] = {0};
    int comps = 0;
    nvjpegChromaSubsampling_t sub;
    nvjpegStatus_t r = nvjpegGetImageInfo(h, data[i], lens[i], &comps, &sub, w, hh);
    if (r != NVJPEG_STATUS_SUCCESS) {
      status[i] = static_cast<int>(r);
      continue;
    }
    if (hh[0] != heights[i] || w[0] != widths[i]) {
      status[i] = -1;
      continue;
    }
    nvjpegImage_t img = {};
    img.channel[0] = outs[i];
    img.pitch[0] = static_cast<size_t>(widths[i]) * 3;
    status[i] = static_cast<int>(nvjpegDecode(h, st, data[i], lens[i], NVJPEG_OUTPUT_RGBI,
                                              &img, s));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
