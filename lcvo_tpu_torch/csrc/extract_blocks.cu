// KLT block extraction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lcvo_tpu/ops/klt_pallas.py::extract_blocks_pallas
// (_extract_kernel, _load_window). For each center (cx, cy) it copies the
// integer-aligned S x S block of the image whose top-left corner is
//
//     ox = clamp(floor(cx) - (S-1)/2, 0, W-S),  oy = clamp(floor(cy) - (S-1)/2, 0, H-S)
//
// and writes that origin. The clamp is against the image shape the caller gives
// (the XLA formulation, lcvo_tpu/ops/klt.py:102-107), not against an alignment-padded
// copy as the Pallas kernel does. The clamp runs in float before the conversion, as
// XLA's clip-then-astype does; fmaxf/fminf map a NaN center to origin 0, so no input
// can address outside the image.
//
// Bound: bytes. The kernel reads N*S*S image elements (mostly from L2: blocks of
// neighbouring tracks overlap and a padded KITTI level is ~2 MB), and writes N*S*S
// elements plus N origins; it does no arithmetic worth counting. Design: one thread
// block per track; the threads stride over the S*S window in row-major order, so the
// writes are fully coalesced and each image row segment is read by consecutive
// threads. The 8/128 tile alignment and the dynamic roll of the Pallas kernel are
// Mosaic constraints with no counterpart here.
//
// Plain C interface, loaded with ctypes: no PyTorch headers, so nvcc compiles it in
// seconds. Launches on the caller's stream, allocates nothing, returns the launch
// error code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void extract_blocks_kernel(const T* __restrict__ img, int H, int W,
                                      const float* __restrict__ centers, int S,
                                      T* __restrict__ blocks,
                                      float* __restrict__ origins) {
  const int n = blockIdx.x;
  const int half = (S - 1) / 2;
  const float wx = floorf(centers[2 * n + 0]) - (float)half;
  const float wy = floorf(centers[2 * n + 1]) - (float)half;
  const int ox = (int)fminf(fmaxf(wx, 0.0f), (float)(W - S));
  const int oy = (int)fminf(fmaxf(wy, 0.0f), (float)(H - S));
  const T* src = img + (int64_t)oy * W + ox;
  T* dst = blocks + (int64_t)n * S * S;
  const int SS = S * S;
  for (int i = threadIdx.x; i < SS; i += blockDim.x) {
    const int r = i / S;
    const int c = i - r * S;
    dst[i] = src[(int64_t)r * W + c];
  }
  if (threadIdx.x == 0) {
    origins[2 * n + 0] = (float)ox;
    origins[2 * n + 1] = (float)oy;
  }
}

template <typename T>
int launch(const void* img, int H, int W, const void* centers, int N, int S,
           void* blocks, void* origins, void* stream) {
  if (N <= 0) return 0;
  extract_blocks_kernel<T><<<N, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)img, H, W, (const float*)centers, S, (T*)blocks, (float*)origins);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lcvo_extract_blocks_f32(const void* img, int H, int W, const void* centers,
                            int N, int S, void* blocks, void* origins,
                            void* stream) {
  return launch<float>(img, H, W, centers, N, S, blocks, origins, stream);
}

int lcvo_extract_blocks_bf16(const void* img, int H, int W, const void* centers,
                             int N, int S, void* blocks, void* origins,
                             void* stream) {
  return launch<__nv_bfloat16>(img, H, W, centers, N, S, blocks, origins, stream);
}

const char* lcvo_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
