// KLT block extraction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lcvo_tpu/ops/klt_pallas.py::extract_blocks_pallas
// (_extract_kernel, _load_window). For each center (cx, cy) it copies an
// integer-aligned S x S block of the image, edge-replicated by `pad` pixels on every
// side, and writes the block's top-left corner in unpadded coordinates:
//
//     ox = clamp(floor(cx + pad) - (S-1)/2, 0, W + 2 pad - S) - pad     (oy alike)
//     block[r][c] = img[clamp(oy + r, 0, H-1)][clamp(ox + c, 0, W-1)]
//
// That is exactly extract(edge_pad(img, pad), centers + pad) with `pad` taken off the
// origins, which is how lcvo_tpu/ops/klt.py::_track_level calls the TPU kernel: there
// the padded copy exists because a VMEM window must lie inside its array. A CUDA
// thread clamps its own read address, so the copy is gone. The pad is added to the
// center in f32 before the floor, as the reference does: floor(cx + pad) is not
// floor(cx) + pad for every cx. The origin clamp is the XLA formulation's (against
// the shape the caller gives, lcvo_tpu/ops/klt.py:102-107), in float before the
// conversion; fmaxf/fminf send a NaN center to the low edge, so no input can address
// outside the image. pad = 0 is the plain unpadded function.
//
// Bound: bytes. N*S*S elements are written and as many read (mostly from L2: the
// blocks of neighbouring tracks overlap and a KITTI level is under 2 MB); there is no
// arithmetic worth counting. At 2048 tracks the whole call is a few microseconds, so
// what decides its time is how many bytes are in flight, not the memory rate:
//
// - Aligned slabs, wide stores. One block of S*S elements is not a multiple of 16
//   bytes for odd S, but 4 consecutive f32 blocks or 8 bf16 blocks are. A thread
//   block takes a slab of G tracks (the caller passes a G with
//   (G*S*S*sizeof) % 16 == 0; ops/klt_extract.py::slab_plan gives 8, 256 thread
//   blocks for 2048 tracks, about two per SM). Each thread gathers 16 bytes of
//   consecutive output elements (they may run over a row end or into the next track)
//   and stores them with one 16-byte store.
// - Loads in flight. The 4 or 8 gathers of a thread are independent, and the loop
//   over a thread's 16-byte pieces is unrolled twice, so 8 to 16 loads are
//   outstanding per thread where the first version had one. S in {21, 29, 33} (what
//   the tracker's window and margins give) are template arguments, so the index
//   arithmetic has no division; any other S takes the same code with S read at run
//   time.
// - The N - n_groups*G tracks that fill no slab go one thread block each through a
//   scalar copy (4-byte-aligned output).
// - No staging in shared memory: gathering the slab there and writing it out with
//   16-byte stores, or with one cp.async.bulk shared-to-global, adds a barrier
//   between the loads and the stores of a block and measured slower on the H100
//   than the direct gather (PERF.md, Findings). No TMA tiled load either: it fills
//   out-of-range elements with zero, not with the edge pixel; it wants row pitches
//   and inner box sizes that are multiples of 16 bytes (a 310-wide level and a
//   29-wide box are not); and the tensor map is encoded through libcuda. The image sits in
//   L2 anyway.
//
// The 8/128 tile alignment and the dynamic roll of the Pallas kernel are Mosaic
// constraints with no counterpart here.
//
// Layered entry. The image may be a stack of L layers (L, H, W) with a layer index per
// center: each center reads its own layer, and its origin is clamped inside that layer
// by the same formula, with a pad per axis (pad_y, pad_x). S images of S streams and
// their centers are one launch this way (the batching rule of ops/klt_extract.py). The
// 2-D call is the case L = 1 with no layer array and pad_y = pad_x = pad; a track's
// layer only moves the base of its reads.
//
// Plain C interface, loaded with ctypes: no PyTorch headers, so nvcc compiles it in
// seconds. Launches on the caller's stream, allocates nothing, returns the launch
// error code. An element is copied as raw bits (uint32_t for f32, uint16_t for bf16).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroup = 32;   // tracks per slab, at most

template <typename E>
struct Job {
  const E* img;           // (L, H, W)
  int L, H, W;
  const float* centers;   // (N, 2) x, y
  const int* layer;       // (N,) layer of each center, or null: every center on layer 0
  int N, S, pad_y, pad_x;
  int G, n_groups;        // tracks per slab; slabs; tracks from n_groups*G on are the tail
  E* blocks;              // (N, S, S)
  float* origins;         // (N, 2)
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// clamped origin of track n in unpadded coordinates of its layer, also written to
// origins, and the offset of that layer in the stack (a layer index outside [0, L) is
// clamped into it, so no input reads outside the stack)
template <typename E>
__device__ __forceinline__ void track_origin(const Job<E>& j, int S, int n, int& ox, int& oy,
                                             int& base) {
  const float half = (float)((S - 1) / 2);
  const float wx = floorf(j.centers[2 * n + 0] + (float)j.pad_x) - half;
  const float wy = floorf(j.centers[2 * n + 1] + (float)j.pad_y) - half;
  ox = (int)fminf(fmaxf(wx, 0.0f), (float)(j.W + 2 * j.pad_x - S)) - j.pad_x;
  oy = (int)fminf(fmaxf(wy, 0.0f), (float)(j.H + 2 * j.pad_y - S)) - j.pad_y;
  base = j.layer == nullptr ? 0 : clampi(j.layer[n], 0, j.L - 1) * j.H * j.W;
  j.origins[2 * n + 0] = (float)ox;
  j.origins[2 * n + 1] = (float)oy;
}

template <typename E>
struct alignas(16) Pack {
  static constexpr int kN = 16 / sizeof(E);
  E e[kN];
};

// S_CT: the block size where it is known at compile time, 0 to read it from the job
template <typename E, int S_CT>
__global__ void __launch_bounds__(kThreads) extract_blocks_kernel(const Job<E> j) {
  const int bid = blockIdx.x;
  const int S = S_CT > 0 ? S_CT : j.S;
  const int SS = S * S;
  const int tid = threadIdx.x;
  const int H1 = j.H - 1, W1 = j.W - 1;
  const E* __restrict__ img = j.img;

  if (bid >= j.n_groups) {
    // tail: one track, scalar copy
    const int n = j.n_groups * j.G + (bid - j.n_groups);
    if (n >= j.N) return;
    int ox, oy, base;
    track_origin(j, S, n, ox, oy, base);  // every thread computes it; all write the same value
    E* __restrict__ dst = j.blocks + (int64_t)n * SS;
    for (int i = tid; i < SS; i += kThreads) {
      const int r = i / S;
      const int c = i - r * S;
      dst[i] = img[base + clampi(oy + r, 0, H1) * j.W + clampi(ox + c, 0, W1)];
    }
    return;
  }

  __shared__ int s_ox[kMaxGroup], s_oy[kMaxGroup], s_base[kMaxGroup];
  const int n0 = bid * j.G;
  if (tid < j.G) {
    int ox, oy, base;
    track_origin(j, S, n0 + tid, ox, oy, base);
    s_ox[tid] = ox;
    s_oy[tid] = oy;
    s_base[tid] = base;
  }
  __syncthreads();

  constexpr int kN = Pack<E>::kN;
  const int nvec = (j.G * SS) / kN;   // 16-byte pieces of the slab
  uint4* __restrict__ out = reinterpret_cast<uint4*>(j.blocks + (int64_t)n0 * SS);

#pragma unroll 2
  for (int i = tid; i < nvec; i += kThreads) {
    // elements i*kN .. i*kN + kN-1 of the slab, from track g, row r, column c on
    const int e = i * kN;
    int g = e / SS;
    const int rem = e - g * SS;
    int r = rem / S;
    int c = rem - r * S;
    Pack<E> p;
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      p.e[k] = img[s_base[g] + clampi(s_oy[g] + r, 0, H1) * j.W + clampi(s_ox[g] + c, 0, W1)];
      if (++c == S) {
        c = 0;
        if (++r == S) { r = 0; ++g; }
      }
    }
    out[i] = *reinterpret_cast<const uint4*>(&p);
  }
}

template <typename E>
int launch(const void* img, int L, int H, int W, const void* centers, const void* layer,
           int N, int S, int pad_y, int pad_x, int G, int n_groups, void* blocks,
           void* origins, void* stream) {
  if (N <= 0) return 0;
  if (G < 1 || G > kMaxGroup || n_groups < 0 || (int64_t)n_groups * G > N ||
      (n_groups > 0 && ((int64_t)G * S * S * sizeof(E)) % 16 != 0) || pad_y < 0 ||
      pad_x < 0 || S < 1 || S > H + 2 * pad_y || S > W + 2 * pad_x || L < 1 ||
      (int64_t)L * H * W >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  const Job<E> j{(const E*)img, L, H, W, (const float*)centers, (const int*)layer, N, S,
                 pad_y, pad_x, G, n_groups, (E*)blocks, (float*)origins};
  const int grid = n_groups + (N - n_groups * G);
  cudaStream_t st = (cudaStream_t)stream;
  switch (S) {
    case 21: extract_blocks_kernel<E, 21><<<grid, kThreads, 0, st>>>(j); break;
    case 29: extract_blocks_kernel<E, 29><<<grid, kThreads, 0, st>>>(j); break;
    case 33: extract_blocks_kernel<E, 33><<<grid, kThreads, 0, st>>>(j); break;
    default: extract_blocks_kernel<E, 0><<<grid, kThreads, 0, st>>>(j); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lcvo_extract_blocks_f32(const void* img, int H, int W, const void* centers, int N,
                            int S, int pad, int G, int n_groups, void* blocks,
                            void* origins, void* stream) {
  return launch<uint32_t>(img, 1, H, W, centers, nullptr, N, S, pad, pad, G, n_groups,
                          blocks, origins, stream);
}

int lcvo_extract_blocks_bf16(const void* img, int H, int W, const void* centers, int N,
                             int S, int pad, int G, int n_groups, void* blocks,
                             void* origins, void* stream) {
  return launch<uint16_t>(img, 1, H, W, centers, nullptr, N, S, pad, pad, G, n_groups,
                          blocks, origins, stream);
}

// img (L, H, W), centers (N, 2), layer (N,) int32
int lcvo_extract_blocks_layered_f32(const void* img, int L, int H, int W,
                                    const void* centers, const void* layer, int N, int S,
                                    int pad_y, int pad_x, int G, int n_groups, void* blocks,
                                    void* origins, void* stream) {
  return launch<uint32_t>(img, L, H, W, centers, layer, N, S, pad_y, pad_x, G, n_groups,
                          blocks, origins, stream);
}

int lcvo_extract_blocks_layered_bf16(const void* img, int L, int H, int W,
                                     const void* centers, const void* layer, int N, int S,
                                     int pad_y, int pad_x, int G, int n_groups,
                                     void* blocks, void* origins, void* stream) {
  return launch<uint16_t>(img, L, H, W, centers, layer, N, S, pad_y, pad_x, G, n_groups,
                          blocks, origins, stream);
}

const char* lcvo_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
