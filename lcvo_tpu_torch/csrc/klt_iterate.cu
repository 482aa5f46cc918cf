// One pyramid level of the KLT tracker after its block extractions, for every track in
// one launch, on Hopper (sm_90a).
//
// Replaces no TPU kernel: lcvo_tpu/ops/klt.py::_track_level runs the inverse-
// compositional Lucas-Kanade loop as plain XLA, fused by the compiler. The port's plain
// version (lcvo_tpu_torch/ops/klt.py::_iterate_level_plain) is eager PyTorch, and on the
// card it is ~300 launches a level: per iteration two interpolation-matrix builds, two
// batched GEMMs and ~50 element-wise and reduction kernels over (N, w, w) tensors. This
// kernel is the whole function, for every track of the call:
//
//   - the (w+2)^2 template sample from the template block, T and the central-difference
//     gradients gx, gy; the Hessian hxx, hxy, hyy, det, det_ok (det > 1e-6), safe_det;
//   - the displacement range dd_min / dd_max whose window stays inside the target block;
//   - all `iters` iterations: sample, error, bx / by, the 2x2 step, the per-track eps
//     freeze (|step|^2 >= eps^2 or no update) and the clamp into [dd_min, dd_max];
//   - the final sample's mean |error| (`residual`) and `sat` (a displacement within
//     1e-3 of its range's edge).
//
// Outputs d (N, 2), det_ok (N,), sat (N,) as bytes, residual (N,), what the plain
// version returns.
//
// Same arithmetic as the plain version, each PyTorch op one correctly rounded intrinsic
// (__fadd_rn, __fmul_rn, __fdiv_rn, __fmaf_rn: nvcc never contracts them). A sample is
// the two GEMMs' sums, vertical first (R_y @ block) and then horizontal (@ C_x^T), each a
// dot over the block whose only non-zero weights are the two taps, accumulated as the
// GEMM accumulates, k ascending: fma(f, b1, (1 - f) * b0). A tap outside the block reads
// 0, and a NaN (or infinite) offset makes the whole patch NaN, as the plain version's
// matrices do. The 225- or 441-term sums follow PyTorch's reduce kernel for a row of a
// contiguous (N, w*w) tensor (PyTorch 2.x, Reduce.cuh): 32 lanes a row; above 128 terms
// 16-byte loads of 4 into 4 accumulators per lane, the row's first (row * w*w) % 4
// unaligned terms first and the tail after, else lane + i * 32 into accumulator i; the
// accumulators combined 0 + 1 + 2 + 3, then a shuffle-down tree over offsets 16..1. The
// mean multiplies that sum by 1 / (w*w). That is PyTorch's order wherever it gives a row
// 32 lanes: every window up to 15, and larger ones from N = 16 tracks on (below, it
// widens its blocks). On the tracker's calls (N = 1,024 and 2,048, windows 15 and 21,
// f32 and bf16) the kernel gives the plain version's bits (PyTorch 2.11, CUDA 12.8,
// H100). Blocks are assumed finite (image values).
//
// Bound: neither bytes nor operations. At N = 2,048, w = 15, S = 29 a level reads 10.5 MB
// of blocks (3.2 us at 3.35 TB/s; they come from L2, where the extraction just wrote them)
// and does about 2,048 x (289 x 6 + 225 x 8 + (iters + 1) x 225 x 11) flops (5.1 MFLOP an
// iteration; 0.6 us for 6 iterations at 67 TFLOP/s). The call takes 18 us on an H100.
// What bounds it is each track's dependent chain: iteration k+1 samples where iteration
// k's step moved it, and each step needs two 225-term sums. So the design runs every
// track at once and keeps the chain short: one warp a track (2,048 warps fit on 132 SMs
// in one wave), the track's two blocks staged once into shared memory (f32, the target
// block already rounded to the iteration's storage dtype), the loop constants (T,
// gradients, Hessian, range) in registers, the sums as warp shuffles with no atomics, so
// two runs give the same bits and a graph replay equals the eager call. Lanes sample in
// row-major order (lane + 32 m: neighbouring lanes read neighbouring words, no bank
// conflicts) and write the error to a per-warp buffer shifted by the row's alignment
// shift, from which each lane reads its reduction terms in PyTorch's order with one
// 16-byte load per 4 terms. Tiers of compile-time register arrays cover windows up to 15,
// 21 and 31; S, the template's S, the window, iters and eps are run-time arguments.
//
// Plain C interface, loaded with ctypes: no PyTorch headers. Launches on the caller's
// stream, allocates nothing, returns the launch error code.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;           // tracks per thread block, one warp each
constexpr int kSmemMax = 232448;    // dynamic shared memory a block may take on sm_90
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float fma_(float a, float b, float c) { return __fmaf_rn(a, b, c); }

// f32 -> bf16 -> f32, round to nearest even, as c10::BFloat16 converts
__device__ __forceinline__ float round_bf16(float x) {
  const uint32_t u = __float_as_uint(x);
  if (isnan(x)) return __uint_as_float(0x7fc00000u);
  return __uint_as_float((u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u);
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(uint16_t x) { return __uint_as_float((uint32_t)x << 16); }

// torch.maximum / torch.minimum: NaN where either side is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// The two taps of a window's first sample along one axis: the window starts at block
// coordinate `off`; sample k reads taps i0 + k (weight w0 = 1 - f) and i0 + k + 1
// (w1 = f), the weights rounded to bf16 where the plain version's matrices are.
struct Taps {
  int i0;
  float w0, w1;
  bool nan;
};

__device__ __forceinline__ Taps taps(float off, bool bf16) {
  const float fl = floorf(off);
  const float f = sub(off, fl);
  Taps t;
  t.nan = isnan(f);       // a NaN or infinite offset
  // an offset beyond the block puts every tap outside it: clamp before the conversion
  t.i0 = t.nan ? 0 : (int)fminf(fmaxf(fl, -65536.0f), 65536.0f);
  t.w0 = sub(1.0f, f);
  t.w1 = f;
  if (bf16) {
    t.w0 = round_bf16(t.w0);
    t.w1 = round_bf16(t.w1);
  }
  return t;
}

template <bool kChecked>
__device__ __forceinline__ float tap(const float* B, int S, int r, int c) {
  if (kChecked && !((unsigned)r < (unsigned)S && (unsigned)c < (unsigned)S)) return 0.0f;
  return B[r * S + c];
}

// Sample (a, b) of the window over an (S, S) block: the vertical pass at block columns
// c and c + 1, then the horizontal one. A column outside the block is no term of the
// second GEMM: it reads 0.
template <bool kChecked>
__device__ __forceinline__ float sample(const float* B, int S, const Taps& ty, const Taps& tx,
                                        int a, int b) {
  const int r = ty.i0 + a, c = tx.i0 + b;
  const float v0 = fma_(ty.w1, tap<kChecked>(B, S, r + 1, c), mul(ty.w0, tap<kChecked>(B, S, r, c)));
  const float v1 = fma_(ty.w1, tap<kChecked>(B, S, r + 1, c + 1),
                        mul(ty.w0, tap<kChecked>(B, S, r, c + 1)));
  return fma_(tx.w1, v1, mul(tx.w0, v0));
}

// Which terms of a row of n lane `lane` sums, in PyTorch's order. Term slots: 0 the
// unaligned head (accumulator 0), 1 + 4 g + i the g-th group's i-th (accumulator i),
// E - 1 the tail (accumulator 0). -1: no term. The positions are the row's own indices.
template <int G>
struct Order {
  static constexpr int E = 2 + 4 * G;
  int el[E];
  int shift;      // where a term sits in the exchange buffer: its index + shift
  bool vec;       // groups of 4 consecutive terms at a 16-byte boundary of the buffer
  int base;       // buffer index of group 0 (vec)
};

template <int G>
__device__ __forceinline__ Order<G> order(int lane, long long row, int n) {
  Order<G> o;
#pragma unroll
  for (int k = 0; k < Order<G>::E; ++k) o.el[k] = -1;
  o.vec = n > 128;
  if (o.vec) {
    const int s = (int)((row * n) & 3);      // the row's start, in floats past 16 bytes
    const int off = s ? 4 - s : 0;           // terms before the first aligned one
    if (s && lane >= s && lane < 4) o.el[0] = lane - s;
    const int m = n - off, nv = m / 4;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int idx = lane + 32 * g;
      if (idx < nv) {
#pragma unroll
        for (int i = 0; i < 4; ++i) o.el[1 + 4 * g + i] = off + 4 * idx + i;
      }
    }
    if (4 * nv + lane < m) o.el[Order<G>::E - 1] = off + 4 * nv + lane;
    o.shift = s;
    o.base = off + s + 4 * lane;            // 0 or 4, plus 4 a lane: 16-byte aligned
  } else {
    int bw = 1;                              // PyTorch's block width: 2^floor(log2 n), <= 32
    while (2 * bw <= n && bw < 32) bw *= 2;
    if (lane < bw) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (lane + i * bw < n) o.el[1 + i] = lane + i * bw;
    }
    o.shift = 0;
    o.base = 0;
  }
  return o;
}

// Gather a lane's terms from the exchange buffer in the order of `o`.
template <int G>
__device__ __forceinline__ void gather(const Order<G>& o, const float* ex, float (&v)[Order<G>::E]) {
  constexpr int E = Order<G>::E;
  v[0] = o.el[0] >= 0 ? ex[o.el[0] + o.shift] : 0.0f;
  v[E - 1] = o.el[E - 1] >= 0 ? ex[o.el[E - 1] + o.shift] : 0.0f;
  if (o.vec) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (o.el[1 + 4 * g] >= 0) {
        const float4 q = *reinterpret_cast<const float4*>(ex + o.base + 128 * g);
        v[1 + 4 * g] = q.x;
        v[2 + 4 * g] = q.y;
        v[3 + 4 * g] = q.z;
        v[4 + 4 * g] = q.w;
      }
    }
  } else {
#pragma unroll
    for (int k = 1; k < E - 1; ++k) v[k] = o.el[k] >= 0 ? ex[o.el[k]] : 0.0f;
  }
}

// The row's sum of the terms v (slot k of `o`), in PyTorch's order; every lane gets it.
template <int G>
__device__ __forceinline__ float row_sum(const Order<G>& o, const float (&v)[Order<G>::E]) {
  constexpr int E = Order<G>::E;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (o.el[0] >= 0) acc[0] = add(acc[0], v[0]);
#pragma unroll
  for (int k = 1; k < E - 1; ++k)
    if (o.el[k] >= 0) acc[(k - 1) & 3] = add(acc[(k - 1) & 3], v[k]);
  if (o.el[E - 1] >= 0) acc[0] = add(acc[0], v[E - 1]);
  float s = add(add(add(acc[0], acc[1]), acc[2]), acc[3]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = add(s, __shfl_down_sync(kAll, s, off));
  return __shfl_sync(kAll, s, 0);
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// floats of one warp's shared memory: template block, target block, the (w+2)^2
// template sample, and two exchange buffers of w*w terms (4 spare for the shift)
__host__ __device__ inline int warp_floats(int w, int St, int S) {
  return round4(St * St) + round4(S * S) + round4((w + 2) * (w + 2)) + 2 * round4(w * w + 4);
}

// The call's arguments (see lcvo_klt_iterate below).
struct Args {
  const void* tblocks;
  const float* torig;
  const void* nblocks;
  const float* norig;
  const float* pts;
  const float* d;
  int N, w, St, S, iters;
  float eps2;
  int bf16_blocks, bf16_iter;
  float* d_out;
  uint8_t* det_ok;
  uint8_t* sat;
  float* residual;
};

// Copy `count` block values of type BT to shared memory as f32, rounded to bf16 if asked.
template <typename BT>
__device__ __forceinline__ void stage(const void* src, size_t first, int count, float* dst,
                                      int lane, bool to_bf16) {
  const BT* p = static_cast<const BT*>(src) + first;
  for (int k = lane; k < count; k += 32) {
    const float v = widen(p[k]);
    dst[k] = to_bf16 ? round_bf16(v) : v;
  }
}

// M: row-major samples a lane computes (>= ceil(w*w / 32)); G: groups of 4 terms a lane
// sums (>= ceil((w*w / 4) / 32))
template <int M, int G>
__global__ void __launch_bounds__(kWarps * 32) klt_iterate_kernel(const Args a) {
  constexpr int E = Order<G>::E;
  extern __shared__ float4 smem4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * (blockDim.x >> 5) + warp;
  if (t >= a.N) return;     // whole warps leave; nothing below syncs across warps
  const int w = a.w, St = a.St, S = a.S;
  const int n = w * w, w2 = w + 2, r = (w - 1) / 2;
  const bool tb_bf16 = a.bf16_blocks != 0;
  const bool ib = a.bf16_iter != 0;

  float* tb = reinterpret_cast<float*>(smem4) + (size_t)warp * warp_floats(w, St, S);
  float* nb = tb + round4(St * St);
  float* T2 = nb + round4(S * S);
  float* exa = T2 + round4(w2 * w2);
  float* exb = exa + round4(n + 4);

  // stage the blocks, widened to f32; the target block in the loop's storage dtype
  if (tb_bf16) {
    stage<uint16_t>(a.tblocks, (size_t)t * St * St, St * St, tb, lane, false);
    stage<uint16_t>(a.nblocks, (size_t)t * S * S, S * S, nb, lane, ib);
  } else {
    stage<float>(a.tblocks, (size_t)t * St * St, St * St, tb, lane, false);
    stage<float>(a.nblocks, (size_t)t * S * S, S * S, nb, lane, ib);
  }
  const float px = a.pts[2 * t], py = a.pts[2 * t + 1];
  const float tox = a.torig[2 * t], toy = a.torig[2 * t + 1];
  const float nox = a.norig[2 * t], noy = a.norig[2 * t + 1];
  float dx = a.d[2 * t], dy = a.d[2 * t + 1];
  __syncwarp();

  // the template's (w+2)^2 sample, its window's top-left at (pts - torig) - (r + 1)
  {
    const Taps tx = taps(sub(sub(px, tox), (float)(r + 1)), tb_bf16);
    const Taps ty = taps(sub(sub(py, toy), (float)(r + 1)), tb_bf16);
    const bool nan = tx.nan || ty.nan;
    for (int p = lane; p < w2 * w2; p += 32) {
      const int y = p / w2, x = p - y * w2;
      T2[p] = nan ? __uint_as_float(0x7fc00000u) : sample<true>(tb, St, ty, tx, y, x);
    }
  }
  __syncwarp();

  // T in row-major lane order; gx, gy to the exchange buffers, then in PyTorch's order
  const Order<G> o = order<G>(lane, t, n);
  float Tl[M];
  int ij[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int p = lane + 32 * m;
    ij[m] = -1;
    Tl[m] = 0.0f;
    if (p < n) {
      const int i = p / w, j = p - i * w;
      ij[m] = (i << 8) | j;
      const float* row = T2 + (i + 1) * w2 + 1 + j;
      Tl[m] = ib ? round_bf16(row[0]) : row[0];
      exa[p + o.shift] = mul(0.5f, sub(row[1], row[-1]));
      exb[p + o.shift] = mul(0.5f, sub(row[w2], row[-w2]));
    }
  }
  __syncwarp();
  float gx[E], gy[E], v[E];
  gather<G>(o, exa, gx);
  gather<G>(o, exb, gy);
#pragma unroll
  for (int k = 0; k < E; ++k) v[k] = mul(gx[k], gx[k]);
  const float hxx = row_sum<G>(o, v);
#pragma unroll
  for (int k = 0; k < E; ++k) v[k] = mul(gx[k], gy[k]);
  const float hxy = row_sum<G>(o, v);
#pragma unroll
  for (int k = 0; k < E; ++k) v[k] = mul(gy[k], gy[k]);
  const float hyy = row_sum<G>(o, v);
  const float det = sub(mul(hxx, hyy), mul(hxy, hxy));
  const bool det_ok = det > 1e-6f;
  const float safe_det = det_ok ? det : 1.0f;
  const float nhxy = -hxy;
  if (ib) {
#pragma unroll
    for (int k = 0; k < E; ++k) {
      gx[k] = round_bf16(gx[k]);
      gy[k] = round_bf16(gy[k]);
    }
  }

  // the displacement range whose sampling window stays inside the target block
  const float lo_x = sub(add(nox, (float)(r + 1)), px), lo_y = sub(add(noy, (float)(r + 1)), py);
  const float hi_x = sub(add(nox, (float)(S - r - 2)), px);
  const float hi_y = sub(add(noy, (float)(S - r - 2)), py);

  // the error of the window at d, written to exa in row-major lane order
  auto error = [&]() {
    __syncwarp();       // the previous gather is done with exa
    const Taps tx = taps(sub(sub(add(px, dx), nox), (float)r), ib);
    const Taps ty = taps(sub(sub(add(py, dy), noy), (float)r), ib);
    const bool nan = tx.nan || ty.nan;
    const bool inside = ty.i0 >= 0 && ty.i0 + w < S && tx.i0 >= 0 && tx.i0 + w < S;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      if (ij[m] < 0) continue;
      const int i = ij[m] >> 8, j = ij[m] & 255;
      float I;
      if (nan) I = __uint_as_float(0x7fc00000u);
      else if (inside) I = sample<false>(nb, S, ty, tx, i, j);
      else I = sample<true>(nb, S, ty, tx, i, j);
      exa[lane + 32 * m + o.shift] = sub(I, Tl[m]);
    }
    __syncwarp();
  };

  for (int it = 0; it < a.iters; ++it) {
    error();
    float e[E];
    gather<G>(o, exa, e);
#pragma unroll
    for (int k = 0; k < E; ++k) v[k] = mul(gx[k], e[k]);
    const float bx = row_sum<G>(o, v);
#pragma unroll
    for (int k = 0; k < E; ++k) v[k] = mul(gy[k], e[k]);
    const float by = row_sum<G>(o, v);
    const float ddx = dvd(sub(mul(hyy, bx), mul(hxy, by)), safe_det);
    const float ddy = dvd(add(mul(nhxy, bx), mul(hxx, by)), safe_det);
    // per-track convergence mask (OpenCV's criteria eps): freeze, don't jitter
    const bool live = det_ok && add(mul(ddx, ddx), mul(ddy, ddy)) >= a.eps2;
    if (live) {
      dx = sub(dx, ddx);
      dy = sub(dy, ddy);
    }
    dx = min_nan(max_nan(dx, lo_x), hi_x);
    dy = min_nan(max_nan(dy, lo_y), hi_y);
  }

  error();
  float e[E];
  gather<G>(o, exa, e);
#pragma unroll
  for (int k = 0; k < E; ++k) v[k] = fabsf(e[k]);
  const float residual = mul(row_sum<G>(o, v), 1.0f / (float)n);
  if (lane == 0) {
    a.d_out[2 * t] = dx;
    a.d_out[2 * t + 1] = dy;
    a.det_ok[t] = det_ok;
    // a displacement pinned at the block boundary wanted to leave the search region
    a.sat[t] = dx <= add(lo_x, 1e-3f) || dx >= sub(hi_x, 1e-3f) ||
               dy <= add(lo_y, 1e-3f) || dy >= sub(hi_y, 1e-3f);
    a.residual[t] = residual;
  }
}

template <int M, int G>
int launch(const Args& a, cudaStream_t stream) {
  auto kernel = klt_iterate_kernel<M, G>;
  const int per_warp = warp_floats(a.w, a.St, a.S) * (int)sizeof(float);
  int warps = kWarps;
  while (warps > 1 && warps * per_warp > kSmemMax) --warps;
  const int bytes = warps * per_warp;
  if (bytes > kSmemMax) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    // above 48 KB only after opting in; set once per instance, at its first such call
    // (an eager call, before any capture of it)
    static bool opted = false;
    if (!opted) {
      const cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
      if (e != cudaSuccess) return (int)e;
      opted = true;
    }
  }
  kernel<<<(a.N + warps - 1) / warps, warps * 32, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// tblocks (N, St, St), nblocks (N, S, S): f32 (bf16_blocks 0) or bf16 (1), both alike;
// torig, norig, pts, d (N, 2) f32; eps2 = eps * eps; bf16_iter: the loop's storage dtype
// is bf16; d_out (N, 2) f32, det_ok and sat (N,) bytes, residual (N,) f32; contiguous
int lcvo_klt_iterate(const void* tblocks, const void* torig, const void* nblocks,
                     const void* norig, const void* pts, const void* d, int N, int w, int St,
                     int S, int iters, float eps2, int bf16_blocks, int bf16_iter, void* d_out,
                     void* det_ok, void* sat, void* residual, void* stream) {
  if (N <= 0) return 0;
  if (w < 1 || w > 31 || St < w + 2 || S < w + 2) return (int)cudaErrorInvalidValue;
  const Args a{tblocks, static_cast<const float*>(torig), nblocks,
               static_cast<const float*>(norig), static_cast<const float*>(pts),
               static_cast<const float*>(d), N, w, St, S, iters, eps2, bf16_blocks, bf16_iter,
               static_cast<float*>(d_out), static_cast<uint8_t*>(det_ok),
               static_cast<uint8_t*>(sat), static_cast<float*>(residual)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // a window of w <= 15 has at most 225 terms (8 a lane, 2 groups of 4), w <= 21 441
  // (14, 4), w <= 31 961 (31, 8)
  if (w <= 15) return launch<8, 2>(a, st);
  if (w <= 21) return launch<14, 4>(a, st);
  return launch<31, 8>(a, st);
}

}  // extern "C"
