// Batched SVD of small f32 matrices on the card, through cuSOLVER's gesvdjBatched.
//
// Stands for XLA's jnp.linalg.svd in lcvo_tpu/ops/epipolar.py:47,54,65 and
// lcvo_tpu/ops/five_point.py (the JAX package leaves the SVD to XLA; no Pallas kernel).
// The port called torch.linalg.svd, which on CUDA runs cusolverDnSgesvdjBatched for every
// matrix of at most 32 x 32 and then reads the per-matrix convergence codes back to the
// host (aten::linalg_svd -> aten::item). That copy is a host sync, and a CUDA graph
// cannot hold one, so the bootstrap's two-view step could not be captured. This launcher
// makes the same call with the same settings (tolerance FLT_EPSILON, cuSOLVER's default
// sweep cap and ordering), so its bits are torch.linalg.svd's, and it leaves the codes
// on the device: the caller reads them at a read-back it makes anyway
// (lcvo_tpu_torch/ops/svd.py).
//
// Layout: A is column-major (lda = m), overwritten; U (m x m, ldu = m) and V (n x n,
// ldv = n) column-major, full; S (min(m, n)) in descending order; info (batch) is 0
// for a matrix that converged and min(m, n) + 1 for one that did not. The handle and the
// parameter set are made once per device and sweep cap, outside any capture (cuSOLVER
// allocates when it makes a handle); the workspace is the caller's.
//
// Bound: at these sizes (at most 512 matrices of 8 x 9) the call is a few hundred
// kilobytes and a few million operations, microseconds at the card's rates; its time is
// cuSOLVER's 2-4 kernel launches and the Jacobi sweeps inside one thread block per
// matrix. What the port gains is the capture, not the kernel.
//
// Plain C interface, loaded with ctypes. A return value of 0 is success, a negative one
// a cuSOLVER status (negated), a positive one a CUDA error.

#include <cuda_runtime.h>
#include <cusolverDn.h>
#include <float.h>

extern "C" {

int lcvo_svd_create(int max_sweeps, void** handle, void** params) {
  cusolverDnHandle_t h = nullptr;
  gesvdjInfo_t p = nullptr;
  cusolverStatus_t s = cusolverDnCreate(&h);
  if (s == CUSOLVER_STATUS_SUCCESS) s = cusolverDnCreateGesvdjInfo(&p);
  if (s == CUSOLVER_STATUS_SUCCESS) s = cusolverDnXgesvdjSetTolerance(p, FLT_EPSILON);
  if (s == CUSOLVER_STATUS_SUCCESS && max_sweeps > 0)
    s = cusolverDnXgesvdjSetMaxSweeps(p, max_sweeps);
  if (s != CUSOLVER_STATUS_SUCCESS) {
    if (p) cusolverDnDestroyGesvdjInfo(p);
    if (h) cusolverDnDestroy(h);
    return -static_cast<int>(s);
  }
  *handle = h;
  *params = p;
  return 0;
}

int lcvo_svd_workspace(void* handle, void* params, float* A, int m, int n, int batch,
                       float* S, float* U, float* V, int* lwork) {
  cusolverStatus_t s = cusolverDnSgesvdjBatched_bufferSize(
      static_cast<cusolverDnHandle_t>(handle), CUSOLVER_EIG_MODE_VECTOR, m, n, A, m, S, U,
      m, V, n, lwork, static_cast<gesvdjInfo_t>(params), batch);
  return -static_cast<int>(s);
}

int lcvo_svd_gesvdj_batched(void* handle, void* params, float* A, int m, int n, int batch,
                            float* S, float* U, float* V, float* work, int lwork, int* info,
                            void* stream) {
  cusolverDnHandle_t h = static_cast<cusolverDnHandle_t>(handle);
  cusolverStatus_t s = cusolverDnSetStream(h, static_cast<cudaStream_t>(stream));
  if (s == CUSOLVER_STATUS_SUCCESS)
    s = cusolverDnSgesvdjBatched(h, CUSOLVER_EIG_MODE_VECTOR, m, n, A, m, S, U, m, V, n,
                                 work, lwork, info, static_cast<gesvdjInfo_t>(params), batch);
  if (s != CUSOLVER_STATUS_SUCCESS) return -static_cast<int>(s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
