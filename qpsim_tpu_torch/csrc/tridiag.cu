// Batched Thomas tridiagonal solve for Hopper.
//
// Replaces: qpsim_tpu/ops/pallas_tridiag.py, _thomas_kernel (called by
// tridiag_solve_pallas).  Solves T x = r for B independent lines of length
// N held line-axis-first, (N, B): row i of line j is element i·B + j.
// sub at row 0 and sup at row N−1 are never read, so zero couplings inside
// a line decouple its intervals exactly, as in the JAX kernel.
//
// Design: one thread per line.  Consecutive threads own consecutive lines,
// so every row of the forward sweep and of the back substitution is one
// coalesced load or store per warp.  c′ goes to a scratch array from the
// wrapper and d′ to the output, which the back substitution overwrites in
// place.
//
// What bounds it on this card: device-memory traffic — four input arrays
// read once, c′ and d′ written and read back once each — and, with few
// lines, latency: each sweep is sequential along its line, and B lines are
// B threads (16 K at 1024² × 16, an eighth of the card's resident threads).

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;

template <typename T>
__global__ void __launch_bounds__(kBlock) thomas_kernel(
    const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ c,
    const T* __restrict__ r, T* __restrict__ x, T* __restrict__ w, int n, int batch) {
  const int line = blockIdx.x * blockDim.x + threadIdx.x;
  if (line >= batch) return;
  const long long B = batch;
  T inv = T(1) / b[line];
  T w_prev = c[line] * inv;
  T g_prev = r[line] * inv;
  w[line] = w_prev;
  x[line] = g_prev;
  for (int i = 1; i < n; ++i) {
    const long long k = i * B + line;
    const T a_i = a[k];
    inv = T(1) / (b[k] - a_i * w_prev);
    w_prev = i + 1 < n ? c[k] * inv : T(0);
    g_prev = (r[k] - a_i * g_prev) * inv;
    w[k] = w_prev;
    x[k] = g_prev;
  }
  T x_next = g_prev;
  for (int i = n - 2; i >= 0; --i) {
    const long long k = i * B + line;
    x_next = x[k] - w[k] * x_next;
    x[k] = x_next;
  }
}

template <typename T>
int launch(const T* a, const T* b, const T* c, const T* r, T* x, T* w, int n, int batch,
           void* stream) {
  if (batch > 0 && n > 0) {
    thomas_kernel<T><<<(batch + kBlock - 1) / kBlock, kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(a, b, c, r, x, w, n, batch);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each returns cudaGetLastError()
// after the launch; the Python wrapper raises when it is not 0.
extern "C" int qp_thomas_f32(const float* a, const float* b, const float* c, const float* r,
                             float* x, float* w, int n, int batch, void* stream) {
  return launch<float>(a, b, c, r, x, w, n, batch, stream);
}

extern "C" int qp_thomas_f64(const double* a, const double* b, const double* c,
                             const double* r, double* x, double* w, int n, int batch,
                             void* stream) {
  return launch<double>(a, b, c, r, x, w, n, batch, stream);
}
