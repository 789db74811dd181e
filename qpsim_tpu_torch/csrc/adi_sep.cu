// Separable Peaceman–Rachford ADI step with host-prefactored Wang sweeps, for Hopper.
//
// Replaces: qpsim_tpu/ops/pallas_adi_sep.py, build_pallas_adi_sep_step and
// its kernels _make_sep_x_kernel (x half) and _make_sep_y_kernel (y half),
// whose body is _prefactored_sweep.  For a separable operator (a full
// rectangle with one BC per face) each half-step, per bin b, is
//   rhs = u + e0·u_prev + e1·u_next + e2·u + e3 + s3
// with e = α·s_b·(lo, hi, diag, src) the explicit direction's 1D vectors
// (u_prev/u_next the neighbouring lines) and s3 = α·s_b·src of the solve
// direction, then the Wang-partition solve of (I − α·s_b·L_d) x = rhs along
// the implicit direction, its eliminations prefactored on the host in
// float64 (ops/adi_sep.py): pack [a_rt, inv, cp, A, C] (5, M, K) and
// interface table [aL, invI, aR, arw, q, w] (K, 6), per bin:
//   forward   dp_i = (d_i − a_rt_i·dp_{i−1})·inv_i      per chunk
//   backward  D_i  = dp_i − cp_i·D_{i+1}                per chunk
//   interface p_j = (D0_j − aL_j·g_{j−1})·invI_j,  g_j = DM_j − aR_j·g_{j−1} + arw_j·p_j,
//             L_j = p_j − q_j·L_{j+1},  R_j = g_j − w_j·L_{j+1}
//   final     x_i  = D_i − A_i·R_{c−1} − C_i·L_{c+1}    per chunk c
// The x half solves along x (lines are rows y), the y half along y (lines
// are columns x); both keep the natural (NB, Ny, Nx) layout.  The TPU
// kernel's swapped intermediate layout and lane-replicated packs are VMEM
// artefacts and are not reproduced.
//
// Design: a block holds TL = 256/K lines × K chunks, one thread per (line,
// chunk); threadIdx.x runs over lines, threadIdx.y over chunks.  A thread
// forms its chunk's rhs on the fly and runs the forward and backward
// sweeps, keeping dp and D in the output array; the chunks' boundary
// values meet in shared memory, where one thread per line runs the K-step
// interface recurrence; then every thread back-substitutes its chunk.
//
// What bounds it on this card: latency.  At 1024² one bin is 1 M cells,
// 4 MB in float32, a few µs of device-memory traffic per half, but each
// thread walks M = 32 dependent rows three times.  In the y half
// consecutive threads own consecutive columns, so each warp access is
// TL-wide coalesced runs; in the x half they own rows Nx apart and rely on
// L1 to reuse each 32-byte sector along the row.  Left for later: staging
// the x half's rows through shared memory, and more lines per block.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // TL·K threads per block

template <typename T, bool kXHalf>
__device__ __forceinline__ void sep_half(
    const T* __restrict__ u, T* __restrict__ out, const T* __restrict__ xv,
    const T* __restrict__ yv, const T* __restrict__ fac, const T* __restrict__ ifc,
    int ny, int nx, int k, T* s_left, T* s_right) {
  // x half: lines are rows (explicit direction y), the solve runs along x
  const int n_lines = kXHalf ? ny : nx;
  const int n = kXHalf ? nx : ny;
  const long long line_stride = kXHalf ? nx : 1;
  const long long elem_stride = kXHalf ? 1 : nx;
  const int tl = blockDim.x;
  const int l = threadIdx.x;
  const int c = threadIdx.y;
  const int b = blockIdx.y;
  const int line = blockIdx.x * tl + l;
  const bool active = line < n_lines;
  const int m = n / k;
  const long long mk = static_cast<long long>(m) * k;
  const T* ev = (kXHalf ? yv : xv) + static_cast<long long>(b) * 4 * n_lines;
  const T* s3 = (kXHalf ? xv : yv) + (static_cast<long long>(b) * 4 + 3) * n;
  const T* pk = fac + static_cast<long long>(b) * 5 * mk;
  const T* itab = ifc + static_cast<long long>(b) * k * 6;
  const long long base = static_cast<long long>(b) * ny * nx + line * line_stride;
  const int slot = c * tl + l;

  T d_first = T(0), d_last = T(0);
  if (active) {
    const T e0 = ev[line], e1 = ev[n_lines + line];
    const T e2 = ev[2 * n_lines + line], e3 = ev[3 * n_lines + line];
    const bool has_prev = line > 0, has_next = line + 1 < n_lines;
    T dp = T(0);
    for (int i = 0; i < m; ++i) {
      const int p = c * m + i;
      const long long at = base + p * elem_stride;
      const T uc = u[at];
      // neighbouring lines outside the grid meet zero coefficients
      const T prev = has_prev ? u[at - line_stride] : T(0);
      const T next = has_next ? u[at + line_stride] : T(0);
      T rhs = uc + e0 * prev + e1 * next + e2 * uc;
      rhs = rhs + e3 + s3[p];
      const long long f = static_cast<long long>(i) * k + c;
      dp = (rhs - pk[f] * dp) * pk[mk + f];  // a_rt is 0 on each chunk's row 0
      out[at] = dp;
    }
    d_last = dp;
    T D = dp;
    for (int i = m - 2; i >= 0; --i) {
      const long long at = base + static_cast<long long>(c * m + i) * elem_stride;
      D = out[at] - pk[2 * mk + static_cast<long long>(i) * k + c] * D;
      out[at] = D;
    }
    d_first = D;
  }
  s_left[slot] = d_first;
  s_right[slot] = d_last;
  __syncthreads();
  if (c == 0 && active) {
    // the interface recurrence of this line: p_j into s_left, g_j into
    // s_right, then L_j and R_j over them
    T g = T(0);
    for (int j = 0; j < k; ++j) {
      const T* row = itab + j * 6;
      const T p = (s_left[j * tl + l] - row[0] * g) * row[1];
      g = s_right[j * tl + l] - row[2] * g + row[3] * p;
      s_left[j * tl + l] = p;
      s_right[j * tl + l] = g;
    }
    T l_next = T(0);
    for (int j = k - 1; j >= 0; --j) {
      const T* row = itab + j * 6;
      const T lj = s_left[j * tl + l] - row[4] * l_next;
      s_right[j * tl + l] = s_right[j * tl + l] - row[5] * l_next;
      s_left[j * tl + l] = lj;
      l_next = lj;
    }
  }
  __syncthreads();
  if (active) {
    const T x_left = c > 0 ? s_right[slot - tl] : T(0);        // R of chunk c−1
    const T x_right = c + 1 < k ? s_left[slot + tl] : T(0);    // L of chunk c+1
    for (int i = 0; i < m; ++i) {
      const long long at = base + static_cast<long long>(c * m + i) * elem_stride;
      const long long f = static_cast<long long>(i) * k + c;
      out[at] = out[at] - pk[3 * mk + f] * x_left - pk[4 * mk + f] * x_right;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) adi_sep_x_kernel(
    const T* __restrict__ u, T* __restrict__ out, const T* __restrict__ xv,
    const T* __restrict__ yv, const T* __restrict__ fac, const T* __restrict__ ifc,
    int ny, int nx, int k) {
  extern __shared__ __align__(16) unsigned char smem_x[];
  T* s = reinterpret_cast<T*>(smem_x);
  sep_half<T, true>(u, out, xv, yv, fac, ifc, ny, nx, k, s, s + kThreads);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) adi_sep_y_kernel(
    const T* __restrict__ u, T* __restrict__ out, const T* __restrict__ xv,
    const T* __restrict__ yv, const T* __restrict__ fac, const T* __restrict__ ifc,
    int ny, int nx, int k) {
  extern __shared__ __align__(16) unsigned char smem_y[];
  T* s = reinterpret_cast<T*>(smem_y);
  sep_half<T, false>(u, out, xv, yv, fac, ifc, ny, nx, k, s, s + kThreads);
}

template <typename T, bool kXHalf>
int launch(const T* u, T* out, const T* xv, const T* yv, const T* fac, const T* ifc, int nb,
           int ny, int nx, int k, void* stream) {
  const int n = kXHalf ? nx : ny;
  const int n_lines = kXHalf ? ny : nx;
  if (k < 2 || k > 32 || (k & (k - 1)) != 0 || n % k != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb > 0 && n_lines > 0) {
    const int tl = kThreads / k;
    const dim3 grid((n_lines + tl - 1) / tl, nb);
    const dim3 block(tl, k);
    const size_t smem = 2 * kThreads * sizeof(T);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if constexpr (kXHalf) {
      adi_sep_x_kernel<T><<<grid, block, smem, s>>>(u, out, xv, yv, fac, ifc, ny, nx, k);
    } else {
      adi_sep_y_kernel<T><<<grid, block, smem, s>>>(u, out, xv, yv, fac, ifc, ny, nx, k);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each returns cudaGetLastError()
// after the launch (or cudaErrorInvalidValue for a chunk count the kernel
// does not take); the Python wrapper raises when it is not 0.
#define QP_SEP_ENTRY(NAME, T, XHALF)                                                    \
  extern "C" int NAME(const T* u, T* out, const T* xv, const T* yv, const T* fac,      \
                      const T* ifc, int nb, int ny, int nx, int k, void* stream) {     \
    return launch<T, XHALF>(u, out, xv, yv, fac, ifc, nb, ny, nx, k, stream);          \
  }

QP_SEP_ENTRY(qp_adi_sep_x_f32, float, true)
QP_SEP_ENTRY(qp_adi_sep_x_f64, double, true)
QP_SEP_ENTRY(qp_adi_sep_y_f32, float, false)
QP_SEP_ENTRY(qp_adi_sep_y_f64, double, false)
