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
// are columns x); both keep the natural (NB, Ny, Nx) layout.
//
// Design (adi_staged.cuh): a block owns TL lines of one bin, one thread per
// (line, chunk).  The x half stages its TL rows into shared memory with
// coalesced loads (with the rows above and below; rows outside the grid
// are zero) and forms their rhs there; the y half forms its columns' rhs as
// the forward sweep reads down them (a warp reads TL-wide runs).  dp and D
// stay in shared memory, the chunks' boundary values meet there, one
// thread per line runs the K-step interface recurrence on the block's copy
// of the interface table, and the back substitution writes the solution
// (the x half back through shared memory, with coalesced stores).  The
// packs (5·M·K values per bin) are read through the read-only cache.
//
// What bounds it on this card: at 1024² × 1 the state is 4 MB in float32,
// a few µs of device-memory traffic per half, but there are only 1024
// lines: each thread walks its M rows twice, then one thread per line
// walks the 2·K steps of the interface recurrence while the line's other
// threads wait.  Each half is bound by that latency, and the scalar path's
// step of two such launches by the host that issues them.

#include <cuda_runtime.h>

#include "adi_staged.cuh"

namespace {

constexpr int kMaxThreads = 256;  // TL·W threads per block

template <typename T_, bool kXHalf>
struct SepPolicy {
  using T = T_;
  static constexpr int kArrays = 1;  // rhs → dp → D → x
  static constexpr int kKept = 1;
  static constexpr int kOut = 0;
  static constexpr int kSlots = 2;   // D of each chunk's first and last row
  static constexpr int kTable = 6;   // the interface table, staged per block

  const T* __restrict__ u;
  T* __restrict__ out;
  const T* __restrict__ ev;    // explicit direction's 4 vectors of this bin
  const T* __restrict__ s3;    // solve direction's source vector of this bin
  const T* __restrict__ pk;    // pack (5, M, K)
  const T* __restrict__ itab;  // interface table (K, 6)
  long long plane;             // b·Ny·Nx
  int nx, n_lines, line0, k, m, tl;
  long long mk;

  __device__ __forceinline__ long long addr(int line, int p) const {
    return plane + (kXHalf ? static_cast<long long>(line) * nx + p
                           : static_cast<long long>(p) * nx + line);
  }

  __device__ __forceinline__ T table(int e) const { return itab[e]; }

  // neighbouring lines outside the grid meet zero coefficients
  __device__ __forceinline__ T state(int line, int p) const {
    return line >= 0 && line < n_lines ? __ldg(u + addr(line, p)) : T(0);
  }

  __device__ __forceinline__ void fetch(int l, int p, T up, T uc, T dn, T* v) const {
    const int line = line0 + l;
    if (line >= n_lines) {
      v[0] = T(0);
      return;
    }
    const T rhs = uc + __ldg(ev + line) * up + __ldg(ev + n_lines + line) * dn +
                  __ldg(ev + 2 * n_lines + line) * uc;
    v[0] = rhs + __ldg(ev + 3 * n_lines + line) + __ldg(s3 + p);
  }

  __device__ __forceinline__ void store(T x, int l, int p) const {
    if (line0 + l < n_lines) out[addr(line0 + l, p)] = x;
  }

  template <class Src>
  __device__ __forceinline__ void eliminate(T* d, int st, int, int c, T* slots, int l,
                                            bool keep, Src&& src) const {
    // row i + 1's rhs is read while row i is eliminated
    T dp = T(0), ahead[1];
    src(0, ahead);
#pragma unroll 4
    for (int i = 0; i < m; ++i) {
      const long long f = static_cast<long long>(i) * k + c;
      const T rhs = ahead[0];
      if (i + 1 < m) src(i + 1, ahead);
      dp = (rhs - __ldg(pk + f) * dp) * __ldg(pk + mk + f);  // a_rt is 0 on row 0
      d[i * st] = dp;
    }
    T D = dp;
#pragma unroll 4
    for (int i = m - 2; i >= 0; --i) {
      D = d[i * st] - __ldg(pk + 2 * mk + static_cast<long long>(i) * k + c) * D;
      d[i * st] = D;
    }
    if (keep) {
      slots[c * tl + l] = D;         // first row
      slots[(k + c) * tl + l] = dp;  // last row
    }
  }

  // p_j into the first-row slots, g_j into the last-row slots, then L_j
  // and R_j over them; itab is the block's copy of the interface table
  __device__ __forceinline__ void interface(T* slots, const T* itab, int l) const {
    T* s_left = slots;
    T* s_right = slots + k * tl;
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

  template <class Sink>
  __device__ __forceinline__ void finish(const T* d, int st, int, int c, const T* slots, int l,
                                         Sink&& sink) const {
    const T x_left = c > 0 ? slots[(k + c - 1) * tl + l] : T(0);  // R of chunk c−1
    const T x_right = c + 1 < k ? slots[(c + 1) * tl + l] : T(0);  // L of chunk c+1
#pragma unroll 4
    for (int i = 0; i < m; ++i) {
      const long long f = static_cast<long long>(i) * k + c;
      sink(i, d[i * st] - __ldg(pk + 3 * mk + f) * x_left - __ldg(pk + 4 * mk + f) * x_right);
    }
  }
};

template <typename T, bool kXHalf>
__global__ void __launch_bounds__(kMaxThreads) adi_sep_kernel(
    const T* __restrict__ u, T* __restrict__ out, const T* __restrict__ xv,
    const T* __restrict__ yv, const T* __restrict__ fac, const T* __restrict__ ifc, int nb,
    int ny, int nx, int k, int tl, int w, int s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_lines = kXHalf ? ny : nx;
  const int n = kXHalf ? nx : ny;
  const int b = blockIdx.x % nb;
  const int tile = blockIdx.x / nb;
  const int m = n / k;
  SepPolicy<T, kXHalf> pol;
  pol.u = u;
  pol.out = out;
  pol.ev = (kXHalf ? yv : xv) + static_cast<long long>(b) * 4 * n_lines;
  pol.s3 = (kXHalf ? xv : yv) + (static_cast<long long>(b) * 4 + 3) * n;
  pol.mk = static_cast<long long>(m) * k;
  pol.pk = fac + static_cast<long long>(b) * 5 * pol.mk;
  pol.itab = ifc + static_cast<long long>(b) * k * 6;
  pol.plane = static_cast<long long>(b) * ny * nx;
  pol.nx = nx;
  pol.n_lines = n_lines;
  pol.line0 = tile * tl;
  pol.k = k;
  pol.m = m;
  pol.tl = tl;
  const qp_adi::Staging g{n, k, m, s, tl, w};
  qp_adi::solve_lines<kXHalf>(pol, g, reinterpret_cast<T*>(smem_raw));
}

template <typename T, bool kXHalf>
bool plan_of(int nb, int ny, int nx, int k, qp_adi::Plan* plan) {
  const int n = kXHalf ? nx : ny;
  const int n_lines = kXHalf ? ny : nx;
  using P = SepPolicy<T, kXHalf>;
  return qp_adi::make_plan(kXHalf, n, n_lines, nb, k, kXHalf ? P::kArrays : P::kKept,
                           P::kSlots, P::kTable, sizeof(T), kMaxThreads, plan);
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
    qp_adi::Plan plan;
    if (!plan_of<T, kXHalf>(nb, ny, nx, k, &plan)) return static_cast<int>(cudaErrorInvalidValue);
    static int granted = 0;
    const cudaError_t err = qp_adi::allow_smem(adi_sep_kernel<T, kXHalf>, plan.smem, &granted);
    if (err != cudaSuccess) return static_cast<int>(err);
    adi_sep_kernel<T, kXHalf><<<plan.blocks, plan.tl * plan.w, plan.smem,
                                static_cast<cudaStream_t>(stream)>>>(
        u, out, xv, yv, fac, ifc, nb, ny, nx, k, plan.tl, plan.w, plan.s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each returns cudaGetLastError()
// after the launch (or cudaErrorInvalidValue for a chunk count the kernel
// does not take, or a line too long for shared memory); the Python wrapper
// raises when it is not 0.
#define QP_SEP_ENTRY(NAME, T, XHALF)                                                    \
  extern "C" int NAME(const T* u, T* out, const T* xv, const T* yv, const T* fac,      \
                      const T* ifc, int nb, int ny, int nx, int k, void* stream) {     \
    return launch<T, XHALF>(u, out, xv, yv, fac, ifc, nb, ny, nx, k, stream);          \
  }

QP_SEP_ENTRY(qp_adi_sep_x_f32, float, true)
QP_SEP_ENTRY(qp_adi_sep_x_f64, double, true)
QP_SEP_ENTRY(qp_adi_sep_y_f32, float, false)
QP_SEP_ENTRY(qp_adi_sep_y_f64, double, false)

// The launch plan of one half: {lines per block, chunks held at once,
// pitch, shared bytes per block, blocks, waves}; returns 0, or
// cudaErrorInvalidValue when the kernel does not take the shape.
extern "C" int qp_adi_sep_plan(int x_half, int elem_bytes, int nb, int ny, int nx, int k,
                               int* out) {
  qp_adi::Plan p;
  bool ok;
  if (elem_bytes == 4) {
    ok = x_half ? plan_of<float, true>(nb, ny, nx, k, &p) : plan_of<float, false>(nb, ny, nx, k, &p);
  } else {
    ok = x_half ? plan_of<double, true>(nb, ny, nx, k, &p) : plan_of<double, false>(nb, ny, nx, k, &p);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int vals[6] = {p.tl, p.w, p.s, p.smem, p.blocks, p.waves};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
  return 0;
}
