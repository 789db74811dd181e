// Peaceman–Rachford ADI diffusion step for Hopper: one kernel per half-step.
//
// Replaces: qpsim_tpu/ops/pallas_adi.py, build_pallas_adi_fused_step and its
// kernels _make_fused_x_kernel (x half) and _make_fused_y_kernel (y half).
// What it computes is ADIDiffusion.make_step (qpsim_tpu/solver/
// diffusion_backends.py): with a_s = alpha·s_b (s_b the per-bin D(E) scale,
// applied lazily to the unit-D geometry planes),
//   x half:  rhs = u + a_s·(L_y u + src),   (I − a_s·L_x) u* = rhs
//   y half:  rhs = u* + a_s·(L_x u* + src), (I − a_s·L_y) u⁺ = rhs
// with CN coefficients a = −a_s·lo, b = 1 − a_s·diag, c = −a_s·hi built from
// the planes inside the kernel.  Masked cells have all-zero coefficient
// rows, so their rows reduce to the identity and decouple exactly.
//
// The solve is the Wang partition of the TPU kernel (_wang_stages), in its
// order (qp_adi::WangStages): each line of n cells splits into K chunks of
// M = ⌈n/K⌉ rows.  K is the caller's (pick_chunks, as the TPU kernel's
// _pick_chunks), raised to 32 on lines of 256 cells or more (and further
// where a chunk does not fit in shared memory), the last chunk padded with
// identity rows (a = c = rhs = 0, b = 1) where K does not divide n: they
// decouple exactly, as the lines past the grid do, so the result agrees
// with the TPU kernel's K to roundoff.  A zero coupling row still cuts an
// interval exactly; at K = 1 (a short line with no chunking) the stages
// reduce to the Thomas sweep.
//
// Design (adi_staged.cuh): a block owns TL lines of one bin, in a grid
// whose bin index runs fastest, so that with one shared plane set
// consecutive blocks read the same plane rows (from L2); one thread per
// (line, chunk).  The x half stages its TL rows (with the rows above and
// below) into shared memory with coalesced loads and forms rhs, a, b and c
// there; the y half forms them as its forward sweep reads down its TL
// columns (a warp reads TL-wide runs).  The Wang stages keep A′, C′ and D
// in shared memory; the solution leaves with coalesced stores (the x half
// from shared memory, the y half as its last sweep walks).  Lines too long
// for shared memory are solved in two passes over groups of chunks (the
// state read twice, written once).  Nothing goes to a device scratch array.
//
// What bounds it on this card: not bytes.  Shared memory holds ≈ 12 lines
// of 1024 cells per SM in the x half (16 B per cell staged in float32) and
// 16 in the y half (12 B per cell kept), so the sweeps' dependent steps and
// the one-thread-per-line interface recurrence are exposed; and each cell
// needs seven plane loads and one (x half) or three (y half) of the
// state.  With many bins the y half is bound by those loads, in TL-wide
// runs.

#include <cuda_runtime.h>

#include "adi_staged.cuh"

namespace {

constexpr int kMaxThreads = 256;  // TL·W threads per block

// The Wang stages (qp_adi::WangStages) on coefficients formed from the
// planes: the state, the stencil's rhs and the planes of this bin.
template <typename T_, bool kXHalf>
struct FusedPolicy : qp_adi::WangStages<T_> {
  using T = T_;

  const T* __restrict__ u;
  T* __restrict__ out;
  // explicit-direction planes and the source, then the solve direction's
  const T* __restrict__ elo;
  const T* __restrict__ ehi;
  const T* __restrict__ ediag;
  const T* __restrict__ src;
  const T* __restrict__ slo;
  const T* __restrict__ shi;
  const T* __restrict__ sdiag;
  long long plane, pplane;  // offsets of this bin's state and planes
  T as;
  int nx, n, n_lines, line0;

  __device__ __forceinline__ long long cell(int line, int p) const {
    return kXHalf ? static_cast<long long>(line) * nx + p : static_cast<long long>(p) * nx + line;
  }

  // the neighbouring lines outside the grid meet zero coefficients; the
  // padding past a line's end is never read
  __device__ __forceinline__ T state(int line, int p) const {
    return line >= 0 && line < n_lines && p < n ? __ldg(u + plane + cell(line, p)) : T(0);
  }

  // v = (a, c, rhs, b) of position p of the block's line l
  __device__ __forceinline__ void fetch(int l, int p, T up, T uc, T dn, T* v) const {
    const int line = line0 + l;
    if (line >= n_lines || p >= n) {  // an identity row
      v[0] = T(0);
      v[1] = T(0);
      v[2] = T(0);
      v[3] = T(1);
      return;
    }
    const long long q = pplane + cell(line, p);
    v[2] = uc + as * (__ldg(elo + q) * up + __ldg(ehi + q) * dn + __ldg(ediag + q) * uc +
                      __ldg(src + q));
    v[0] = p > 0 ? -as * __ldg(slo + q) : T(0);
    v[1] = p + 1 < n ? -as * __ldg(shi + q) : T(0);
    v[3] = T(1) - as * __ldg(sdiag + q);
  }

  __device__ __forceinline__ void store(T x, int l, int p) const {
    if (line0 + l < n_lines && p < n) out[plane + cell(line0 + l, p)] = x;
  }
};

template <typename T, bool kXHalf>
__global__ void __launch_bounds__(kMaxThreads) adi_kernel(
    const T* __restrict__ u, T* __restrict__ out, const T* __restrict__ elo,
    const T* __restrict__ ehi, const T* __restrict__ ediag, const T* __restrict__ src,
    const T* __restrict__ slo, const T* __restrict__ shi, const T* __restrict__ sdiag,
    const T* __restrict__ scale, int nb, int nbp, int ny, int nx, T alpha, int k, int tl, int w,
    int s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_lines = kXHalf ? ny : nx;
  const int n = kXHalf ? nx : ny;
  // the bin runs fastest, so consecutive blocks share plane rows
  const int b = blockIdx.x % nb;
  const int tile = blockIdx.x / nb;
  FusedPolicy<T, kXHalf> pol;
  pol.u = u;
  pol.out = out;
  pol.elo = elo;
  pol.ehi = ehi;
  pol.ediag = ediag;
  pol.src = src;
  pol.slo = slo;
  pol.shi = shi;
  pol.sdiag = sdiag;
  pol.plane = static_cast<long long>(b) * ny * nx;
  pol.pplane = static_cast<long long>(nbp > 1 ? b : 0) * ny * nx;
  pol.as = alpha * scale[b];
  pol.nx = nx;
  pol.n = n;
  pol.n_lines = n_lines;
  pol.line0 = tile * tl;
  const int m = (n + k - 1) / k;
  pol.k = k;
  pol.m = m;
  pol.tl = tl;
  const qp_adi::Staging g{n, k, m, s, tl, w};
  qp_adi::solve_lines<kXHalf>(pol, g, reinterpret_cast<T*>(smem_raw));
}

// The plan for lines of n in *k Wang chunks (raised where one chunk does
// not fit in shared memory); *k is the K launched.
template <typename T, bool kXHalf>
bool plan_of(int nb, int ny, int nx, int* k, qp_adi::Plan* plan) {
  using P = FusedPolicy<T, kXHalf>;
  return qp_adi::make_plan_raising_k(kXHalf, kXHalf ? nx : ny, kXHalf ? ny : nx, nb, k,
                                     kXHalf ? P::kArrays : P::kKept, P::kSlots, P::kTable,
                                     sizeof(T), kMaxThreads, plan);
}

template <typename T, bool kXHalf>
int launch(const T* u, T* out, const T* p0, const T* p1, const T* p2, const T* src,
           const T* q0, const T* q1, const T* q2, const T* scale, int nb, int nbp, int ny,
           int nx, int k, double alpha, void* stream) {
  const int n = kXHalf ? nx : ny;
  if (k < 1 || k > n) return static_cast<int>(cudaErrorInvalidValue);
  if (nb > 0 && ny > 0 && nx > 0) {
    qp_adi::Plan plan;
    if (!plan_of<T, kXHalf>(nb, ny, nx, &k, &plan)) return static_cast<int>(cudaErrorInvalidValue);
    static int granted = 0;
    const cudaError_t err = qp_adi::allow_smem(adi_kernel<T, kXHalf>, plan.smem, &granted);
    if (err != cudaSuccess) return static_cast<int>(err);
    adi_kernel<T, kXHalf><<<plan.blocks, plan.tl * plan.w, plan.smem,
                            static_cast<cudaStream_t>(stream)>>>(
        u, out, p0, p1, p2, src, q0, q1, q2, scale, nb, nbp, ny, nx, static_cast<T>(alpha), k,
        plan.tl, plan.w, plan.s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).  The x half takes the y planes
// (lo, hi, diag), the source and the x planes; the y half the x planes,
// the source and the y planes; k is the Wang chunk count asked for (1 ≤ k
// ≤ the line length).  Each returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a k out of range; the Python wrapper raises
// when it is not 0.
#define QP_ADI_ENTRY(NAME, T, XHALF)                                                      \
  extern "C" int NAME(const T* in, T* out, const T* p0, const T* p1, const T* p2,         \
                      const T* src, const T* q0, const T* q1, const T* q2, const T* scale, \
                      int nb, int nbp, int ny, int nx, int k, double alpha, void* stream) { \
    return launch<T, XHALF>(in, out, p0, p1, p2, src, q0, q1, q2, scale, nb, nbp, ny, nx, k, \
                            alpha, stream);                                               \
  }

QP_ADI_ENTRY(qp_adi_x_f32, float, true)
QP_ADI_ENTRY(qp_adi_x_f64, double, true)
QP_ADI_ENTRY(qp_adi_y_f32, float, false)
QP_ADI_ENTRY(qp_adi_y_f64, double, false)

// The launch plan of one half for k Wang chunks asked for: {lines per
// block, chunks held at once, pitch, shared bytes per block, blocks, waves,
// K launched}; returns 0, or cudaErrorInvalidValue when the kernel does
// not take the shape.
extern "C" int qp_adi_plan(int x_half, int elem_bytes, int nb, int ny, int nx, int k, int* out) {
  qp_adi::Plan p;
  bool ok;
  if (elem_bytes == 4) {
    ok = x_half ? plan_of<float, true>(nb, ny, nx, &k, &p) : plan_of<float, false>(nb, ny, nx, &k, &p);
  } else {
    ok = x_half ? plan_of<double, true>(nb, ny, nx, &k, &p)
                : plan_of<double, false>(nb, ny, nx, &k, &p);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int vals[7] = {p.tl, p.w, p.s, p.smem, p.blocks, p.waves, k};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}
