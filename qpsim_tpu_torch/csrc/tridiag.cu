// Batched tridiagonal solve for Hopper (K10): T x = r along every line.
//
// Replaces: qpsim_tpu/ops/pallas_tridiag.py, _thomas_kernel (called by
// tridiag_solve_pallas).  sub at position 0 and sup at position n − 1 of a
// line are never read (they hold whatever the caller's arrays hold there,
// often the neighbouring line's couplings), so a line's ends are open and
// zero couplings inside it decouple its intervals exactly, as in the JAX
// kernel.
//
// Design: the shared-memory line solve of the ADI kernels (adi_staged.cuh,
// with K2's Wang stages, qp_adi::WangStages), on four general per-cell
// arrays read in place in one of two layouts; nothing is transposed and no
// elimination value goes to device memory (4 arrays in, 1 out).
//   rows: lines contiguous along the last axis, line L's position p at
//     L·n + p — the x half of the line solve: a block stages its TL lines
//     through shared memory with coalesced loads and writes the solution
//     back with coalesced stores.
//   cols: every array the movedim(−2, −1) view of a contiguous (lead, n,
//     B) tensor, position p of line j of lead index g at (g·n + p)·B + j —
//     the y half: a block owns TL adjacent lines of one lead index, and a
//     warp's loads down a chunk are TL-wide runs.
// One thread per (line, Wang chunk).  The chunk count is the caller's,
// raised as K2's and K7's are (to 32 on lines of 256 cells or more, and
// further where one chunk does not fit in shared memory), the last chunk
// padded with identity rows; at K = 1 the stages are the Thomas sweep.
// Lines too long for shared memory take the two-pass form.  Offsets are
// 64-bit: lines × n may pass 2³¹.
//
// What bounds it on this card: not bytes.  As in K2's x half and K7, the
// lines resident per SM (shared memory holds four staged values a cell in
// the rows form, three kept values in the cols form) and the sweeps'
// dependent steps, with the one-thread-per-line interface recurrence
// between them.

#include <cuda_runtime.h>

#include "adi_staged.cuh"

namespace {

constexpr int kMaxThreads = 256;  // TL·W threads per block

// The Wang stages on four general per-cell arrays.
template <typename T_, bool kRows>
struct TridiagPolicy : qp_adi::WangStages<T_> {
  using T = T_;

  const T* __restrict__ a;  // sub
  const T* __restrict__ b;  // diag
  const T* __restrict__ c;  // sup
  const T* __restrict__ r;  // rhs
  T* __restrict__ out;
  long long base;  // cols: offset of this block's lead index
  int n, n_lines, line0;

  __device__ __forceinline__ long long cell(int line, int p) const {
    return kRows ? static_cast<long long>(line) * n + p
                 : base + static_cast<long long>(p) * n_lines + line;
  }

  // no stencil: the rhs is read in fetch
  __device__ __forceinline__ T state(int, int) const { return T(0); }

  // v = (a, c, rhs, b) of position p of the block's line l; the line's
  // sub[0] and sup[n − 1] are read as zero
  __device__ __forceinline__ void fetch(int l, int p, T, T, T, T* v) const {
    const int line = line0 + l;
    if (line >= n_lines || p >= n) {  // an identity row
      v[0] = T(0);
      v[1] = T(0);
      v[2] = T(0);
      v[3] = T(1);
      return;
    }
    const long long q = cell(line, p);
    v[0] = p > 0 ? __ldg(a + q) : T(0);
    v[1] = p + 1 < n ? __ldg(c + q) : T(0);
    v[2] = __ldg(r + q);
    v[3] = __ldg(b + q);
  }

  __device__ __forceinline__ void store(T x, int l, int p) const {
    if (line0 + l < n_lines && p < n) out[cell(line0 + l, p)] = x;
  }
};

template <typename T, bool kRows>
__global__ void __launch_bounds__(kMaxThreads) thomas_kernel(
    const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ c,
    const T* __restrict__ r, T* __restrict__ x, int n, int n_lines, int k, int tl, int w, int s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the tile runs fastest: consecutive blocks read adjacent runs of a row
  const int tiles = (n_lines + tl - 1) / tl;
  const int tile = blockIdx.x % tiles;
  const int lead = blockIdx.x / tiles;
  TridiagPolicy<T, kRows> pol;
  pol.a = a;
  pol.b = b;
  pol.c = c;
  pol.r = r;
  pol.out = x;
  pol.base = static_cast<long long>(lead) * n * n_lines;
  pol.n = n;
  pol.n_lines = n_lines;
  pol.line0 = tile * tl;
  const int m = (n + k - 1) / k;
  pol.k = k;
  pol.m = m;
  pol.tl = tl;
  const qp_adi::Staging g{n, k, m, s, tl, w};
  qp_adi::solve_lines<kRows>(pol, g, reinterpret_cast<T*>(smem_raw));
}

// The plan for n_lines lines of n (rows: every line; cols: the lines of
// one of nb lead indices) in *k Wang chunks (raised where asked for fewer
// than 32 on a line of 256 cells or more, or where one chunk does not fit
// in shared memory); *k is the K launched.
template <typename T, bool kRows>
bool plan_of(int n, int n_lines, int nb, int* k, qp_adi::Plan* plan) {
  using P = TridiagPolicy<T, kRows>;
  return qp_adi::make_plan_raising_k(kRows, n, n_lines, nb, k, kRows ? P::kArrays : P::kKept,
                                     P::kSlots, P::kTable, sizeof(T), kMaxThreads, plan);
}

template <typename T, bool kRows>
int launch(const T* a, const T* b, const T* c, const T* r, T* x, int n, int n_lines, int nb,
           int k, void* stream) {
  if (k < 1 || k > n || nb < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_lines > 0) {
    qp_adi::Plan plan;
    if (!plan_of<T, kRows>(n, n_lines, nb, &k, &plan)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    static int granted = 0;
    const cudaError_t err = qp_adi::allow_smem(thomas_kernel<T, kRows>, plan.smem, &granted);
    if (err != cudaSuccess) return static_cast<int>(err);
    thomas_kernel<T, kRows><<<plan.blocks, plan.tl * plan.w, plan.smem,
                              static_cast<cudaStream_t>(stream)>>>(a, b, c, r, x, n, n_lines, k,
                                                                   plan.tl, plan.w, plan.s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).  cols = 0: `lines` contiguous
// lines of n (lead must be 1); cols = 1: `lead` × `lines` lines of n in the
// (lead, n, lines) layout.  k is the Wang chunk count asked for (1 ≤ k ≤
// n).  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments or a shape the kernel does not take;
// the Python wrapper raises when it is not 0.
#define QP_THOMAS_ENTRY(NAME, T)                                                              \
  extern "C" int NAME(const T* a, const T* b, const T* c, const T* r, T* x, int cols, int n,  \
                      int lines, int lead, int k, void* stream) {                             \
    if (!cols && lead != 1) return static_cast<int>(cudaErrorInvalidValue);                   \
    return cols ? launch<T, false>(a, b, c, r, x, n, lines, lead, k, stream)                  \
                : launch<T, true>(a, b, c, r, x, n, lines, 1, k, stream);                     \
  }

QP_THOMAS_ENTRY(qp_thomas_f32, float)
QP_THOMAS_ENTRY(qp_thomas_f64, double)

// The launch plan for k Wang chunks asked for: {lines per block, chunks
// held at once, pitch, shared bytes per block, blocks, waves, K launched};
// returns 0, or cudaErrorInvalidValue when the kernel does not take the
// shape.
extern "C" int qp_thomas_plan(int cols, int elem_bytes, int n, int lines, int lead, int k,
                              int* out) {
  if (k < 1 || k > n || lead < 1) return static_cast<int>(cudaErrorInvalidValue);
  qp_adi::Plan p;
  bool ok;
  if (elem_bytes == 4) {
    ok = cols ? plan_of<float, false>(n, lines, lead, &k, &p)
              : plan_of<float, true>(n, lines, 1, &k, &p);
  } else {
    ok = cols ? plan_of<double, false>(n, lines, lead, &k, &p)
              : plan_of<double, true>(n, lines, 1, &k, &p);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int vals[7] = {p.tl, p.w, p.s, p.smem, p.blocks, p.waves, k};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}
