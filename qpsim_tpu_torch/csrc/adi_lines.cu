// One-direction Crank–Nicolson line solve for Hopper: (I − α·s_b·L) x = rhs
// along the middle axis of an (NB, N, B) array, B lines per bin.
//
// adi_lines_kernel (K7) replaces qpsim_tpu/ops/pallas_adi.py,
// solve_lines_pallas and its two kernels: _make_wang_kernel (the Wang
// K-chunk partition, K > 1) and _make_kernel (Thomas, K = 1).  The
// coefficients are formed in the kernel from the geometry planes lo/di/hi
// (NBp = 1 shared or NBp = NB per bin) × the bin's scale, as there:
//   a_i = −α·s·lo_i,  b_i = 1 − α·s·di_i,  c_i = −α·s·hi_i.
// The recurrences are the TPU kernel's (_wang_stages), in its order, so a
// zero coupling row cuts an interval exactly; at K = 1 they reduce to the
// Thomas sweep.  build_adi_step (ops/adi_cuda.py) calls it twice per step,
// on the swapped layout for the x lines and the natural one for the y
// lines.
//
// Design: the y half of the staged line solve (adi_staged.cuh, with K2's
// Wang stages, qp_adi::WangStages): the B lines of a row lie side by side,
// as K2's columns do, so a block owns TL adjacent lines of one bin with one
// thread per (line, chunk), reads each row of its chunk from device memory
// as the forward sweep walks it (a warp reads TL-wide runs), keeps A′, C′
// and D in shared memory, and writes the solution as its last sweep walks
// it.  The chunk count is the caller's, raised as K2's is (to 32 on lines
// of 256 cells or more, and where a chunk does not fit in shared memory),
// the last chunk padded with identity rows.
// The TPU kernel's lane padding to 128 and its chunk-major VMEM relayout
// are layout artefacts: any B works here.
//
// What bounds it on this card: as K2's y half, the lines resident per SM
// (shared memory holds the three kept values of every cell of a line) and
// the sweeps' dependent steps, not bytes.

#include <cuda_runtime.h>

#include "adi_staged.cuh"

namespace {

constexpr int kMaxThreads = 256;  // TL·W threads per block

// The Wang stages on coefficients formed from the planes; the rhs is given.
template <typename T_>
struct LinesPolicy : qp_adi::WangStages<T_> {
  using T = T_;

  const T* __restrict__ rhs;
  T* __restrict__ out;
  const T* __restrict__ lo;
  const T* __restrict__ di;
  const T* __restrict__ hi;
  long long plane, pplane;  // offsets of this bin's rhs and planes
  T neg_as, as;
  int n, batch, line0;

  __device__ __forceinline__ long long cell(int line, int p) const {
    return static_cast<long long>(p) * batch + line;
  }

  // no stencil: the rhs is read in fetch
  __device__ __forceinline__ T state(int, int) const { return T(0); }

  // v = (a, c, rhs, b) of position p of the block's line l
  __device__ __forceinline__ void fetch(int l, int p, T, T, T, T* v) const {
    const int line = line0 + l;
    if (line >= batch || p >= n) {  // an identity row
      v[0] = T(0);
      v[1] = T(0);
      v[2] = T(0);
      v[3] = T(1);
      return;
    }
    const long long q = cell(line, p);
    v[2] = __ldg(rhs + plane + q);
    v[0] = neg_as * __ldg(lo + pplane + q);
    v[1] = neg_as * __ldg(hi + pplane + q);
    v[3] = T(1) - as * __ldg(di + pplane + q);
  }

  __device__ __forceinline__ void store(T x, int l, int p) const {
    if (line0 + l < batch && p < n) out[plane + cell(line0 + l, p)] = x;
  }
};

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) adi_lines_kernel(
    const T* __restrict__ rhs, const T* __restrict__ lo, const T* __restrict__ di,
    const T* __restrict__ hi, const T* __restrict__ scale, T* __restrict__ out, int nb, int nbp,
    int n, int batch, int k, T alpha, int tl, int w, int s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the bin runs fastest, so with one shared plane set consecutive blocks
  // read the same plane rows
  const int b = blockIdx.x % nb;
  const int tile = blockIdx.x / nb;
  const int m = (n + k - 1) / k;
  LinesPolicy<T> pol;
  pol.rhs = rhs;
  pol.out = out;
  pol.lo = lo;
  pol.di = di;
  pol.hi = hi;
  pol.plane = static_cast<long long>(b) * n * batch;
  pol.pplane = static_cast<long long>(nbp > 1 ? b : 0) * n * batch;
  pol.as = alpha * scale[b];
  pol.neg_as = -pol.as;
  pol.n = n;
  pol.batch = batch;
  pol.line0 = tile * tl;
  pol.k = k;
  pol.m = m;
  pol.tl = tl;
  const qp_adi::Staging g{n, k, m, s, tl, w};
  qp_adi::solve_lines<false>(pol, g, reinterpret_cast<T*>(smem_raw));
}

template <typename T>
int launch(const T* rhs, const T* lo, const T* di, const T* hi, const T* scale, T* out, int nb,
           int nbp, int n, int batch, int k, double alpha, void* stream) {
  if (k < 1 || k > kMaxThreads || n < 1 || n % k != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nb > 0 && batch > 0) {
    using P = LinesPolicy<T>;
    qp_adi::Plan plan;
    if (!qp_adi::make_plan_raising_k(false, n, batch, nb, &k, P::kKept, P::kSlots, P::kTable,
                                     sizeof(T), kMaxThreads, &plan)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    static int granted = 0;
    const cudaError_t err = qp_adi::allow_smem(adi_lines_kernel<T>, plan.smem, &granted);
    if (err != cudaSuccess) return static_cast<int>(err);
    adi_lines_kernel<T><<<plan.blocks, plan.tl * plan.w, plan.smem,
                          static_cast<cudaStream_t>(stream)>>>(
        rhs, lo, di, hi, scale, out, nb, nbp, n, batch, k, static_cast<T>(alpha), plan.tl, plan.w,
        plan.s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a chunk count the kernel does not
// take (K must divide N, 1 ≤ K ≤ 256).
#define QP_ADI_LINES_ENTRY(NAME, T)                                                             \
  extern "C" int NAME(const T* rhs, const T* lo, const T* di, const T* hi, const T* scale,      \
                      T* out, int nb, int nbp, int n, int batch, int k, double alpha,           \
                      void* stream) {                                                           \
    return launch<T>(rhs, lo, di, hi, scale, out, nb, nbp, n, batch, k, alpha, stream);         \
  }

QP_ADI_LINES_ENTRY(qp_adi_lines_f32, float)
QP_ADI_LINES_ENTRY(qp_adi_lines_f64, double)
