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
// Thomas sweep x_i = g_i − w_i·x_{i+1}.  build_adi_step
// (ops/adi_cuda.py) calls it twice per step, on the swapped layout for the
// x lines and the natural one for the y lines.
//
// Design: one thread per (line, chunk).  A block holds TL = 256/K lines ×
// K chunks; threadIdx.x runs over lines, so at every row of a sweep a warp
// reads 32 adjacent lines (coalesced: the layout keeps the B lines of a row
// side by side).  Each thread eliminates its chunk of M = N/K rows: the
// forward sweep (stage 1) writes A′, C′ to two scratch arrays and D′ to the
// output, the backward sweep (stage 2) turns them into x_i = D_i − A_i·X_L
// − C_i·X_R in place.  The chunks' boundary rows meet in shared memory,
// where one thread per line runs the 2K-unknown interface recurrence
// (stage 3), as K1 (adi_sep.cu) does; then every thread applies its
// neighbours' boundary values to its chunk (stage 4).  The TPU kernel's
// lane padding to 128 and its chunk-major VMEM relayout are layout
// artefacts: any B works here.
//
// What bounds it on this card: device memory — rhs and the three planes
// read once, the solution written once — against which the scratch round
// trips of A′, C′ and D′ (K > 1) add about twice the state's traffic; and
// latency where the lines are few: each thread walks M dependent rows three
// times.  Left for later: keeping a chunk in registers or shared memory
// instead of the scratch arrays.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // TL·K threads per block

template <typename T>
__global__ void __launch_bounds__(kThreads) adi_lines_kernel(
    const T* __restrict__ rhs, const T* __restrict__ lo, const T* __restrict__ di,
    const T* __restrict__ hi, const T* __restrict__ scale, T* __restrict__ out,
    T* __restrict__ a_scr, T* __restrict__ c_scr, int nbp, int n, int batch, int k, T alpha) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tl = blockDim.x;
  // boundary rows of each chunk: [aL, cL, dL, aR, cR, dR][K][TL]
  T* s = reinterpret_cast<T*>(smem_raw);
  const int slots = k * tl;
  T *s_al = s, *s_cl = s + slots, *s_dl = s + 2 * slots;
  T *s_ar = s + 3 * slots, *s_cr = s + 4 * slots, *s_dr = s + 5 * slots;
  const int l = threadIdx.x;
  const int c = threadIdx.y;
  const int bin = blockIdx.y;
  const long long line = static_cast<long long>(blockIdx.x) * tl + l;
  const bool active = line < batch;
  const bool wang = k > 1;
  const int m = n / k;
  const long long B = batch;
  const long long base = static_cast<long long>(bin) * n * B + line;
  const long long pbase = static_cast<long long>(nbp > 1 ? bin : 0) * n * B + line;
  const T as = alpha * scale[bin];
  const T neg_as = -as;
  const int slot = c * tl + l;

  T al = T(0), cl = T(0), dl = T(0), ar = T(0), cr = T(0), dr = T(0);
  if (active) {
    const int r0 = c * m;
    // stage 1: forward elimination of the sub-diagonal within the chunk
    long long at = static_cast<long long>(r0) * B;
    T inv = T(1) / (T(1) - as * di[pbase + at]);
    T cp = neg_as * hi[pbase + at] * inv;
    T ap = neg_as * lo[pbase + at] * inv;  // X_L enters row 0 with weight a_0
    T dp = rhs[base + at] * inv;
    c_scr[base + at] = cp;
    if (wang) a_scr[base + at] = ap;
    out[base + at] = dp;
    for (int i = 1; i < m; ++i) {
      at = static_cast<long long>(r0 + i) * B;
      const T a_i = neg_as * lo[pbase + at];
      inv = T(1) / (T(1) - as * di[pbase + at] - a_i * cp);
      cp = neg_as * hi[pbase + at] * inv;
      if (wang) ap = -a_i * ap * inv;
      dp = (rhs[base + at] - a_i * dp) * inv;
      c_scr[base + at] = cp;
      if (wang) a_scr[base + at] = ap;
      out[base + at] = dp;
    }
    // stage 2: backward elimination of the super-diagonal; row m − 1 is
    // already final (its c′ couples X_R)
    ar = ap;
    cr = cp;
    dr = dp;
    T c_n = cp, a_n = ap, d_n = dp;
    for (int i = m - 2; i >= 0; --i) {
      at = static_cast<long long>(r0 + i) * B;
      const T cp_i = c_scr[base + at];
      d_n = out[base + at] - cp_i * d_n;
      out[base + at] = d_n;
      if (wang) {
        c_n = -cp_i * c_n;
        a_n = a_scr[base + at] - cp_i * a_n;
        c_scr[base + at] = c_n;
        a_scr[base + at] = a_n;
      }
    }
    al = a_n;
    cl = c_n;
    dl = d_n;
  }
  if (!wang) return;  // Thomas: the backward sweep wrote x; no barrier follows

  s_al[slot] = al;
  s_cl[slot] = cl;
  s_dl[slot] = dl;
  s_ar[slot] = ar;
  s_cr[slot] = cr;
  s_dr[slot] = dr;
  __syncthreads();
  if (c == 0 && active) {
    // stage 3: the interface recurrence of this line, p_j and q_j into the
    // dL and cL slots, g_j and w_j into dR and cR; then L_j into dL, R_j into dR
    T g = T(0), w = T(0);
    for (int j = 0; j < k; ++j) {
      const int at = j * tl + l;
      const T a_l = s_al[at], a_r = s_ar[at];
      const T inv = T(1) / (T(1) - a_l * w);
      const T p = (s_dl[at] - a_l * g) * inv;
      const T q = s_cl[at] * inv;
      g = s_dr[at] - a_r * g + a_r * w * p;
      w = s_cr[at] + a_r * w * q;
      s_dl[at] = p;
      s_cl[at] = q;
      s_dr[at] = g;
      s_cr[at] = w;
    }
    T l_next = T(0);
    for (int j = k - 1; j >= 0; --j) {
      const int at = j * tl + l;
      const T lj = s_dl[at] - s_cl[at] * l_next;
      s_dr[at] = s_dr[at] - s_cr[at] * l_next;
      s_dl[at] = lj;
      l_next = lj;
    }
  }
  __syncthreads();
  if (!active) return;
  // stage 4: x_i = D_i − A_i·R_{c−1} − C_i·L_{c+1}
  const T x_left = c > 0 ? s_dr[slot - tl] : T(0);
  const T x_right = c + 1 < k ? s_dl[slot + tl] : T(0);
  for (int i = 0; i < m; ++i) {
    const long long at = base + static_cast<long long>(c * m + i) * B;
    out[at] = out[at] - a_scr[at] * x_left - c_scr[at] * x_right;
  }
}

template <typename T>
int launch(const T* rhs, const T* lo, const T* di, const T* hi, const T* scale, T* out, T* a_scr,
           T* c_scr, int nb, int nbp, int n, int batch, int k, double alpha, void* stream) {
  if (k < 1 || k > kThreads || n < 1 || n % k != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nb > 0 && batch > 0) {
    const int tl = kThreads / k;
    const dim3 grid(static_cast<unsigned int>((batch + tl - 1) / tl), nb);
    const dim3 block(tl, k);
    const size_t smem = k > 1 ? 6 * static_cast<size_t>(tl) * k * sizeof(T) : 0;
    adi_lines_kernel<T><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
        rhs, lo, di, hi, scale, out, a_scr, c_scr, nbp, n, batch, k, static_cast<T>(alpha));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).  a_scr and c_scr are (NB, N, B)
// scratch arrays from the wrapper (a_scr unused at K = 1).  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a chunk
// count the kernel does not take (K must divide N, 1 ≤ K ≤ 256).
#define QP_ADI_LINES_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(const T* rhs, const T* lo, const T* di, const T* hi, const T* scale,   \
                      T* out, T* a_scr, T* c_scr, int nb, int nbp, int n, int batch, int k,  \
                      double alpha, void* stream) {                                          \
    return launch<T>(rhs, lo, di, hi, scale, out, a_scr, c_scr, nb, nbp, n, batch, k, alpha, \
                     stream);                                                                \
  }

QP_ADI_LINES_ENTRY(qp_adi_lines_f32, float)
QP_ADI_LINES_ENTRY(qp_adi_lines_f64, double)
