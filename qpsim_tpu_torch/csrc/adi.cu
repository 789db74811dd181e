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
// Design: one thread per line.  It forms the rhs and the coefficients of
// its line on the fly and runs a Thomas sweep; c′ goes to a scratch array
// from the wrapper and d′ to the output, which the back substitution then
// overwrites in place.  The intermediate u* stays in the natural
// (NB, Ny, Nx) layout.
//
// What bounds it on this card: device-memory traffic (the state is read
// and written once per half, the planes broadcast over bins), and, at
// this simple design, latency: the sweep is sequential along each line.
//   * x half: neighbouring threads own lines Nx apart, so every load and
//     store is uncoalesced (one 32-byte sector per thread per element).
//   * only NB·Ny (or NB·Nx) lines exist — 16 K at 1024²×16 — far below the
//     card's resident-thread count, so the sweeps cannot hide latency.
// Left for later: a swapped layout or shared-memory transpose for the x
// half, and the TPU kernel's Wang K-chunk partition (lines × K independent
// sweeps) to fill the card.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;

// x half: line = (b, y), the sweep walks x.
template <typename T>
__global__ void __launch_bounds__(kBlock) adi_x_kernel(
    const T* __restrict__ u, T* __restrict__ out, T* __restrict__ wscr,
    const T* __restrict__ ylo, const T* __restrict__ yhi, const T* __restrict__ ydiag,
    const T* __restrict__ src, const T* __restrict__ xlo, const T* __restrict__ xhi,
    const T* __restrict__ xdiag, const T* __restrict__ scale,
    int nb, int nbp, int ny, int nx, T alpha) {
  const int line = blockIdx.x * blockDim.x + threadIdx.x;
  if (line >= nb * ny) return;
  const int b = line / ny;
  const int y = line - b * ny;
  const long long row = static_cast<long long>(line) * nx;
  const long long prow = (static_cast<long long>(nbp > 1 ? b : 0) * ny + y) * nx;
  const T as = alpha * scale[b];
  T w_prev = T(0), g_prev = T(0);
  for (int x = 0; x < nx; ++x) {
    const long long i = row + x;
    const long long k = prow + x;
    const T uc = u[i];
    // the y neighbours outside the grid meet zero coefficients
    const T up = y > 0 ? u[i - nx] : T(0);
    const T dn = y + 1 < ny ? u[i + nx] : T(0);
    const T rhs = uc + as * (ylo[k] * up + yhi[k] * dn + ydiag[k] * uc + src[k]);
    const T a = x > 0 ? -as * xlo[k] : T(0);
    const T c = x + 1 < nx ? -as * xhi[k] : T(0);
    const T inv = T(1) / ((T(1) - as * xdiag[k]) - a * w_prev);
    w_prev = c * inv;
    g_prev = (rhs - a * g_prev) * inv;
    wscr[i] = w_prev;
    out[i] = g_prev;
  }
  T x_next = g_prev;
  for (int x = nx - 2; x >= 0; --x) {
    const long long i = row + x;
    x_next = out[i] - wscr[i] * x_next;
    out[i] = x_next;
  }
}

// y half: line = (b, x), the sweep walks y; neighbouring threads touch
// neighbouring addresses.
template <typename T>
__global__ void __launch_bounds__(kBlock) adi_y_kernel(
    const T* __restrict__ v, T* __restrict__ out, T* __restrict__ wscr,
    const T* __restrict__ xlo, const T* __restrict__ xhi, const T* __restrict__ xdiag,
    const T* __restrict__ src, const T* __restrict__ ylo, const T* __restrict__ yhi,
    const T* __restrict__ ydiag, const T* __restrict__ scale,
    int nb, int nbp, int ny, int nx, T alpha) {
  const int line = blockIdx.x * blockDim.x + threadIdx.x;
  if (line >= nb * nx) return;
  const int b = line / nx;
  const int x = line - b * nx;
  const long long base = static_cast<long long>(b) * ny * nx + x;
  const long long pbase = static_cast<long long>(nbp > 1 ? b : 0) * ny * nx + x;
  const T as = alpha * scale[b];
  T w_prev = T(0), g_prev = T(0);
  for (int y = 0; y < ny; ++y) {
    const long long i = base + static_cast<long long>(y) * nx;
    const long long k = pbase + static_cast<long long>(y) * nx;
    const T vc = v[i];
    const T lf = x > 0 ? v[i - 1] : T(0);
    const T rt = x + 1 < nx ? v[i + 1] : T(0);
    const T rhs = vc + as * (xlo[k] * lf + xhi[k] * rt + xdiag[k] * vc + src[k]);
    const T a = y > 0 ? -as * ylo[k] : T(0);
    const T c = y + 1 < ny ? -as * yhi[k] : T(0);
    const T inv = T(1) / ((T(1) - as * ydiag[k]) - a * w_prev);
    w_prev = c * inv;
    g_prev = (rhs - a * g_prev) * inv;
    wscr[i] = w_prev;
    out[i] = g_prev;
  }
  T x_next = g_prev;
  for (int y = ny - 2; y >= 0; --y) {
    const long long i = base + static_cast<long long>(y) * nx;
    x_next = out[i] - wscr[i] * x_next;
    out[i] = x_next;
  }
}

template <typename T>
int launch_x(const T* u, T* out, T* w, const T* ylo, const T* yhi, const T* ydiag,
             const T* src, const T* xlo, const T* xhi, const T* xdiag, const T* scale,
             int nb, int nbp, int ny, int nx, double alpha, void* stream) {
  const int lines = nb * ny;
  if (lines > 0) {
    adi_x_kernel<T><<<(lines + kBlock - 1) / kBlock, kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        u, out, w, ylo, yhi, ydiag, src, xlo, xhi, xdiag, scale, nb, nbp, ny, nx,
        static_cast<T>(alpha));
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_y(const T* v, T* out, T* w, const T* xlo, const T* xhi, const T* xdiag,
             const T* src, const T* ylo, const T* yhi, const T* ydiag, const T* scale,
             int nb, int nbp, int ny, int nx, double alpha, void* stream) {
  const int lines = nb * nx;
  if (lines > 0) {
    adi_y_kernel<T><<<(lines + kBlock - 1) / kBlock, kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        v, out, w, xlo, xhi, xdiag, src, ylo, yhi, ydiag, scale, nb, nbp, ny, nx,
        static_cast<T>(alpha));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each returns cudaGetLastError()
// after the launch; the Python wrapper raises when it is not 0.
#define QP_ADI_ENTRY(NAME, LAUNCH, T)                                              \
  extern "C" int NAME(const T* in, T* out, T* w, const T* p0, const T* p1,         \
                      const T* p2, const T* src, const T* q0, const T* q1,         \
                      const T* q2, const T* scale, int nb, int nbp, int ny, int nx, \
                      double alpha, void* stream) {                                \
    return LAUNCH<T>(in, out, w, p0, p1, p2, src, q0, q1, q2, scale, nb, nbp, ny,  \
                     nx, alpha, stream);                                           \
  }

QP_ADI_ENTRY(qp_adi_x_f32, launch_x, float)
QP_ADI_ENTRY(qp_adi_x_f64, launch_x, double)
QP_ADI_ENTRY(qp_adi_y_f32, launch_y, float)
QP_ADI_ENTRY(qp_adi_y_f64, launch_y, double)
