// Fischer–Catelani collision substep for Hopper: one thread per pixel.
//
// Replaces: qpsim_tpu/ops/pallas_collisions.py, build_pallas_collision_step
// and its kernel _make_kernel (uniform gap, G = 1), including the fused
// forward-Euler generation pre-add (gen_input=True).  What it computes is
// the plain integrator qpsim_tpu/ops/collisions.py (make_collision_step,
// chunk_update) for one pixel:
//   f = q / max(ρ, 1e-30),  partner = ρ·max(1 − f, 0)
//   scattering:  loss_i += Σ_j dE·K^s₀[i,j]·N[i,j]·partner_j
//                gain_i += partner_i·Σ_j dE·K^s₀[j,i]·N[j,i]·q_j
//                (N = 1 + n_ph for emission, n_ph for absorption, at the
//                pair's ω row idx_diff)
//   recombination / pair breaking at ω row idx_sum, S = n_ph:
//                loss_i += Σ_j 2dE·K^r₀[i,j]·(1 + S)·q_j
//                gain_i += partner_i·Σ_j 2dE·K^r₀[i,j]·S·partner_j
//   q⁺ = e^{−μdt}q + (−expm1(−μdt)/μ)·max(gain + (μ − loss)q, 0), μ = max(loss, 0)
//   phonons, per ω row w: a = Σ emission + recombination rates,
//                         b = a − Σ absorption + pair-breaking rates,
//   n_ph⁺ = max(e^{x}·n_ph + (expm1(x)/b)·a, 0), x = clip(b·dt, ±80).
// expm1 is CUDA's own (the TPU kernel needed a Taylor substitute).  The
// physics arrives as small device tables (ρ, dE·K^s₀, 2dE·K^r₀, idx_diff,
// idx_sum, sign(E_i − E_j) and a per-ω-row list of the pairs that land on
// it), not as compile-time constants, so one build serves every setting.
//
// Design: one thread per pixel on the (NE, P) layout with the pixel index
// fastest, so every state load and store is coalesced.  The thread keeps
// q and partner of its pixel in local arrays (NE ≤ 64), walks the ordered
// (i, j) pairs once for the QP update (gain and loss of bin i are gathered,
// so no per-bin accumulator array exists), then walks each ω row's pair
// list for that row's a and b (so no per-ω accumulator array exists
// either) and writes the row.  The outputs are separate buffers: the
// phonon rates need the pre-update q.
//
// What bounds it on this card: arithmetic and L1 traffic of the NE² pair
// walk (≈ 4 table or state loads and ≈ 12 flops per pair, twice), not
// device memory: each state element is read about once and written once.
// The runtime-indexed q/partner arrays live in local memory (see the
// -Xptxas -v report).  Left for later: the unordered walk of the TPU kernel
// (pairs (i, j) and (j, i) share their ω row and products, ~1.5x fewer
// operations), tables in shared or constant memory, and the G ≤ 8 gap-id
// blend for piecewise gap maps.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kMaxBins = 64;

// max(x, 0) that propagates NaN like jnp.maximum / torch.clamp
template <typename T>
__device__ __forceinline__ T relu(T x) { return x < T(0) ? T(0) : x; }

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dexpm1(float x) { return expm1f(x); }
__device__ __forceinline__ double dexpm1(double x) { return expm1(x); }
__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
__device__ __forceinline__ double dabs(double x) { return fabs(x); }

// positivity-preserving exponential relaxation of dn/dt = gain − loss·n
template <typename T>
__device__ __forceinline__ T relax(T n, T gain, T loss, T dt) {
  const T floor = T(1e-14);
  const T mu = relu(loss);
  const T p_term = relu(gain + (mu - loss) * n);
  const T decay = dexp(-mu * dt);
  const T coeff = mu < floor ? dt : -dexpm1(-mu * dt) / (mu < floor ? floor : mu);
  return relu(decay * n + coeff * p_term);
}

// exact frozen-coefficient solve of y' = a + b·y, clamped non-negative
template <typename T>
__device__ __forceinline__ T affine(T y, T a, T b, T dt) {
  T x = b * dt;
  x = x < T(-80) ? T(-80) : (x > T(80) ? T(80) : x);
  const bool tiny = dabs(b) < T(1e-14);
  const T coeff = tiny ? dt : dexpm1(x) / b;
  return relu(dexp(x) * y + coeff * a);
}

template <typename T>
__global__ void __launch_bounds__(kBlock) collision_step_kernel(
    const T* __restrict__ q_in, const T* __restrict__ ph_in, const T* __restrict__ gen,
    T* __restrict__ q_out, T* __restrict__ ph_out, const T* __restrict__ rho,
    const T* __restrict__ ks, const T* __restrict__ kr,
    const int* __restrict__ idx_diff, const int* __restrict__ idx_sum,
    const signed char* __restrict__ sgn, const int* __restrict__ row_ptr,
    const int* __restrict__ row_code, int ne, int nw, long long n_pix, T dt,
    int update_phonons) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n_pix) return;

  T qv[kMaxBins];
  T pv[kMaxBins];
  for (int i = 0; i < ne; ++i) {
    T qi = q_in[i * n_pix + p];
    if (gen != nullptr) qi += gen[p];  // fused forward-Euler n += dt·g
    const T r = rho[i];
    const T f = qi / (r > T(1e-30) ? r : T(1e-30));
    qv[i] = qi;
    pv[i] = r * relu(T(1) - f);
  }

  for (int i = 0; i < ne; ++i) {
    T gain_s = T(0), loss_s = T(0), gain_r = T(0), loss_r = T(0);
    for (int j = 0; j < ne; ++j) {
      const int ij = i * ne + j;
      if (ks != nullptr) {
        const int ji = j * ne + i;
        const signed char s_ij = sgn[ij];
        if (s_ij != 0) {
          const T n = ph_in[idx_diff[ij] * n_pix + p];
          loss_s += ks[ij] * (s_ij > 0 ? T(1) + n : n) * pv[j];
        }
        const signed char s_ji = sgn[ji];
        if (s_ji != 0) {
          const T n = ph_in[idx_diff[ji] * n_pix + p];
          gain_s += ks[ji] * (s_ji > 0 ? T(1) + n : n) * qv[j];
        }
      }
      if (kr != nullptr) {
        const T s = ph_in[idx_sum[ij] * n_pix + p];
        loss_r += kr[ij] * (T(1) + s) * qv[j];
        gain_r += kr[ij] * s * pv[j];
      }
    }
    const T gain = pv[i] * gain_s + pv[i] * gain_r;
    q_out[i * n_pix + p] = relax(qv[i], gain, loss_s + loss_r, dt);
  }

  if (!update_phonons) return;
  for (int w = 0; w < nw; ++w) {
    T a = T(0), b = T(0);
    for (int e = row_ptr[w]; e < row_ptr[w + 1]; ++e) {
      // code = pair·4 + kind; kind 0 emission, 1 absorption, 2 recombination
      const int code = row_code[e];
      const int pair = code >> 2;
      const int kind = code & 3;
      const int i = pair / ne;
      const int j = pair - i * ne;
      if (kind == 2) {
        const T k = T(0.5) * kr[pair];  // dE·K^r₀ from the 2dE table (exact)
        const T rec = k * qv[i] * qv[j];
        a += rec;
        b += rec - k * pv[i] * pv[j];
      } else {
        const T v = ks[pair] * qv[i] * pv[j];
        if (kind == 0) {
          a += v;
          b += v;
        } else {
          b -= v;
        }
      }
    }
    ph_out[w * n_pix + p] = affine(ph_in[w * n_pix + p], a, b, dt);
  }
}

template <typename T>
int launch(const T* q_in, const T* ph_in, const T* gen, T* q_out, T* ph_out,
           const T* rho, const T* ks, const T* kr, const int* idx_diff,
           const int* idx_sum, const signed char* sgn, const int* row_ptr,
           const int* row_code, int ne, int nw, long long n_pix, double dt,
           int update_phonons, void* stream) {
  if (ne > kMaxBins) return static_cast<int>(cudaErrorInvalidValue);
  if (n_pix > 0) {
    const long long blocks = (n_pix + kBlock - 1) / kBlock;
    collision_step_kernel<T><<<static_cast<unsigned int>(blocks), kBlock, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        q_in, ph_in, gen, q_out, ph_out, rho, ks, kr, idx_diff, idx_sum, sgn, row_ptr,
        row_code, ne, nw, n_pix, static_cast<T>(dt), update_phonons);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).  ks / kr / gen may be null (channel
// off, no generation).  Returns cudaGetLastError() after the launch.
#define QP_COLLISION_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(const T* q_in, const T* ph_in, const T* gen, T* q_out,          \
                      T* ph_out, const T* rho, const T* ks, const T* kr,              \
                      const int* idx_diff, const int* idx_sum, const signed char* sgn, \
                      const int* row_ptr, const int* row_code, int ne, int nw,        \
                      long long n_pix, double dt, int update_phonons, void* stream) { \
    return launch<T>(q_in, ph_in, gen, q_out, ph_out, rho, ks, kr, idx_diff, idx_sum, \
                     sgn, row_ptr, row_code, ne, nw, n_pix, dt, update_phonons,       \
                     stream);                                                         \
  }

QP_COLLISION_ENTRY(qp_collision_step_f32, float)
QP_COLLISION_ENTRY(qp_collision_step_f64, double)
