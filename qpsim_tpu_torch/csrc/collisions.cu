// Fischer–Catelani collision substep for Hopper: one thread per pixel.
//
// Two kernels share this file's update rules and ω-row walk:
//
// collision_step_kernel<T, kGapIds> (K3) replaces
// qpsim_tpu/ops/pallas_collisions.py, build_pallas_collision_step and its
// kernel _make_kernel, including the per-pixel gap-id blend of piecewise
// gap maps (G ≤ 8 unique gaps) and the fused forward-Euler generation
// pre-add (gen_input=True).  What it computes is the plain integrator
// qpsim_tpu/ops/collisions.py (make_collision_step, chunk_update) for one
// pixel:
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
// The physics arrives as small device tables (ρ, dE·K^s₀, 2dE·K^r₀ per gap,
// idx_diff, idx_sum, sign(E_i − E_j) and a per-ω-row list of the pairs that
// land on it), not as compile-time constants, so one build serves every
// setting.  With kGapIds each pixel reads its gap id (uint8) once and
// indexes the per-gap tables at g·NE + i and g·NE² + ij; the ω maps and
// row lists depend only on E_bins and are shared by all gaps.  The TPU
// kernel blends its baked per-gap constants with G − 1 lane selects and
// sends G > 1 at NE 33–64 to its blocked kernel, because Mosaic's compile
// time grows with NE²; tables in device memory have no such cap, so this
// kernel takes G ≤ 8 up to NE = 64.
//
// collision_step_analytic_kernel<T> (K4) replaces pallas_collisions.py,
// build_pallas_collision_step_analytic and its kernel
// _make_analytic_kernel: the same substep for continuous gap maps (any
// number of distinct gaps), from the pixel's Δ² instead of per-gap tables.
// K^s₀ = a_s·max(1 − Δ²/(E_iE_j), 0) and K^r₀ = a_r·(1 + Δ²/(E_iE_j)) are
// affine in Δ², so dE·K^s₀ = max(dE·a_s − dE·b_s·Δ², 0) and
// 2dE·K^r₀ = 2dE·a_r + 2dE·b_r·Δ² from four (NE, NE) tables built in
// float64, and the Dynes ρ and 1/ρ are closed forms of Δ²:
//   γ = 0:  r2 = E² − Δ², ρ = E·rsqrt(r2), 1/ρ = r2·rsqrt(r2)/E (0 where r2 ≤ 0)
//   γ > 0:  z = (E² − γ² − Δ²) − 2iEγ, principal root s + it,
//           ρ = max((E·s − γ·t)/|z|, 0), 1/ρ = 1/ρ where ρ > 1e-30
// in the same order as the plain version (ops/collisions.py, analytic_rho)
// so the float32 comparison measures the kernel and not the formula
// (E² − Δ² cancels near the threshold).  Partner = ρ·max(1 − q·(1/ρ), 0).
//
// The update rules and the closed-form ρ live in collision_math.cuh, shared
// with the column walk (offset_walk.cu: K5, K6, K8, K9).  expm1 is CUDA's own
// (the TPU kernels needed a Taylor substitute).
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
// What bounds them on this card: arithmetic and L1 traffic of the NE² pair
// walk (≈ 4 table or state loads and ≈ 12 flops per pair, twice; K4 adds
// 2–3 flops per pair for its constants), not device memory: each state
// element is read about once and written once.  The runtime-indexed
// q/partner arrays live in local memory (see the -Xptxas -v report).  With
// gap ids, neighbouring pixels of a warp may read different tables, which
// splits the table loads of a warp.  Left for later: the unordered walk of
// the TPU kernels (pairs (i, j) and (j, i) share their ω row and products,
// ~1.5x fewer operations) and tables in shared or constant memory.

#include <cuda_runtime.h>

#include "collision_math.cuh"

namespace {

using qpsim::affine;
using qpsim::analytic_rho;
using qpsim::relax;
using qpsim::relu;

constexpr int kBlock = 128;
constexpr int kMaxBins = 64;

template <typename T, bool kGapIds>
__global__ void __launch_bounds__(kBlock) collision_step_kernel(
    const T* __restrict__ q_in, const T* __restrict__ ph_in, const T* __restrict__ gen,
    T* __restrict__ q_out, T* __restrict__ ph_out, const unsigned char* __restrict__ gid,
    const T* __restrict__ rho, const T* __restrict__ ks, const T* __restrict__ kr,
    const int* __restrict__ idx_diff, const int* __restrict__ idx_sum,
    const signed char* __restrict__ sgn, const int* __restrict__ row_ptr,
    const int* __restrict__ row_code, int ne, int nw, long long n_pix, T dt,
    int update_phonons) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  if (kGapIds) {  // this pixel's tables
    const int g = gid[p];
    rho += g * ne;
    if (ks != nullptr) ks += g * ne * ne;
    if (kr != nullptr) kr += g * ne * ne;
  }

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
__global__ void __launch_bounds__(kBlock) collision_step_analytic_kernel(
    const T* __restrict__ q_in, const T* __restrict__ ph_in, const T* __restrict__ gen,
    T* __restrict__ q_out, T* __restrict__ ph_out, const T* __restrict__ g2,
    const T* __restrict__ e_bins, const T* __restrict__ inv_e, const T* __restrict__ e2,
    const T* __restrict__ zim, const T* __restrict__ a_s, const T* __restrict__ b_s,
    const T* __restrict__ a_r, const T* __restrict__ b_r, const int* __restrict__ idx_diff,
    const int* __restrict__ idx_sum, const signed char* __restrict__ sgn,
    const int* __restrict__ row_ptr, const int* __restrict__ row_code, int ne, int nw,
    long long n_pix, T dt, T gamma, int update_phonons) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  const T d2 = g2[p];  // Δ²(px)

  T qv[kMaxBins];
  T pv[kMaxBins];
  for (int i = 0; i < ne; ++i) {
    T qi = q_in[i * n_pix + p];
    if (gen != nullptr) qi += gen[p];  // fused forward-Euler n += dt·g
    T rho_i, inv_i;
    analytic_rho(d2, e_bins[i], inv_e[i], e2[i], zim[i], gamma, rho_i, inv_i);
    qv[i] = qi;
    pv[i] = rho_i * relu(T(1) - qi * inv_i);
  }

  for (int i = 0; i < ne; ++i) {
    T gain_s = T(0), loss_s = T(0), gain_r = T(0), loss_r = T(0);
    for (int j = 0; j < ne; ++j) {
      const int ij = i * ne + j;
      if (a_s != nullptr) {
        const int ji = j * ne + i;
        const signed char s_ij = sgn[ij];
        if (s_ij != 0) {
          const T n = ph_in[idx_diff[ij] * n_pix + p];
          const T cs = relu(a_s[ij] - b_s[ij] * d2);
          loss_s += cs * (s_ij > 0 ? T(1) + n : n) * pv[j];
        }
        const signed char s_ji = sgn[ji];
        if (s_ji != 0) {
          const T n = ph_in[idx_diff[ji] * n_pix + p];
          const T cs = relu(a_s[ji] - b_s[ji] * d2);
          gain_s += cs * (s_ji > 0 ? T(1) + n : n) * qv[j];
        }
      }
      if (a_r != nullptr) {
        const T s = ph_in[idx_sum[ij] * n_pix + p];
        const T c = a_r[ij] + b_r[ij] * d2;  // 2dE·K^r₀(px)
        loss_r += c * (T(1) + s) * qv[j];
        gain_r += c * s * pv[j];
      }
    }
    const T gain = pv[i] * gain_s + pv[i] * gain_r;
    q_out[i * n_pix + p] = relax(qv[i], gain, loss_s + loss_r, dt);
  }

  if (!update_phonons) return;
  for (int w = 0; w < nw; ++w) {
    T a = T(0), b = T(0);
    for (int e = row_ptr[w]; e < row_ptr[w + 1]; ++e) {
      const int code = row_code[e];
      const int pair = code >> 2;
      const int kind = code & 3;
      const int i = pair / ne;
      const int j = pair - i * ne;
      if (kind == 2) {
        const T k = T(0.5) * (a_r[pair] + b_r[pair] * d2);  // dE·K^r₀(px)
        const T rec = k * qv[i] * qv[j];
        a += rec;
        b += rec - k * pv[i] * pv[j];
      } else {
        const T v = relu(a_s[pair] - b_s[pair] * d2) * qv[i] * pv[j];
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

inline unsigned int blocks_for(long long n_pix) {
  return static_cast<unsigned int>((n_pix + kBlock - 1) / kBlock);
}

template <typename T, bool kGapIds>
int launch(const T* q_in, const T* ph_in, const T* gen, T* q_out, T* ph_out,
           const unsigned char* gid, const T* rho, const T* ks, const T* kr,
           const int* idx_diff, const int* idx_sum, const signed char* sgn,
           const int* row_ptr, const int* row_code, int ne, int nw, long long n_pix,
           double dt, int update_phonons, void* stream) {
  if (ne > kMaxBins) return static_cast<int>(cudaErrorInvalidValue);
  if (n_pix > 0) {
    collision_step_kernel<T, kGapIds><<<blocks_for(n_pix), kBlock, 0,
                                        static_cast<cudaStream_t>(stream)>>>(
        q_in, ph_in, gen, q_out, ph_out, gid, rho, ks, kr, idx_diff, idx_sum, sgn, row_ptr,
        row_code, ne, nw, n_pix, static_cast<T>(dt), update_phonons);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_analytic(const T* q_in, const T* ph_in, const T* gen, T* q_out, T* ph_out,
                    const T* g2, const T* e_bins, const T* inv_e, const T* e2, const T* zim,
                    const T* a_s, const T* b_s, const T* a_r, const T* b_r,
                    const int* idx_diff, const int* idx_sum, const signed char* sgn,
                    const int* row_ptr, const int* row_code, int ne, int nw, long long n_pix,
                    double dt, double gamma, int update_phonons, void* stream) {
  if (ne > kMaxBins) return static_cast<int>(cudaErrorInvalidValue);
  if (n_pix > 0) {
    collision_step_analytic_kernel<T><<<blocks_for(n_pix), kBlock, 0,
                                        static_cast<cudaStream_t>(stream)>>>(
        q_in, ph_in, gen, q_out, ph_out, g2, e_bins, inv_e, e2, zim, a_s, b_s, a_r, b_r,
        idx_diff, idx_sum, sgn, row_ptr, row_code, ne, nw, n_pix, static_cast<T>(dt),
        static_cast<T>(gamma), update_phonons);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).  ks / kr (a_s..b_r) / gen may be
// null (channel off, no generation).  Returns cudaGetLastError() after the
// launch.
#define QP_COLLISION_ENTRY(NAME, T)                                                   \
  extern "C" int NAME(const T* q_in, const T* ph_in, const T* gen, T* q_out,          \
                      T* ph_out, const T* rho, const T* ks, const T* kr,              \
                      const int* idx_diff, const int* idx_sum, const signed char* sgn, \
                      const int* row_ptr, const int* row_code, int ne, int nw,        \
                      long long n_pix, double dt, int update_phonons, void* stream) { \
    return launch<T, false>(q_in, ph_in, gen, q_out, ph_out, nullptr, rho, ks, kr,    \
                            idx_diff, idx_sum, sgn, row_ptr, row_code, ne, nw, n_pix, \
                            dt, update_phonons, stream);                              \
  }

// gap ids: gid is (n_pix,) uint8, rho (G, NE), ks / kr (G, NE, NE)
#define QP_COLLISION_GID_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const T* q_in, const T* ph_in, const T* gen, T* q_out,             \
                      T* ph_out, const unsigned char* gid, const T* rho, const T* ks,    \
                      const T* kr, const int* idx_diff, const int* idx_sum,              \
                      const signed char* sgn, const int* row_ptr, const int* row_code,   \
                      int ne, int nw, long long n_pix, double dt, int update_phonons,    \
                      void* stream) {                                                    \
    return launch<T, true>(q_in, ph_in, gen, q_out, ph_out, gid, rho, ks, kr, idx_diff,  \
                           idx_sum, sgn, row_ptr, row_code, ne, nw, n_pix, dt,           \
                           update_phonons, stream);                                      \
  }

#define QP_COLLISION_ANALYTIC_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const T* q_in, const T* ph_in, const T* gen, T* q_out,               \
                      T* ph_out, const T* g2, const T* e_bins, const T* inv_e,             \
                      const T* e2, const T* zim, const T* a_s, const T* b_s, const T* a_r, \
                      const T* b_r, const int* idx_diff, const int* idx_sum,               \
                      const signed char* sgn, const int* row_ptr, const int* row_code,     \
                      int ne, int nw, long long n_pix, double dt, double gamma,            \
                      int update_phonons, void* stream) {                                  \
    return launch_analytic<T>(q_in, ph_in, gen, q_out, ph_out, g2, e_bins, inv_e, e2, zim, \
                              a_s, b_s, a_r, b_r, idx_diff, idx_sum, sgn, row_ptr,         \
                              row_code, ne, nw, n_pix, dt, gamma, update_phonons, stream); \
  }

QP_COLLISION_ENTRY(qp_collision_step_f32, float)
QP_COLLISION_ENTRY(qp_collision_step_f64, double)
QP_COLLISION_GID_ENTRY(qp_collision_step_gid_f32, float)
QP_COLLISION_GID_ENTRY(qp_collision_step_gid_f64, double)
QP_COLLISION_ANALYTIC_ENTRY(qp_collision_step_analytic_f32, float)
QP_COLLISION_ANALYTIC_ENTRY(qp_collision_step_analytic_f64, double)
