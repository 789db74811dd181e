// Fischer–Catelani collision substep for Hopper beyond 64 energy bins:
// one block per tile of 32 pixels, its state staged in shared memory.
//
// blocked_collision_kernel<T, TableConsts<T>> (K5) replaces
// qpsim_tpu/ops/pallas_collisions_blocked.py,
// build_pallas_collision_step_blocked (its kernel, body at :324), for a
// uniform gap and for piecewise gap maps of G ≤ 8 unique gaps (per-pixel
// uint8 gap ids); blocked_collision_kernel<T, AnalyticConsts<T>> (K6)
// replaces build_pallas_collision_step_blocked_analytic, the same walk
// with the constants formed from the pixel's Δ² (continuous gap maps, any
// number of distinct gaps).  They compute exactly the substep of K3 and K4
// (collisions.cu; update rules in collision_math.cuh) — the QP gather over
// ordered pairs (i, j), the per-ω-row pair lists (CSR) for the phonon
// rates, the fused forward-Euler generation plane — for 65 to 256 bins,
// where one thread's q and partner arrays (2 KB to 4 KB at 256 bins) no
// longer fit the per-thread design of K3/K4.
//
// Design: the grid runs over tiles of kTile = 32 pixels (one lane per
// pixel), a block of kWarps warps per tile.  The block stages the tile's
// q (+ dt·g) and partner ρ(1 − f) into dynamic shared memory, laid out
// [NE][32] with the pixel fastest, so a warp reading bin j for its 32
// pixels touches 32 consecutive words (no bank conflict).  Then
//   QP update:  warp w takes bins i = w, w + kWarps, …; for each it walks
//               j = 0..NE−1, reading q_j and partner_j from shared memory,
//               the pair tables (sign, ω maps, constants) at warp-uniform
//               addresses (broadcast loads) and the phonon rows
//               n_ph[row, tile] from device memory, 32 consecutive pixels
//               per read (coalesced; the rows a block touches stay in
//               L1/L2), and writes q_out coalesced;
//   phonons:    warp w takes ω rows w, w + kWarps, …, walks the row's pair
//               list reading q and partner from shared memory, and writes
//               the row coalesced.
// The phonon rows are not staged: at 256 bins in float64 q and partner
// take 128 KB of the block's 227 KB and the 767 ω rows another 196 KB.
// Shared memory above 48 KB needs the per-kernel opt-in
// (cudaFuncAttributeMaxDynamicSharedMemorySize), set before each launch.
//
// The three forms share this skeleton through a constants type:
// TableConsts reads ρ, dE·K^s₀ and 2dE·K^r₀ tables (with gap ids, each
// lane offsets them by its gap id, as K3 does); AnalyticConsts forms
// relu(dE·a_s − dE·b_s·Δ²), 2dE·a_r + 2dE·b_r·Δ² and the closed-form
// Dynes ρ, 1/ρ from the lane's Δ², as K4 does.  The kernels read the exact
// per-pair ω maps, so a grid whose ω diagonals split (the TPU kernel then
// declines, and the JAX package runs its XLA integrator) is computed
// exactly, and an ω row shared by a difference and a sum simply holds
// emission, absorption and recombination entries in its list.
//
// What bounds them on this card: the issue rate of the pair walk (per pair
// and pixel ≈ 13 loads — 2 shared, 3 phonon rows, ≈ 8 warp-uniform table
// words — for ≈ 15 flops, twice), not device memory: each state element is
// read about once and written once.  Left for later: the unordered walk
// (pairs (i, j) and (j, i) share their ω row and products), packed pair
// tables in shared memory, staging the phonon rows where they fit.

#include <cuda_runtime.h>

#include "collision_math.cuh"

namespace {

using qpsim::affine;
using qpsim::analytic_rho;
using qpsim::relax;
using qpsim::relu;

constexpr int kTile = 32;   // pixels per block: one lane per pixel
constexpr int kWarps = 8;   // warps per block
constexpr int kThreads = kTile * kWarps;
constexpr int kMaxBins = 256;  // MAX_BLOCKED_BINS in ops/collisions_blocked_cuda.py

// K5: per-gap tables; gid null on a uniform gap
template <typename T>
struct TableConsts {
  const unsigned char* gid;  // (n_pix,) uint8 or null
  const T* rho;              // (G, NE)
  const T* ks;               // (G, NE, NE) dE·K^s₀, null when scattering is off
  const T* kr;               // (G, NE, NE) 2dE·K^r₀, null when recombination is off

  // this pixel's tables
  __device__ TableConsts at(long long p, int ne) const {
    TableConsts c = *this;
    if (gid != nullptr) {
      const int g = gid[p];
      c.rho += g * ne;
      if (c.ks != nullptr) c.ks += g * ne * ne;
      if (c.kr != nullptr) c.kr += g * ne * ne;
    }
    return c;
  }
  __device__ bool scattering() const { return ks != nullptr; }
  __device__ bool recombination() const { return kr != nullptr; }
  __device__ T scat(int ij) const { return ks[ij]; }  // dE·K^s₀
  __device__ T rec2(int ij) const { return kr[ij]; }  // 2dE·K^r₀
  __device__ T partner(int i, T q) const {
    const T r = rho[i];
    const T f = q / (r > T(1e-30) ? r : T(1e-30));
    return r * relu(T(1) - f);
  }
};

// K6: constants affine in the pixel's Δ²
template <typename T>
struct AnalyticConsts {
  const T* g2;  // (n_pix,) Δ²
  const T* e_bins;
  const T* inv_e;
  const T* e2;   // E² − γ²
  const T* zim;  // −2Eγ
  const T* a_s;  // dE·a_s, null when scattering is off
  const T* b_s;
  const T* a_r;  // 2dE·a_r, null when recombination is off
  const T* b_r;
  T gamma;
  T d2;  // this pixel's Δ² (set by at())

  __device__ AnalyticConsts at(long long p, int) const {
    AnalyticConsts c = *this;
    c.d2 = g2[p];
    return c;
  }
  __device__ bool scattering() const { return a_s != nullptr; }
  __device__ bool recombination() const { return a_r != nullptr; }
  __device__ T scat(int ij) const { return relu(a_s[ij] - b_s[ij] * d2); }
  __device__ T rec2(int ij) const { return a_r[ij] + b_r[ij] * d2; }
  __device__ T partner(int i, T q) const {
    T rho_i, inv_i;
    analytic_rho(d2, e_bins[i], inv_e[i], e2[i], zim[i], gamma, rho_i, inv_i);
    return rho_i * relu(T(1) - q * inv_i);
  }
};

template <typename T, typename Consts>
__global__ void __launch_bounds__(kThreads) blocked_collision_kernel(
    const T* __restrict__ q_in, const T* __restrict__ ph_in, const T* __restrict__ gen,
    T* __restrict__ q_out, T* __restrict__ ph_out, Consts consts,
    const int* __restrict__ idx_diff, const int* __restrict__ idx_sum,
    const signed char* __restrict__ sgn, const int* __restrict__ row_ptr,
    const int* __restrict__ row_code, int ne, int nw, long long n_pix, T dt,
    int update_phonons) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);  // [ne][kTile] q (+ dt·g)
  T* sp = sq + ne * kTile;                 // [ne][kTile] partner
  const int lane = threadIdx.x % kTile;
  const int warp = threadIdx.x / kTile;
  const long long p = static_cast<long long>(blockIdx.x) * kTile + lane;
  const bool valid = p < n_pix;
  const Consts c = valid ? consts.at(p, ne) : consts;

  for (int i = warp; i < ne; i += kWarps) {
    T qi = T(0), pi = T(0);
    if (valid) {
      qi = q_in[i * n_pix + p];
      if (gen != nullptr) qi += gen[p];  // fused forward-Euler n += dt·g
      pi = c.partner(i, qi);
    }
    sq[i * kTile + lane] = qi;
    sp[i * kTile + lane] = pi;
  }
  __syncthreads();
  if (!valid) return;  // no barrier follows

  const T* ph = ph_in + p;  // this pixel's column of the phonon rows
  for (int i = warp; i < ne; i += kWarps) {
    T gain_s = T(0), loss_s = T(0), gain_r = T(0), loss_r = T(0);
    for (int j = 0; j < ne; ++j) {
      const T qj = sq[j * kTile + lane];
      const T pj = sp[j * kTile + lane];
      const int ij = i * ne + j;
      if (c.scattering()) {
        const int ji = j * ne + i;
        const signed char s_ij = sgn[ij];
        if (s_ij != 0) {
          const T n = ph[idx_diff[ij] * n_pix];
          loss_s += c.scat(ij) * (s_ij > 0 ? T(1) + n : n) * pj;
        }
        const signed char s_ji = sgn[ji];
        if (s_ji != 0) {
          const T n = ph[idx_diff[ji] * n_pix];
          gain_s += c.scat(ji) * (s_ji > 0 ? T(1) + n : n) * qj;
        }
      }
      if (c.recombination()) {
        const T s = ph[idx_sum[ij] * n_pix];
        const T k = c.rec2(ij);
        loss_r += k * (T(1) + s) * qj;
        gain_r += k * s * pj;
      }
    }
    const T qi = sq[i * kTile + lane];
    const T pi = sp[i * kTile + lane];
    const T gain = pi * gain_s + pi * gain_r;
    q_out[i * n_pix + p] = relax(qi, gain, loss_s + loss_r, dt);
  }

  if (!update_phonons) return;
  for (int w = warp; w < nw; w += kWarps) {
    T a = T(0), b = T(0);
    for (int e = row_ptr[w]; e < row_ptr[w + 1]; ++e) {
      // code = pair·4 + kind; kind 0 emission, 1 absorption, 2 recombination
      const int code = row_code[e];
      const int pair = code >> 2;
      const int kind = code & 3;
      const int i = pair / ne;
      const int j = pair - i * ne;
      const T qi = sq[i * kTile + lane];
      if (kind == 2) {
        const T k = T(0.5) * c.rec2(pair);  // dE·K^r₀
        const T rec = k * qi * sq[j * kTile + lane];
        a += rec;
        b += rec - k * sp[i * kTile + lane] * sp[j * kTile + lane];
      } else {
        const T v = c.scat(pair) * qi * sp[j * kTile + lane];
        if (kind == 0) {
          a += v;
          b += v;
        } else {
          b -= v;
        }
      }
    }
    ph_out[w * n_pix + p] = affine(ph[w * n_pix], a, b, dt);
  }
}

template <typename T, typename Consts>
int launch(const T* q_in, const T* ph_in, const T* gen, T* q_out, T* ph_out, Consts consts,
           const int* idx_diff, const int* idx_sum, const signed char* sgn, const int* row_ptr,
           const int* row_code, int ne, int nw, long long n_pix, double dt, int update_phonons,
           void* stream) {
  if (ne < 1 || ne > kMaxBins) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 2 * ne * kTile * static_cast<int>(sizeof(T));
  auto kernel = blocked_collision_kernel<T, Consts>;
  // above 48 KB only after the opt-in; a refused launch would never run
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_pix > 0) {
    const unsigned int blocks = static_cast<unsigned int>((n_pix + kTile - 1) / kTile);
    kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        q_in, ph_in, gen, q_out, ph_out, consts, idx_diff, idx_sum, sgn, row_ptr, row_code, ne,
        nw, n_pix, static_cast<T>(dt), update_phonons);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes), argument for argument that of
// K3 and K4 (collisions.cu).  ks / kr (a_s..b_r) / gen may be null (channel
// off, no generation).  Returns cudaGetLastError() after the launch.
#define QP_BLOCKED_ENTRY(NAME, T)                                                       \
  extern "C" int NAME(const T* q_in, const T* ph_in, const T* gen, T* q_out,            \
                      T* ph_out, const T* rho, const T* ks, const T* kr,                \
                      const int* idx_diff, const int* idx_sum, const signed char* sgn,   \
                      const int* row_ptr, const int* row_code, int ne, int nw,          \
                      long long n_pix, double dt, int update_phonons, void* stream) {   \
    return launch<T>(q_in, ph_in, gen, q_out, ph_out, TableConsts<T>{nullptr, rho, ks, kr}, \
                     idx_diff, idx_sum, sgn, row_ptr, row_code, ne, nw, n_pix, dt,      \
                     update_phonons, stream);                                           \
  }

// gap ids: gid is (n_pix,) uint8, rho (G, NE), ks / kr (G, NE, NE)
#define QP_BLOCKED_GID_ENTRY(NAME, T)                                                     \
  extern "C" int NAME(const T* q_in, const T* ph_in, const T* gen, T* q_out,              \
                      T* ph_out, const unsigned char* gid, const T* rho, const T* ks,     \
                      const T* kr, const int* idx_diff, const int* idx_sum,               \
                      const signed char* sgn, const int* row_ptr, const int* row_code,    \
                      int ne, int nw, long long n_pix, double dt, int update_phonons,     \
                      void* stream) {                                                     \
    return launch<T>(q_in, ph_in, gen, q_out, ph_out, TableConsts<T>{gid, rho, ks, kr},   \
                     idx_diff, idx_sum, sgn, row_ptr, row_code, ne, nw, n_pix, dt,        \
                     update_phonons, stream);                                             \
  }

#define QP_BLOCKED_ANALYTIC_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const T* q_in, const T* ph_in, const T* gen, T* q_out,               \
                      T* ph_out, const T* g2, const T* e_bins, const T* inv_e,             \
                      const T* e2, const T* zim, const T* a_s, const T* b_s, const T* a_r, \
                      const T* b_r, const int* idx_diff, const int* idx_sum,               \
                      const signed char* sgn, const int* row_ptr, const int* row_code,     \
                      int ne, int nw, long long n_pix, double dt, double gamma,            \
                      int update_phonons, void* stream) {                                  \
    const AnalyticConsts<T> consts{g2,  e_bins, inv_e, e2, zim, a_s, b_s, a_r, b_r,        \
                                   static_cast<T>(gamma), T(0)};                           \
    return launch<T>(q_in, ph_in, gen, q_out, ph_out, consts, idx_diff, idx_sum, sgn,      \
                     row_ptr, row_code, ne, nw, n_pix, dt, update_phonons, stream);        \
  }

QP_BLOCKED_ENTRY(qp_collision_blocked_f32, float)
QP_BLOCKED_ENTRY(qp_collision_blocked_f64, double)
QP_BLOCKED_GID_ENTRY(qp_collision_blocked_gid_f32, float)
QP_BLOCKED_GID_ENTRY(qp_collision_blocked_gid_f64, double)
QP_BLOCKED_ANALYTIC_ENTRY(qp_collision_blocked_analytic_f32, float)
QP_BLOCKED_ANALYTIC_ENTRY(qp_collision_blocked_analytic_f64, double)
