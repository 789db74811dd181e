// Fischer–Catelani collision substep walked by energy-offset columns, for Hopper.
//
// column_walk_kernel replaces four TPU kernels of qpsim_tpu/ops:
//   K5  pallas_collisions_blocked.py, build_pallas_collision_step_blocked
//       (kernel :101, body :324, call :930): beyond 64 bins (the TPU
//       kernel's envelope ends at 256, the walk here at none), a uniform
//       gap or G ≤ 8 per-pixel gap ids, with the dt·g plane fused;
//   K6  the same file's build_pallas_collision_step_blocked_analytic
//       (:972): continuous gap maps, constants affine in the pixel's Δ²;
//   K8  pallas_collisions_loop.py, build_pallas_collision_step_loop (kernel
//       body :168, call :356): one column per offset k = i − j and per
//       anti-diagonal s = i + j, a uniform gap or per-pixel gap ids;
//   K9  pallas_collisions_rows.py, build_pallas_collision_step_rows (kernel
//       body :180, call :361): one column per (offset, ω row) and
//       (anti-diagonal, ω row) group.
// All four are one column form (host tables in ops/collisions_loop_cuda.py,
// ops/collisions_rows_cuda.py and ops/collisions_blocked_cuda.py; device
// tables and launch in ops/column_walk.py).  K3 and K4 (collisions.cu) run
// here too from 17 to 64 bins, where the column walk measured faster than
// a pixel's bins in registers (ops/collisions_cuda.py routes them, counted
// under their own names).
// Scattering column c has an offset k_c ≥ 1, an ω row and, for every bin
// m ≥ k_c whose pair (m, m − k_c) lies in the column's group, the pair
// (K[m, m−k], K[m−k, m])·dE — zero for pairs outside it; recombination
// column c has an anti-diagonal s_c, an ω row and R[i] = 2dE·K^r₀[i, s−i].
// K5 and K8/K9 group pairs as K9 does, so a split ω diagonal (NE 65/66) is
// two columns and stays exact, and an ω row shared by a difference and a
// sum (NE 72) holds both kinds in its row list.  They compute exactly the
// substep of K3 and K4 (collisions.cu; update rules in collision_math.cuh).
//
// Design: a block of kWarps warps per tile of 32·P pixels; each lane owns
// P neighbouring pixels.  The block stages the tile's q (+ dt·g) and
// partner ρ(1 − f) [NE][32·P] in dynamic shared memory; a lane's P pixels
// are one 4-, 8- or 16-byte shared access, conflict-free across the warp,
// and each warp-uniform column index and table load serves P pixels.  The
// phonon value of a column's ω row is read through L1, one P-wide load
// per lane (rows of a tile are L1-resident: every bin meets them).  Then
//   QP side:    warp w takes bins i = w, w + kWarps, …; it walks the
//               scattering columns with k ≤ i (pairs (i, i−k)), those with
//               i + k < NE (pairs (i+k, i)), and the recombination columns
//               of the anti-diagonals s ∈ [i, i + NE), and writes q_out;
//               the tables are read [bin][column], so consecutive columns
//               share a cache line;
//   phonon side: warp w owns ω rows w, w + kWarps, …; a host list gives each
//               row the columns that land on it, and the owner sums every
//               column's rates over its bins in a fixed order — no atomics;
//               it reads a [column][bin] copy of the tables, so consecutive
//               bins share a cache line; rows no column touches are copied
//               unchanged.
// The constants come through a type: TableConsts reads per-gap tables
// (G, NE, C), each lane's pixels offset by their int32 gap ids; when all 32·P
// ids of a warp agree (a trap map's interior) the warp takes one table
// base, so every table load stays a broadcast, and only mixed warps gather
// per pixel.  AnalyticConsts reads (a, b) pairs of column tables and forms
// relu(a − b·Δ²) (scattering) and a + b·Δ² (recombination) per pixel, and
// the closed-form Dynes ρ.  The TPU kernels' rolls, masked lane reductions
// and dynamic-sublane updates are Mosaic artefacts with no counterpart here.
//
// What bounds it on this card: the issue rate of the walk — per ordered
// pair and P pixels ≈ 2 shared loads, one load of the column's phonon
// values and one broadcast table load for 2P fused multiply-adds, twice
// (QP and phonon side) — not device memory: each state element is read
// once and written once.  The host picks P per launch
// (ops/column_walk.py, column_pixels, the rule measured with
// tools/column_walk_levers.py, PERF.md §6): P = 2 where the tile still
// leaves 3 blocks (24 warps) per SM, else P = 1.  Staging the columns'
// phonon values in shared memory too, and P = 4, were measured the same
// way and lost: both cost blocks per SM, which hid more latency than they
// saved.
//
// Two launch forms of the one walk.  The staged form above holds the tile's
// q and partner in shared memory: 2·NE·32·P·sizeof(T) bytes, up to NE 908
// in float32 and 454 in float64 at P = 1 on this card's 227-KB opt-in.
// Beyond that the device-memory form (kDevice) runs the same walk with
// sq/sp pointing at the block's own slice of a scratch buffer in device
// memory ([2][NE][32], P = 1), written by the same staging loop: the
// block's threads see each other's writes after __syncthreads, and the
// walk then reads the slice through L1/L2 with ordinary loads (not the
// read-only path: the kernel wrote it).  It computes what the staged form
// computes, in the same order.  The host picks the form from NE and the
// dtype alone (ops/column_walk.py, column_form).

#include <cuda_runtime.h>

#include "collision_math.cuh"

namespace {

using qpsim::affine;
using qpsim::analytic_rho;
using qpsim::relax;
using qpsim::relu;

constexpr int kWarps = 8;  // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

// a lane's P neighbouring pixels: one 4-, 8- or 16-byte shared access
template <typename T, int P>
struct alignas(sizeof(T) * P) Px {
  T v[P];
};

template <typename T, int P>
__device__ __forceinline__ Px<T, P> lds(const T* row, int x0) {
  return *reinterpret_cast<const Px<T, P>*>(row + x0);
}

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

// two neighbouring table entries, one read-only load
template <typename T>
__device__ __forceinline__ typename Pair<T>::type ldg2(const T* p) {
  return __ldg(reinterpret_cast<const typename Pair<T>::type*>(p));
}

// the column form's index arrays (device pointers)
struct Columns {
  const int* scat_k;    // (n_scat,) offset of each scattering column, ascending
  const int* scat_row;  // (n_scat,) its ω row
  const int* k_count;   // (NE,) scattering columns of offset ≤ m
  const int* rec_s;     // (n_rec,) anti-diagonal of each recombination column, ascending
  const int* rec_row;   // (n_rec,) its ω row
  const int* s_ptr;     // (2NE,) first recombination column of anti-diagonal s
  const int* row_ptr;   // (NW + 1,) each ω row's columns in row_code
  const int* row_code;  // column·2 + kind (0 scattering, 1 recombination)
  int n_scat;           // 0 when scattering is off
  int n_rec;            // 0 when recombination is off
};

// K5, K8, K9: per-gap column tables, each pixel's by its gap id
template <typename T>
struct TableConsts {
  using Key = int;  // a pixel's gap id
  const int* gid;         // (n_pix,) or null (uniform gap)
  const T* rho;           // (G, NE)
  const T* scat;          // (G, NE, n_scat, 2): (K[m, m−k], K[m−k, m])·dE
  const T* scat_t;        // (G, n_scat, NE, 2): the same, column-major
  const T* rec;           // (G, NE, n_rec): 2dE·K^r₀[i, s−i]
  const T* rec_t;         // (G, n_rec, NE)
  int ne, n_scat, n_rec;

  __device__ bool can_mix() const { return gid != nullptr; }
  __device__ Key key(long long p) const { return gid != nullptr ? gid[p] : 0; }
  __device__ T partner(int i, T q, long long p) const {
    const T r = rho[static_cast<long long>(key(p)) * ne + i];
    return r * relu(T(1) - q / (r > T(1e-30) ? r : T(1e-30)));
  }
  // the pair at element ``at`` of a (G, …, 2) scattering table, for each pixel
  template <int P, bool kMixed>
  __device__ __forceinline__ void pair(const T* tab, const Key (&g)[P], long long at, T (&e)[P],
                                       T (&a)[P]) const {
    const long long stride = 2LL * ne * n_scat;
    if constexpr (!kMixed) {
      const auto v = ldg2(tab + static_cast<long long>(g[0]) * stride + at);
#pragma unroll
      for (int p = 0; p < P; ++p) e[p] = v.x, a[p] = v.y;
    } else {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const auto v = ldg2(tab + static_cast<long long>(g[p]) * stride + at);
        e[p] = v.x, a[p] = v.y;
      }
    }
  }
  // the entry at ``at`` of a (G, …) recombination table, for each pixel
  template <int P, bool kMixed>
  __device__ __forceinline__ void one(const T* tab, const Key (&g)[P], long long at,
                                      T (&r)[P]) const {
    const long long stride = static_cast<long long>(ne) * n_rec;
    if constexpr (!kMixed) {
      const T v = __ldg(tab + static_cast<long long>(g[0]) * stride + at);
#pragma unroll
      for (int p = 0; p < P; ++p) r[p] = v;
    } else {
#pragma unroll
      for (int p = 0; p < P; ++p) r[p] = __ldg(tab + static_cast<long long>(g[p]) * stride + at);
    }
  }
  // (K[m, m−k], K[m−k, m]) of column c: by bin (QP side), by column (phonon side)
  template <int P, bool kMixed>
  __device__ __forceinline__ void scat_at(const Key (&g)[P], int m, int c, T (&e)[P],
                                          T (&a)[P]) const {
    pair<P, kMixed>(scat, g, (static_cast<long long>(m) * n_scat + c) * 2, e, a);
  }
  template <int P, bool kMixed>
  __device__ __forceinline__ void scat_col(const Key (&g)[P], int c, int m, T (&e)[P],
                                           T (&a)[P]) const {
    pair<P, kMixed>(scat_t, g, (static_cast<long long>(c) * ne + m) * 2, e, a);
  }
  // 2dE·K^r₀[i, s−i] of column c: by bin, by column
  template <int P, bool kMixed>
  __device__ __forceinline__ void rec_at(const Key (&g)[P], int i, int c, T (&r)[P]) const {
    one<P, kMixed>(rec, g, static_cast<long long>(i) * n_rec + c, r);
  }
  template <int P, bool kMixed>
  __device__ __forceinline__ void rec_col(const Key (&g)[P], int c, int i, T (&r)[P]) const {
    one<P, kMixed>(rec_t, g, static_cast<long long>(c) * ne + i, r);
  }
};

// K6: (a, b) column tables, the constants affine in the pixel's Δ²
template <typename T>
struct AnalyticConsts {
  using Key = T;  // a pixel's Δ²
  const T* g2;    // (n_pix,) Δ²
  const T* e_bins;
  const T* inv_e;
  const T* e2;    // E² − γ²
  const T* zim;   // −2Eγ
  const T* scat;    // (NE, n_scat, 4): dE·(a, a', b, b') of (K[m, m−k], K[m−k, m])
  const T* scat_t;  // (n_scat, NE, 4): the same, column-major
  const T* rec;     // (NE, n_rec, 2): 2dE·(a_r, b_r)
  const T* rec_t;   // (n_rec, NE, 2)
  T gamma;
  int ne, n_scat, n_rec;

  __device__ bool can_mix() const { return false; }
  __device__ Key key(long long p) const { return g2[p]; }
  __device__ T partner(int i, T q, long long p) const {
    T rho_i, inv_i;
    analytic_rho(g2[p], e_bins[i], inv_e[i], e2[i], zim[i], gamma, rho_i, inv_i);
    return rho_i * relu(T(1) - q * inv_i);
  }
  template <int P>
  __device__ __forceinline__ void quad(const T* at, const Key (&d2)[P], T (&e)[P],
                                       T (&a)[P]) const {
    const auto va = ldg2(at);      // (a, a')
    const auto vb = ldg2(at + 2);  // (b, b')
#pragma unroll
    for (int p = 0; p < P; ++p) {
      e[p] = relu(va.x - vb.x * d2[p]);
      a[p] = relu(va.y - vb.y * d2[p]);
    }
  }
  template <int P>
  __device__ __forceinline__ void affine2(const T* at, const Key (&d2)[P], T (&r)[P]) const {
    const auto v = ldg2(at);  // (a_r, b_r)
#pragma unroll
    for (int p = 0; p < P; ++p) r[p] = v.x + v.y * d2[p];
  }
  template <int P, bool>
  __device__ __forceinline__ void scat_at(const Key (&d2)[P], int m, int c, T (&e)[P],
                                          T (&a)[P]) const {
    quad<P>(scat + (static_cast<long long>(m) * n_scat + c) * 4, d2, e, a);
  }
  template <int P, bool>
  __device__ __forceinline__ void scat_col(const Key (&d2)[P], int c, int m, T (&e)[P],
                                           T (&a)[P]) const {
    quad<P>(scat_t + (static_cast<long long>(c) * ne + m) * 4, d2, e, a);
  }
  template <int P, bool>
  __device__ __forceinline__ void rec_at(const Key (&d2)[P], int i, int c, T (&r)[P]) const {
    affine2<P>(rec + (static_cast<long long>(i) * n_rec + c) * 2, d2, r);
  }
  template <int P, bool>
  __device__ __forceinline__ void rec_col(const Key (&d2)[P], int c, int i, T (&r)[P]) const {
    affine2<P>(rec_t + (static_cast<long long>(c) * ne + i) * 2, d2, r);
  }
};

// the phonon value of column c for a lane's P pixels, one P-wide load
// through the column's ω row (the host launches P = 2 only for an even
// pixel count; the idle pixels of a ragged tile read the last pixels'
// values, and their results are never stored)
template <typename T, int P>
__device__ __forceinline__ Px<T, P> column_value(const T* ph_in, const int* rows, int c,
                                                 long long px, long long n_pix) {
  const T* at = ph_in + static_cast<long long>(rows[c]) * n_pix + px;
  Px<T, P> v;
  if constexpr (P == 1) {
    v.v[0] = __ldg(at);
  } else {
    const auto t = ldg2(at);
    v.v[0] = t.x;
    v.v[1] = t.y;
  }
  return v;
}

// the walk of one lane's P pixels after the staging (see the header)
template <typename T, int P, bool kMixed, typename Consts>
__device__ __forceinline__ void walk(const Consts& consts, const typename Consts::Key (&key)[P],
                                     const Columns& cols, const T* sq, const T* sp,
                                     const T* ph_in, T* q_out, T* ph_out, int ne, int nw,
                                     long long n_pix, long long p0, int x0, int warp, T dt,
                                     int update_phonons) {
  static_assert(P == 1 || P == 2, "one or two pixels per lane");
  constexpr int kTile = 32 * P;
  const long long px = p0 < n_pix ? p0 : n_pix - P;  // this lane's column values
  for (int i = warp; i < ne; i += kWarps) {
    T loss[P], gain[P];
#pragma unroll
    for (int p = 0; p < P; ++p) loss[p] = gain[p] = T(0);
    if (cols.n_scat > 0) {
      // pairs (i, i−k): emission i → i−k (loss, partner[i−k]), absorption
      // i−k → i (gain, q[i−k])
      const int down = cols.k_count[i];
      for (int c = 0; c < down; ++c) {
        const int j = i - cols.scat_k[c];
        const Px<T, P> d = column_value<T, P>(ph_in, cols.scat_row, c, px, n_pix);
        const Px<T, P> pj = lds<T, P>(sp + j * kTile, x0);
        const Px<T, P> qj = lds<T, P>(sq + j * kTile, x0);
        T e[P], a[P];
        consts.template scat_at<P, kMixed>(key, i, c, e, a);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          loss[p] += e[p] * (T(1) + d.v[p]) * pj.v[p];
          gain[p] += a[p] * d.v[p] * qj.v[p];
        }
      }
      // pairs (i+k, i): absorption i → i+k (loss, partner[i+k]), emission
      // i+k → i (gain, q[i+k]); the column's entry at bin m = i + k
      const int up = cols.k_count[ne - 1 - i];
      for (int c = 0; c < up; ++c) {
        const int m = i + cols.scat_k[c];
        const Px<T, P> d = column_value<T, P>(ph_in, cols.scat_row, c, px, n_pix);
        const Px<T, P> pm = lds<T, P>(sp + m * kTile, x0);
        const Px<T, P> qm = lds<T, P>(sq + m * kTile, x0);
        T e[P], a[P];
        consts.template scat_at<P, kMixed>(key, m, c, e, a);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          loss[p] += a[p] * d.v[p] * pm.v[p];
          gain[p] += e[p] * (T(1) + d.v[p]) * qm.v[p];
        }
      }
    }
    if (cols.n_rec > 0) {
      // recombination with bin s − i and pair breaking into (i, s−i)
      for (int c = cols.s_ptr[i]; c < cols.s_ptr[i + ne]; ++c) {
        const int j = cols.rec_s[c] - i;
        const Px<T, P> sv = column_value<T, P>(ph_in, cols.rec_row, c, px, n_pix);
        const Px<T, P> qj = lds<T, P>(sq + j * kTile, x0);
        const Px<T, P> pj = lds<T, P>(sp + j * kTile, x0);
        T r[P];
        consts.template rec_at<P, kMixed>(key, i, c, r);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          loss[p] += r[p] * (T(1) + sv.v[p]) * qj.v[p];
          gain[p] += r[p] * sv.v[p] * pj.v[p];
        }
      }
    }
    const Px<T, P> qi = lds<T, P>(sq + i * kTile, x0);
    const Px<T, P> pi = lds<T, P>(sp + i * kTile, x0);
    T* out = q_out + static_cast<long long>(i) * n_pix + p0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (p0 + p < n_pix) out[p] = relax(qi.v[p], pi.v[p] * gain[p], loss[p], dt);
    }
  }

  if (!update_phonons) return;
  for (int r = warp; r < nw; r += kWarps) {
    const int e0 = cols.row_ptr[r], e1 = cols.row_ptr[r + 1];
    T a[P], b[P];
#pragma unroll
    for (int p = 0; p < P; ++p) a[p] = b[p] = T(0);
    for (int e = e0; e < e1; ++e) {
      const int code = cols.row_code[e];
      const int c = code >> 1;
      if ((code & 1) == 0) {  // scattering: emission creates, absorption destroys
        const int k = cols.scat_k[c];
        T em[P], ab[P];
#pragma unroll
        for (int p = 0; p < P; ++p) em[p] = ab[p] = T(0);
        for (int m = k; m < ne; ++m) {
          T ke[P], ka[P];
          consts.template scat_col<P, kMixed>(key, c, m, ke, ka);
          const Px<T, P> qm = lds<T, P>(sq + m * kTile, x0);
          const Px<T, P> pm = lds<T, P>(sp + m * kTile, x0);
          const Px<T, P> qj = lds<T, P>(sq + (m - k) * kTile, x0);
          const Px<T, P> pj = lds<T, P>(sp + (m - k) * kTile, x0);
#pragma unroll
          for (int p = 0; p < P; ++p) {
            em[p] += ke[p] * qm.v[p] * pj.v[p];  // pair (m → m−k)
            ab[p] += ka[p] * qj.v[p] * pm.v[p];  // pair (m−k → m)
          }
        }
#pragma unroll
        for (int p = 0; p < P; ++p) {
          a[p] += em[p];
          b[p] += em[p] - ab[p];
        }
      } else {  // recombination creates, pair breaking destroys
        const int s = cols.rec_s[c];
        const int lo = s - ne + 1 > 0 ? s - ne + 1 : 0;
        const int hi = s < ne - 1 ? s : ne - 1;
        T rc[P], pb[P];
#pragma unroll
        for (int p = 0; p < P; ++p) rc[p] = pb[p] = T(0);
        for (int i = lo; i <= hi; ++i) {
          T kr[P];
          consts.template rec_col<P, kMixed>(key, c, i, kr);
          const Px<T, P> qi = lds<T, P>(sq + i * kTile, x0);
          const Px<T, P> pi = lds<T, P>(sp + i * kTile, x0);
          const Px<T, P> qj = lds<T, P>(sq + (s - i) * kTile, x0);
          const Px<T, P> pj = lds<T, P>(sp + (s - i) * kTile, x0);
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const T k = T(0.5) * kr[p];  // dE·K^r₀
            rc[p] += k * qi.v[p] * qj.v[p];
            pb[p] += k * pi.v[p] * pj.v[p];
          }
        }
#pragma unroll
        for (int p = 0; p < P; ++p) {
          a[p] += rc[p];
          b[p] += rc[p] - pb[p];
        }
      }
    }
    const T* y = ph_in + static_cast<long long>(r) * n_pix + p0;
    T* out = ph_out + static_cast<long long>(r) * n_pix + p0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (p0 + p < n_pix) out[p] = e0 == e1 ? y[p] : affine(y[p], a[p], b[p], dt);
    }
  }
}

// the registers must leave 4 blocks per SM (≤ 64 a thread): the 100-bin
// float32 tile at P = 2 leaves 4 by shared memory, and at the 100
// registers ptxas took unbounded K5 ran 1.27x slower on 2 blocks
// (tools/time_blocked.py, PERF.md §6); a few spilled words cost less
template <typename T, int P, typename Consts, bool kDevice>
__global__ void __launch_bounds__(kThreads, 4) column_walk_kernel(
    const T* __restrict__ q_in, const T* __restrict__ ph_in, const T* __restrict__ gen,
    T* __restrict__ q_out, T* __restrict__ ph_out, Consts consts, Columns cols, int ne, int nw,
    long long n_pix, T dt, int update_phonons, T* scratch) {
  constexpr int kTile = 32 * P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [ne][kTile] q (+ dt·g), then [ne][kTile] partner: in shared memory, or
  // in the block's slice of the scratch buffer (the device-memory form)
  T* sq = kDevice ? scratch + static_cast<long long>(blockIdx.x) * (2LL * ne * kTile)
                  : reinterpret_cast<T*>(smem_raw);
  T* sp = sq + ne * kTile;
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;

  // staging: consecutive threads take consecutive pixels (coalesced reads);
  // the idle pixels of a ragged tile hold zeros
  for (int e = threadIdx.x; e < ne * kTile; e += kThreads) {
    const int i = e / kTile;
    const long long p = tile0 + (e - i * kTile);
    T qi = T(0), pi = T(0);
    if (p < n_pix) {
      qi = q_in[i * n_pix + p];
      if (gen != nullptr) qi += gen[p];  // fused forward-Euler n += dt·g
      pi = consts.partner(i, qi, p);
    }
    sq[e] = qi;
    sp[e] = pi;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x0 = lane * P;
  const long long p0 = tile0 + x0;
  // the lane's keys (gap ids or Δ²); idle pixels take the last pixel's
  typename Consts::Key key[P];
#pragma unroll
  for (int p = 0; p < P; ++p) key[p] = consts.key(p0 + p < n_pix ? p0 + p : n_pix - 1);
  bool mixed = false;
  if (consts.can_mix()) {  // warp-uniform: gap ids given or not
    bool same = true;
#pragma unroll
    for (int p = 1; p < P; ++p) same = same && key[p] == key[0];
    const typename Consts::Key lead = __shfl_sync(kFull, key[0], 0);
    mixed = !__all_sync(kFull, same && key[0] == lead);
  }
  if (mixed) {
    walk<T, P, true>(consts, key, cols, sq, sp, ph_in, q_out, ph_out, ne, nw, n_pix, p0, x0,
                     warp, dt, update_phonons);
  } else {
    walk<T, P, false>(consts, key, cols, sq, sp, ph_in, q_out, ph_out, ne, nw, n_pix, p0, x0,
                      warp, dt, update_phonons);
  }
}

// the staged form (scratch null) or the device-memory form (scratch: the
// blocks' slices, 2·NE·32·P entries each)
template <typename T, int P, typename Consts, bool kDevice>
int launch_form(const T* q_in, const T* ph_in, const T* gen, T* q_out, T* ph_out,
                const Consts& consts, const Columns& cols, int ne, int nw, long long n_pix,
                double dt, int update_phonons, T* scratch, cudaStream_t stream) {
  const long long smem = kDevice ? 0 : 2LL * ne * 32 * P * static_cast<long long>(sizeof(T));
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > max_smem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = column_walk_kernel<T, P, Consts, kDevice>;
  if (!kDevice) {
    // above 48 KB only after the opt-in; a refused launch would never run
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned int blocks = static_cast<unsigned int>((n_pix + 32 * P - 1) / (32 * P));
  kernel<<<blocks, kThreads, static_cast<size_t>(smem), stream>>>(
      q_in, ph_in, gen, q_out, ph_out, consts, cols, ne, nw, n_pix, static_cast<T>(dt),
      update_phonons, scratch);
  return static_cast<int>(cudaGetLastError());
}

// P = 2 reads a lane's column values as one pair: even pixel counts and a
// pair-aligned phonon state only; the device-memory form (scratch given)
// takes P = 1
template <typename T, typename Consts>
int launch(const T* q_in, const T* ph_in, const T* gen, T* q_out, T* ph_out, const Consts& consts,
           const Columns& cols, int ne, int nw, long long n_pix, double dt, int update_phonons,
           int pixels, T* scratch, void* stream) {
  const bool pairs_ok =
      n_pix % 2 == 0 && reinterpret_cast<unsigned long long>(ph_in) % (2 * sizeof(T)) == 0;
  if (ne < 2 || pixels < 1 || pixels > 2 || (pixels == 2 && !pairs_ok) ||
      (scratch != nullptr && pixels != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_pix <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scratch != nullptr) {
    return launch_form<T, 1, Consts, true>(q_in, ph_in, gen, q_out, ph_out, consts, cols, ne, nw,
                                           n_pix, dt, update_phonons, scratch, s);
  }
  if (pixels == 2) {
    return launch_form<T, 2, Consts, false>(q_in, ph_in, gen, q_out, ph_out, consts, cols, ne, nw,
                                            n_pix, dt, update_phonons, nullptr, s);
  }
  return launch_form<T, 1, Consts, false>(q_in, ph_in, gen, q_out, ph_out, consts, cols, ne, nw,
                                          n_pix, dt, update_phonons, nullptr, s);
}

}  // namespace

// Plain C interface (loaded with ctypes), one entry per dtype for all four
// kernels.  Table form (g2 null): rho (G, NE), scat (G, NE, n_scat, 2) and
// its column-major copy scat_t (G, n_scat, NE, 2), rec (G, NE, n_rec) and
// rec_t (G, n_rec, NE), gid null (uniform gap) or (n_pix,) int32 ids.
// Analytic form (g2 non-null): scat (NE, n_scat, 4), scat_t (n_scat, NE,
// 4), rec (NE, n_rec, 2), rec_t (n_rec, NE, 2), the Δ² plane and the
// Dynes constants.  A channel's tables (with their
// index arrays) may be null (channel off), gen null (no generation), ph_out
// null when update_phonons is 0.  pixels (1 or 2) picks the lane's width.
// scratch null launches the staged form; else the device-memory form, at
// pixels 1, with scratch holding 2·NE·32 entries per 32-pixel tile.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a width the inputs do not allow or a staged tile that does not fit the
// block's shared memory.
#define QP_COLUMN_WALK_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(const T* q_in, const T* ph_in, const T* gen, T* q_out, T* ph_out,       \
                      const int* gid, const T* rho, const T* scat,                             \
                      const T* scat_t, const T* rec, const T* rec_t, const T* g2,              \
                      const T* e_bins, const T* inv_e, const T* e2, const T* zim, double gamma, \
                      const int* scat_k, const int* scat_row, const int* k_count, int n_scat,  \
                      const int* rec_s, const int* rec_row, const int* s_ptr, int n_rec,       \
                      const int* row_ptr, const int* row_code, int ne, int nw, long long n_pix, \
                      double dt, int update_phonons, int pixels, T* scratch, void* stream) {   \
    const int ns = scat != nullptr ? n_scat : 0, nr = rec != nullptr ? n_rec : 0;              \
    const Columns cols{scat_k, scat_row, k_count, rec_s, rec_row, s_ptr, row_ptr, row_code,    \
                       ns, nr};                                                                \
    if (g2 != nullptr) {                                                                       \
      const AnalyticConsts<T> c{g2,     e_bins, inv_e, e2, zim, scat, scat_t, rec,             \
                                rec_t,  static_cast<T>(gamma), ne, ns, nr};                    \
      return launch<T>(q_in, ph_in, gen, q_out, ph_out, c, cols, ne, nw, n_pix, dt,            \
                       update_phonons, pixels, scratch, stream);                               \
    }                                                                                          \
    const TableConsts<T> c{gid, rho, scat, scat_t, rec, rec_t, ne, ns, nr};                   \
    return launch<T>(q_in, ph_in, gen, q_out, ph_out, c, cols, ne, nw, n_pix, dt,              \
                     update_phonons, pixels, scratch, stream);                                 \
  }

QP_COLUMN_WALK_ENTRY(qp_column_walk_f32, float)
QP_COLUMN_WALK_ENTRY(qp_column_walk_f64, double)
