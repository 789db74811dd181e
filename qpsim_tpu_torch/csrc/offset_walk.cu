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
// are one 4-, 8- or 16-byte shared access, conflict-free across the warp.
// The phonon values are read through L1, one P-wide load per lane and ω
// row.  Then the warps take tasks w, w + kWarps, …, each a register block
// of B consecutive bins, offsets or anti-diagonals of the lane's pixels:
//   QP side:      bins [i0, i0 + B).  The lane walks each partner bin j
//                 once and loads q_j and partner_j once for the B pair
//                 terms (i, j).  The offsets |i − j| of the B bins are B
//                 consecutive columns, and so are the anti-diagonals i + j,
//                 so their phonon values form two register windows (slot
//                 δ mod B for the difference δ = i − j, s mod B for the sum)
//                 that take one new P-wide load each per step of j.  The B
//                 table entries at fixed j are vector loads from a
//                 [partner][bin] copy of the tables (qs, qr);
//   phonon side:  offsets [k0, k0 + B) walk m: q_m and partner_m load once
//                 for the B columns, q_{m−k} and partner_{m−k} come from a
//                 window, the entries from a [bin][offset] copy (ps);
//                 anti-diagonals [s0, s0 + B) walk i so, with the window
//                 over s − i and a [bin][anti-diagonal] copy (pr).  Each ω
//                 row that one such first column alone lands on is written
//                 by the column's task, its sums in the per-row walk's order.
// The windows hold the first column of each offset and anti-diagonal, and
// the rest of the column form stays exact: a column beyond the first of
// its offset or anti-diagonal (a split ω diagonal: NE 17, 65/66) is walked
// bin by bin as extra terms after the block, and an ω row with any other
// column list (split, shared by a difference and a sum, or empty) is a
// task of its own that sums its columns in order from the [column][bin]
// tables (the per-row walk) — no atomics anywhere, every sum in a fixed
// order.
// The constants come through a type: TableConsts reads per-gap tables
// (G, NE, C), each lane's pixels offset by their int32 gap ids; when all 32·P
// ids of a warp agree (a trap map's interior) the warp takes one table
// base, so every table load stays a broadcast, and only mixed warps gather
// per pixel.  AnalyticConsts reads (a, b) pairs of column tables and forms
// relu(a − b·Δ²) (scattering) and a + b·Δ² (recombination) per pixel, and
// the closed-form Dynes ρ.  The TPU kernels' rolls, masked lane reductions
// and dynamic-sublane updates are Mosaic artefacts with no counterpart here.
//
// What bounds it on this card: not device memory (each state element is
// read once and written once) but how fast the SMs run the walk.  The walk
// before the blocking took, per ordered pair and P pixels, ≈ 2 shared
// loads, one load of the column's phonon values, one table load and two
// index loads for 2P fused multiply-adds, twice (QP and phonon side),
// each partner loaded again for every bin that pairs with it: it was bound
// by the shared-memory/L1 port (26.9 ms at 1024² × 100 in float32).  The
// blocks cut that traffic about B-fold a pair term: a step of j (or m, i)
// makes 2 shared loads, one phonon load and one index load, and B-wide
// vector table loads, for 2B·P fused multiply-adds, and each window's
// 1 + value is formed once, not B times.  That takes it to 17.0 ms
// (PERF.md §6), where the FP32 pipe's 4 instructions a pair term and pixel
// would need ≈ 4 ms at the SMs' full instruction rate: the steps' latency
// likely sets the pace now — a row index, then its phonon values, which
// mostly miss an L1 left small by the tiles' shared memory.  The host
// picks P and B per launch
// (ops/column_walk.py, column_pixels and column_bins, the rules measured
// with tools/column_walk_levers.py, PERF.md §6): B = 8 only where the
// tile's shared memory already holds the SM to 3 blocks, since its 80
// registers a thread cost the fourth.
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

// N consecutive entries, a multiple of 16 bytes, in 16-byte read-only
// loads; ``p`` is 16-byte aligned
template <typename T, int N>
__device__ __forceinline__ void ldv(const T* p, T (&v)[N]) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  static_assert(N % kPer == 0, "whole 16-byte loads");
  const uint4* src = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int c = 0; c < N / kPer; ++c) {
    union {
      uint4 r;
      T t[kPer];
    } u;
    u.r = __ldg(src + c);
#pragma unroll
    for (int n = 0; n < kPer; ++n) v[c * kPer + n] = u.t[n];
  }
}

// the column form's index arrays (device pointers)
struct Columns {
  const int* scat_k;    // (n_scat,) offset of each scattering column, ascending
  const int* scat_row;  // (n_scat,) its ω row
  const int* rec_s;     // (n_rec,) anti-diagonal of each recombination column, ascending
  const int* rec_row;   // (n_rec,) its ω row
  const int* row_ptr;   // (NW + 1,) each ω row's columns in row_code
  const int* row_code;  // column·2 + kind (0 scattering, 1 recombination)
  int n_scat;           // 0 when scattering is off
  int n_rec;            // 0 when recombination is off
};

// the blocked walk's index arrays (device pointers)
struct Blocked {
  const int* k_row;      // (NE,) ω row of offset k's first scattering column (k ≥ 1)
  const int* k_out;      // (NE,) that row where offset k's task writes it, else −1
  const int* s_row;      // (2NE − 1,) ω row of anti-diagonal s's first recombination column
  const int* s_out;      // (2NE − 1,) that row where anti-diagonal s's task writes it, else −1
  const int* x_scat;     // (n_xs,) scattering columns beyond the first of their offset
  const int* x_rec;      // (n_xr,) recombination columns beyond the first of their anti-diagonal
  const int* slow_rows;  // (n_slow,) ω rows the per-row walk writes
  int n_xs, n_xr, n_slow;
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
  const T* qs;            // (G, NE, ne_pad, 2): at [j][i] the pair of scat for bins i, j
  const T* qr;            // (G, NE, ne_pad): at [j][i] rec[i] of anti-diagonal i + j
  const T* ps;            // (G, NE, ne_pad, 2): at [m][k − 1] the pair of offset k at bin m
  const T* pr;            // (G, NE, s_pad): at [i][s] rec[i] of anti-diagonal s
  int ne, n_scat, n_rec, ne_pad, s_pad;

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
  // N consecutive entries at ``at`` of a dense (G, …) table of ``stride``
  // entries a gap, for each pixel: one vector load a warp whose gaps agree
  template <int N, int P, bool kMixed>
  __device__ __forceinline__ void run(const T* tab, long long stride, const Key (&g)[P],
                                      long long at, T (&v)[P][N]) const {
    if constexpr (!kMixed) {
      ldv<T, N>(tab + static_cast<long long>(g[0]) * stride + at, v[0]);
#pragma unroll
      for (int p = 1; p < P; ++p) {
#pragma unroll
        for (int n = 0; n < N; ++n) v[p][n] = v[0][n];
      }
    } else {
#pragma unroll
      for (int p = 0; p < P; ++p) ldv<T, N>(tab + static_cast<long long>(g[p]) * stride + at, v[p]);
    }
  }
  template <int B, int P, bool kMixed>
  __device__ __forceinline__ void pairs(const T* tab, const Key (&g)[P], long long at, T (&e)[P][B],
                                        T (&a)[P][B]) const {
    T v[P][2 * B];
    run<2 * B, P, kMixed>(tab, 2LL * ne * ne_pad, g, at * 2, v);
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int b = 0; b < B; ++b) e[p][b] = v[p][2 * b], a[p][b] = v[p][2 * b + 1];
    }
  }
  // the scattering pairs (i0 + b, j) and recombination entries of bins
  // i0 + b with partner j (QP side); the pairs of offsets k0 + b at bin m
  // and the entries of anti-diagonals s0 + b at bin i (phonon side)
  template <int B, int P, bool kMixed>
  __device__ __forceinline__ void qp_scat(const Key (&g)[P], int j, int i0, T (&e)[P][B],
                                          T (&a)[P][B]) const {
    pairs<B, P, kMixed>(qs, g, static_cast<long long>(j) * ne_pad + i0, e, a);
  }
  template <int B, int P, bool kMixed>
  __device__ __forceinline__ void qp_rec(const Key (&g)[P], int j, int i0, T (&r)[P][B]) const {
    run<B, P, kMixed>(qr, static_cast<long long>(ne) * ne_pad, g,
                      static_cast<long long>(j) * ne_pad + i0, r);
  }
  template <int B, int P, bool kMixed>
  __device__ __forceinline__ void ph_scat(const Key (&g)[P], int m, int k0, T (&e)[P][B],
                                          T (&a)[P][B]) const {
    pairs<B, P, kMixed>(ps, g, static_cast<long long>(m) * ne_pad + k0 - 1, e, a);
  }
  template <int B, int P, bool kMixed>
  __device__ __forceinline__ void ph_rec(const Key (&g)[P], int i, int s0, T (&r)[P][B]) const {
    run<B, P, kMixed>(pr, static_cast<long long>(ne) * s_pad, g,
                      static_cast<long long>(i) * s_pad + s0, r);
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
  const T* qs;      // (NE, ne_pad, 4), (NE, ne_pad, 2), (NE, ne_pad, 4), (NE, s_pad, 2):
  const T* qr;      // TableConsts' dense copies with these entries
  const T* ps;
  const T* pr;
  T gamma;
  int ne, n_scat, n_rec, ne_pad, s_pad;

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
  // B quads (a, a', b, b') from one run of 4B entries, formed per pixel
  template <int B, int P>
  __device__ __forceinline__ void quads(const T* at, const Key (&d2)[P], T (&e)[P][B],
                                        T (&a)[P][B]) const {
    T v[4 * B];
    ldv<T, 4 * B>(at, v);
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int b = 0; b < B; ++b) {
        e[p][b] = relu(v[4 * b] - v[4 * b + 2] * d2[p]);
        a[p][b] = relu(v[4 * b + 1] - v[4 * b + 3] * d2[p]);
      }
    }
  }
  template <int B, int P>
  __device__ __forceinline__ void affines(const T* at, const Key (&d2)[P], T (&r)[P][B]) const {
    T v[2 * B];
    ldv<T, 2 * B>(at, v);
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int b = 0; b < B; ++b) r[p][b] = v[2 * b] + v[2 * b + 1] * d2[p];
    }
  }
  template <int B, int P, bool>
  __device__ __forceinline__ void qp_scat(const Key (&d2)[P], int j, int i0, T (&e)[P][B],
                                          T (&a)[P][B]) const {
    quads<B, P>(qs + (static_cast<long long>(j) * ne_pad + i0) * 4, d2, e, a);
  }
  template <int B, int P, bool>
  __device__ __forceinline__ void qp_rec(const Key (&d2)[P], int j, int i0, T (&r)[P][B]) const {
    affines<B, P>(qr + (static_cast<long long>(j) * ne_pad + i0) * 2, d2, r);
  }
  template <int B, int P, bool>
  __device__ __forceinline__ void ph_scat(const Key (&d2)[P], int m, int k0, T (&e)[P][B],
                                          T (&a)[P][B]) const {
    quads<B, P>(ps + (static_cast<long long>(m) * ne_pad + k0 - 1) * 4, d2, e, a);
  }
  template <int B, int P, bool>
  __device__ __forceinline__ void ph_rec(const Key (&d2)[P], int i, int s0, T (&r)[P][B]) const {
    affines<B, P>(pr + (static_cast<long long>(i) * s_pad + s0) * 2, d2, r);
  }
};

// the phonon values of ω row ``row`` for a lane's P pixels, one P-wide
// load from ``at`` (the lane's first pixel of row 0).  The host launches
// P = 2 only for an even pixel count; the idle pixels of a ragged tile
// read the last pixels' values, and their results are never stored.
template <typename T, int P>
__device__ __forceinline__ Px<T, P> row_value(const T* at, int row, int stride) {
  at += static_cast<long long>(row) * stride;
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

// the state of one lane's walk after the staging
template <typename T, int P, typename Consts>
struct Lane {
  const Consts& consts;
  const typename Consts::Key (&key)[P];
  const Columns& cols;
  const Blocked& bl;
  const T* sq;
  const T* sp;
  const T* ph_in;
  const T* ph_px;  // the lane's first pixel whose phonon values it reads, in row 0
  T* q_out;
  T* ph_out;
  int ne;
  long long n_pix, p0;
  int stride;  // n_pix, below 2^31 (the launch checks)
  int x0;
  T dt;

  __device__ __forceinline__ Px<T, P> q(int i) const { return lds<T, P>(sq + i * 32 * P, x0); }
  __device__ __forceinline__ Px<T, P> p(int i) const { return lds<T, P>(sp + i * 32 * P, x0); }
  __device__ __forceinline__ Px<T, P> ph(int row) const {
    return row_value<T, P>(ph_px, row, stride);
  }
  // the relaxed q of bin i from its rates
  __device__ __forceinline__ void store_q(int i, const T (&loss)[P], const T (&gain)[P]) const {
    const Px<T, P> qi = q(i), pi = p(i);
    T* out = q_out + static_cast<long long>(i) * n_pix + p0;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (p0 + k < n_pix) out[k] = relax(qi.v[k], pi.v[k] * gain[k], loss[k], dt);
    }
  }
  // ω row r from its rates (y' = a + b·y)
  __device__ __forceinline__ void store_ph(int r, const T (&a)[P], const T (&b)[P]) const {
    const T* y = ph_in + static_cast<long long>(r) * n_pix + p0;
    T* out = ph_out + static_cast<long long>(r) * n_pix + p0;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (p0 + k < n_pix) out[k] = affine(y[k], a[k], b[k], dt);
    }
  }
};

// ω row r, each of its columns over its bins in the row list's order, from
// the [column][bin] tables (the per-row walk); a row no column touches is
// copied unchanged
template <bool kMixed, typename T, int P, typename Consts>
__device__ __forceinline__ void row_walk(const Lane<T, P, Consts>& l, int r) {
  const Consts& consts = l.consts;
  const Columns& cols = l.cols;
  const int ne = l.ne;
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
        consts.template scat_col<P, kMixed>(l.key, c, m, ke, ka);
        const Px<T, P> qm = l.q(m), pm = l.p(m), qj = l.q(m - k), pj = l.p(m - k);
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
        consts.template rec_col<P, kMixed>(l.key, c, i, kr);
        const Px<T, P> qi = l.q(i), pi = l.p(i), qj = l.q(s - i), pj = l.p(s - i);
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
  if (e0 == e1) {
    const T* y = l.ph_in + static_cast<long long>(r) * l.n_pix + l.p0;
    T* out = l.ph_out + static_cast<long long>(r) * l.n_pix + l.p0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (l.p0 + p < l.n_pix) out[p] = y[p];
    }
  } else {
    l.store_ph(r, a, b);
  }
}

// where the partners j of a chunk lie against the QP block [i0, i0 + B)
enum Span { kBelow, kInside, kAbove };

// a register window of B phonon values and their 1 + value, slot by slot
template <typename T, int P, int B>
struct Window {
  Px<T, P> v[B], v1[B];

  __device__ __forceinline__ void set(int slot, const Px<T, P>& x) {
    v[slot] = x;
#pragma unroll
    for (int p = 0; p < P; ++p) v1[slot].v[p] = T(1) + x.v[p];
  }
};

// B steps j = jc + u of the QP block [i0, i0 + B)'s scattering pass (only
// u with jc + u < NE where kGuard): the window holds offset |δ|'s value in
// slot δ mod B (δ = i − j), a slot fixed at compile time since i0 and jc
// are multiples of B; the step's new value is δ = i0 − j's (b = 0)
template <int kSpan, bool kGuard, bool kMixed, int B, typename T, int P, typename Consts>
__device__ __forceinline__ void scat_chunk(const Lane<T, P, Consts>& l, int i0, int jc,
                                           T (&loss)[B][P], T (&gain)[B][P],
                                           Window<T, P, B>& d) {
#pragma unroll
  for (int u = 0; u < B; ++u) {
    const int j = jc + u;
    if (kGuard && j >= l.ne) break;
    const Px<T, P> qj = l.q(j), pj = l.p(j);
    d.set((B - u) % B, l.ph(l.bl.k_row[kSpan == kBelow ? i0 - j : j - i0]));
    T e[P][B], a[P][B];
    l.consts.template qp_scat<B, P, kMixed>(l.key, j, i0, e, a);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int w = (b - u + B) % B;
      if (kSpan == kBelow || (kSpan == kInside && b > u)) {
        // pair (i, j), j = i − k: emission i → j (loss, partner[j]),
        // absorption j → i (gain, q[j])
#pragma unroll
        for (int p = 0; p < P; ++p) {
          loss[b][p] += e[p][b] * d.v1[w].v[p] * pj.v[p];
          gain[b][p] += a[p][b] * d.v[w].v[p] * qj.v[p];
        }
      } else if (kSpan == kAbove || b < u) {
        // pair (j, i), j = i + k: absorption i → j (loss, partner[j]),
        // emission j → i (gain, q[j]); the entry of bin j
#pragma unroll
        for (int p = 0; p < P; ++p) {
          loss[b][p] += a[p][b] * d.v[w].v[p] * pj.v[p];
          gain[b][p] += e[p][b] * d.v1[w].v[p] * qj.v[p];
        }
      }
    }
  }
}

// B steps of the QP block's recombination pass: the window holds
// anti-diagonal s's value in slot s mod B; the step's new value is
// s = i0 + B − 1 + j's (b = B − 1).  Recombination with bin j and pair
// breaking into (i, j)
template <bool kGuard, bool kMixed, int B, typename T, int P, typename Consts>
__device__ __forceinline__ void rec_chunk(const Lane<T, P, Consts>& l, int i0, int jc,
                                          T (&loss)[B][P], T (&gain)[B][P],
                                          Window<T, P, B>& v) {
#pragma unroll
  for (int u = 0; u < B; ++u) {
    const int j = jc + u;
    if (kGuard && j >= l.ne) break;
    const Px<T, P> qj = l.q(j), pj = l.p(j);
    v.set((B - 1 + u) % B, l.ph(l.bl.s_row[i0 + B - 1 + j]));
    T r[P][B];
    l.consts.template qp_rec<B, P, kMixed>(l.key, j, i0, r);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int w = (b + u) % B;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        loss[b][p] += r[p][b] * v.v1[w].v[p] * qj.v[p];
        gain[b][p] += r[p][b] * v.v[w].v[p] * pj.v[p];
      }
    }
  }
}

// the QP side of bins [i0, i0 + B): each channel's pass over every partner
// j once, then the columns beyond the first of their offset or
// anti-diagonal bin by bin
template <bool kMixed, int B, typename T, int P, typename Consts>
__device__ __forceinline__ void qp_block(const Lane<T, P, Consts>& l, int i0) {
  const Consts& consts = l.consts;
  const Columns& cols = l.cols;
  const Blocked& bl = l.bl;
  const int ne = l.ne;
  T loss[B][P], gain[B][P];
#pragma unroll
  for (int b = 0; b < B; ++b) {
#pragma unroll
    for (int p = 0; p < P; ++p) loss[b][p] = gain[b][p] = T(0);
  }
  if (cols.n_scat > 0) {
    Window<T, P, B> d;
#pragma unroll
    for (int b = 1; b < B; ++b) d.set(b, l.ph(bl.k_row[i0 + b]));  // offsets no step loads
    int jc = 0;
    for (; jc < i0; jc += B) scat_chunk<kBelow, false, kMixed>(l, i0, jc, loss, gain, d);
    scat_chunk<kInside, true, kMixed>(l, i0, jc, loss, gain, d);
    for (jc += B; jc + B <= ne; jc += B) scat_chunk<kAbove, false, kMixed>(l, i0, jc, loss, gain, d);
    if (jc < ne) scat_chunk<kAbove, true, kMixed>(l, i0, jc, loss, gain, d);
  }
  if (cols.n_rec > 0) {
    Window<T, P, B> v;
#pragma unroll
    for (int b = 0; b < B - 1; ++b) v.set(b, l.ph(bl.s_row[i0 + b]));  // sums no step loads
    int jc = 0;
    for (; jc + B <= ne; jc += B) rec_chunk<false, kMixed>(l, i0, jc, loss, gain, v);
    if (jc < ne) rec_chunk<true, kMixed>(l, i0, jc, loss, gain, v);
  }
  const bool extra = bl.n_xs + bl.n_xr > 0;
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int i = i0 + b;
    if (i >= ne) break;
    for (int x = 0; extra && x < bl.n_xs; ++x) {
      const int c = bl.x_scat[x], k = cols.scat_k[c];
      const Px<T, P> dc = l.ph(cols.scat_row[c]);
      T e[P], a[P];
      if (k <= i) {  // pair (i, i−k)
        const Px<T, P> pj = l.p(i - k), qj = l.q(i - k);
        consts.template scat_at<P, kMixed>(l.key, i, c, e, a);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          loss[b][p] += e[p] * (T(1) + dc.v[p]) * pj.v[p];
          gain[b][p] += a[p] * dc.v[p] * qj.v[p];
        }
      }
      if (i + k < ne) {  // pair (i+k, i)
        const Px<T, P> pm = l.p(i + k), qm = l.q(i + k);
        consts.template scat_at<P, kMixed>(l.key, i + k, c, e, a);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          loss[b][p] += a[p] * dc.v[p] * pm.v[p];
          gain[b][p] += e[p] * (T(1) + dc.v[p]) * qm.v[p];
        }
      }
    }
    for (int x = 0; extra && x < bl.n_xr; ++x) {
      const int c = bl.x_rec[x], j = cols.rec_s[c] - i;
      if (j < 0 || j >= ne) continue;
      const Px<T, P> sv = l.ph(cols.rec_row[c]);
      const Px<T, P> qj = l.q(j), pj = l.p(j);
      T r[P];
      consts.template rec_at<P, kMixed>(l.key, i, c, r);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        loss[b][p] += r[p] * (T(1) + sv.v[p]) * qj.v[p];
        gain[b][p] += r[p] * sv.v[p] * pj.v[p];
      }
    }
    l.store_q(i, loss[b], gain[b]);
  }
}

// B steps m = mc + u of the first scattering columns of offsets
// [k0, k0 + B): q_m, partner_m once, the partners m − k from a window
// (slot (m − k0 − b) mod B; zeros before the first), each column's sums in
// the per-row walk's order (the steps m < k add zero)
template <bool kGuard, bool kMixed, int B, typename T, int P, typename Consts>
__device__ __forceinline__ void scat_row_chunk(const Lane<T, P, Consts>& l, int k0, int mc,
                                               T (&em)[B][P], T (&ab)[B][P], Px<T, P> (&wq)[B],
                                               Px<T, P> (&wp)[B]) {
#pragma unroll
  for (int u = 0; u < B; ++u) {
    const int m = mc + u;
    if (kGuard && m >= l.ne) break;
    const Px<T, P> qm = l.q(m), pm = l.p(m);
    wq[u] = l.q(m - k0);
    wp[u] = l.p(m - k0);
    T ke[P][B], ka[P][B];
    l.consts.template ph_scat<B, P, kMixed>(l.key, m, k0, ke, ka);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int w = (u - b + B) % B;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        em[b][p] += ke[p][b] * qm.v[p] * wp[w].v[p];  // pair (m → m−k)
        ab[b][p] += ka[p][b] * wq[w].v[p] * pm.v[p];  // pair (m−k → m)
      }
    }
  }
}

// the first scattering columns of offsets [k0, k0 + B) over m = k0, …
template <bool kMixed, int B, typename T, int P, typename Consts>
__device__ __forceinline__ void scat_block(const Lane<T, P, Consts>& l, int k0) {
  const int ne = l.ne;
  T em[B][P], ab[B][P];
  Px<T, P> wq[B], wp[B];
#pragma unroll
  for (int b = 0; b < B; ++b) {
#pragma unroll
    for (int p = 0; p < P; ++p) em[b][p] = ab[b][p] = wq[b].v[p] = wp[b].v[p] = T(0);
  }
  int mc = k0;
  for (; mc + B <= ne; mc += B) scat_row_chunk<false, kMixed>(l, k0, mc, em, ab, wq, wp);
  if (mc < ne) scat_row_chunk<true, kMixed>(l, k0, mc, em, ab, wq, wp);
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int r = k0 + b < ne ? l.bl.k_out[k0 + b] : -1;
    if (r < 0) continue;
    T a[P], bb[P];
#pragma unroll
    for (int p = 0; p < P; ++p) a[p] = em[b][p], bb[p] = em[b][p] - ab[b][p];
    l.store_ph(r, a, bb);
  }
}

// B steps i = ic + u (i ≤ hi where kGuard) of the first recombination
// columns of anti-diagonals [s0, s0 + B): q_i, partner_i once, the partners
// s − i from a window (slot (s − i) mod B; zeros outside [0, NE)), each
// column's sums in the per-row walk's order (the steps outside its bins add
// zero); the step's new partner is s0 − i's (b = 0)
template <bool kGuard, bool kMixed, int B, typename T, int P, typename Consts>
__device__ __forceinline__ void rec_row_chunk(const Lane<T, P, Consts>& l, int s0, int ic, int hi,
                                              T (&rc)[B][P], T (&pb)[B][P], Px<T, P> (&wq)[B],
                                              Px<T, P> (&wp)[B]) {
#pragma unroll
  for (int u = 0; u < B; ++u) {
    const int i = ic + u;
    if (kGuard && i > hi) break;
    const int y = s0 - i, w0 = (B - u) % B;
    const bool in = static_cast<unsigned>(y) < static_cast<unsigned>(l.ne);
    wq[w0] = l.q(in ? y : 0);
    wp[w0] = l.p(in ? y : 0);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      wq[w0].v[p] = in ? wq[w0].v[p] : T(0);
      wp[w0].v[p] = in ? wp[w0].v[p] : T(0);
    }
    const Px<T, P> qi = l.q(i), pi = l.p(i);
    T kr[P][B];
    l.consts.template ph_rec<B, P, kMixed>(l.key, i, s0, kr);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int w = (b - u + B) % B;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const T k = T(0.5) * kr[p][b];  // dE·K^r₀
        rc[b][p] += k * qi.v[p] * wq[w].v[p];
        pb[b][p] += k * pi.v[p] * wp[w].v[p];
      }
    }
  }
}

// the first recombination columns of anti-diagonals [s0, s0 + B) over i
template <bool kMixed, int B, typename T, int P, typename Consts>
__device__ __forceinline__ void rec_block(const Lane<T, P, Consts>& l, int s0) {
  const int ne = l.ne;
  const int lo = s0 - ne + 1 > 0 ? s0 - ne + 1 : 0;
  const int hi = s0 + B - 1 < ne - 1 ? s0 + B - 1 : ne - 1;
  const int ic0 = lo - lo % B;
  T rc[B][P], pb[B][P];
  Px<T, P> wq[B], wp[B];
#pragma unroll
  for (int b = 0; b < B; ++b) {
#pragma unroll
    for (int p = 0; p < P; ++p) rc[b][p] = pb[b][p] = wq[b].v[p] = wp[b].v[p] = T(0);
    const int y = s0 + b - ic0;  // the partners of the first step's b ≥ 1
    if (b > 0 && y < ne) {
      wq[b] = l.q(y);
      wp[b] = l.p(y);
    }
  }
  int ic = ic0;
  for (; ic + B - 1 <= hi; ic += B) rec_row_chunk<false, kMixed>(l, s0, ic, hi, rc, pb, wq, wp);
  if (ic <= hi) rec_row_chunk<true, kMixed>(l, s0, ic, hi, rc, pb, wq, wp);
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int r = s0 + b < 2 * ne - 1 ? l.bl.s_out[s0 + b] : -1;
    if (r < 0) continue;
    T a[P], bb[P];
#pragma unroll
    for (int p = 0; p < P; ++p) a[p] = rc[b][p], bb[p] = rc[b][p] - pb[b][p];
    l.store_ph(r, a, bb);
  }
}

// the walk of one lane's P pixels after the staging: the blocked walk's
// tasks (see the header)
template <typename T, int P, int B, bool kMixed, typename Consts>
__device__ __forceinline__ void walk(const Lane<T, P, Consts>& l, int warp, int update_phonons) {
  static_assert(P == 1 || P == 2, "one or two pixels per lane");
  const int ne = l.ne;
  const int nq = (ne + B - 1) / B;
  const int ns = update_phonons && l.cols.n_scat > 0 ? (ne - 1 + B - 1) / B : 0;
  const int nr = update_phonons && l.cols.n_rec > 0 ? (2 * ne - 1 + B - 1) / B : 0;
  const int nx = update_phonons ? l.bl.n_slow : 0;
  for (int t = warp; t < nq + ns + nr + nx; t += kWarps) {
    if (t < nq) {
      qp_block<kMixed, B>(l, t * B);
    } else if (t < nq + ns) {
      scat_block<kMixed, B>(l, 1 + (t - nq) * B);
    } else if (t < nq + ns + nr) {
      rec_block<kMixed, B>(l, (t - nq - ns) * B);
    } else {
      row_walk<kMixed>(l, l.bl.slow_rows[t - nq - ns - nr]);
    }
  }
}

// the registers must leave 4 blocks per SM (≤ 64 a thread): the 100-bin
// float32 tile at P = 2 leaves 4 by shared memory, and at the 100
// registers ptxas took unbounded K5 ran 1.27x slower on 2 blocks
// (tools/time_blocked.py, PERF.md §6); a few spilled words cost less.  The
// 8-bin register block holds 16 accumulators, a window of 16 and its 16
// table entries a pixel: it takes 3 blocks (≤ 80 registers)
template <typename T, int P, int B, typename Consts, bool kDevice>
__global__ void __launch_bounds__(kThreads, B == 8 ? 3 : 4) column_walk_kernel(
    const T* __restrict__ q_in, const T* __restrict__ ph_in, const T* __restrict__ gen,
    T* __restrict__ q_out, T* __restrict__ ph_out, Consts consts, Columns cols, Blocked bl, int ne,
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
  const Lane<T, P, Consts> l{consts, key,  cols, bl,   sq,  sp,
                             ph_in,  ph_in + (p0 < n_pix ? p0 : n_pix - P), q_out, ph_out,
                             ne,     n_pix, p0,  static_cast<int>(n_pix), x0, dt};
  if (mixed) {
    walk<T, P, B, true>(l, warp, update_phonons);
  } else {
    walk<T, P, B, false>(l, warp, update_phonons);
  }
}

// the staged form (scratch null) or the device-memory form (scratch: the
// blocks' slices, 2·NE·32·P entries each)
template <typename T, int P, int B, typename Consts, bool kDevice>
int launch_form(const T* q_in, const T* ph_in, const T* gen, T* q_out, T* ph_out,
                const Consts& consts, const Columns& cols, const Blocked& bl, int ne,
                long long n_pix, double dt, int update_phonons, T* scratch, cudaStream_t stream) {
  const long long smem = kDevice ? 0 : 2LL * ne * 32 * P * static_cast<long long>(sizeof(T));
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > max_smem) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = column_walk_kernel<T, P, B, Consts, kDevice>;
  if (!kDevice) {
    // above 48 KB only after the opt-in; a refused launch would never run
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned int blocks = static_cast<unsigned int>((n_pix + 32 * P - 1) / (32 * P));
  kernel<<<blocks, kThreads, static_cast<size_t>(smem), stream>>>(
      q_in, ph_in, gen, q_out, ph_out, consts, cols, bl, ne, n_pix, static_cast<T>(dt),
      update_phonons, scratch);
  return static_cast<int>(cudaGetLastError());
}

// the (P, B) forms built, those the host's rules launch (column_pixels,
// column_bins): P = 1 with B = 4, staged and in device memory; and, in
// float32 only, staged P = 1 with B = 8 and P = 2 with B = 4
template <typename T, typename Consts>
int launch(const T* q_in, const T* ph_in, const T* gen, T* q_out, T* ph_out, const Consts& consts,
           const Columns& cols, const Blocked& bl, int ne, long long n_pix, double dt,
           int update_phonons, int pixels, int bins, T* scratch, void* stream) {
  constexpr bool kWide = sizeof(T) == 4;
  // P = 2 reads a lane's phonon values as one pair: even pixel counts and a
  // pair-aligned phonon state only
  const bool pairs_ok =
      n_pix % 2 == 0 && reinterpret_cast<unsigned long long>(ph_in) % (2 * sizeof(T)) == 0;
  const bool form_ok = bins == 4 ? pixels == 1 || (pixels == 2 && kWide && pairs_ok && !scratch)
                                 : bins == 8 && pixels == 1 && kWide && !scratch;
  if (ne < 2 || !form_ok || n_pix > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (n_pix <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define QP_FORM(PP, BB, DEV)                                                                   \
  return launch_form<T, PP, BB, Consts, DEV>(q_in, ph_in, gen, q_out, ph_out, consts, cols, bl, \
                                             ne, n_pix, dt, update_phonons, scratch, s)
  if (scratch != nullptr) QP_FORM(1, 4, true);
  if constexpr (kWide) {
    if (pixels == 2) QP_FORM(2, 4, false);
    if (bins == 8) QP_FORM(1, 8, false);
  }
  QP_FORM(1, 4, false);
#undef QP_FORM
}

}  // namespace

// Plain C interface (loaded with ctypes), one entry per dtype for all four
// kernels.  Table form (g2 null): rho (G, NE), scat (G, NE, n_scat, 2) and
// its column-major copy scat_t (G, n_scat, NE, 2), rec (G, NE, n_rec) and
// rec_t (G, n_rec, NE), and the blocked walk's dense copies qs (G, NE,
// ne_pad, 2), qr (G, NE, ne_pad), ps (G, NE, ne_pad, 2), pr (G, NE, s_pad);
// gid null (uniform gap) or (n_pix,) int32 ids.  Analytic form (g2
// non-null): scat (NE, n_scat, 4), scat_t (n_scat, NE, 4), rec (NE, n_rec,
// 2), rec_t (n_rec, NE, 2), qs (NE, ne_pad, 4), qr (NE, ne_pad, 2), ps (NE,
// ne_pad, 4), pr (NE, s_pad, 2), the Δ² plane and the Dynes constants.
// ne_pad and s_pad are NE and 2NE − 1 rounded up to 8.  A channel's tables
// (with their index arrays) may be null (channel off), gen null (no
// generation), ph_out null when update_phonons is 0.  pixels (1 or 2)
// picks the lane's width, bins the register block (4; 8 only in float32
// at pixels 1, staged); k_row and s_row hold valid ω rows up to NE + 7
// and 2NE + 6.  scratch null launches the staged form; else the
// device-memory form, at pixels 1 and bins 4, with scratch holding 2·NE·32
// entries per 32-pixel tile.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a width the inputs do not allow or a staged
// tile that does not fit the block's shared memory.
#define QP_COLUMN_WALK_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(const T* q_in, const T* ph_in, const T* gen, T* q_out, T* ph_out,       \
                      const int* gid, const T* rho, const T* scat, const T* scat_t,            \
                      const T* rec, const T* rec_t, const T* qs, const T* qr, const T* ps,     \
                      const T* pr, int ne_pad, int s_pad, const T* g2, const T* e_bins,        \
                      const T* inv_e, const T* e2, const T* zim, double gamma,                 \
                      const int* scat_k, const int* scat_row, int n_scat, const int* rec_s,    \
                      const int* rec_row, int n_rec,                                           \
                      const int* row_ptr, const int* row_code, const int* k_row,               \
                      const int* k_out, const int* s_row, const int* s_out,                    \
                      const int* x_scat, int n_xs, const int* x_rec, int n_xr,                 \
                      const int* slow_rows, int n_slow, int ne, long long n_pix,               \
                      double dt, int update_phonons, int pixels, int bins, T* scratch,         \
                      void* stream) {                                                          \
    const int ns = scat != nullptr ? n_scat : 0, nr = rec != nullptr ? n_rec : 0;              \
    const Columns cols{scat_k, scat_row, rec_s, rec_row, row_ptr, row_code, ns, nr};           \
    const Blocked bl{k_row, k_out, s_row, s_out, x_scat, x_rec, slow_rows, n_xs, n_xr, n_slow}; \
    if (g2 != nullptr) {                                                                       \
      const AnalyticConsts<T> c{g2,     e_bins, inv_e, e2, zim, scat,  scat_t, rec,             \
                                rec_t,  qs,     qr,    ps, pr,  static_cast<T>(gamma),         \
                                ne,     ns,     nr,    ne_pad, s_pad};                         \
      return launch<T>(q_in, ph_in, gen, q_out, ph_out, c, cols, bl, ne, n_pix, dt,            \
                       update_phonons, pixels, bins, scratch, stream);                         \
    }                                                                                          \
    const TableConsts<T> c{gid, rho, scat, scat_t, rec, rec_t, qs, qr, ps, pr,                \
                           ne,  ns,  nr,   ne_pad, s_pad};                                     \
    return launch<T>(q_in, ph_in, gen, q_out, ph_out, c, cols, bl, ne, n_pix, dt,              \
                     update_phonons, pixels, bins, scratch, stream);                           \
  }

QP_COLUMN_WALK_ENTRY(qp_column_walk_f32, float)
QP_COLUMN_WALK_ENTRY(qp_column_walk_f64, double)
