// Fischer–Catelani collision substep walked by energy offset, for Hopper.
//
// offset_walk_kernel replaces two TPU kernels of qpsim_tpu/ops:
//   K8  pallas_collisions_loop.py, build_pallas_collision_step_loop (kernel
//       body :168): one column per offset k = i − j (Toeplitz: every pair on
//       it shares the phonon row diff_row[k]) and per anti-diagonal
//       s = i + j (Hankel: shared row sum_row[s]), a uniform gap or G ≤ 8
//       per-pixel gap ids; the builder declines grids whose ω diagonals split;
//   K9  pallas_collisions_rows.py, build_pallas_collision_step_rows (kernel
//       body :180): one column per (offset, ω row) and (anti-diagonal, ω row)
//       group, so a split diagonal becomes two columns and stays exact;
//       uniform gap.
// Both are one column form (host tables in ops/collisions_loop_cuda.py and
// ops/collisions_rows_cuda.py): scattering column c has an offset k_c, an ω
// row and four [G][NE][C] tables — e_up[i][c] = dE·K^s₀[i+k, i], e_dn[i][c] =
// dE·K^s₀[i, i−k], a_up[i][c] = dE·K^s₀[i, i+k], a_dn[i][c] = dE·K^s₀[i−k, i],
// zero for pairs outside the column's group; recombination column c has an
// anti-diagonal s_c, an ω row and R[i][c] = 2dE·K^r₀[i, s−i].  They compute
// the substep of K3 without the generation plane (the TPU kernels take
// none): update rules in collision_math.cuh.
//
// Design: one block of kWarps warps per tile of 32 pixels (one lane per
// pixel), as K5 (collisions_blocked.cu).  The block stages the tile's q and
// partner ρ(1 − f) [NE][32] in dynamic shared memory and, where it fits,
// the phonon value of every column's ω row [C][32], read once per tile,
// coalesced over the 32 pixels: every bin of a pixel meets the same value
// on a column.  Then
//   QP side:    warp w takes bins i = w, w + kWarps, …; it walks the
//               scattering columns (q[i±k], partner[i±k] from shared
//               memory, the four table entries at warp-uniform addresses:
//               broadcast loads) and the recombination columns of the
//               anti-diagonals s ∈ [i, i + NE) (a per-s column pointer),
//               and writes q_out coalesced;
//   phonon side: warp w owns ω rows w, w + kWarps, …; a host list gives each
//               row the columns that land on it (a difference row can also
//               be a sum row), and the owner sums every column's rates over
//               its bins in a fixed order — no atomics; rows no column
//               touches are copied unchanged.
// The TPU kernels' incremental ±1 rolls, masked lane reductions and
// dynamic-sublane read-modify-writes are Mosaic artefacts and have no
// counterpart here.  Where the staged phonon values do not fit the block's
// shared memory (float64 at 256 bins: 320 KB) the walk reads them from
// device memory through the columns' ω rows instead (kStage = false).
//
// What bounds it on this card: the issue rate of the walk, as K5 — per
// ordered pair ≈ 2 shared loads of the state, 1 of the column's phonon
// value and 1–2 broadcast table loads for ≈ 4 flops, twice (QP and phonon
// side) — not device memory: each state element is read once and written
// once.  Left for later: the unordered walk (pairs (i, j) and (j, i) share
// their column), the tables in shared memory, more pixels per lane.

#include <cuda_runtime.h>

#include "collision_math.cuh"

namespace {

using qpsim::affine;
using qpsim::relax;
using qpsim::relu;

constexpr int kTile = 32;  // pixels per block: one lane per pixel
constexpr int kWarps = 8;  // warps per block
constexpr int kThreads = kTile * kWarps;

// the column form of one substep (device pointers; tables null when their
// channel is off, gid null on a uniform gap)
template <typename T>
struct Walk {
  const unsigned char* gid;  // (n_pix,) uint8 gap ids or null
  const T* rho;              // (G, NE)
  const T* eup;              // (G, NE, n_scat) each
  const T* edn;
  const T* aup;
  const T* adn;
  const int* scat_k;    // (n_scat,) offset of each scattering column
  const int* scat_row;  // (n_scat,) its ω row
  const T* rtab;        // (G, NE, n_rec) 2dE·K^r₀
  const int* rec_s;     // (n_rec,) anti-diagonal of each recombination column
  const int* rec_row;   // (n_rec,) its ω row
  const int* s_ptr;     // (2NE,) first recombination column of anti-diagonal s
  const int* row_ptr;   // (NW + 1,) each ω row's columns in row_code
  const int* row_code;  // column·2 + kind (0 scattering, 1 recombination)
  int n_scat;
  int n_rec;
};

// the phonon value of column c: staged [C][32], or read through its ω row
template <typename T, bool kStage>
__device__ __forceinline__ T column_value(const T* staged, const T* ph, const int* rows, int c,
                                          int lane, long long n_pix) {
  if constexpr (kStage) {
    return staged[c * kTile + lane];
  } else {
    return ph[static_cast<long long>(rows[c]) * n_pix];
  }
}

template <typename T, bool kStage>
__global__ void __launch_bounds__(kThreads) offset_walk_kernel(
    const T* __restrict__ q_in, const T* __restrict__ ph_in, T* __restrict__ q_out,
    T* __restrict__ ph_out, Walk<T> w, int ne, int nw, long long n_pix, T dt,
    int update_phonons) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);  // [ne][kTile] q
  T* sp = sq + ne * kTile;                 // [ne][kTile] partner
  T* sd = sp + ne * kTile;                 // [n_scat][kTile] (kStage)
  T* ss = sd + w.n_scat * kTile;           // [n_rec][kTile] (kStage)
  const int lane = threadIdx.x % kTile;
  const int warp = threadIdx.x / kTile;
  const long long p = static_cast<long long>(blockIdx.x) * kTile + lane;
  const bool valid = p < n_pix;

  // this pixel's tables
  const long long g = (valid && w.gid != nullptr) ? w.gid[p] : 0;
  const T* rho = w.rho + g * ne;
  const long long scat_at = g * ne * w.n_scat;
  const long long rec_at = g * ne * w.n_rec;
  const bool scattering = w.eup != nullptr;
  const bool recombination = w.rtab != nullptr;

  for (int i = warp; i < ne; i += kWarps) {
    T qi = T(0), pi = T(0);
    if (valid) {
      qi = q_in[i * n_pix + p];
      const T r = rho[i];
      pi = r * relu(T(1) - qi / (r > T(1e-30) ? r : T(1e-30)));
    }
    sq[i * kTile + lane] = qi;
    sp[i * kTile + lane] = pi;
  }
  if constexpr (kStage) {
    for (int c = warp; c < w.n_scat; c += kWarps) {
      sd[c * kTile + lane] = valid ? ph_in[static_cast<long long>(w.scat_row[c]) * n_pix + p] : T(0);
    }
    for (int c = warp; c < w.n_rec; c += kWarps) {
      ss[c * kTile + lane] = valid ? ph_in[static_cast<long long>(w.rec_row[c]) * n_pix + p] : T(0);
    }
  }
  __syncthreads();
  if (!valid) return;  // no barrier follows

  const T* ph = ph_in + p;  // this pixel's column of the phonon rows
  for (int i = warp; i < ne; i += kWarps) {
    T loss = T(0), gain = T(0);
    if (scattering) {
      const long long row = scat_at + static_cast<long long>(i) * w.n_scat;
      for (int c = 0; c < w.n_scat; ++c) {
        const int k = w.scat_k[c];
        const T d = column_value<T, kStage>(sd, ph, w.scat_row, c, lane, n_pix);
        const T em = T(1) + d;  // emission: 1 + n_ph; absorption: n_ph
        if (i >= k) {  // emission i → i−k, absorption i−k → i
          const int j = (i - k) * kTile + lane;
          loss += w.edn[row + c] * em * sp[j];
          gain += w.adn[row + c] * d * sq[j];
        }
        if (i + k < ne) {  // absorption i → i+k, emission i+k → i
          const int j = (i + k) * kTile + lane;
          loss += w.aup[row + c] * d * sp[j];
          gain += w.eup[row + c] * em * sq[j];
        }
      }
    }
    if (recombination) {
      const long long row = rec_at + static_cast<long long>(i) * w.n_rec;
      for (int c = w.s_ptr[i]; c < w.s_ptr[i + ne]; ++c) {
        const int j = (w.rec_s[c] - i) * kTile + lane;
        const T s = column_value<T, kStage>(ss, ph, w.rec_row, c, lane, n_pix);
        const T r = w.rtab[row + c];
        loss += r * (T(1) + s) * sq[j];
        gain += r * s * sp[j];
      }
    }
    const T qi = sq[i * kTile + lane];
    q_out[i * n_pix + p] = relax(qi, sp[i * kTile + lane] * gain, loss, dt);
  }

  if (!update_phonons) return;
  for (int r = warp; r < nw; r += kWarps) {
    const T y = ph[static_cast<long long>(r) * n_pix];
    const int e0 = w.row_ptr[r], e1 = w.row_ptr[r + 1];
    if (e0 == e1) {  // no column lands here: the row stays as it is
      ph_out[static_cast<long long>(r) * n_pix + p] = y;
      continue;
    }
    T a = T(0), b = T(0);
    for (int e = e0; e < e1; ++e) {
      const int code = w.row_code[e];
      const int c = code >> 1;
      if ((code & 1) == 0) {  // scattering column: emission creates, absorption destroys
        const int k = w.scat_k[c];
        T em = T(0), ab = T(0);
        for (int j = 0; j + k < ne; ++j) {
          const long long at = scat_at + static_cast<long long>(j) * w.n_scat + c;
          const T qj = sq[j * kTile + lane], pj = sp[j * kTile + lane];
          const T qk = sq[(j + k) * kTile + lane], pk = sp[(j + k) * kTile + lane];
          em += w.eup[at] * qk * pj;  // pair (j+k → j)
          ab += w.aup[at] * qj * pk;  // pair (j → j+k)
        }
        a += em;
        b += em - ab;
      } else {  // recombination column: recombination creates, pair breaking destroys
        const int s = w.rec_s[c];
        const int lo = s - ne + 1 > 0 ? s - ne + 1 : 0;
        const int hi = s < ne - 1 ? s : ne - 1;
        T rec = T(0), pb = T(0);
        for (int i = lo; i <= hi; ++i) {
          const T k = T(0.5) * w.rtab[rec_at + static_cast<long long>(i) * w.n_rec + c];  // dE·K^r₀
          const int a_i = i * kTile + lane, a_j = (s - i) * kTile + lane;
          rec += k * sq[a_i] * sq[a_j];
          pb += k * sp[a_i] * sp[a_j];
        }
        a += rec;
        b += rec - pb;
      }
    }
    ph_out[static_cast<long long>(r) * n_pix + p] = affine(y, a, b, dt);
  }
}

template <typename T, bool kStage>
int launch_form(const T* q_in, const T* ph_in, T* q_out, T* ph_out, const Walk<T>& w, int ne,
                int nw, long long n_pix, double dt, int update_phonons, int smem,
                cudaStream_t stream) {
  auto kernel = offset_walk_kernel<T, kStage>;
  // above 48 KB only after the opt-in; a refused launch would never run
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int blocks = static_cast<unsigned int>((n_pix + kTile - 1) / kTile);
  kernel<<<blocks, kThreads, smem, stream>>>(q_in, ph_in, q_out, ph_out, w, ne, nw, n_pix,
                                             static_cast<T>(dt), update_phonons);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* q_in, const T* ph_in, T* q_out, T* ph_out, const Walk<T>& w, int ne, int nw,
           long long n_pix, double dt, int update_phonons, void* stream) {
  if (ne < 2) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long row_bytes = static_cast<long long>(kTile) * sizeof(T);
  const long long state = 2LL * ne * row_bytes;
  const long long staged = state + static_cast<long long>(w.n_scat + w.n_rec) * row_bytes;
  if (state > max_smem) return static_cast<int>(cudaErrorInvalidValue);
  if (n_pix <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (staged <= max_smem) {
    return launch_form<T, true>(q_in, ph_in, q_out, ph_out, w, ne, nw, n_pix, dt,
                                update_phonons, static_cast<int>(staged), s);
  }
  return launch_form<T, false>(q_in, ph_in, q_out, ph_out, w, ne, nw, n_pix, dt, update_phonons,
                               static_cast<int>(state), s);
}

}  // namespace

// Plain C interface (loaded with ctypes).  gid, the four scattering tables
// (with scat_k, scat_row) and the recombination table (with rec_s,
// rec_row, s_ptr) may be null (uniform gap, channel off); ph_out may be null
// when update_phonons is 0.  Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue when q and partner of a 32-pixel tile do not fit
// the block's shared memory.
#define QP_OFFSET_WALK_ENTRY(NAME, T)                                                      \
  extern "C" int NAME(const T* q_in, const T* ph_in, T* q_out, T* ph_out,                  \
                      const unsigned char* gid, const T* rho, const T* eup, const T* edn,  \
                      const T* aup, const T* adn, const int* scat_k, const int* scat_row,  \
                      int n_scat, const T* rtab, const int* rec_s, const int* rec_row,     \
                      const int* s_ptr, int n_rec, const int* row_ptr, const int* row_code, \
                      int ne, int nw, long long n_pix, double dt, int update_phonons,      \
                      void* stream) {                                                      \
    const Walk<T> w{gid,    rho,   eup,     edn,   aup,     adn,      scat_k, scat_row,    \
                    rtab,   rec_s, rec_row, s_ptr, row_ptr, row_code,                      \
                    eup != nullptr ? n_scat : 0, rtab != nullptr ? n_rec : 0};             \
    return launch<T>(q_in, ph_in, q_out, ph_out, w, ne, nw, n_pix, dt, update_phonons,     \
                     stream);                                                              \
  }

QP_OFFSET_WALK_ENTRY(qp_offset_walk_f32, float)
QP_OFFSET_WALK_ENTRY(qp_offset_walk_f64, double)
