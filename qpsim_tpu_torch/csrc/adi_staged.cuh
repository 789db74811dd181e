// Shared-memory line solves of the ADI kernels, shared by the separable
// step (K1, adi_sep.cu), the fused step (K2, adi.cu) and the line solve
// (K7, adi_lines.cu, the y half on a given rhs).
//
// A block owns TL lines of one bin: rows of the state in the x half,
// columns in the y half, with one thread per (line, Wang chunk).  What a
// chunk's eliminations produce stays in shared memory; only the state (and
// the planes) are read from device memory and only the solution is
// written.
//   x half: consecutive x are one row, so the block first stages its TL
//     rows into shared memory with coalesced loads (consecutive threads on
//     consecutive x, each thread walking down the rows with the rows above
//     and below in registers, the rows outside the grid zero), solves them
//     there, and writes them back with coalesced stores.
//   y half: a row of the block's TL columns is already contiguous, so each
//     thread reads its chunk straight from device memory as its forward
//     sweep walks down it (the warp's loads are TL-wide runs) and writes
//     the solution as its last sweep walks it; only what the sweeps keep
//     lives in shared memory.
// A policy class P supplies what differs between the kernels (K2's and
// K7's derive the sweeps from WangStages below):
//   P::T; P::kArrays, the values staged per cell in the x half, in the
//   order (a, c, rhs, b) for K2 and (rhs) for K1; P::kKept, the first
//   kArrays of them that the sweeps keep (A′, C′, D for K2; D for K1);
//   P::kSlots, the per-chunk boundary values of the interface recurrence;
//   P::kTable, the per-chunk values of a table staged once per block;
//   table(e)                       — entry e of that table;
//   state(line, p)                 — the state at position p of a line of
//                                    this bin (zero outside the grid);
//   fetch(l, p, up, uc, dn, v)     — the kArrays values of position p of
//                                    the block's line l, from the state
//                                    there (uc) and on the lines before and
//                                    after (up, dn);
//   store(x, l, p)                 — write the solution;
//   eliminate(base, st, size, c, slots, l, keep, src)
//                                  — the chunk's forward and backward
//                                    sweeps over its M rows, row i's values
//                                    from src(i, v) and what they keep at
//                                    base[j·size + i·st]; with keep, the
//                                    boundary values into the slots;
//   interface(slots, table, l)     — the K-chunk interface recurrence;
//   finish(base, st, size, c, slots, l, sink)
//                                  — x_i = D_i − A_i·R_{c−1} − C_i·L_{c+1}
//                                    into sink(i, x).
//
// Layout.  Chunk c of a line holds positions c·M … c·M+M−1, M = ⌈n/K⌉
// (positions from n on, when K does not divide n, are identity rows that
// the policy fetches as such and never stores); its rows sit S apart (the
// chunk pitch S is M, or M + 1 when M is even, so that the
// 32 threads of a warp, each at row i of its own chunk, fall in 32
// distinct banks).  x half: element (line l, chunk slot w, row i) at
// (l·W + w)·S + i, thread t owning line t / W and slot t % W; y half: at
// (w·S + i)·TL + l, thread t owning line t % TL and slot t / TL.
//
// Long lines.  All K chunks of a line are held at once (W = K) when the
// block's lines fit in shared memory.  Otherwise W < K chunks of each line
// are held at a time, in K / W waves, and the solve takes two passes over
// the waves: the first eliminates each chunk and keeps only its boundary
// values, the second reads and eliminates it again and finishes it.  The
// state is then read twice and still written once; no elimination value
// goes to device memory in either form.  One chunk must fit (make_plan);
// a caller whose chunk count is free raises it until one does.

#pragma once

#include <cuda_runtime.h>

namespace qp_adi {

struct Staging {
  int n;   // line length
  int k;   // Wang chunks per line (1: the Thomas sweep)
  int m;   // rows per chunk, ⌈n / k⌉
  int s;   // chunk pitch in shared memory
  int tl;  // lines per block
  int w;   // chunks of a line held at once

  template <bool kXHalf>
  __device__ __forceinline__ int at(int l, int cw, int i) const {
    return kXHalf ? (l * w + cw) * s + i : (cw * s + i) * tl + l;
  }
  __device__ __forceinline__ int size() const { return tl * w * s; }  // one array
};

// Positions a thread of the x half loads before it stores any to shared
// memory, so that its loads overlap.
constexpr int kBatch = 4;

// The Wang partition of the TPU kernel (_wang_stages), in its order, for a
// policy that fetches a cell as (a, c, rhs, b) — K2 (adi.cu) and K7
// (adi_lines.cu) derive theirs from it: each chunk eliminates its sub- and
// super-diagonal (stages 1–2, A′ and C′ overwriting a and c), the 2K
// boundary unknowns of a line meet in one sequential recurrence (stage 3),
// and every chunk applies its neighbours' boundary values (stage 4).  A
// zero coupling row cuts an interval exactly; at K = 1 the stages reduce
// to the Thomas sweep.
template <typename T_>
struct WangStages {
  using T = T_;
  static constexpr int kArrays = 4;  // a → A′, c → C′, rhs → D → x, b
  static constexpr int kKept = 3;    // A′, C′, D (b is spent in the forward sweep)
  static constexpr int kOut = 2;
  static constexpr int kSlots = 6;   // aL, cL, dL, aR, cR, dR of each chunk
  static constexpr int kTable = 0;

  int k, m, tl;  // chunks per line, rows per chunk, lines per block

  __device__ __forceinline__ T table(int) const { return T(0); }

  // stages 1–2 on one chunk: A′ into base, C′ into base + size, D into
  // base + 2·size
  template <class Src>
  __device__ __forceinline__ void eliminate(T* base, int st, int size, int c, T* slots, int l,
                                            bool keep, Src&& src) const {
    T* a = base;
    T* cc = base + size;
    T* d = base + 2 * size;
    // stage 1: forward elimination of the sub-diagonal within the chunk,
    // row i + 1's values read while row i is eliminated.  The start values
    // make row 0 the TPU kernel's inv = 1/b_0, c′ = c_0·inv, a′ = a_0·inv
    // (X_L enters row 0 with weight a_0), d′ = d_0·inv.
    T cp = T(0), ap = T(-1), dp = T(0);
    T v[4], ahead[4];
    src(0, ahead);
#pragma unroll 4
    for (int i = 0; i < m; ++i) {
      const int j = i * st;
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = ahead[e];
      if (i + 1 < m) src(i + 1, ahead);
      const T a_i = v[0];
      const T inv = T(1) / (v[3] - a_i * cp);
      cp = v[1] * inv;
      ap = -a_i * ap * inv;
      dp = (v[2] - a_i * dp) * inv;
      a[j] = ap;
      cc[j] = cp;
      d[j] = dp;
    }
    // stage 2: backward elimination of the super-diagonal; row m − 1 is
    // already final (its c′ couples X_R)
    T c_n = cp, a_n = ap, d_n = dp;
#pragma unroll 4
    for (int i = m - 2; i >= 0; --i) {
      const int j = i * st;
      const T cp_i = cc[j];
      d_n = d[j] - cp_i * d_n;
      d[j] = d_n;
      if (k > 1) {
        c_n = -cp_i * c_n;
        a_n = a[j] - cp_i * a_n;
        cc[j] = c_n;
        a[j] = a_n;
      }
    }
    if (keep && k > 1) {
      const int kt = k * tl, at = c * tl + l;
      slots[at] = a_n;
      slots[kt + at] = c_n;
      slots[2 * kt + at] = d_n;
      slots[3 * kt + at] = ap;
      slots[4 * kt + at] = cp;
      slots[5 * kt + at] = dp;
    }
  }

  // stage 3: the interface recurrence of line l, p_j and q_j into the dL
  // and cL slots, g_j and w_j into dR and cR; then L_j into dL, R_j into dR
  __device__ __forceinline__ void interface(T* slots, const T*, int l) const {
    const int kt = k * tl;
    T *s_al = slots, *s_cl = slots + kt, *s_dl = slots + 2 * kt;
    T *s_ar = slots + 3 * kt, *s_cr = slots + 4 * kt, *s_dr = slots + 5 * kt;
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

  // stage 4: x_i = D_i − A_i·R_{c−1} − C_i·L_{c+1} (x_i = D_i at K = 1)
  template <class Sink>
  __device__ __forceinline__ void finish(const T* base, int st, int size, int c, const T* slots,
                                         int l, Sink&& sink) const {
    const int kt = k * tl;
    const T x_left = c > 0 ? slots[5 * kt + (c - 1) * tl + l] : T(0);
    const T x_right = c + 1 < k ? slots[2 * kt + (c + 1) * tl + l] : T(0);
    const T* a = base;
    const T* cc = base + size;
    const T* d = base + 2 * size;
#pragma unroll 4
    for (int i = 0; i < m; ++i) {
      const int j = i * st;
      sink(i, k > 1 ? d[j] - a[j] * x_left - cc[j] * x_right : d[j]);
    }
  }
};

// The block's part of one half-step; every thread of the block calls it
// (lines past the grid are solved as identity rows and never stored).
template <bool kXHalf, class P>
__device__ __forceinline__ void solve_lines(const P& pol, const Staging& g,
                                            typename P::T* smem) {
  using T = typename P::T;
  constexpr int kHeld = kXHalf ? P::kArrays : P::kKept;
  T* arr = smem;
  T* slots = smem + kHeld * g.size();
  T* table = slots + P::kSlots * g.k * g.tl;  // P::kTable values per chunk
  const int t = threadIdx.x, nt = blockDim.x;
  const int l = kXHalf ? t / g.w : t % g.tl;
  const int cw = kXHalf ? t % g.w : t / g.tl;
  const int waves = g.k / g.w;
  const int span = g.w * g.m;  // positions of a line in one wave
  const int size = g.size();
  const int st = kXHalf ? 1 : g.tl;
  T* mine = arr + g.at<kXHalf>(l, cw, 0);

  for (int e = t; e < P::kTable * g.k; e += nt) table[e] = pol.table(e);

  // x half: this thread's positions q = t, t + nt, … of a wave, kBatch at
  // a time, down the block's rows; (c, i) is q's chunk slot and row
  const int dc = nt / g.m, di = nt % g.m;
  auto x_positions = [&](auto&& fn) {
    int c = t / g.m, i = t % g.m;
    for (int q0 = t; q0 < span; q0 += kBatch * nt) {
      int cs[kBatch], is[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        cs[b] = c;
        is[b] = i;
        c += dc;
        i += di;
        if (i >= g.m) {
          i -= g.m;
          ++c;
        }
      }
      fn(q0, cs, is);
    }
  };
  auto stage = [&](int wave) {  // x half only
    const int p0 = wave * span;
    x_positions([&](int q0, const int* cs, const int* is) {
      T up[kBatch], uc[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (q0 + b * nt < span) {
          up[b] = pol.state(pol.line0 - 1, p0 + q0 + b * nt);
          uc[b] = pol.state(pol.line0, p0 + q0 + b * nt);
        }
      }
      for (int r = 0; r < g.tl; ++r) {
        T v[kBatch][P::kArrays];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (q0 + b * nt < span) {
            const int p = p0 + q0 + b * nt;
            const T dn = pol.state(pol.line0 + r + 1, p);
            pol.fetch(r, p, up[b], uc[b], dn, v[b]);
            up[b] = uc[b];
            uc[b] = dn;
          }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          if (q0 + b * nt < span) {
            const int at = g.at<true>(r, cs[b], is[b]);
#pragma unroll
            for (int j = 0; j < P::kArrays; ++j) arr[at + j * size] = v[b][j];
          }
        }
      }
    });
  };
  auto from_smem = [&](int i, T* v) {
#pragma unroll
    for (int j = 0; j < P::kArrays; ++j) v[j] = mine[j * size + i * st];
  };
  auto from_state = [&](int c) {  // y half: row i of chunk c from device memory
    return [&pol, c, l, m = g.m](int i, T* v) {
      const int p = c * m + i, line = pol.line0 + l;
      pol.fetch(l, p, pol.state(line - 1, p), pol.state(line, p), pol.state(line + 1, p), v);
    };
  };

  for (int wave = 0; wave < waves; ++wave) {
    const int c = wave * g.w + cw;
    if (kXHalf) {
      if (wave > 0) __syncthreads();
      stage(wave);
      __syncthreads();
      pol.eliminate(mine, st, size, c, slots, l, true, from_smem);
    } else {
      pol.eliminate(mine, st, size, c, slots, l, true, from_state(c));
    }
  }
  __syncthreads();
  if (g.k > 1 && cw == 0) pol.interface(slots, table, l);
  __syncthreads();
  for (int wave = 0; wave < waves; ++wave) {
    const int c = wave * g.w + cw;
    if (kXHalf) {
      if (waves > 1) {
        __syncthreads();
        stage(wave);
        __syncthreads();
        pol.eliminate(mine, st, size, c, slots, l, false, from_smem);
      }
      pol.finish(mine, st, size, c, slots, l,
                 [&](int i, T x) { mine[P::kOut * size + i] = x; });
      __syncthreads();
      const int p0 = wave * span;
      x_positions([&](int q0, const int* cs, const int* is) {
        for (int r = 0; r < g.tl; ++r) {
#pragma unroll
          for (int b = 0; b < kBatch; ++b) {
            if (q0 + b * nt < span) {
              pol.store(arr[P::kOut * size + g.at<true>(r, cs[b], is[b])], r, p0 + q0 + b * nt);
            }
          }
        }
      });
    } else {
      if (waves > 1) pol.eliminate(mine, st, size, c, slots, l, false, from_state(c));
      pol.finish(mine, st, size, c, slots, l,
                 [&](int i, T x) { pol.store(x, l, c * g.m + i); });
    }
  }
}

// Launch plan of one half: lines per block, chunks held at once, pitch,
// dynamic shared bytes, blocks.
struct Plan {
  int tl, w, s, smem, blocks, waves;
};

// The device's shared memory per block (opted in), read once per device.
inline int smem_optin() {
  static int cached[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] == 0) {
    cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return cached[dev];
}

// arrays: the values per cell held in shared memory (P::kArrays in the x
// half, P::kKept in the y half).  Returns false when even one chunk of one
// line does not fit in shared memory.
inline bool make_plan(bool x_half, int n, int n_lines, int nb, int k, int arrays, int slots,
                      int table, int elem, int max_threads, Plan* plan) {
  const int optin = smem_optin();
  const int m = (n + k - 1) / k;
  const int s = m % 2 == 0 ? m + 1 : m;
  auto bytes = [&](int tl, int w) {
    return (static_cast<long long>(tl) * (static_cast<long long>(arrays) * w * s +
                                          static_cast<long long>(slots) * k) +
            static_cast<long long>(table) * k) * elem;
  };
  int w = k;
  while (w > 1 && (w > max_threads || bytes(1, w) > optin)) {
    do --w; while (k % w);
  }
  if (bytes(1, w) > optin) return false;
  const int tl_max = max_threads / w > 1 ? max_threads / w : 1;
  int tl;
  if (x_half) {
    // the most lines per block while a block takes at most a third of the
    // SM's shared memory (measured: more lines beat more blocks, even
    // below one block per SM at 1024 lines)
    tl = tl_max;
    while (tl > 1 && bytes(tl, w) > optin / 3) tl /= 2;
  } else {
    // a warp's load in the y half is runs of TL columns: a whole 32-byte
    // sector of them, while two blocks fit per SM
    tl = 32 / elem < tl_max ? 32 / elem : tl_max;
    while (tl > 1 && bytes(tl, w) > optin / 2) tl /= 2;
  }
  plan->tl = tl;
  plan->w = w;
  plan->s = s;
  plan->smem = static_cast<int>(bytes(tl, w));
  plan->blocks = ((n_lines + tl - 1) / tl) * nb;
  plan->waves = k / w;
  return true;
}

// make_plan where the chunk count is the kernel's to choose (K2, K7).  A
// line of 256 cells or more takes at least 32 chunks, the last one padded
// with identity rows where 32 does not divide it: with fewer, each thread
// walks hundreds of dependent rows while shared memory holds only a few
// lines per SM.  Where one chunk still does not fit, K doubles until one
// does.  *k is the
// K asked for on entry and the K to launch on return.
inline bool make_plan_raising_k(bool x_half, int n, int n_lines, int nb, int* k, int arrays,
                                int slots, int table, int elem, int max_threads, Plan* plan) {
  if (*k < 32 && n >= 256) *k = 32;
  while (!make_plan(x_half, n, n_lines, nb, *k, arrays, slots, table, elem, max_threads, plan)) {
    if (*k >= n) return false;
    *k *= 2;
  }
  return true;
}

// Raise a kernel's dynamic shared-memory limit when a plan needs more than
// the default 48 KB (once per size).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, int* granted) {
  if (bytes <= 48 * 1024 || bytes <= *granted) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *granted = bytes;
  return err;
}

}  // namespace qp_adi
