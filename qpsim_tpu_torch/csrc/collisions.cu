// Fischer–Catelani collision substep up to 16 energy bins, for Hopper.
//
// collision_step_kernel replaces two TPU kernels of
// qpsim_tpu/ops/pallas_collisions.py:
//   K3  build_pallas_collision_step and its kernel _make_kernel (:169, call
//       :919): a uniform gap, or G ≤ 8 unique gaps blended per pixel by gap
//       id, with the forward-Euler generation plane dt·g fused (gen_input);
//   K4  build_pallas_collision_step_analytic and its kernel
//       _make_analytic_kernel (:429, call :721): continuous gap maps, the
//       constants affine in the pixel's Δ² and the Dynes ρ in closed form.
// It computes the plain integrator qpsim_tpu_torch/ops/collisions.py
// (collision_step_plain, collision_step_analytic_plain) for one pixel:
//   f = q / max(ρ, 1e-30),  partner p = ρ·max(1 − f, 0)
//   scattering, pair i > j (E_i > E_j) at ω row n = n_ph[idx_diff]:
//     emission i → j:   loss_i += K[i,j](1 + n)·p_j, gain_j += K[i,j](1 + n)·q_i,
//                       creation  q_i·K[i,j]·p_j
//     absorption j → i: loss_j += K[j,i]·n·p_i,     gain_i += K[j,i]·n·q_j,
//                       destruction q_j·K[j,i]·p_i
//   recombination, pair i ≥ j at ω row S = n_ph[idx_sum]:
//     loss_i += R[i,j](1 + S)·q_j, gain_i += R[i,j]·S·p_j (and the same for j
//     with R[j,i]), creation ½(R[i,j] + R[j,i])·q_i·q_j, destruction
//     the same with p (once on the diagonal i = j)
//   q⁺ = relax(q, p·gain, loss), n_ph⁺ = affine(n_ph, a, b) with a the
//   creation and b = a − destruction summed over the row's pairs
// (K = dE·K^s₀, R = 2dE·K^r₀; update rules in collision_math.cuh).  From
// 17 to 64 bins the wrappers (ops/collisions_cuda.py) launch the column
// walk of offset_walk.cu for K3 and K4, which measured faster there than
// any register form (PERF.md §6).
//
// Design.  One thread per pixel; the walk visits each unordered pair once,
// as the TPU kernel does, and forms the shared weights K·(1 + n), K·n,
// R·(1 + S), R·S and the products q_i·q_j, p_i·p_j once for both bins and
// the pair's ω row.  It goes diagonal-major: scattering along the
// diagonals k = i − j, recombination along the anti-diagonals s = i + j.
// The host cuts each diagonal into groups, one per ω row its pairs land on,
// so a split diagonal (NE 11 at Δ = 180, E_max = 4Δ) stays exact: each
// group carries the diagonal's constants with zeros at the pairs of other
// rows.  A group reads its row value once, from device memory, and keeps
// its creation and destruction sums in two registers, which it adds into
// the pixel's row rates a and b in shared memory (each thread its own
// column: no bank conflicts, no synchronisation); after the walk one loop
// updates every ω row, a row no pair reaches with a = b = 0 as the plain
// version does.
//
// The bins live in registers: the walk covers kBins = 16 bins (bins past
// NE carry q = 0, ρ = 0 and zero constants, which add exactly 0) and is
// spelled out by template recursion, so q, p, gain and loss are arrays with
// compile-time indices.  The constants sit in the constant bank, copied in
// before each launch on its stream: with a compile-time index an entry is
// an instruction operand, as the TPU kernel's baked constants are.  In the
// main path's simple form (NE = 16, one group per diagonal, every ω row
// reached by one group at most) every index is known at compile time;
// otherwise the groups come from device tables.
// TableConsts offsets each pixel's constants by its uint8 gap id — when a
// warp's ids agree (a trap map's interior, a uniform film) an access is one
// broadcast, mixed warps serialise per distinct id.  AnalyticConsts forms
// relu(a − b·Δ²) and a + b·Δ² once per unordered pair and the Dynes ρ per
// bin (collision_math.cuh).  K[i,j] and K[j,i] are read apart, so
// asymmetric tables stay exact, though the physics never makes them.  No
// tensor cores: the coefficients differ per pixel, and the float32 gates
// exclude TF32.
//
// What bounds it on this card: instruction issue, not bytes (≈ 500 B a
// pixel of state in and out, each element read and written once).  The
// walk is ≈ 10 flops per scattering pair and 14 per recombination pair;
// the ω-row and QP updates (exp, expm1 and a division each) cost as much
// again per pixel.  Unrolled per group, those updates made the kernel's
// code ≈ 10 k instructions (≈ 160 KB) and the kernel 1.5x slower: they run
// in loops after the walk, the QP update through shared memory
// (tools/collisions_ablate.py, PERF.md §6).

#include <cuda_runtime.h>

#include "collision_math.cuh"

namespace {

using qpsim::affine;
using qpsim::analytic_rho;
using qpsim::relax;
using qpsim::relu;

constexpr int kBlock = 128;  // threads per block at most (launch bound)
constexpr int kBins = 16;    // the walk's bins: NE ≤ 16 in registers, bins past NE padded
constexpr int kMaxRows = 64;  // the simple form's group rows (3·kBins − 2 of them)

// The launch's constants, copied in before each launch on its stream
// (ops/collisions_cuda.py packs them).  In the constant bank a table entry
// with a compile-time index is an instruction operand: the walk loads no
// constant, as the TPU kernel, whose constants are baked into its code.
// One bank serves every launch of a device, so launches must be ordered:
// the wrappers order a launch on a new stream after the last stream's
// queued work (ops/collisions_cuda.py, _bank_stream).
constexpr int kConstBytes = 48 * 1024;
union ConstBank {
  float f[kConstBytes / sizeof(float)];
  double d[kConstBytes / sizeof(double)];
};
__constant__ ConstBank c_bank;
// the simple form's ω row of each group: diagonals 1 … kBins − 1, then
// anti-diagonals 0 … 2kBins − 2
__constant__ int c_rows[kMaxRows];

template <typename T>
__device__ __forceinline__ T bank(int e);
template <>
__device__ __forceinline__ float bank<float>(int e) {
  return c_bank.f[e];
}
template <>
__device__ __forceinline__ double bank<double>(int e) {
  return c_bank.d[e];
}

// The walk's groups (device pointers, ops/collisions_cuda.py).  Group
// entries are the pairs of its diagonal in the walk's bins: diagonal k
// holds pairs (j + k, j), j = 0 … nb − 1 − k; anti-diagonal s holds pairs
// (s − j, j), j = max(0, s − nb + 1) … ⌊s/2⌋.  The constants of entry e
// start at scat_off + width·e (rec_off for recombination).
struct Groups {
  const int* s_ptr;    // (nb + 1,) scattering groups of diagonal k: [s_ptr[k], s_ptr[k + 1])
  const int* r_ptr;    // (2nb,) recombination groups of anti-diagonal s
  const int2* s_meta;  // per group: (ω row, first entry)
  const int2* r_meta;
  int scat_off, rec_off;
};

// K3: per gap [ρ (nb) | (K[i,j], K[j,i]) per scattering entry | (R[i,j],
// R[j,i]) per recombination entry], each pixel's gap by its uint8 id
template <typename T, bool kGapIds>
struct TableConsts {
  static constexpr int kHead = 1;   // ρ: one constant per bin
  static constexpr int kWidth = 2;  // constants per entry
  const unsigned char* gid;         // (n_pix,) with kGapIds
  int per_gap;                      // constants per gap

  struct Pixel {
    int base;  // the pixel's gap: gid·per_gap (0 without gap ids)
    __device__ __forceinline__ int at(int e) const { return kGapIds ? base + e : e; }
    __device__ __forceinline__ T partner(int i, T q) const {
      const T r = bank<T>(at(i));
      return r * relu(T(1) - q / (r > T(1e-30) ? r : T(1e-30)));
    }
    __device__ __forceinline__ void scattering(int e, T& ke, T& ka) const {
      ke = bank<T>(at(e));
      ka = bank<T>(at(e + 1));
    }
    __device__ __forceinline__ void recombination(int e, T& rij, T& rji) const {
      rij = bank<T>(at(e));
      rji = bank<T>(at(e + 1));
    }
  };
  __device__ __forceinline__ Pixel at(long long p) const {
    return {kGapIds ? static_cast<int>(gid[p]) * per_gap : 0};
  }
};

// K4: [E, 1/E, E² − γ², −2Eγ (nb each) | dE·(a_s[i,j], b_s[i,j], a_s[j,i],
// b_s[j,i]) per scattering entry | 2dE·(a_r[i,j], b_r[i,j], a_r[j,i],
// b_r[j,i]) per recombination entry]: the constants affine in the pixel's Δ²
template <typename T>
struct AnalyticConsts {
  static constexpr int kHead = 4;
  static constexpr int kWidth = 4;
  const T* g2;  // (n_pix,) Δ²
  T gamma;

  struct Pixel {
    T d2, gamma;
    __device__ __forceinline__ T partner(int i, T q) const {
      T rho_i, inv_i;
      analytic_rho(d2, bank<T>(i), bank<T>(kBins + i), bank<T>(2 * kBins + i),
                   bank<T>(3 * kBins + i), gamma, rho_i, inv_i);
      return rho_i * relu(T(1) - q * inv_i);
    }
    __device__ __forceinline__ void scattering(int e, T& ke, T& ka) const {
      ke = relu(bank<T>(e) - bank<T>(e + 1) * d2);
      ka = relu(bank<T>(e + 2) - bank<T>(e + 3) * d2);
    }
    __device__ __forceinline__ void recombination(int e, T& rij, T& rji) const {
      rij = bank<T>(e) + bank<T>(e + 1) * d2;
      rji = bank<T>(e + 2) + bank<T>(e + 3) * d2;
    }
  };
  __device__ __forceinline__ Pixel at(long long p) const { return {g2[p], gamma}; }
};

// entries before diagonal k (anti-diagonal s) in a walk over nb bins
__host__ __device__ constexpr int scattering_first(int nb, int k) {
  return (k - 1) * nb - (k - 1) * k / 2;
}
__host__ __device__ constexpr int recombination_first(int nb, int s) {
  int n = 0;
  for (int d = 0; d < s; ++d) n += d / 2 - (d - nb + 1 > 0 ? d - nb + 1 : 0) + 1;
  return n;
}

// One pixel's walk with its kBins bins in registers.  The walk is spelled
// out by template recursion over the diagonals and their pairs, so every
// bin index is a compile-time constant and q, p, gain and loss stay in
// registers.  A group's row sums go to the pixel's row accumulators a, b
// in shared memory; the rows' updates run after the walk, in a loop, so
// that their code (exp, expm1, a division) is not repeated per group.
// kSimple: NE = kBins, both channels on, one group per diagonal and no ω
// row reached by two groups (as on the main path's grid; the host decides,
// ops/collisions_cuda.py): group g of diagonal k is k − 1 (anti-diagonal
// s: kBins − 1 + s), its row in the constant bank and every constant's
// index known at compile time, and a group sets its row's rates where the
// general form adds (measured 1.2–1.7x faster, PERF.md §6).
template <typename T, bool kSimple, class Consts>
struct Walker {
  static constexpr int NB = kBins;
  static constexpr int kW = Consts::kWidth;
  static constexpr int kScatOff = Consts::kHead * NB;  // the simple layout's offsets
  static constexpr int kRecOff = kScatOff + kW * scattering_first(NB, NB);
  T q[NB], p[NB], gain[NB], loss[NB];
  typename Consts::Pixel c;
  Groups grp;
  const T* ph;  // the pixel's phonon column in device memory, [row][n_pix]
  long long n_pix;
  T* acc;       // its row accumulators a, b in shared memory, [2·row (+1)][thread]
  int cs;       // their stride (threads per block)

  // a group ends: its sums into its row's creation a and net rate b
  __device__ __forceinline__ void finish(int w, T pos, T neg) {
    T& a = acc[2 * w * cs];
    T& b = acc[(2 * w + 1) * cs];
    if (kSimple) {  // the row's only group (the host's simple flag)
      a = pos;
      b = pos - neg;
    } else {  // a difference and a sum may share an ω row
      a += pos;
      b += pos - neg;
    }
  }

  // scattering pair (I, J), I > J, its constants at x: emission I → J
  // dressed by 1 + n, absorption J → I dressed by n
  template <int I, int J>
  __device__ __forceinline__ void scattering_pair(int x, T n, T n1, T& pos, T& neg) {
    T ke, ka;
    c.scattering(x, ke, ka);
    const T we = ke * n1, wa = ka * n;
    loss[I] += we * p[J];
    gain[J] += we * q[I];
    loss[J] += wa * p[I];
    gain[I] += wa * q[J];
    pos += (q[I] * ke) * p[J];
    neg += (q[J] * ka) * p[I];
  }
  template <int K, int J = 0>
  __device__ __forceinline__ void scattering_pairs(int x, T n, T n1, T& pos, T& neg) {
    if constexpr (J < NB - K) {
      scattering_pair<J + K, J>(x + kW * J, n, n1, pos, neg);
      scattering_pairs<K, J + 1>(x, n, n1, pos, neg);
    }
  }
  template <int K>
  __device__ __forceinline__ void scattering_group(int w, int x) {
    const T n = __ldg(ph + w * n_pix);
    T pos = T(0), neg = T(0);
    scattering_pairs<K>(x, n, T(1) + n, pos, neg);
    finish(w, pos, neg);
  }
  // diagonals k = K … NB − 1
  template <int K = 1>
  __device__ __forceinline__ void scattering() {
    if constexpr (K < NB) {
      if constexpr (kSimple) {
        scattering_group<K>(c_rows[K - 1], kScatOff + kW * scattering_first(NB, K));
      } else {
        for (int g = __ldg(grp.s_ptr + K); g < __ldg(grp.s_ptr + K + 1); ++g) {
          const int2 m = __ldg(grp.s_meta + g);
          scattering_group<K>(m.x, grp.scat_off + kW * m.y);
        }
      }
      scattering<K + 1>();
    }
  }

  // recombination pair (I, J), I > J, and the diagonal pair (I, I)
  template <int I, int J>
  __device__ __forceinline__ void recombination_pair(int x, T s, T s1, T& pos, T& neg) {
    T rij, rji;
    c.recombination(x, rij, rji);
    loss[I] += (rij * s1) * q[J];
    gain[I] += (rij * s) * p[J];
    loss[J] += (rji * s1) * q[I];
    gain[J] += (rji * s) * p[I];
    const T h = T(0.5) * (rij + rji);
    pos += h * (q[I] * q[J]);
    neg += h * (p[I] * p[J]);
  }
  template <int I>
  __device__ __forceinline__ void recombination_diagonal(int x, T s, T s1, T& pos, T& neg) {
    T rii, unused;
    c.recombination(x, rii, unused);
    loss[I] += (rii * s1) * q[I];
    gain[I] += (rii * s) * p[I];
    const T h = T(0.5) * rii;
    pos += (q[I] * h) * q[I];
    neg += (p[I] * h) * p[I];
  }
  // anti-diagonal S from its pair (S − J, J): entry J − J0
  template <int S, int J0, int J = J0>
  __device__ __forceinline__ void recombination_pairs(int x, T s, T s1, T& pos, T& neg) {
    if constexpr (2 * J < S) {
      recombination_pair<S - J, J>(x + kW * (J - J0), s, s1, pos, neg);
      recombination_pairs<S, J0, J + 1>(x, s, s1, pos, neg);
    } else if constexpr (2 * J == S) {
      recombination_diagonal<J>(x + kW * (J - J0), s, s1, pos, neg);
    }
  }
  template <int S>
  __device__ __forceinline__ void recombination_group(int w, int x) {
    const T s = __ldg(ph + w * n_pix);
    T pos = T(0), neg = T(0);
    recombination_pairs<S, (S - NB + 1 > 0 ? S - NB + 1 : 0)>(x, s, T(1) + s, pos, neg);
    finish(w, pos, neg);
  }
  // anti-diagonals s = S … 2NB − 2
  template <int S = 0>
  __device__ __forceinline__ void recombination() {
    if constexpr (S < 2 * NB - 1) {
      if constexpr (kSimple) {
        recombination_group<S>(c_rows[NB - 1 + S], kRecOff + kW * recombination_first(NB, S));
      } else {
        for (int g = __ldg(grp.r_ptr + S); g < __ldg(grp.r_ptr + S + 1); ++g) {
          const int2 m = __ldg(grp.r_meta + g);
          recombination_group<S>(m.x, grp.rec_off + kW * m.y);
        }
      }
      recombination<S + 1>();
    }
  }
};

// the kernel: one thread per pixel, its bins in registers; dynamic shared
// memory holds the thread's row accumulators (2·nw), [row][thread], and
// after the rows' update its bins' q, p·gain and loss for the QP update
template <typename T, bool kSimple, class Consts>
__global__ void __launch_bounds__(kBlock) collision_step_kernel(
    const T* __restrict__ q_in, const T* __restrict__ ph_in, const T* __restrict__ gen,
    T* __restrict__ q_out, T* __restrict__ ph_out, Consts consts, Groups grp, int ne, int nw,
    long long n_pix, T dt, int update_phonons) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cs = blockDim.x;
  const long long p = static_cast<long long>(blockIdx.x) * cs + threadIdx.x;
  if (p >= n_pix) return;
  T* acc = reinterpret_cast<T*>(smem_raw) + threadIdx.x;
  // rows no group reaches keep a = b = 0 (the plain version's affine of them)
  for (int e = 0; e < 2 * nw; ++e) acc[e * cs] = T(0);
  Walker<T, kSimple, Consts> wk{{}, {}, {}, {}, consts.at(p), grp, ph_in + p, n_pix, acc, cs};
  const T g = gen != nullptr ? gen[p] : T(0);
#pragma unroll
  for (int i = 0; i < kBins; ++i) {
    T qi = T(0);
    if (kSimple || i < ne) {
      qi = q_in[i * n_pix + p];
      if (gen != nullptr) qi += g;  // fused forward-Euler n += dt·g
    }
    wk.q[i] = qi;
    wk.gain[i] = T(0);
    wk.loss[i] = T(0);
  }
#pragma unroll
  for (int i = 0; i < kBins; ++i) wk.p[i] = kSimple || i < ne ? wk.c.partner(i, wk.q[i]) : T(0);
  wk.scattering();
  wk.recombination();
  // the rows' frozen-coefficient update, every ω row once
  if (update_phonons != 0) {
#pragma unroll 4
    for (int w = 0; w < nw; ++w) {
      ph_out[w * n_pix + p] = affine(__ldg(ph_in + w * n_pix + p), acc[2 * w * cs],
                                     acc[(2 * w + 1) * cs], dt);
    }
  }
  // the QP update, in a loop through shared memory (the accumulators' room)
#pragma unroll
  for (int i = 0; i < kBins; ++i) {
    acc[i * cs] = wk.q[i];
    acc[(kBins + i) * cs] = wk.p[i] * wk.gain[i];
    acc[(2 * kBins + i) * cs] = wk.loss[i];
  }
#pragma unroll 4
  for (int i = 0; i < ne; ++i) {
    q_out[i * n_pix + p] = relax(acc[i * cs], acc[(kBins + i) * cs], acc[(2 * kBins + i) * cs], dt);
  }
}

template <typename T, bool kSimple, class Consts>
int launch_form(const T* q_in, const T* ph_in, const T* gen, T* q_out, T* ph_out,
                const Consts& consts, const Groups& grp, int ne, int nw, long long n_pix, T dt,
                int update_phonons, cudaStream_t stream) {
  auto kernel = &collision_step_kernel<T, kSimple, Consts>;
  // threads per block: 128, halved (to 32) while the accumulators exceed
  // 64 KB; above 48 KB only after the opt-in, and a refused launch would
  // never run
  const long long per_thread = (2 * nw > 3 * kBins ? 2LL * nw : 3LL * kBins) * sizeof(T);
  int threads = kBlock;
  while (threads > 32 && per_thread * threads > 64 * 1024) threads /= 2;
  const long long smem = per_thread * threads;
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > max_smem) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int blocks = static_cast<unsigned int>((n_pix + threads - 1) / threads);
  kernel<<<blocks, threads, static_cast<size_t>(smem), stream>>>(
      q_in, ph_in, gen, q_out, ph_out, consts, grp, ne, nw, n_pix, dt, update_phonons);
  return static_cast<int>(cudaGetLastError());
}

// the simple form where the host asks for it (see Walker), its rows into the bank
template <typename T, class Consts>
int launch(const T* q_in, const T* ph_in, const T* gen, T* q_out, T* ph_out,
           const Consts& consts, const Groups& grp, const int* rows, int n_sgroups,
           int n_rgroups, int simple, int ne, int nw, long long n_pix, double dt,
           int update_phonons, cudaStream_t stream) {
  using Simple = Walker<T, true, Consts>;
  const T tdt = static_cast<T>(dt);
  if (simple != 0) {
    if (ne != kBins || n_sgroups != kBins - 1 || n_rgroups != 2 * kBins - 1 ||
        grp.scat_off != Simple::kScatOff || grp.rec_off != Simple::kRecOff) {
      return static_cast<int>(cudaErrorInvalidValue);  // tables not of the simple form
    }
    const cudaError_t err = cudaMemcpyToSymbolAsync(
        c_rows, rows, (n_sgroups + n_rgroups) * sizeof(int), 0, cudaMemcpyDeviceToDevice, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch_form<T, true>(q_in, ph_in, gen, q_out, ph_out, consts, grp, ne, nw, n_pix, tdt,
                                update_phonons, stream);
  }
  return launch_form<T, false>(q_in, ph_in, gen, q_out, ph_out, consts, grp, ne, nw, n_pix, tdt,
                               update_phonons, stream);
}

template <typename T>
int launch_any(const T* q_in, const T* ph_in, const T* gen, T* q_out, T* ph_out,
               const T* consts, long long n_consts, int per_gap, const unsigned char* gid,
               const T* g2, double gamma, const Groups& grp, const int* rows, int n_sgroups,
               int n_rgroups, int simple, int ne, int nb, int nw, long long n_pix, double dt,
               int update_phonons, void* stream) {
  static_assert(3 * kBins - 2 <= kMaxRows, "the simple form's rows fit c_rows");
  if (ne < 1 || ne > nb || nb != kBins ||
      n_consts * static_cast<long long>(sizeof(T)) > kConstBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_pix <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the launch's constants into the bank, ordered before the kernel on its stream
  cudaError_t err = cudaMemcpyToSymbolAsync(c_bank, consts, n_consts * sizeof(T), 0,
                                            cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g2 != nullptr) {
    return launch<T>(q_in, ph_in, gen, q_out, ph_out, AnalyticConsts<T>{g2, static_cast<T>(gamma)},
                     grp, rows, n_sgroups, n_rgroups, simple, ne, nw, n_pix, dt, update_phonons,
                     s);
  }
  if (gid != nullptr) {
    return launch<T>(q_in, ph_in, gen, q_out, ph_out, TableConsts<T, true>{gid, per_gap}, grp,
                     rows, n_sgroups, n_rgroups, simple, ne, nw, n_pix, dt, update_phonons, s);
  }
  return launch<T>(q_in, ph_in, gen, q_out, ph_out, TableConsts<T, false>{nullptr, per_gap}, grp,
                   rows, n_sgroups, n_rgroups, simple, ne, nw, n_pix, dt, update_phonons, s);
}

}  // namespace

// Plain C interface (loaded with ctypes), one entry per dtype for K3 and K4.
// consts: the packed constants (n_consts of them; per_gap a gap in the
// table form, whose gap ids gid are null on a uniform gap, else (n_pix,)
// uint8); g2 the Δ² plane of the analytic form (null for the table form).
// The groups' entries start at scat_off / rec_off of the constants; rows
// is each group's ω row (the scattering groups', then the recombination
// groups'); simple asks for the simple form (Walker), which the caller
// may ask for only where no two groups share a row.  gen may be null (no
// generation), ph_out null when update_phonons is 0.  nb is the walk's
// bins (16).  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for bins it does not take, constants that do not
// fit the bank, tables not of the simple form it was asked for, or a
// block that does not fit shared memory.
#define QP_COLLISION_ENTRY(NAME, T)                                                            \
  extern "C" int NAME(const T* q_in, const T* ph_in, const T* gen, T* q_out, T* ph_out,       \
                      const T* consts, long long n_consts, int per_gap, int scat_off,           \
                      int rec_off, const unsigned char* gid, const T* g2, double gamma,         \
                      const int* s_ptr, const int* r_ptr, const int* s_meta,                    \
                      const int* r_meta, const int* rows, int n_sgroups, int n_rgroups,         \
                      int simple, int ne, int nb, int nw, long long n_pix, double dt,           \
                      int update_phonons, void* stream) {                                       \
    const Groups grp{s_ptr, r_ptr, reinterpret_cast<const int2*>(s_meta),                      \
                     reinterpret_cast<const int2*>(r_meta), scat_off, rec_off};                \
    return launch_any<T>(q_in, ph_in, gen, q_out, ph_out, consts, n_consts, per_gap, gid, g2,   \
                         gamma, grp, rows, n_sgroups, n_rgroups, simple, ne, nb, nw, n_pix, dt, \
                         update_phonons, stream);                                               \
  }

// one dtype per translation unit, so the two compile in parallel
// (collisions_f64.cu includes this file with QP_COLLISIONS_F64 defined)
#ifdef QP_COLLISIONS_F64
QP_COLLISION_ENTRY(qp_collision_step_f64, double)
#else
QP_COLLISION_ENTRY(qp_collision_step_f32, float)
#endif
