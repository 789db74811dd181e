// The light snapshot's reductions of one state, in float64, for Hopper.
//
// Replaces no TPU kernel.  The JAX package copies its t = 0 state to the
// host and reduces it there in float64 (numpy); the port did the same
// until this kernel, copying q and n_ph whole (264 MB at 1024² × 16 bins,
// 1.67 GB at 100) and widening them on the host for seconds while the card
// stood idle.  This kernel reduces the state where it lies and hands back
// only the four light values (solver/spectral_runner.py, light_on_host):
//   integrated[p] = (Σ_b q[b, p]) · dE              masked pixels, else 0
//   bin_sums[b]   = Σ_p q[b, p]                      over masked pixels
//   ph_frame[p]   = Σ_w width[w] · n_ph[w, p]        masked pixels, else 0
//   ph_sums[w]    = Σ_p n_ph[w, p]                   over masked pixels
// every value widened to float64 before it is added.
//
// Frames, bit for bit the host's.  The host's interior q[:, mask] comes
// out of numpy's advanced indexing with the planes adjacent in memory, so
// np.sum(..., axis=0) runs numpy's pairwise sum along each pixel's planes
// (pairwise_sum in numpy's loops): blocks of at most 128 planes, each
// added into eight accumulators r[j] (r[j] = x[j], then r[j] += x[i + j]
// for i = 8, 16, … below n − n % 8), folded as ((r0 + r1) + (r2 + r3)) +
// ((r4 + r5) + (r6 + r7)), then the last n % 8 planes added in turn (a
// block of fewer than 8: 0 plus each plane in turn); a longer run is split
// at n/2 rounded down to a multiple of 8, and the halves' sums added; the
// result is added to 0.  One thread walks its pixel's planes in that order:
// the blocks come in plane order, so the loads of a plane stay coalesced
// across the warp, and a small stack holds the sums of the halves still to
// be added.  The phonon frame adds width · n_ph the same way, and the
// integrated frame is scaled by dE once at the end.  The adds and products
// are the explicit _rn intrinsics: the library is compiled with FMA
// contraction allowed, and a fused multiply-add would change the bits.
//
// Sums, deterministic: the host takes its per-plane sums along the pixels
// in its own order, so the sums (and the mass, their total × dE · dx²)
// agree with the host's to about 1e-16, not bit for bit.  Each block
// reduces its fixed tile of pixels in a fixed tree (a thread's pixels,
// a warp's shuffles, then its eight warps in order) into one partial per
// plane; a second launch adds each plane's partials in a fixed tree.  No
// atomics: the same state gives the same bits on every run.
//
// What bounds it: the state is read once, so bytes: 264 MB / 3.35 TB/s ≈
// 0.08 ms at 1024² × 16 bins, 1.67 GB ≈ 0.50 ms at 100.  A thread owns
// kPixels pixels a kThreads apart, so each plane's loads are coalesced;
// the eight planes of an accumulator group are loaded together.  Each
// plane's load is followed by its warp's shuffle tree, a few instructions
// an element, still under the bytes.  The kernel runs once a job.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPixels = 2;
constexpr int kTile = kThreads * kPixels;  // pixels of one block
constexpr int kChunk = 32;                 // planes whose warp sums wait in shared memory
constexpr int kLeaf = 128;                 // numpy's PW_BLOCKSIZE
constexpr int kStack = 32;                 // pending halves: the split depth is below 32

// One array's planes over the block's tile, read once: each pixel's sum of
// its (weighted, with kWeighted) planes in numpy's pairwise order, and each
// plane's block partial (unweighted) in partial[plane · n_blocks + block].
template <typename T, bool kWeighted>
struct Sweep {
  const T* x;
  const double* w;
  int n_planes;
  long long n_pix, first;
  bool in[kPixels];
  double (*warp_sums)[kChunk];
  double* partial;

  // plane b of the thread's pixels (0 outside the mask), its term, and its
  // share of the plane's warp sum
  __device__ void load(int b, double (&v)[kPixels], double (&term)[kPixels]) const {
    const T* plane = x + static_cast<long long>(b) * n_pix;
    const double wb = kWeighted ? __ldg(w + b) : 0.0;
#pragma unroll
    for (int k = 0; k < kPixels; ++k) {
      v[k] = in[k] ? static_cast<double>(__ldg(plane + first + k * kThreads)) : 0.0;
      term[k] = kWeighted ? __dmul_rn(wb, v[k]) : v[k];
    }
  }

  __device__ void warp_sum(int b, const double (&v)[kPixels]) const {
    double local = v[0];
#pragma unroll
    for (int k = 1; k < kPixels; ++k) local = __dadd_rn(local, v[k]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      local = __dadd_rn(local, __shfl_down_sync(0xffffffffu, local, off));
    }
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5][b % kChunk] = local;
  }

  // after plane b: at the end of a chunk, the block's partials of its planes
  __device__ void flush(int b) const {
    if ((b + 1) % kChunk != 0 && b + 1 != n_planes) return;  // the same for the whole block
    __syncthreads();
    const int c0 = b - b % kChunk;
    if (threadIdx.x <= b - c0) {
      double s = warp_sums[0][threadIdx.x];
#pragma unroll
      for (int i = 1; i < kWarps; ++i) s = __dadd_rn(s, warp_sums[i][threadIdx.x]);
      partial[static_cast<long long>(c0 + threadIdx.x) * gridDim.x + blockIdx.x] = s;
    }
    __syncthreads();
  }

  // one plane added in turn: res = res + term
  __device__ void add_in_turn(int b, double (&res)[kPixels]) const {
    double v[kPixels], term[kPixels];
    load(b, v, term);
#pragma unroll
    for (int k = 0; k < kPixels; ++k) res[k] = __dadd_rn(res[k], term[k]);
    warp_sum(b, v);
    flush(b);
  }

  // numpy's block of n ≤ kLeaf planes from lo (a multiple of 8)
  __device__ void leaf(int lo, int n, double (&res)[kPixels]) const {
#pragma unroll
    for (int k = 0; k < kPixels; ++k) res[k] = 0.0;
    if (n < 8) {
      for (int b = lo; b < lo + n; ++b) add_in_turn(b, res);
      return;
    }
    const int m = n - n % 8;
    double r[kPixels][8];
    for (int i = 0; i < m; i += 8) {
      double v[8][kPixels], term[8][kPixels];
#pragma unroll
      for (int j = 0; j < 8; ++j) load(lo + i + j, v[j], term[j]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int k = 0; k < kPixels; ++k) r[k][j] = i == 0 ? term[j][k] : __dadd_rn(r[k][j], term[j][k]);
        warp_sum(lo + i + j, v[j]);
      }
      flush(lo + i + 7);  // a chunk ends at a multiple of 8, or at the last plane
    }
#pragma unroll
    for (int k = 0; k < kPixels; ++k) {
      res[k] = __dadd_rn(__dadd_rn(__dadd_rn(r[k][0], r[k][1]), __dadd_rn(r[k][2], r[k][3])),
                         __dadd_rn(__dadd_rn(r[k][4], r[k][5]), __dadd_rn(r[k][6], r[k][7])));
    }
    for (int b = lo + m; b < lo + n; ++b) add_in_turn(b, res);
  }

  // every plane in numpy's pairwise order; the same ranges for every thread
  __device__ void run(double (&out)[kPixels]) const {
    int todo_lo[kStack], todo_n[kStack], todo_depth[kStack];
    double done[kStack][kPixels];
    int done_depth[kStack];
    int n_todo = 1, n_done = 0;
    todo_lo[0] = 0;
    todo_n[0] = n_planes;
    todo_depth[0] = 0;
    while (n_todo > 0) {
      --n_todo;
      const int lo = todo_lo[n_todo], n = todo_n[n_todo];
      int depth = todo_depth[n_todo];
      if (n > kLeaf) {  // left half first, then the right
        const int n2 = n / 2 - (n / 2) % 8;
        todo_lo[n_todo] = lo + n2, todo_n[n_todo] = n - n2, todo_depth[n_todo] = depth + 1;
        ++n_todo;
        todo_lo[n_todo] = lo, todo_n[n_todo] = n2, todo_depth[n_todo] = depth + 1;
        ++n_todo;
        continue;
      }
      double res[kPixels];
      leaf(lo, n, res);
      // a right half done: add it to its left half, which waits on top
      while (n_done > 0 && done_depth[n_done - 1] == depth) {
        --n_done;
#pragma unroll
        for (int k = 0; k < kPixels; ++k) res[k] = __dadd_rn(done[n_done][k], res[k]);
        --depth;
      }
#pragma unroll
      for (int k = 0; k < kPixels; ++k) done[n_done][k] = res[k];
      done_depth[n_done++] = depth;
    }
#pragma unroll
    for (int k = 0; k < kPixels; ++k) out[k] = __dadd_rn(0.0, done[0][k]);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    snapshot_tile_kernel(const T* __restrict__ q, const T* __restrict__ ph,
                         const unsigned char* __restrict__ mask, const double* __restrict__ widths,
                         double dE, int ne, int nw, long long n_pix, double* __restrict__ integrated,
                         double* __restrict__ ph_frame, double* __restrict__ partial) {
  __shared__ double warp_sums[kWarps][kChunk];
  const long long first = static_cast<long long>(blockIdx.x) * kTile + threadIdx.x;
  Sweep<T, false> qs{q, nullptr, ne, n_pix, first, {}, warp_sums, partial};
#pragma unroll
  for (int k = 0; k < kPixels; ++k) {
    const long long p = first + k * kThreads;
    qs.in[k] = p < n_pix && mask[p] != 0;
  }
  double acc[kPixels];
  qs.run(acc);
#pragma unroll
  for (int k = 0; k < kPixels; ++k) {
    const long long p = first + k * kThreads;
    if (p < n_pix) integrated[p] = qs.in[k] ? __dmul_rn(acc[k], dE) : 0.0;
  }
  if (ph == nullptr) return;
  Sweep<T, true> ps{ph, widths, nw, n_pix, first, {}, warp_sums,
                    partial + static_cast<long long>(ne) * gridDim.x};
#pragma unroll
  for (int k = 0; k < kPixels; ++k) ps.in[k] = qs.in[k];
  ps.run(acc);
#pragma unroll
  for (int k = 0; k < kPixels; ++k) {
    const long long p = first + k * kThreads;
    if (p < n_pix) ph_frame[p] = ps.in[k] ? acc[k] : 0.0;
  }
}

// sums[j] = the blocks' partials of plane j, added in a fixed tree: a
// thread's stride through them, then a warp's shuffles, then the warps.
__global__ void __launch_bounds__(kThreads)
    snapshot_sums_kernel(const double* __restrict__ partial, int n_blocks, double* __restrict__ sums) {
  __shared__ double warp_sums[kWarps];
  const double* row = partial + static_cast<long long>(blockIdx.x) * n_blocks;
  double s = 0.0;
  for (int i = threadIdx.x; i < n_blocks; i += kThreads) s = __dadd_rn(s, row[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = __dadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = warp_sums[0];
    for (int i = 1; i < kWarps; ++i) total = __dadd_rn(total, warp_sums[i]);
    sums[blockIdx.x] = total;
  }
}

int blocks_for(long long n_pix) { return static_cast<int>((n_pix + kTile - 1) / kTile); }

template <typename T>
int launch(const T* q, const T* ph, const unsigned char* mask, const double* widths, double dE,
           int ne, int nw, long long n_pix, double* integrated, double* ph_frame, double* sums,
           double* partial, void* stream) {
  if (ne < 1 || nw < 0 || n_pix < 0 || (ph != nullptr && nw < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_blocks = blocks_for(n_pix);
  const int planes = ne + (ph != nullptr ? nw : 0);
  auto s = static_cast<cudaStream_t>(stream);
  if (n_blocks > 0) {
    snapshot_tile_kernel<T><<<n_blocks, kThreads, 0, s>>>(q, ph, mask, widths, dE, ne, nw, n_pix,
                                                        integrated, ph_frame, partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  snapshot_sums_kernel<<<planes, kThreads, 0, s>>>(partial, n_blocks, sums);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes).  ph may be null (no phonon
// outputs; ph_frame and widths then unused).  partial is a scratch buffer
// of (ne + nw) · qp_snapshot_reduce_blocks(n_pix) doubles; sums holds the
// ne bin sums, then the nw ω sums.  Each returns cudaGetLastError().
extern "C" int qp_snapshot_reduce_blocks(long long n_pix) { return blocks_for(n_pix); }

#define QP_SNAPSHOT_ENTRY(NAME, T)                                                                  \
  extern "C" int NAME(const T* q, const T* ph, const unsigned char* mask, const double* widths,   \
                      double dE, int ne, int nw, long long n_pix, double* integrated,             \
                      double* ph_frame, double* sums, double* partial, void* stream) {            \
    return launch<T>(q, ph, mask, widths, dE, ne, nw, n_pix, integrated, ph_frame, sums, partial, \
                     stream);                                                                     \
  }

QP_SNAPSHOT_ENTRY(qp_snapshot_reduce_f32, float)
QP_SNAPSHOT_ENTRY(qp_snapshot_reduce_f64, double)
