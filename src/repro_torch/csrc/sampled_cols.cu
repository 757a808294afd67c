// Column-sampled kernels of the dual (CA-BDCD) hot path: Y = X[:, flat]
// read from X's original (d, n) row-major layout -- no transposed copy of X
// exists anywhere -- with flat (m,) int32, duplicates allowed.
//
// K3 cols_packet: (G, r) = (scale * Y^T Y + reg * I, scale_r * Y^T u),
//   contracted over d, u (d,).
//   Replaces gram_packet_sampled_cols_pallas (src/repro/kernels/gram/
//   sampled_colmajor.py), which fetches a 128-lane slab per sampled column
//   and picks the lane with a one-hot select.  Here each element
//   X[k, flat[a]] is read on its own: one 32-byte sector for 4 useful bytes
//   in f32 (8x over-read, against the TPU's 128x slab).  Bound on the H100:
//   the sector traffic m * d * 32 B at 3.35 TB/s (about 26 us at m = 128,
//   d = 20958), above both the useful-bytes bound and the m(m+1)/2 * d
//   multiply-adds on the f32 CUDA cores; at the solve's m = 8 every bound is
//   under 2 us and each block's chain of instructions and round trips is
//   what is left.  K3 runs the dense Gram tile (dense_tile.cuh) with
//   SRC = COLS: each copying thread keeps the 64-bit base X + flat[a] of
//   its panel row and steps a row of X (n elements) at a time, each element
//   its own 4- (8-) byte cp.async into the k-major stage, a warp copying 32
//   panel rows at one step.  The chunk stays K3's own
//   (tuning.default_chunk(m, d, "cols"): 73 splits at m = 8, 13 at 128),
//   so K3(X, flat, u) equals K7(X[:, flat]^T, u) at that chunk, and K5
//   equals K3's r, bit for bit; more than one chunk is summed by
//   dense_reduce.  The host picks the tile edge from m (16, with 2 x 2 a
//   thread, up to 16 rows; else 32) and a shallow ring for each
//   (gram_kernel.COLS_BUILT, from launch.tile_sweep --only cols); only
//   those two geometries are built here.
//   bf16 X and u (the reference's bf16 packet, f32 sums and outputs) run
//   mma_tile (dense_tile.cuh) on the tensor cores: one 128-tile at
//   m <= 128 reads each sampled element once (the f32 32-tile reads each
//   column from 4 tiles), each element's aligned 4-byte word by its own
//   cp.async into a word slot, the fragment build keeping its half (no
//   widening pass); bound, as f32, by the rate at which the memory serves
//   isolated elements, at bf16's own chunk (a third of the SMs' worth of
//   blocks: fewer reads in flight come faster).
//
// K4 cols_apply: out(d) = scale * Y v.
//   Replaces panel_apply_cols_pallas (sampled_colmajor.py).  The reads are
//   scattered by nature: the bound is the sector traffic m * d * 32 B (about
//   1.6 us at the solve's m = 8), and with one sample a lane each row is one
//   dependent round trip; so the design is about keeping every load in
//   flight at once.  Each row of X gets a segment of W lanes, W the smallest
//   power of two >= min(m, 32), so 32 / W rows share a warp; each thread
//   owns one row, reads the indices and weights of its samples into
//   registers (once per row: every segment of a block reads the same ones,
//   from L1) and issues the loads of X for BATCH samples before any of their
//   multiply-adds: no shared memory, no barrier, and at the solve's m = 8
//   one round trip for the indices and one for X.  Sharing the indices
//   among rows (a thread owning 2 or 4 rows) read no faster in
//   launch.tile_sweep's cols sweep (PERF.md), so a thread owns one.  The
//   host picks W from m (sampled_colmajor.apply_cols_geometry): at m = 8
//   the grid is one resident wave, 655 blocks.
//   The order of every row's sum, which no geometry moves: lane l of a
//   row sums fma_rn(X[row, flat[a]], v[a], acc) over a = l, l + 32, ...
//   < m in increasing a from +0, then a shuffle tree adds the lanes at
//   offsets 16, 8, 4, 2, 1, then out = scale * acc.  A segment of W < 32
//   lanes runs only the tree's last log2(W) levels.  That is exact: W < 32
//   only where m <= W, so every lane past W holds +0 (no sample), every
//   value a level brings from such a lane is a sum of +0s, i.e. +0, and
//   x + (+0) == x for every x (an fma_rn chain from +0 never ends at -0 in
//   round to nearest, and torch.equal holds -0 equal to +0 besides).
//
// K5 cols_matvec: out(T, m) = scale * Y^T t for T tenant vectors t (T, d).
//   Replaces panel_matvec_cols_pallas (sampled_colmajor.py), which the
//   batched dual maps over its tenants.  One launch serves every tenant,
//   each in K3's residual order, so K5(X, flat, w) equals K3's r bit for
//   bit (gram_common.cuh).  Bound: the scattered reads, one 32-byte sector
//   per sampled element (m * d * 32 B), plus T * d elements of t.  The
//   design (matvec_ring): blocks of a few sampled columns stream them
//   through a shared-memory ring, one 4- or 8-byte cp.async per element
//   (no two sampled elements share a line), so that thousands of reads per
//   SM are in flight.  What bounds it on an H100 is the rate at which the
//   memory serves isolated elements, each in its own DRAM page: PyTorch's
//   own gather of the same elements (index_select) takes longer than the
//   whole kernel (PERF.md), and no ring depth or block shape moves it.
#include <limits.h>

#include "dense_tile.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct ColsGather {
  static constexpr bool CONTIGUOUS = false;  // Y's rows are columns of X
  const T* __restrict__ X;
  int64_t n;  // row length of X; the contraction runs over X's d rows

  __device__ __forceinline__ int index(const int* __restrict__ flat,
                                       int a) const {
    return flat[a];
  }

  // Where Y[a, k] = X[k, col] lies for sample column `col` (matvec_ring).
  __device__ __forceinline__ const T* at(int col, int64_t k) const {
    return X + k * n + col;
  }
};

// K4's block size, and the samples a lane loads at once before their
// multiply-adds.
constexpr int APPLY_THREADS = 256;
constexpr int APPLY_BATCH = 4;

// Row blockIdx.x * SEGS + threadIdx.x / W of X, one segment of W lanes.
// Lane l of the segment reads the indices and weights of its samples
// a = l, l + 32, ... into registers, then the elements of X they pick.  A
// segment past the last row sums nothing but still joins the shuffles.
template <typename T, int W>
__global__ void __launch_bounds__(APPLY_THREADS)
cols_apply(const T* __restrict__ X, const int* __restrict__ flat,
           const T* __restrict__ v, int m, int64_t d, int64_t n, T scale,
           T* __restrict__ out) {
  constexpr int SEGS = APPLY_THREADS / W;  // segments (rows at once) a block
  const int lane = threadIdx.x % W;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * SEGS + threadIdx.x / W;
  const bool ok = row < d;
  const T* xr = X + (ok ? row : 0) * n;
  T acc = 0;
  for (int a0 = lane; a0 < m; a0 += 32 * APPLY_BATCH) {
    int idx[APPLY_BATCH];
    T w[APPLY_BATCH], x[APPLY_BATCH];
#pragma unroll
    for (int b = 0; b < APPLY_BATCH; ++b) {
      const bool in = a0 + 32 * b < m;
      idx[b] = in ? flat[a0 + 32 * b] : 0;
      w[b] = in ? v[a0 + 32 * b] : T(0);
    }
#pragma unroll
    for (int b = 0; b < APPLY_BATCH; ++b)
      x[b] = a0 + 32 * b < m && ok ? xr[idx[b]] : T(0);
#pragma unroll
    for (int b = 0; b < APPLY_BATCH; ++b)
      if (a0 + 32 * b < m) acc = repro::fma_rn(x[b], w[b], acc);
  }
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1)
    acc += __shfl_down_sync(FULL, acc, off, W);
  if (lane == 0 && ok) out[row] = scale * acc;
}

// K3: the gathered-column tile at the geometries the host can pick
// (gram_kernel.COLS_BUILT, the same for f32 and f64).  Anything else is
// refused with cudaErrorInvalidValue before a launch.
template <typename T>
int packet_impl(const void* X, const void* flat, const void* u,
                const int* tiles, void* Gp, void* rp, void* G, void* r,
                int64_t d, int64_t n, int m, int64_t chunk, int splits,
                int bm, int tm, int tn, int stages, int steps, int ntiles,
                int smem, double scale, double reg, double scale_r,
                void* stream) {
#define REPRO_TILE(B, M, N, S, Q)                                             \
  if (bm == B && tm == M && tn == N && stages == S && steps == Q)             \
    return static_cast<int>(repro::launch_tile<T, B, M, N, S, Q, true,       \
                                               repro::Source::COLS>(          \
        static_cast<const T*>(X), static_cast<const int*>(flat),              \
        static_cast<const T*>(u), tiles, ntiles, m, d, chunk, splits, smem,   \
        static_cast<T>(scale), static_cast<T>(reg), static_cast<T>(scale_r),  \
        static_cast<T*>(Gp), static_cast<T*>(rp), static_cast<T*>(G),         \
        static_cast<T*>(r), static_cast<cudaStream_t>(stream), n));
  REPRO_TILE(16, 2, 2, 3, 32)
  REPRO_TILE(32, 4, 4, 4, 8)
#undef REPRO_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3 in bf16: the tensor-core tile (dense_tile.cuh's mma_tile) on word
// slots at the geometries the host can pick (gram_kernel.MMA_BUILT["cols"]).
int packet_bf16(const void* X, const void* flat, const void* u,
                const int* tiles, void* Gp, void* rp, void* G, void* r,
                int64_t d, int64_t n, int m, int64_t chunk, int splits,
                int bm, int tm, int tn, int stages, int steps, int ntiles,
                int smem, double scale, double reg, double scale_r,
                void* stream) {
#define REPRO_MMA(B, S, Q)                                                    \
  if (bm == B && tm == 16 && tn == 8 && stages == S && steps == Q)            \
    return static_cast<int>(                                                  \
        repro::launch_mma_tile<B, S, Q, repro::Source::COLS>(                 \
            static_cast<const __nv_bfloat16*>(X),                             \
            static_cast<const int*>(flat),                                    \
            static_cast<const __nv_bfloat16*>(u), tiles, ntiles, m, d, chunk, \
            splits, smem, static_cast<float>(scale), static_cast<float>(reg), \
            static_cast<float>(scale_r), static_cast<float*>(Gp),             \
            static_cast<float*>(rp), static_cast<float*>(G),                  \
            static_cast<float*>(r), static_cast<cudaStream_t>(stream), n));
  REPRO_MMA(16, 3, 32)
  REPRO_MMA(128, 3, 32)
#undef REPRO_MMA
  return static_cast<int>(cudaErrorInvalidValue);
}

// K4 at segments of `seg` lanes, from the list below
// (sampled_colmajor.APPLY_COLS_SEGS lists the same); a segment too narrow
// for m's lanes (seg < min(m, 32)), any other block size, or a grid past
// the card's limit is refused with cudaErrorInvalidValue before a launch.
template <typename T>
int apply_impl(const void* X, const void* flat, const void* v, void* out,
               int64_t d, int64_t n, int m, int threads, int seg,
               double scale, void* stream) {
  if (threads != APPLY_THREADS || d < 1 || m < 1 || seg < (m < 32 ? m : 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t span = APPLY_THREADS / seg;
  const int64_t blocks = (d + span - 1) / span;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_APPLY(W)                                                        \
  if (seg == W) {                                                             \
    cols_apply<T, W><<<static_cast<int>(blocks), APPLY_THREADS, 0,            \
                       static_cast<cudaStream_t>(stream)>>>(                  \
        static_cast<const T*>(X), static_cast<const int*>(flat),              \
        static_cast<const T*>(v), m, d, n, static_cast<T>(scale),             \
        static_cast<T*>(out));                                                \
    return static_cast<int>(cudaGetLastError());                              \
  }
  REPRO_APPLY(1)
  REPRO_APPLY(2)
  REPRO_APPLY(4)
  REPRO_APPLY(8)
  REPRO_APPLY(16)
  REPRO_APPLY(32)
#undef REPRO_APPLY
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int matvec_impl(const void* X, const void* flat, const void* t, void* rp,
                void* tickets, void* out, int64_t d, int64_t n, int m,
                int tenants, int64_t chunk, int splits, int rows, int group,
                int stages, int steps, int grid_x, int smem, double scale,
                void* stream) {
  ColsGather<T> gather{static_cast<const T*>(X), n};
  return repro::launch_matvec<T>(
      gather, static_cast<const int*>(flat), static_cast<const T*>(t),
      tenants, m, d, chunk, splits, rows, group, stages, steps, grid_x, smem,
      scale, static_cast<T*>(rp), static_cast<int*>(tickets),
      static_cast<T*>(out), static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// cols_packet_*(X, flat, u, tiles, Gp, rp, G, r, d, n, m, chunk, splits, bm,
// tm, tn, stages, steps, ntiles, smem, scale, reg, scale_r, stream): Gp
// (splits, mp, mp) and rp (splits, mp) are read only at splits > 1.
int cols_packet_f32(const void* X, const void* flat, const void* u,
                    const int* tiles, void* Gp, void* rp, void* G, void* r,
                    int64_t d, int64_t n, int m, int64_t chunk, int splits,
                    int bm, int tm, int tn, int stages, int steps, int ntiles,
                    int smem, double scale, double reg, double scale_r,
                    void* stream) {
  return packet_impl<float>(X, flat, u, tiles, Gp, rp, G, r, d, n, m, chunk,
                            splits, bm, tm, tn, stages, steps, ntiles, smem,
                            scale, reg, scale_r, stream);
}

int cols_packet_f64(const void* X, const void* flat, const void* u,
                    const int* tiles, void* Gp, void* rp, void* G, void* r,
                    int64_t d, int64_t n, int m, int64_t chunk, int splits,
                    int bm, int tm, int tn, int stages, int steps, int ntiles,
                    int smem, double scale, double reg, double scale_r,
                    void* stream) {
  return packet_impl<double>(X, flat, u, tiles, Gp, rp, G, r, d, n, m, chunk,
                             splits, bm, tm, tn, stages, steps, ntiles, smem,
                             scale, reg, scale_r, stream);
}

// cols_packet_bf16: as cols_packet_f32 with X and u bf16; Gp, rp, G and r
// are f32.
int cols_packet_bf16(const void* X, const void* flat, const void* u,
                     const int* tiles, void* Gp, void* rp, void* G, void* r,
                     int64_t d, int64_t n, int m, int64_t chunk, int splits,
                     int bm, int tm, int tn, int stages, int steps,
                     int ntiles, int smem, double scale, double reg,
                     double scale_r, void* stream) {
  return packet_bf16(X, flat, u, tiles, Gp, rp, G, r, d, n, m, chunk, splits,
                     bm, tm, tn, stages, steps, ntiles, smem, scale, reg,
                     scale_r, stream);
}

// cols_apply_*(X, flat, v, out, d, n, m, threads, seg, scale, stream)
int cols_apply_f32(const void* X, const void* flat, const void* v, void* out,
                   int64_t d, int64_t n, int m, int threads, int seg,
                   double scale, void* stream) {
  return apply_impl<float>(X, flat, v, out, d, n, m, threads, seg, scale,
                           stream);
}

int cols_apply_f64(const void* X, const void* flat, const void* v, void* out,
                   int64_t d, int64_t n, int m, int threads, int seg,
                   double scale, void* stream) {
  return apply_impl<double>(X, flat, v, out, d, n, m, threads, seg, scale,
                            stream);
}

int cols_matvec_f32(const void* X, const void* flat, const void* t,
                    void* rp, void* tickets, void* out, int64_t d,
                    int64_t n, int m, int tenants, int64_t chunk,
                    int splits, int rows, int group, int stages, int steps,
                    int grid_x, int smem, double scale, void* stream) {
  return matvec_impl<float>(X, flat, t, rp, tickets, out, d, n, m, tenants,
                           chunk, splits, rows, group, stages, steps, grid_x,
                           smem, scale, stream);
}

int cols_matvec_f64(const void* X, const void* flat, const void* t,
                    void* rp, void* tickets, void* out, int64_t d,
                    int64_t n, int m, int tenants, int64_t chunk,
                    int splits, int rows, int group, int stages, int steps,
                    int grid_x, int smem, double scale, void* stream) {
  return matvec_impl<double>(X, flat, t, rp, tickets, out, d, n, m, tenants,
                             chunk, splits, rows, group, stages, steps,
                             grid_x, smem, scale, stream);
}

}  // extern "C"
