// Row-sampled kernels of the primal (CA-BCD) hot path: Y = X[flat, :] for
// X (d, n) row-major, flat (m,) int32 with duplicates allowed.
//
// K1 rows_packet: (G, r) = (scale * Y Y^T + reg * I, scale_r * Y u).
//   Replaces gram_packet_sampled_pallas (src/repro/kernels/gram/
//   sampled_kernel.py), which scalar-prefetches flat and DMA-gathers the
//   sampled rows into VMEM tile by tile.  Bound on the H100: m(m+1)/2 * n
//   fused multiply-adds on the f32 CUDA cores (no tensor cores are used)
//   against m*n reads of X; at the solve's m = 128, n = 72309 the
//   operations bound (about 18 us at 67 TFLOP/s) exceeds the bytes bound
//   (about 11 us), at its m = 8 both are under 1 us and each block's chain
//   of round trips is what is left.  Rows of X are contiguous, so the
//   gather changes only a row's base address: K1 runs the dense Gram tile
//   (dense_tile.cuh) with SRC = ROWS, each copying thread holding the
//   64-bit base X + flat[a] * n of its rows, at the chunk and geometry the
//   host picks for the dense kernel K7 at the same (m, n).  So K1(X, flat,
//   u) equals K7(X[flat], u) bit for bit, and at more than one chunk
//   dense_reduce sums the partials.  Built only for the geometries the
//   host can pick (gram_kernel.GATHERED_TILES at the ring (3, 16)).  What
//   the gather still costs is the
//   rows' addresses: at m = 128 the 1030 blocks read 128 rows scattered
//   over all of X, and the tile then takes
//   about 1.7x its time on as many consecutive rows (PERF.md;
//   launch.tile_sweep --only gather); at m = 8 it costs nothing.
//   bf16 X and u (the reference's bf16 packet, f32 sums and outputs) run
//   mma_tile (dense_tile.cuh): the same function on the tensor cores,
//   bound by the sampled rows' bytes (m n 2 bytes, about 5 us at m = 128)
//   where the f32 tile is bound by its FMAs.  Each row's span of a stage
//   moves as 16-byte cp.async.cg chunks from its 16-byte floor (a row of X
//   starts 2-byte aligned) and the fragment build realigns it with byte
//   permutes; one 128-tile at m <= 128 reads each row once.
//
// K2 rows_apply: out(n) = scale * Y^T v.
//   Replaces panel_apply_pallas (sampled_kernel.py).  Bound: the m * n
//   reads of X at 3.35 TB/s; each column's sum is one chain of m fused
//   multiply-adds in increasing sample order, so the kernel needs many
//   loads in flight.  Each thread owns COLS columns 32 apart (a warp reads
//   32 COLS neighbouring elements of one row per sample, COLS coalesced
//   loads) and keeps two register batches of BATCH samples: it issues the
//   loads of the next batch before the multiply-adds of the current one.
//   A warp reads the samples' indices and weights 32 at a time, one per
//   lane, two windows ahead, and hands them round with shuffles (no shared
//   memory); a barrier at each window keeps a block's warps within one
//   window of each other.  All blocks are resident at once.  What is left
//   at CG's shape (m = d, flat = arange(d)) is the access pattern: every
//   warp reads short runs of every row of X, as cuBLAS's own gemv on X in
//   place does, not long runs of few rows (PERF.md).  The host picks the
//   block, columns and batch from (m, n, dtype) alone
//   (sampled_kernel.apply_geometry); they never move a sum.
//
// K6 rows_matvec: out(T, m) = scale * Y t for T tenant vectors t (T, n).
//   Replaces panel_matvec_pallas (sampled_kernel.py), which the batched
//   engine maps over the tenants (one launch each).  Here one launch serves
//   every tenant, each in K1's residual order, so K6(X, flat, u) equals
//   K1's r bit for bit (gram_common.cuh).  With flat = arange(d) it is CG's
//   X p.  Bound: the m * n bytes of the sampled rows plus the T * n bytes of
//   t, at 3.35 TB/s; a chain does one multiply-add per step, so the kernel
//   gets near it only with many loads in flight.  The design (matvec_ring):
//   blocks of a few sample rows stream them through a shared-memory ring
//   filled by 16-byte cp.async chunks, the next stage in flight while the
//   block sums the current one, and the split sum done by the last block of
//   each row group.  At CG's shape (one long chain per row) that reaches
//   1.2x the bytes bound on an H100; at the solve's m = 128 a chunk is
//   short (704 steps, six stages of 128), and each block's fixed chain of
//   round trips (its indices, its stages, the ticket and split sum) is what
//   is left (PERF.md).
#include <limits.h>

#include "dense_tile.cuh"

namespace {

using repro::RowsGather;

constexpr unsigned FULL = 0xffffffffu;

template <typename T, int COLS, int BATCH>
__global__ void __launch_bounds__(256)
rows_apply(const T* __restrict__ X, const int* __restrict__ flat,
           const T* __restrict__ v, int m, int n, T scale,
           T* __restrict__ out) {
  static_assert(32 % BATCH == 0, "a batch lies inside one window");
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  // This thread's columns: k0 + 32 c for c < COLS, where the warp's span of
  // 32 COLS columns starts at k0 - lane.
  // A warp past n stays: it reads nothing but meets the block's barriers.
  const int64_t k0 = static_cast<int64_t>(warp) * 32 * COLS + lane;
  bool ok[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) ok[c] = k0 + 32 * c < n;
  const T* col = X + k0;

  // Windows of 32 samples: lane j holds the index and weight of sample
  // w + j (0 past m), for the current window and the two after it.
  auto window = [&](int w, int& idx, T& val) {
    const int a = w + lane;
    idx = a < m ? flat[a] : 0;
    val = a < m ? v[a] : T(0);
  };
  int i0, i1, i2;
  T v0, v1, v2;
  window(0, i0, v0);
  window(32, i1, v1);
  window(64, i2, v2);

  // Loads of samples a0 .. a0 + BATCH - 1, whose indices `idx` holds; a
  // column past n reads nothing.
  auto fetch = [&](int a0, int idx, T (&x)[BATCH][COLS]) {
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int row = __shfl_sync(FULL, idx, (a0 & 31) + j);
      const T* p = col + static_cast<int64_t>(row) * n;
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        x[j][c] = a0 + j < m && ok[c] ? p[32 * c] : T(0);
    }
  };
  // The next batch's loads, then the current batch's multiply-adds: per
  // column one chain in increasing sample order.
  T acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0;
  auto step = [&](int a0, const T (&x)[BATCH][COLS],
                  T (&next)[BATCH][COLS]) {
    const int b0 = a0 + BATCH;
    const bool turn = (b0 & 31) == 0;  // the next batch opens a window
    if (b0 < m) fetch(b0, turn ? i1 : i0, next);
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const T w = __shfl_sync(FULL, v0, (a0 & 31) + j);
      if (a0 + j < m) {
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          acc[c] = repro::fma_rn(x[j][c], w, acc[c]);
      }
    }
    if (turn) {
      i0 = i1; v0 = v1;
      i1 = i2; v1 = v2;
      window(b0 + 64, i2, v2);
      // The block's warps stay within one window of each other, so that
      // together they read runs of 32 COLS threads' columns of each row.
      __syncthreads();
    }
  };
  T xa[BATCH][COLS], xb[BATCH][COLS];
  fetch(0, i0, xa);
  for (int a0 = 0; a0 < m; a0 += 2 * BATCH) {
    step(a0, xa, xb);
    if (a0 + BATCH < m) step(a0 + BATCH, xb, xa);
  }
#pragma unroll
  for (int c = 0; c < COLS; ++c)
    if (ok[c]) out[k0 + 32 * c] = scale * acc[c];
}

// K1: the gathered dense tile at the geometries the host can pick (f32
// tiles of 128 (8 x 8), 64 and 32 (4 x 4); f64 64 and 32 (4 x 4); the ring
// of 3 stages of 16 steps).  Anything else is refused with
// cudaErrorInvalidValue before a launch.
template <typename T>
int packet_impl(const void* X, const void* flat, const void* u,
                const int* tiles, void* Gp, void* rp, void* G, void* r,
                int64_t n, int m, int64_t chunk, int splits, int bm, int tm,
                int tn, int stages, int steps, int ntiles, int smem,
                double scale, double reg, double scale_r, void* stream) {
#define REPRO_TILE(B, M, N, S, Q)                                             \
  if (bm == B && tm == M && tn == N && stages == S && steps == Q)             \
    return static_cast<int>(repro::launch_tile<T, B, M, N, S, Q, true,       \
                                               repro::Source::ROWS>(          \
        static_cast<const T*>(X), static_cast<const int*>(flat),              \
        static_cast<const T*>(u), tiles, ntiles, m, n, chunk, splits, smem,   \
        static_cast<T>(scale), static_cast<T>(reg), static_cast<T>(scale_r),  \
        static_cast<T*>(Gp), static_cast<T*>(rp), static_cast<T*>(G),         \
        static_cast<T*>(r), static_cast<cudaStream_t>(stream)));
  if constexpr (sizeof(T) == 4) {
    REPRO_TILE(128, 8, 8, 3, 16)
    REPRO_TILE(64, 4, 4, 3, 16)
    REPRO_TILE(32, 4, 4, 3, 16)
  } else {
    REPRO_TILE(64, 4, 4, 3, 16)
    REPRO_TILE(32, 4, 4, 3, 16)
  }
#undef REPRO_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

// K1 in bf16: the tensor-core tile (dense_tile.cuh's mma_tile) at the
// geometries the host can pick (gram_kernel.MMA_BUILT["rows"]: the 16-tile
// up to m = 16, else the 128-tile, micro-tile the 16 x 8 product).
int packet_bf16(const void* X, const void* flat, const void* u,
                const int* tiles, void* Gp, void* rp, void* G, void* r,
                int64_t n, int m, int64_t chunk, int splits, int bm, int tm,
                int tn, int stages, int steps, int ntiles, int smem,
                double scale, double reg, double scale_r, void* stream) {
#define REPRO_MMA(B, S, Q)                                                    \
  if (bm == B && tm == 16 && tn == 8 && stages == S && steps == Q)            \
    return static_cast<int>(                                                  \
        repro::launch_mma_tile<B, S, Q, repro::Source::ROWS>(                 \
            static_cast<const __nv_bfloat16*>(X),                             \
            static_cast<const int*>(flat),                                    \
            static_cast<const __nv_bfloat16*>(u), tiles, ntiles, m, n, chunk, \
            splits, smem, static_cast<float>(scale), static_cast<float>(reg), \
            static_cast<float>(scale_r), static_cast<float*>(Gp),             \
            static_cast<float*>(rp), static_cast<float*>(G),                  \
            static_cast<float*>(r), static_cast<cudaStream_t>(stream)));
  REPRO_MMA(16, 4, 128)
  REPRO_MMA(128, 3, 64)
#undef REPRO_MMA
  return static_cast<int>(cudaErrorInvalidValue);
}

// K2 at `threads` threads a block (64, 128 or 256), COLS columns a thread
// and BATCH samples a batch, from the list below (sampled_kernel.APPLY_BUILT
// lists the same); anything else, or n past an int, is refused with
// cudaErrorInvalidValue before a launch.
template <typename T>
int apply_impl(const void* X, const void* flat, const void* v, void* out,
               int64_t n, int m, int threads, int cols, int batch,
               double scale, void* stream) {
  if (n < 1 || n > INT_MAX ||
      (threads != 64 && threads != 128 && threads != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t span = static_cast<int64_t>(threads) * cols;
  const int blocks = static_cast<int>((n + span - 1) / span);
#define REPRO_APPLY(C, B)                                                     \
  if (cols == C && batch == B) {                                              \
    rows_apply<T, C, B><<<blocks, threads, 0,                                 \
                          static_cast<cudaStream_t>(stream)>>>(               \
        static_cast<const T*>(X), static_cast<const int*>(flat),              \
        static_cast<const T*>(v), m, static_cast<int>(n),                     \
        static_cast<T>(scale), static_cast<T*>(out));                         \
    return static_cast<int>(cudaGetLastError());                              \
  }
  if constexpr (sizeof(T) == 4) {
    REPRO_APPLY(1, 8)
    REPRO_APPLY(2, 4)
    REPRO_APPLY(2, 8)
    REPRO_APPLY(2, 16)
    REPRO_APPLY(4, 8)
  } else {
    REPRO_APPLY(1, 8)
    REPRO_APPLY(2, 4)
    REPRO_APPLY(2, 8)
  }
#undef REPRO_APPLY
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int matvec_impl(const void* X, const void* flat, const void* t, void* rp,
                void* tickets, void* out, int64_t n, int m, int tenants,
                int64_t chunk, int splits, int rows, int group, int stages,
                int steps, int grid_x, int smem, double scale,
                void* stream) {
  RowsGather<T> gather{static_cast<const T*>(X), n};
  return repro::launch_matvec<T>(
      gather, static_cast<const int*>(flat), static_cast<const T*>(t),
      tenants, m, n, chunk, splits, rows, group, stages, steps, grid_x, smem,
      scale, static_cast<T*>(rp), static_cast<int*>(tickets),
      static_cast<T*>(out), static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// rows_packet_*(X, flat, u, tiles, Gp, rp, G, r, n, m, chunk, splits, bm,
// tm, tn, stages, steps, ntiles, smem, scale, reg, scale_r, stream): Gp
// (splits, mp, mp) and rp (splits, mp) are read only at splits > 1.
int rows_packet_f32(const void* X, const void* flat, const void* u,
                    const int* tiles, void* Gp, void* rp, void* G, void* r,
                    int64_t n, int m, int64_t chunk, int splits, int bm,
                    int tm, int tn, int stages, int steps, int ntiles,
                    int smem, double scale, double reg, double scale_r,
                    void* stream) {
  return packet_impl<float>(X, flat, u, tiles, Gp, rp, G, r, n, m, chunk,
                            splits, bm, tm, tn, stages, steps, ntiles, smem,
                            scale, reg, scale_r, stream);
}

int rows_packet_f64(const void* X, const void* flat, const void* u,
                    const int* tiles, void* Gp, void* rp, void* G, void* r,
                    int64_t n, int m, int64_t chunk, int splits, int bm,
                    int tm, int tn, int stages, int steps, int ntiles,
                    int smem, double scale, double reg, double scale_r,
                    void* stream) {
  return packet_impl<double>(X, flat, u, tiles, Gp, rp, G, r, n, m, chunk,
                             splits, bm, tm, tn, stages, steps, ntiles, smem,
                             scale, reg, scale_r, stream);
}

// rows_packet_bf16: as rows_packet_f32 with X and u bf16; Gp, rp, G and r
// are f32.
int rows_packet_bf16(const void* X, const void* flat, const void* u,
                     const int* tiles, void* Gp, void* rp, void* G, void* r,
                     int64_t n, int m, int64_t chunk, int splits, int bm,
                     int tm, int tn, int stages, int steps, int ntiles,
                     int smem, double scale, double reg, double scale_r,
                     void* stream) {
  return packet_bf16(X, flat, u, tiles, Gp, rp, G, r, n, m, chunk, splits,
                     bm, tm, tn, stages, steps, ntiles, smem, scale, reg,
                     scale_r, stream);
}

// rows_apply_*(X, flat, v, out, n, m, threads, cols, batch, scale, stream)
int rows_apply_f32(const void* X, const void* flat, const void* v, void* out,
                   int64_t n, int m, int threads, int cols, int batch,
                   double scale, void* stream) {
  return apply_impl<float>(X, flat, v, out, n, m, threads, cols, batch,
                           scale, stream);
}

int rows_apply_f64(const void* X, const void* flat, const void* v, void* out,
                   int64_t n, int m, int threads, int cols, int batch,
                   double scale, void* stream) {
  return apply_impl<double>(X, flat, v, out, n, m, threads, cols, batch,
                            scale, stream);
}

int rows_matvec_f32(const void* X, const void* flat, const void* t,
                    void* rp, void* tickets, void* out, int64_t n, int m,
                    int tenants, int64_t chunk, int splits, int rows,
                    int group, int stages, int steps, int grid_x, int smem,
                    double scale, void* stream) {
  return matvec_impl<float>(X, flat, t, rp, tickets, out, n, m, tenants,
                           chunk, splits, rows, group, stages, steps, grid_x,
                           smem, scale, stream);
}

int rows_matvec_f64(const void* X, const void* flat, const void* t,
                    void* rp, void* tickets, void* out, int64_t n, int m,
                    int tenants, int64_t chunk, int splits, int rows,
                    int group, int stages, int steps, int grid_x, int smem,
                    double scale, void* stream) {
  return matvec_impl<double>(X, flat, t, rp, tickets, out, n, m, tenants,
                             chunk, splits, rows, group, stages, steps,
                             grid_x, smem, scale, stream);
}

}  // extern "C"
