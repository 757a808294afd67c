// Gram kernels on a materialised operand A (m, K), row-major, contiguous: the
// baselines' path (CholeskyQR's R factor, the packet on a gathered panel).
//
// K7 dense_packet: (G, r) = (scale * A A^T + reg * I, scale_r * A u).
//   Replaces gram_packet_pallas (src/repro/kernels/gram/gram_kernel.py),
//   which walks a (m/bm, m/bm, K/bk) grid in order, keeping each G tile in
//   VMEM over the whole contraction, skipping the upper tiles and riding r
//   on the j == 0 cells.
// K8 dense_gram: G = scale * A A^T + reg * I.
//   Replaces gram_pallas (same file), the packet body with the residual refs
//   statically absent: here dense_tile with RESIDUAL = false, so no u is read
//   and no r is computed or written, and G is summed exactly as K7's G.
//
// Bound on the H100: m(m+1)/2 * K (+ m * K for r) fused multiply-adds on
// the f32 CUDA cores, no tensor cores (a TF32 product fails the f32 gate).
// K7 also takes bf16 A and u (the reference's bf16 packet): bf16 products
// with f32 sums on the tensor cores (dense_tile.cuh's mma_tile, K1's bf16
// geometry and chunk, bound by the operand's bytes), equal to bf16 K1 on
// the gathered rows and, at K3's chunk, to bf16 K3.
// At CholeskyQR's real-sim operand (m = 20958, K = 93267) that is 0.61 s of
// operations against 2.3 ms of bytes; at K7's gathered panel (m = 128,
// K = 72309) about 18 us against 11 us.  So the kernel has to keep the FMA
// pipes fed, and what starves them is operand traffic into the SM.
//
// The kernel (dense_tile, dense_reduce) is in dense_tile.cuh, shared with
// the row-sampled packet K1; here it reads the rows of A in place
// (SRC = DENSE).  At CholeskyQR's operand (one chunk) the 128-tile
// writes G directly; at K7's gathered panel K1's chunk gives 103 splits,
// so the 32-tile runs 1030 blocks and dense_reduce sums their partials.
#include "dense_tile.cuh"

namespace {

// The geometries the kernel is built for (gram_kernel.DENSE_TILES and
// DENSE_RINGS list the same): f32 tiles (BM, TM, TN) of 128 (8 x 8), 64
// (8 x 8 and 4 x 4) and 32 (4 x 4) with every ring of 2-4 stages of 8, 16
// or 32 steps; f64, whose 8 x 8 accumulators would not fit beside the rest
// in 128 registers, the 64 and 32 tiles of 4 x 4 with 3 stages of 16
// steps.  Anything else is refused with cudaErrorInvalidValue before a
// launch.
template <typename T, bool RESIDUAL>
int dense_impl(const void* A, const void* u, const int* tiles, void* Gp,
               void* rp, void* G, void* r, int64_t K, int m, int64_t chunk,
               int splits, int bm, int tm, int tn, int stages, int steps,
               int ntiles, int smem, double scale, double reg, double scale_r,
               void* stream) {
#define REPRO_TILE(B, M, N, S, Q)                                             \
  if (bm == B && tm == M && tn == N && stages == S && steps == Q)             \
    return static_cast<int>(                                                  \
        repro::launch_tile<T, B, M, N, S, Q, RESIDUAL,                        \
                           repro::Source::DENSE>(                             \
            static_cast<const T*>(A), nullptr, static_cast<const T*>(u),      \
            tiles, ntiles, m, K, chunk, splits, smem, static_cast<T>(scale),  \
            static_cast<T>(reg), static_cast<T>(scale_r),                     \
            static_cast<T*>(Gp), static_cast<T*>(rp), static_cast<T*>(G),     \
            static_cast<T*>(r), static_cast<cudaStream_t>(stream)));
#define REPRO_RINGS(B, M, N)                                                  \
  REPRO_TILE(B, M, N, 2, 8) REPRO_TILE(B, M, N, 2, 16)                        \
  REPRO_TILE(B, M, N, 2, 32) REPRO_TILE(B, M, N, 3, 8)                        \
  REPRO_TILE(B, M, N, 3, 16) REPRO_TILE(B, M, N, 3, 32)                       \
  REPRO_TILE(B, M, N, 4, 8) REPRO_TILE(B, M, N, 4, 16)                        \
  REPRO_TILE(B, M, N, 4, 32)
  if constexpr (sizeof(T) == 4) {
    REPRO_RINGS(128, 8, 8)
    REPRO_RINGS(64, 8, 8)
    REPRO_RINGS(64, 4, 4)
    REPRO_RINGS(32, 4, 4)
  } else {
    REPRO_TILE(64, 4, 4, 3, 16)
    REPRO_TILE(32, 4, 4, 3, 16)
  }
#undef REPRO_RINGS
#undef REPRO_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

// K7 in bf16: the tensor-core tile (dense_tile.cuh's mma_tile) at the
// geometries the host can pick (gram_kernel.MMA_BUILT["dense"], K1's).
int dense_bf16(const void* A, const void* u, const int* tiles, void* Gp,
               void* rp, void* G, void* r, int64_t K, int m, int64_t chunk,
               int splits, int bm, int tm, int tn, int stages, int steps,
               int ntiles, int smem, double scale, double reg, double scale_r,
               void* stream) {
#define REPRO_MMA(B, S, Q)                                                    \
  if (bm == B && tm == 16 && tn == 8 && stages == S && steps == Q)            \
    return static_cast<int>(                                                  \
        repro::launch_mma_tile<B, S, Q, repro::Source::DENSE>(                \
            static_cast<const __nv_bfloat16*>(A), nullptr,                    \
            static_cast<const __nv_bfloat16*>(u), tiles, ntiles, m, K, chunk, \
            splits, smem, static_cast<float>(scale), static_cast<float>(reg), \
            static_cast<float>(scale_r), static_cast<float*>(Gp),             \
            static_cast<float*>(rp), static_cast<float*>(G),                  \
            static_cast<float*>(r), static_cast<cudaStream_t>(stream)));
  REPRO_MMA(16, 4, 128)
  REPRO_MMA(128, 3, 64)
#undef REPRO_MMA
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dense_packet_*(A, u, tiles, Gp, rp, G, r, K, m, chunk, splits, bm, tm, tn,
// stages, steps, ntiles, smem, scale, reg, scale_r, stream): Gp (splits, mp,
// mp) and rp (splits, mp) are read only at splits > 1 (null otherwise).
int dense_packet_f32(const void* A, const void* u, const int* tiles, void* Gp,
                     void* rp, void* G, void* r, int64_t K, int m,
                     int64_t chunk, int splits, int bm, int tm, int tn,
                     int stages, int steps, int ntiles, int smem, double scale,
                     double reg, double scale_r, void* stream) {
  return dense_impl<float, true>(A, u, tiles, Gp, rp, G, r, K, m, chunk,
                                 splits, bm, tm, tn, stages, steps, ntiles,
                                 smem, scale, reg, scale_r, stream);
}

int dense_packet_f64(const void* A, const void* u, const int* tiles, void* Gp,
                     void* rp, void* G, void* r, int64_t K, int m,
                     int64_t chunk, int splits, int bm, int tm, int tn,
                     int stages, int steps, int ntiles, int smem, double scale,
                     double reg, double scale_r, void* stream) {
  return dense_impl<double, true>(A, u, tiles, Gp, rp, G, r, K, m, chunk,
                                  splits, bm, tm, tn, stages, steps, ntiles,
                                  smem, scale, reg, scale_r, stream);
}

// dense_packet_bf16: as dense_packet_f32 with A and u bf16; Gp, rp, G and
// r are f32.
int dense_packet_bf16(const void* A, const void* u, const int* tiles,
                      void* Gp, void* rp, void* G, void* r, int64_t K, int m,
                      int64_t chunk, int splits, int bm, int tm, int tn,
                      int stages, int steps, int ntiles, int smem,
                      double scale, double reg, double scale_r, void* stream) {
  return dense_bf16(A, u, tiles, Gp, rp, G, r, K, m, chunk, splits, bm, tm,
                    tn, stages, steps, ntiles, smem, scale, reg, scale_r,
                    stream);
}

// dense_gram_*(A, tiles, Gp, G, K, m, chunk, splits, bm, tm, tn, stages,
// steps, ntiles, smem, scale, reg, stream)
int dense_gram_f32(const void* A, const int* tiles, void* Gp, void* G,
                   int64_t K, int m, int64_t chunk, int splits, int bm, int tm,
                   int tn, int stages, int steps, int ntiles, int smem,
                   double scale, double reg, void* stream) {
  return dense_impl<float, false>(A, nullptr, tiles, Gp, nullptr, G, nullptr,
                                  K, m, chunk, splits, bm, tm, tn, stages,
                                  steps, ntiles, smem, scale, reg, 1.0,
                                  stream);
}

int dense_gram_f64(const void* A, const int* tiles, void* Gp, void* G,
                   int64_t K, int m, int64_t chunk, int splits, int bm, int tm,
                   int tn, int stages, int steps, int ntiles, int smem,
                   double scale, double reg, void* stream) {
  return dense_impl<double, false>(A, nullptr, tiles, Gp, nullptr, G, nullptr,
                                   K, m, chunk, splits, bm, tm, tn, stages,
                                   steps, ntiles, smem, scale, reg, 1.0,
                                   stream);
}

}  // extern "C"
