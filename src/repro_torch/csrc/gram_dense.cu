// Gram kernels on a materialised operand A (m, K), row-major, contiguous: the
// baselines' path (CholeskyQR's R factor, the packet on a gathered panel).
//
// K7 dense_packet: (G, r) = (scale * A A^T + reg * I, scale_r * A u).
//   Replaces gram_packet_pallas (src/repro/kernels/gram/gram_kernel.py),
//   which walks a (m/bm, m/bm, K/bk) grid in order, keeping each G tile in
//   VMEM over the whole contraction, skipping the upper tiles and riding r
//   on the j == 0 cells.  Here it is K1's kernel (gram_common.cuh) with a
//   gather that reads the tile's own rows of A, A[row * K + k] in int64
//   offsets, and loads no index: lower 32 x 32 tiles only, the contraction
//   split into chunks over blocks with no atomics, and a second pass that
//   sums the chunks in index order and mirrors the upper triangle.  The
//   chunk comes from tuning.pick_tiles(m, K, dtype, "rows"), K1's pick, so
//   K7(X[flat], u) equals K1(X, flat, u) bit for bit.  Bound on the H100:
//   m(m+1)/2 * K + m * K fused multiply-adds on the f32 CUDA cores (no
//   tensor cores), against m * K reads of A; at the gathered panel's
//   m = 128, K = 72309 the operations (about 18 us at 67 TFLOP/s) exceed
//   the bytes (about 11 us).
//
// K8 dense_gram: G = scale * A A^T + reg * I.
//   Replaces gram_pallas (same file), the packet body with the residual refs
//   statically absent.  Here the same kernels instantiated with
//   RESIDUAL = false: no u is read, no r is computed or written, and G is
//   summed exactly as K7's G (K8(A) equals K7(A, u)'s G bit for bit).
//   Bound: m(m+1)/2 * K multiply-adds; at CholeskyQR's real-sim operand
//   (m = 20958, K = 93267) about 0.61 s of f32 operations against 2.3 ms of
//   bytes.  The grid then holds 214840 lower tiles, enough to fill the card
//   with one chunk each, so the pick gives a single split and each thread
//   sums its 4 x 4 outputs over all of K in order.
#include "gram_common.cuh"

namespace {

// The dense layout: sample a is row a of A.
template <typename T>
struct DenseGather : repro::RowsGather<T> {
  __device__ __forceinline__ int index(const int*, int a) const { return a; }
};

template <typename T, bool RESIDUAL>
int dense_impl(const void* A, const void* u, void* Gp, void* rp, void* G,
               void* r, int64_t K, int m, int64_t chunk, int splits,
               double scale, double reg, double scale_r, void* stream) {
  DenseGather<T> gather{{static_cast<const T*>(A), K}};
  return repro::launch_packet<T, DenseGather<T>, RESIDUAL>(
      gather, nullptr, static_cast<const T*>(u), m, K, chunk, splits, scale,
      reg, scale_r, static_cast<T*>(Gp), static_cast<T*>(rp),
      static_cast<T*>(G), static_cast<T*>(r),
      static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

int dense_packet_f32(const void* A, const void* u, void* Gp, void* rp,
                     void* G, void* r, int64_t K, int m, int64_t chunk,
                     int splits, double scale, double reg, double scale_r,
                     void* stream) {
  return dense_impl<float, true>(A, u, Gp, rp, G, r, K, m, chunk, splits,
                                 scale, reg, scale_r, stream);
}

int dense_packet_f64(const void* A, const void* u, void* Gp, void* rp,
                     void* G, void* r, int64_t K, int m, int64_t chunk,
                     int splits, double scale, double reg, double scale_r,
                     void* stream) {
  return dense_impl<double, true>(A, u, Gp, rp, G, r, K, m, chunk, splits,
                                  scale, reg, scale_r, stream);
}

int dense_gram_f32(const void* A, void* Gp, void* G, int64_t K, int m,
                   int64_t chunk, int splits, double scale, double reg,
                   void* stream) {
  return dense_impl<float, false>(A, nullptr, Gp, nullptr, G, nullptr, K, m,
                                  chunk, splits, scale, reg, 1.0, stream);
}

int dense_gram_f64(const void* A, void* Gp, void* G, int64_t K, int m,
                   int64_t chunk, int splits, double scale, double reg,
                   void* stream) {
  return dense_impl<double, false>(A, nullptr, Gp, nullptr, G, nullptr, K, m,
                                   chunk, splits, scale, reg, 1.0, stream);
}

}  // extern "C"
