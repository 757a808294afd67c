// Row-sampled kernels of the primal (CA-BCD) hot path: Y = X[flat, :] for
// X (d, n) row-major, flat (m,) int32 with duplicates allowed.
//
// K1 rows_packet: (G, r) = (scale * Y Y^T + reg * I, scale_r * Y u).
//   Replaces gram_packet_sampled_pallas (src/repro/kernels/gram/
//   sampled_kernel.py), which scalar-prefetches flat and DMA-gathers the
//   sampled rows into VMEM tile by tile.  Here each block loads its 32
//   indices itself and stages X[flat[a], k0:k0+32] in shared memory with
//   coalesced loads (a warp reads 32 neighbouring columns of one row).
//   Bound on the H100: m(m+1)/2 * n fused multiply-adds on the f32 CUDA
//   cores (no tensor cores are used) against m*n reads of X; at the solve's
//   m = 128, n = 72309 the operations bound (about 18 us at 67 TFLOP/s)
//   exceeds the bytes bound (about 11 us).  The design fills the card by
//   splitting n across blocks (gram_common.cuh) and skips the upper tiles.
//
// K2 rows_apply: out(n) = scale * Y^T v.
//   Replaces panel_apply_pallas (sampled_kernel.py).  A bandwidth kernel:
//   each thread owns one column of n and walks the m gathered rows, so every
//   read of X is coalesced and duplicate indices accumulate naturally.
//   Bound: m * n reads of X at 3.35 TB/s.
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
#include "gram_common.cuh"

namespace {

using repro::RowsGather;
using repro::THREADS;

template <typename T>
__global__ void __launch_bounds__(THREADS)
rows_apply(const T* __restrict__ X, const int* __restrict__ flat,
           const T* __restrict__ v, int m, int64_t n, T scale,
           T* __restrict__ out) {
  __shared__ int idx_s[THREADS];
  __shared__ T v_s[THREADS];
  const int64_t k = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  T acc = 0;
  for (int a0 = 0; a0 < m; a0 += THREADS) {
    const int cnt = min(THREADS, m - a0);
    __syncthreads();
    if (threadIdx.x < cnt) {
      idx_s[threadIdx.x] = flat[a0 + threadIdx.x];
      v_s[threadIdx.x] = v[a0 + threadIdx.x];
    }
    __syncthreads();
    if (k < n)
      for (int a = 0; a < cnt; ++a) acc += X[idx_s[a] * n + k] * v_s[a];
  }
  if (k < n) out[k] = scale * acc;
}

template <typename T>
int packet_impl(const void* X, const void* flat, const void* u, void* Gp,
                void* rp, void* G, void* r, int64_t n, int m, int64_t chunk,
                int splits, double scale, double reg, double scale_r,
                void* stream) {
  RowsGather<T> gather{static_cast<const T*>(X), n};
  return repro::launch_packet<T>(
      gather, static_cast<const int*>(flat), static_cast<const T*>(u), m, n,
      chunk, splits, scale, reg, scale_r, static_cast<T*>(Gp),
      static_cast<T*>(rp), static_cast<T*>(G), static_cast<T*>(r),
      static_cast<cudaStream_t>(stream));
}

template <typename T>
int apply_impl(const void* X, const void* flat, const void* v, void* out,
               int64_t n, int m, double scale, void* stream) {
  const int blocks = static_cast<int>((n + THREADS - 1) / THREADS);
  rows_apply<T><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(X), static_cast<const int*>(flat),
      static_cast<const T*>(v), m, n, static_cast<T>(scale),
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
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

int rows_packet_f32(const void* X, const void* flat, const void* u, void* Gp,
                    void* rp, void* G, void* r, int64_t n, int m,
                    int64_t chunk, int splits, double scale, double reg,
                    double scale_r, void* stream) {
  return packet_impl<float>(X, flat, u, Gp, rp, G, r, n, m, chunk, splits,
                            scale, reg, scale_r, stream);
}

int rows_packet_f64(const void* X, const void* flat, const void* u, void* Gp,
                    void* rp, void* G, void* r, int64_t n, int m,
                    int64_t chunk, int splits, double scale, double reg,
                    double scale_r, void* stream) {
  return packet_impl<double>(X, flat, u, Gp, rp, G, r, n, m, chunk, splits,
                             scale, reg, scale_r, stream);
}

int rows_apply_f32(const void* X, const void* flat, const void* v, void* out,
                   int64_t n, int m, double scale, void* stream) {
  return apply_impl<float>(X, flat, v, out, n, m, scale, stream);
}

int rows_apply_f64(const void* X, const void* flat, const void* v, void* out,
                   int64_t n, int m, double scale, void* stream) {
  return apply_impl<double>(X, flat, v, out, n, m, scale, stream);
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
