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
//   multiply-adds on the f32 CUDA cores.  The split-contraction tile of
//   gram_common.cuh (packet_partial, packet_reduce); the d-chunks fill the
//   card.
//
// K4 cols_apply: out(d) = scale * Y v.
//   Replaces panel_apply_cols_pallas (sampled_colmajor.py).  One warp per row
//   k of X; the lanes stride over the sampled columns and a fixed shuffle
//   tree sums them.  The reads are scattered by nature: the bound is the
//   sector traffic m * d * 32 B.
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
#include "gram_common.cuh"

namespace {

using repro::LOADS;
using repro::PTHREADS;
using repro::Slab;
using repro::THREADS;
using repro::TILE;

template <typename T>
struct ColsGather {
  static constexpr bool CONTIGUOUS = false;  // Y's rows are columns of X
  const T* __restrict__ X;
  int64_t n;  // row length of X; the contraction runs over X's d rows

  __device__ __forceinline__ int index(const int* __restrict__ flat,
                                       int a) const {
    return flat[a];
  }

  // Element e = tid + PTHREADS * q of a slab is (sample e % TILE, step
  // e / TILE): a warp reads the 32 sampled columns of one row of X.
  __device__ __forceinline__ void fetch(T (&pre)[LOADS], const int* idx,
                                        int64_t k0, int64_t k_end,
                                        int tid) const {
#pragma unroll
    for (int q = 0; q < LOADS; ++q) {
      const int e = tid + PTHREADS * q;
      const int col = idx[e % TILE];
      const int64_t k = k0 + e / TILE;
      pre[q] = (col >= 0 && k < k_end) ? X[k * n + col] : T(0);
    }
  }

  __device__ __forceinline__ void store(Slab<T>& ys, const T (&pre)[LOADS],
                                        int tid) const {
#pragma unroll
    for (int q = 0; q < LOADS; ++q) {
      const int e = tid + PTHREADS * q;
      ys[e / TILE][e % TILE] = pre[q];
    }
  }

  // Where Y[a, k] = X[k, col] lies for sample column `col` (matvec_ring).
  __device__ __forceinline__ const T* at(int col, int64_t k) const {
    return X + k * n + col;
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
cols_apply(const T* __restrict__ X, const int* __restrict__ flat,
           const T* __restrict__ v, int m, int64_t d, int64_t n, T scale,
           T* __restrict__ out) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= d) return;  // uniform across the warp
  const T* __restrict__ xr = X + row * n;
  T acc = 0;
  for (int a = lane; a < m; a += 32) acc += xr[flat[a]] * v[a];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[row] = scale * acc;
}

template <typename T>
int packet_impl(const void* X, const void* flat, const void* u, void* Gp,
                void* rp, void* G, void* r, int64_t d, int64_t n, int m,
                int64_t chunk, int splits, double scale, double reg,
                double scale_r, void* stream) {
  ColsGather<T> gather{static_cast<const T*>(X), n};
  return repro::launch_packet<T>(
      gather, static_cast<const int*>(flat), static_cast<const T*>(u), m, d,
      chunk, splits, scale, reg, scale_r, static_cast<T*>(Gp),
      static_cast<T*>(rp), static_cast<T*>(G), static_cast<T*>(r),
      static_cast<cudaStream_t>(stream));
}

template <typename T>
int apply_impl(const void* X, const void* flat, const void* v, void* out,
               int64_t d, int64_t n, int m, double scale, void* stream) {
  constexpr int rows_per_block = THREADS / 32;
  const int blocks = static_cast<int>((d + rows_per_block - 1) / rows_per_block);
  cols_apply<T><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(X), static_cast<const int*>(flat),
      static_cast<const T*>(v), m, d, n, static_cast<T>(scale),
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
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

int cols_packet_f32(const void* X, const void* flat, const void* u, void* Gp,
                    void* rp, void* G, void* r, int64_t d, int64_t n, int m,
                    int64_t chunk, int splits, double scale, double reg,
                    double scale_r, void* stream) {
  return packet_impl<float>(X, flat, u, Gp, rp, G, r, d, n, m, chunk, splits,
                            scale, reg, scale_r, stream);
}

int cols_packet_f64(const void* X, const void* flat, const void* u, void* Gp,
                    void* rp, void* G, void* r, int64_t d, int64_t n, int m,
                    int64_t chunk, int splits, double scale, double reg,
                    double scale_r, void* stream) {
  return packet_impl<double>(X, flat, u, Gp, rp, G, r, d, n, m, chunk,
                             splits, scale, reg, scale_r, stream);
}

int cols_apply_f32(const void* X, const void* flat, const void* v, void* out,
                   int64_t d, int64_t n, int m, double scale, void* stream) {
  return apply_impl<float>(X, flat, v, out, d, n, m, scale, stream);
}

int cols_apply_f64(const void* X, const void* flat, const void* v, void* out,
                   int64_t d, int64_t n, int m, double scale, void* stream) {
  return apply_impl<double>(X, flat, v, out, d, n, m, scale, stream);
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
