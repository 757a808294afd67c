// Shared pieces of the Gram-packet kernels (sampled_rows.cu,
// sampled_cols.cu, gram_dense.cu): the split-contraction tile kernel,
// parameterised on how a tile of the panel Y is gathered, and the
// fixed-order second pass that sums the split partials, mirrors the upper
// triangle and applies scale / reg / scale_r.
//
// Packet contract (every layout): for Y (m, K) the panel,
//   G = scale * Y Y^T + reg * I   (m, m),   r = scale_r * Y u   (m,).
// The rows layout gathers Y = X[flat, :] (K = n), the cols layout gathers
// Y = X[:, flat]^T (K = d) straight from X's (d, n) layout, and the dense
// layout reads a materialised Y = A (m, K) with no index.  The Gram alone
// (K8) is the packet instantiated with RESIDUAL = false: no u is read and
// no r is written, and G is summed exactly as the packet's G.
//
// Matvec contract (K5 / K6): out = scale * Y t for T tenant vectors t (T, K),
// each summed in exactly the order of the packet's r: the same chunks, the
// same two lanes per sample row over a chunk (even and odd steps, each in
// increasing k, each step one fused multiply-add), the same pairing and the
// same split sum.  residual_lane, residual_pair and split_sum below are that
// order; packet_partial / packet_reduce and matvec_partial / matvec_reduce
// all go through them, so K6(X, flat, u) == K1's r and K5 == K3's r bit for
// bit at equal (m, K, chunk).
//
// Work split.  G has only ceil(m/32)(ceil(m/32)+1)/2 lower tiles (10 at
// m = 128), far fewer than the card's 132 SMs, so the contraction K is cut
// into `splits` chunks of `chunk` elements and every (lower tile, chunk)
// pair is one block.  Each block writes its own partial tile; no float
// atomics, so the result is the same on every run.  The chunking is chosen
// on the host from the shapes alone (tuning.py), which fixes the summation
// order for a given (m, K).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int TILE = 32;      // edge of a G tile
constexpr int BK = 32;        // contraction step staged in shared memory
constexpr int THREADS = 256;  // block size of the reduce and apply kernels
constexpr int PTHREADS = 64;  // packet_partial: 8 x 8 threads, 4 x 4 outputs each
constexpr int PAD = 4;        // keeps the rows of a [k][sample] slab 16-byte aligned
constexpr int LOADS = TILE * BK / PTHREADS;  // slab elements per thread per step

// A slab holds BK contraction steps of TILE samples, k-major, so that a
// thread reads its 4 consecutive samples with one 16-byte shared load.
template <typename T>
using Slab = T[BK][TILE + PAD];

// Linear lower-triangle tile index t -> (ti, tj) with tj <= ti.
__device__ __forceinline__ void lower_tile(int t, int* ti, int* tj) {
  int i = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  while (i * (i + 1) / 2 > t) --i;
  *ti = i;
  *tj = t - i * (i + 1) / 2;
}

__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

__device__ __forceinline__ void load4(const double* p, double (&o)[4]) {
  const double2 v0 = reinterpret_cast<const double2*>(p)[0];
  const double2 v1 = reinterpret_cast<const double2*>(p)[1];
  o[0] = v0.x; o[1] = v0.y; o[2] = v1.x; o[3] = v1.y;
}

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// One residual lane over one staged slab: sample row `row`, lane `part`
// (0 or 1) adds ys[kk][row] * us[kk] for kk = part, part + 2, ... < BK in
// increasing kk, each as one explicit fused multiply-add.  Past m and past
// the chunk's end the slab and us hold zeros, so every lane runs the same
// steps in every kernel.
template <typename T>
__device__ __forceinline__ T residual_lane(const Slab<T>& ys, const T* us,
                                           int row, int part, T acc) {
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int kk = 2 * i + part;
    acc = fma_rn(ys[kk][row], us[kk], acc);
  }
  return acc;
}

// A sample row's chunk partial: the even lane's sum plus the odd lane's.
template <typename T>
__device__ __forceinline__ T residual_pair(T even, T odd) {
  return even + odd;
}

// sum_s p[s * stride] for s = 0 .. splits-1, in index order from 0.
template <typename T>
__device__ __forceinline__ T split_sum(const T* __restrict__ p, int splits,
                                       size_t stride) {
  T acc = 0;
#pragma unroll 8
  for (int s = 0; s < splits; ++s) acc += p[s * stride];
  return acc;
}

// The row gather, Y = X[flat, :] for X (S, n) row-major: element
// e = tid + PTHREADS * q of a slab is (sample e / BK, step e % BK), so a
// warp reads 32 neighbouring columns of one row.  K1, K6 and, through
// DenseGather (gram_dense.cu), K7 and K8.
template <typename T>
struct RowsGather {
  const T* __restrict__ X;
  int64_t n;  // row length of X (the contraction)

  __device__ __forceinline__ int index(const int* __restrict__ flat,
                                       int a) const {
    return flat[a];
  }

  __device__ __forceinline__ void fetch(T (&pre)[LOADS], const int* idx,
                                        int64_t k0, int64_t k_end,
                                        int tid) const {
#pragma unroll
    for (int q = 0; q < LOADS; ++q) {
      const int e = tid + PTHREADS * q;
      const int row = idx[e / BK];
      const int64_t k = k0 + e % BK;
      pre[q] = (row >= 0 && k < k_end) ? X[row * n + k] : T(0);
    }
  }

  __device__ __forceinline__ void store(Slab<T>& ys, const T (&pre)[LOADS],
                                        int tid) const {
#pragma unroll
    for (int q = 0; q < LOADS; ++q) {
      const int e = tid + PTHREADS * q;
      ys[e % BK][e / BK] = pre[q];
    }
  }
};

// One block: lower tile (ti, tj) of G over contraction chunk blockIdx.y.
// `Gather` has index(flat, a), the row of X that sample a reads;
// fetch(pre, idx, k0, k_end, tid), which reads this thread's LOADS elements
// of the next slab from X into registers (0 past m, where idx < 0, and past
// k_end); and store(slab, pre, tid), which writes them to shared memory.
// The next slab's loads are issued before the current slab's arithmetic, so
// their latency hides behind it.  RESIDUAL = false leaves out every step of
// r (u and rp may be null); G's arithmetic is the same either way.
template <typename T, typename Gather, bool RESIDUAL>
__global__ void __launch_bounds__(PTHREADS)
packet_partial(Gather gather, const int* __restrict__ flat,
               const T* __restrict__ u, int m, int64_t K, int64_t chunk,
               int mp, T* __restrict__ Gp, T* __restrict__ rp) {
  __shared__ __align__(16) Slab<T> ys_i;
  __shared__ __align__(16) Slab<T> ys_j;
  __shared__ T us[BK];
  __shared__ int idx_i[TILE];
  __shared__ int idx_j[TILE];

  int ti, tj;
  lower_tile(blockIdx.x, &ti, &tj);
  const int split = blockIdx.y;
  const int64_t k_begin = static_cast<int64_t>(split) * chunk;
  const int64_t k_end = min(K, k_begin + chunk);
  const int tid = threadIdx.x;
  const bool diag = (ti == tj);
  // r rides on exactly one tile per row band
  const bool with_r = RESIDUAL && (tj == 0);

  if (tid < TILE) {
    const int a = ti * TILE + tid;
    const int c = tj * TILE + tid;
    idx_i[tid] = a < m ? gather.index(flat, a) : -1;
    idx_j[tid] = c < m ? gather.index(flat, c) : -1;
  }
  __syncthreads();

  T pre_i[LOADS], pre_j[LOADS];
  T pre_u = 0;
  gather.fetch(pre_i, idx_i, k_begin, k_end, tid);
  if (!diag) gather.fetch(pre_j, idx_j, k_begin, k_end, tid);
  if (with_r && tid < BK && k_begin + tid < k_end) pre_u = u[k_begin + tid];

  const int tx = tid % 8, ty = tid / 8;  // rows 4ty..4ty+3, cols 4tx..4tx+3
  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  // Residual: 2 threads per tile row, each over every other step.
  const int rrow = tid / 2, rpart = tid % 2;
  T racc = 0;

  for (int64_t k0 = k_begin; k0 < k_end; k0 += BK) {
    gather.store(ys_i, pre_i, tid);
    if (diag) gather.store(ys_j, pre_i, tid);
    else gather.store(ys_j, pre_j, tid);
    if (with_r && tid < BK) us[tid] = pre_u;
    __syncthreads();
    const int64_t kn = k0 + BK;
    if (kn < k_end) {
      gather.fetch(pre_i, idx_i, kn, k_end, tid);
      if (!diag) gather.fetch(pre_j, idx_j, kn, k_end, tid);
      if (with_r && tid < BK) pre_u = (kn + tid < k_end) ? u[kn + tid] : T(0);
    }
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      T a[4], b[4];
      load4(&ys_i[kk][4 * ty], a);
      load4(&ys_j[kk][4 * tx], b);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    if (with_r) racc = residual_lane(ys_i, us, rrow, rpart, racc);
    __syncthreads();
  }

  T* G = Gp + static_cast<size_t>(split) * mp * mp;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T* row = G + static_cast<size_t>(ti * TILE + 4 * ty + i) * mp + tj * TILE;
#pragma unroll
    for (int j = 0; j < 4; ++j) row[4 * tx + j] = acc[i][j];
  }
  if (with_r) {
    const T odd = __shfl_down_sync(0xffffffffu, racc, 1, 2);
    if (rpart == 0)
      rp[static_cast<size_t>(split) * mp + ti * TILE + rrow] =
          residual_pair(racc, odd);
  }
}

// Second pass: G[a, b] = scale * sum_s Gp[s, lower(a, b)] + reg * (a == b),
// r[a] = scale_r * sum_s rp[s, a] (with RESIDUAL), splits summed in index
// order.  Entries strictly above the tile diagonal read the transposed lower
// tile.
template <typename T, bool RESIDUAL>
__global__ void packet_reduce(const T* __restrict__ Gp,
                              const T* __restrict__ rp, int splits, int m,
                              int mp, T scale, T reg, T scale_r,
                              T* __restrict__ G, T* __restrict__ r) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t mm = static_cast<int64_t>(m) * m;
  const size_t plane = static_cast<size_t>(mp) * mp;
  if (e < mm) {
    const int a = static_cast<int>(e / m), b = static_cast<int>(e % m);
    const size_t src = (a / TILE >= b / TILE)
                           ? static_cast<size_t>(a) * mp + b
                           : static_cast<size_t>(b) * mp + a;
    T g = scale * split_sum(Gp + src, splits, plane);
    if (a == b) g += reg;
    G[e] = g;
  } else if (RESIDUAL && e < mm + m) {
    const int a = static_cast<int>(e - mm);
    r[a] = scale_r * split_sum(rp + a, splits, static_cast<size_t>(mp));
  }
}

// Launch both passes on `stream`; returns the first launch error (0 if none).
template <typename T, typename Gather, bool RESIDUAL = true>
int launch_packet(Gather gather, const int* flat, const T* u, int m,
                  int64_t K, int64_t chunk, int splits, double scale,
                  double reg, double scale_r, T* Gp, T* rp, T* G, T* r,
                  cudaStream_t stream) {
  const int nt = (m + TILE - 1) / TILE;
  const int mp = nt * TILE;
  dim3 grid(nt * (nt + 1) / 2, splits);
  packet_partial<T, Gather, RESIDUAL><<<grid, PTHREADS, 0, stream>>>(
      gather, flat, u, m, K, chunk, mp, Gp, rp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(m) * m + (RESIDUAL ? m : 0);
  const int blocks = static_cast<int>((total + THREADS - 1) / THREADS);
  packet_reduce<T, RESIDUAL><<<blocks, THREADS, 0, stream>>>(
      Gp, rp, splits, m, mp, static_cast<T>(scale), static_cast<T>(reg),
      static_cast<T>(scale_r), G, r);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Matvec kernels (K5, K6): out[j] = scale * Y t[j] for tenants j < T.
//
// One block per (32-row band of Y, contraction chunk, group of MV_TENANTS
// tenants).  The block stages each gathered slab of Y once, with the same
// Gather as the packet, and runs every tenant of its group over it; each
// thread owns one residual lane (row, part) and keeps its group's
// accumulators in shared memory.  Bound by the bytes of the sampled rows /
// columns of X (read once per tenant group) and of t.
// ---------------------------------------------------------------------------

constexpr int MV_TENANTS = 32;                     // tenants per block
constexpr int TLOADS = MV_TENANTS * BK / PTHREADS;  // t elements per thread

// This thread's share of the next t slab: element e = tid + PTHREADS * q is
// (tenant t0 + e / BK, step k0 + e % BK), 0 past the group or the chunk.
template <typename T>
__device__ __forceinline__ void fetch_t(T (&pre)[TLOADS],
                                        const T* __restrict__ t, int t0,
                                        int nt, int64_t K, int64_t k0,
                                        int64_t k_end, int tid) {
#pragma unroll
  for (int q = 0; q < TLOADS; ++q) {
    const int e = tid + PTHREADS * q;
    const int j = e / BK;
    const int64_t k = k0 + e % BK;
    pre[q] = (j < nt && k < k_end)
                 ? t[static_cast<int64_t>(t0 + j) * K + k] : T(0);
  }
}

template <typename T, typename Gather>
__global__ void __launch_bounds__(PTHREADS)
matvec_partial(Gather gather, const int* __restrict__ flat,
               const T* __restrict__ t, int tenants, int m, int64_t K,
               int64_t chunk, int mp, T* __restrict__ rp) {
  __shared__ __align__(16) Slab<T> ys;
  __shared__ T ts[MV_TENANTS][BK];
  __shared__ T acc[MV_TENANTS][PTHREADS];
  __shared__ int idx[TILE];

  const int band = blockIdx.x;
  const int split = blockIdx.y;
  const int t0 = blockIdx.z * MV_TENANTS;
  const int nt = min(MV_TENANTS, tenants - t0);
  const int64_t k_begin = static_cast<int64_t>(split) * chunk;
  const int64_t k_end = min(K, k_begin + chunk);
  const int tid = threadIdx.x;
  const int row = tid / 2, part = tid % 2;

  if (tid < TILE) {
    const int a = band * TILE + tid;
    idx[tid] = a < m ? gather.index(flat, a) : -1;
  }
  for (int j = 0; j < nt; ++j) acc[j][tid] = 0;  // each thread its own column
  __syncthreads();

  T pre[LOADS], pre_t[TLOADS];
  gather.fetch(pre, idx, k_begin, k_end, tid);
  fetch_t(pre_t, t, t0, nt, K, k_begin, k_end, tid);

  for (int64_t k0 = k_begin; k0 < k_end; k0 += BK) {
    gather.store(ys, pre, tid);
#pragma unroll
    for (int q = 0; q < TLOADS; ++q) {
      const int e = tid + PTHREADS * q;
      ts[e / BK][e % BK] = pre_t[q];
    }
    __syncthreads();
    const int64_t kn = k0 + BK;
    if (kn < k_end) {
      gather.fetch(pre, idx, kn, k_end, tid);
      fetch_t(pre_t, t, t0, nt, K, kn, k_end, tid);
    }
    for (int j = 0; j < nt; ++j)
      acc[j][tid] = residual_lane(ys, ts[j], row, part, acc[j][tid]);
    __syncthreads();
  }

  for (int j = 0; j < nt; ++j) {  // nt is uniform across the block
    const T mine = acc[j][tid];
    const T odd = __shfl_down_sync(0xffffffffu, mine, 1, 2);
    if (part == 0)
      rp[(static_cast<size_t>(split) * tenants + t0 + j) * mp + band * TILE +
         row] = residual_pair(mine, odd);
  }
}

// Second pass: out[j, a] = scale * sum_s rp[s, j, a], splits in index order.
template <typename T>
__global__ void matvec_reduce(const T* __restrict__ rp, int splits,
                              int tenants, int m, int mp, T scale,
                              T* __restrict__ out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<int64_t>(tenants) * m) return;
  const int j = static_cast<int>(e / m), a = static_cast<int>(e % m);
  out[e] = scale * split_sum(rp + static_cast<size_t>(j) * mp + a, splits,
                             static_cast<size_t>(tenants) * mp);
}

// Launch both matvec passes on `stream`; rp holds (splits, tenants, mp).
template <typename T, typename Gather>
int launch_matvec(Gather gather, const int* flat, const T* t, int tenants,
                  int m, int64_t K, int64_t chunk, int splits, double scale,
                  T* rp, T* out, cudaStream_t stream) {
  const int nt = (m + TILE - 1) / TILE;
  const int mp = nt * TILE;
  dim3 grid(nt, splits, (tenants + MV_TENANTS - 1) / MV_TENANTS);
  matvec_partial<T, Gather><<<grid, PTHREADS, 0, stream>>>(
      gather, flat, t, tenants, m, K, chunk, mp, rp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(tenants) * m;
  const int blocks = static_cast<int>((total + THREADS - 1) / THREADS);
  matvec_reduce<T><<<blocks, THREADS, 0, stream>>>(
      rp, splits, tenants, m, mp, static_cast<T>(scale), out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro
