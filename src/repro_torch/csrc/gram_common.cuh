// Shared pieces of the Gram-packet kernels (sampled_rows.cu,
// sampled_cols.cu, gram_dense.cu): the summation order every packet keeps,
// the column packet's split-contraction tile kernel (K3) and its
// fixed-order second pass that sums the split partials, mirrors the upper
// triangle and applies scale / reg / scale_r, and the matvecs' ring kernel.
// The row and dense packets (K1, K7, K8) run dense_tile.cuh's tile.
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
// order; packet_partial / packet_reduce go through them, and the matvecs'
// ring kernel (matvec_ring, at the end of this file) runs the same fma_rn
// chains and goes through residual_pair / split_sum, so K6(X, flat, u) ==
// K1's r and K5 == K3's r bit for bit at equal (m, K, chunk).
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

// acc + sum_s p[s * stride] for s = 0 .. splits-1, each added in index
// order to the running sum, which starts at acc (0 for a whole split sum).
template <typename T>
__device__ __forceinline__ T split_sum(const T* __restrict__ p, int splits,
                                       size_t stride, T acc = T(0)) {
#pragma unroll 8
  for (int s = 0; s < splits; ++s) acc += p[s * stride];
  return acc;
}

// The row gather, Y = X[flat, :] for X (S, n) row-major, as the matvec
// ring kernel reads it (K6).  K1 gathers its rows in dense_tile.cuh.
template <typename T>
struct RowsGather {
  static constexpr bool CONTIGUOUS = true;  // Y's rows are rows of X
  const T* __restrict__ X;
  int64_t n;  // row length of X (the contraction)

  __device__ __forceinline__ int index(const int* __restrict__ flat,
                                       int a) const {
    return flat[a];
  }
  // Where Y[a, k] lies for a sample whose row of X is `row` (matvec_ring).
  __device__ __forceinline__ const T* at(int row, int64_t k) const {
    return X + row * n + k;
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
// Both are latency-bound unless many loads are in flight: each step carries
// one multiply-add per chain, far too little to hide a DRAM round trip.  So
// each block streams its share of Y and t through a ring of STAGES
// shared-memory stages of STEPS contraction steps each (a multiple of 32),
// filled by cp.async (LDGSTS), keeping STAGES - 1 stages in flight while it
// sums the oldest one.
//
// One block per (group of `rows` sample rows, contraction chunk, group of
// `group` tenants); grid.x = row group * tenant groups + tenant group (the
// tenant groups of one row group run side by side and share its lines in
// L2), grid.y = chunk.  A stage holds one smem row of MvRow<T>::LD
// elements for each of the rows sample rows of Y and each of the nt tenant
// vectors.
//
// Copies.  A contiguous row (a row of X for K6, a tenant's t in both) moves
// as 16-byte cp.async.cg chunks.  Rows of X need not be 16-byte aligned (n
// is odd at real-sim), so each row's chunks start at the aligned address at
// or below its first element, and that element lands `off` elements into
// the smem row (off < 16 / sizeof(T), fixed per row since chunk and STEPS
// are multiples of 32 steps); the bytes before it are never read.  The
// src-size operand zero-fills every element at or past the chunk's end and
// whole rows past m (index -1).  A sampled column of X (K5) has no two
// elements in one line: each element is its own 4- or 8-byte cp.async.ca,
// zero-filled the same way; that scattered traffic bounds K5.
//
// Thread (r, j) of the block's first rows * group threads owns sample row r
// and tenant j: both residual lanes of that row, in two registers; the other
// threads only copy.  Per chain the order is the packet's (residual_lane):
// one fma_rn chain from 0 per lane over k = k_begin + lane, + 2, ... in
// increasing k, the zero-filled steps past the chunk adding nothing; the
// chunk partial is residual_pair(even, odd), written to rp.
//
// The split sum runs in the same kernel: the last block of a row group to
// finish (a ticket counter per grid.x, taken after __threadfence, so no
// float atomics) stages the group's partials in the ring's shared memory
// and sums them with split_sum in index order, then resets its counter for
// the next launch.  So K6(X, flat, u) == K1's r and K5 == K3's r bit for
// bit at equal (m, K, chunk), and a tenant's sums do not depend on the
// tenants beside it.  The launch geometry (rows, group, stages, steps,
// grid, shared memory) is worked out on the host from the shapes alone
// (sampled_kernel.py, matvec_geometry); only the chunk fixes a sum.
// ---------------------------------------------------------------------------

constexpr int MV_THREADS = 128;  // block size of the ring kernel

// 16-byte chunks per element type, and the smem row: STEPS steps plus room
// for the misaligned start (one more chunk).
template <typename T, int STEPS>
struct MvRow {
  static constexpr int V = 16 / static_cast<int>(sizeof(T));
  static constexpr int CHUNKS = STEPS / V + 1;
  static constexpr int LD = CHUNKS * V;
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes global -> shared, both 16-byte aligned; the first `bytes` are
// read and the rest zero-filled (bytes 0: nothing is read from src).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

// One element global -> shared; `valid` false zero-fills it.
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src,
                                              bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
               "l"(src), "n"(static_cast<int>(sizeof(T))),
               "r"(valid ? static_cast<int>(sizeof(T)) : 0)
               : "memory");
}

// Elements from p to its 16-byte aligned floor.
template <typename T>
__device__ __forceinline__ int misalign(const T* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
}

// Copy the 16-byte chunks of smem row `slot` of one stage: the contiguous
// source row `base` (its element k0; null for a row past m) from k0 - off
// on, elements at or past k_end zero-filled.
template <typename T, int STEPS>
__device__ __forceinline__ void issue_row_chunk(T* stage, int slot, int c,
                                                const T* base, int off,
                                                int64_t k0, int64_t k_end,
                                                const T* any) {
  using R = MvRow<T, STEPS>;
  if (off == 0 && c == R::CHUNKS - 1) return;  // past the stage: not read
  const int64_t first = c * R::V - off;        // step of the chunk's start
  const int64_t left = base ? k_end - k0 - first : 0;
  const int n = static_cast<int>(left < 0 ? 0 : left < R::V ? left : R::V);
  cp_async16(stage + slot * R::LD + c * R::V,
             n ? static_cast<const void*>(base + first)
               : static_cast<const void*>(any),
             n * static_cast<int>(sizeof(T)));
}

// Issue the copies of one stage: the rows sample rows of Y in smem rows
// 0 .. rows-1, then the nt tenants' t in smem rows rows .. rows+nt-1.
template <int STEPS, typename T, typename Gather>
__device__ __forceinline__ void ring_issue(const Gather& gather, T* stage,
                                           const int* idx, const int* offs,
                                           int rows, const T* __restrict__ t,
                                           int t0, int nt, int64_t K,
                                           int64_t k0, int64_t k_end,
                                           int tid) {
  using R = MvRow<T, STEPS>;
  // a 16-byte aligned source for the copies that read nothing
  const T* any = reinterpret_cast<const T*>(
      reinterpret_cast<uintptr_t>(t) & ~static_cast<uintptr_t>(15));
  if constexpr (Gather::CONTIGUOUS) {
    for (int e = tid; e < (rows + nt) * R::CHUNKS; e += MV_THREADS) {
      const int slot = e / R::CHUNKS, c = e % R::CHUNKS;
      const T* base;
      if (slot < rows)
        base = idx[slot] >= 0 ? gather.at(idx[slot], k0) : nullptr;
      else
        base = t + static_cast<int64_t>(t0 + slot - rows) * K + k0;
      issue_row_chunk<T, STEPS>(stage, slot, c, base, offs[slot], k0, k_end,
                                any);
    }
  } else {
    for (int e = tid; e < rows * STEPS; e += MV_THREADS) {
      const int slot = e / STEPS;
      const int64_t k = k0 + e % STEPS;
      const int col = idx[slot];
      const bool valid = col >= 0 && k < k_end;
      cp_async_elem(stage + slot * R::LD + e % STEPS,
                    valid ? gather.at(col, k) : gather.X, valid);
    }
    for (int e = tid; e < nt * R::CHUNKS; e += MV_THREADS) {
      const int slot = rows + e / R::CHUNKS;
      issue_row_chunk<T, STEPS>(stage, slot, e % R::CHUNKS,
                      t + static_cast<int64_t>(t0 + slot - rows) * K + k0,
                      offs[slot], k0, k_end, any);
    }
  }
}

template <typename T, typename Gather, int STAGES, int STEPS>
__global__ void __launch_bounds__(MV_THREADS)
matvec_ring(Gather gather, const int* __restrict__ flat,
            const T* __restrict__ t, int tenants, int m, int64_t K,
            int64_t chunk, int mp, int rows, int group, T scale,
            T* __restrict__ rp, int* __restrict__ tickets,
            T* __restrict__ out) {
  using R = MvRow<T, STEPS>;
  extern __shared__ __align__(16) unsigned char mv_smem[];
  int* idx = reinterpret_cast<int*>(mv_smem);  // rows sample indices
  int* offs = idx + rows;                      // rows + group start offsets
  T* ring = reinterpret_cast<T*>(mv_smem +
                                 16 * ((4 * (2 * rows + group) + 15) / 16));
  const int stage_len = (rows + group) * R::LD;

  const int tgroups = (tenants + group - 1) / group;
  const int band = blockIdx.x / tgroups;
  const int t0 = (blockIdx.x % tgroups) * group;
  const int nt = min(group, tenants - t0);
  const int split = blockIdx.y;
  const int64_t k_begin = static_cast<int64_t>(split) * chunk;
  const int64_t k_end = min(K, k_begin + chunk);
  const int slabs = static_cast<int>((k_end - k_begin + STEPS - 1) / STEPS);
  const int tid = threadIdx.x;
  const int r = tid % rows, j = tid / rows;
  const bool owner = j < nt;

  if (tid < rows) {
    const int a = band * rows + tid;
    const int row = a < m ? gather.index(flat, a) : -1;
    idx[tid] = row;
    offs[tid] = (Gather::CONTIGUOUS && row >= 0)
                    ? misalign(gather.at(row, k_begin)) : 0;
  } else if (tid < rows + nt) {
    offs[tid] = misalign(t + static_cast<int64_t>(t0 + tid - rows) * K +
                         k_begin);
  }
  __syncthreads();

#pragma unroll
  for (int q = 0; q < STAGES - 1; ++q) {
    if (q < slabs)
      ring_issue<STEPS>(gather, ring + q * stage_len, idx, offs, rows, t, t0,
                        nt, K, k_begin + static_cast<int64_t>(q) * STEPS,
                        k_end, tid);
    cp_async_commit();
  }

  const int xo = owner ? r * R::LD + offs[r] : 0;
  const int to = owner ? (rows + j) * R::LD + offs[rows + j] : 0;
  T even = 0, odd = 0;
  int cur = 0, nxt = STAGES - 1;  // ring slots of stages q, q + STAGES - 1
  for (int q = 0; q < slabs; ++q) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of stage q landed
    __syncthreads();              // everyone's; and stage q - 1 is consumed
    const int qn = q + STAGES - 1;
    if (qn < slabs)
      ring_issue<STEPS>(gather, ring + nxt * stage_len, idx, offs, rows, t,
                        t0, nt, K, k_begin + static_cast<int64_t>(qn) * STEPS,
                        k_end, tid);
    cp_async_commit();
    if (owner) {
      const T* ys = ring + cur * stage_len + xo;
      const T* ts = ring + cur * stage_len + to;
#pragma unroll 16
      for (int i = 0; i < STEPS; i += 2) {
        even = fma_rn(ys[i], ts[i], even);
        odd = fma_rn(ys[i + 1], ts[i + 1], odd);
      }
    }
    cur = cur + 1 == STAGES ? 0 : cur + 1;
    nxt = nxt + 1 == STAGES ? 0 : nxt + 1;
  }
  cp_async_wait<0>();

  // rp[s, tenant, a]: this block's partials, then the ticket.
  const size_t col = static_cast<size_t>(t0) * mp + band * rows;
  const size_t plane = static_cast<size_t>(tenants) * mp;
  if (owner) rp[split * plane + col + j * mp + r] = residual_pair(even, odd);
  __threadfence();
  __syncthreads();
  __shared__ int last;
  const int splits = gridDim.y;
  if (tid == 0) last = atomicAdd(tickets + blockIdx.x, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // The split sum of the group's rows x nt outputs, `cap` splits at a time
  // through the (now idle) ring; output o = j * rows + r is owner tid's.
  const int outs = rows * nt;
  const int cap = STAGES * stage_len / outs;
  T acc = 0;
  for (int s0 = 0; s0 < splits; s0 += cap) {
    const int cnt = min(cap, splits - s0);
    for (int e = tid; e < cnt * outs; e += MV_THREADS) {
      const int o = e % outs;
      ring[e] = __ldcg(rp + (s0 + e / outs) * plane + col + (o / rows) * mp +
                       o % rows);
    }
    __syncthreads();
    if (owner) acc = split_sum(ring + tid, cnt, outs, acc);
    __syncthreads();
  }
  if (owner && band * rows + r < m)
    out[static_cast<size_t>(t0 + j) * m + band * rows + r] = scale * acc;
  if (tid == 0) tickets[blockIdx.x] = 0;  // ready for the next launch
}

template <typename T, typename Gather, int STAGES, int STEPS>
cudaError_t launch_ring(Gather gather, const int* flat, const T* t,
                        int tenants, int m, int64_t K, int64_t chunk,
                        int splits, int rows, int group, int grid_x, int smem,
                        T scale, T* rp, int* tickets, T* out,
                        cudaStream_t stream) {
  auto kernel = matvec_ring<T, Gather, STAGES, STEPS>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int mp = (m + TILE - 1) / TILE * TILE;
  kernel<<<dim3(grid_x, splits), MV_THREADS, smem, stream>>>(
      gather, flat, t, tenants, m, K, chunk, mp, rows, group, scale, rp,
      tickets, out);
  return cudaGetLastError();
}

// Launch the matvec on `stream`: rp holds (splits, tenants, mp) partials,
// tickets grid_x zeros (left zero again).  The geometry (rows, group,
// stages, steps, grid_x, smem) comes from the host; a shape the kernel is
// not built for is refused with cudaErrorInvalidValue before anything is
// launched.
template <typename T, typename Gather>
int launch_matvec(Gather gather, const int* flat, const T* t, int tenants,
                  int m, int64_t K, int64_t chunk, int splits, int rows,
                  int group, int stages, int steps, int grid_x, int smem,
                  double scale, T* rp, int* tickets, T* out,
                  cudaStream_t stream) {
  if (rows < 1 || TILE % rows != 0 || group < 1 ||
      rows * group > MV_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_RING(S, Q)                                                     \
  if (stages == S && steps == Q)                                             \
    return static_cast<int>(launch_ring<T, Gather, S, Q>(                    \
        gather, flat, t, tenants, m, K, chunk, splits, rows, group, grid_x,  \
        smem, static_cast<T>(scale), rp, tickets, out, stream));
  REPRO_RING(2, 64)
  REPRO_RING(2, 128)
  REPRO_RING(2, 256)
  REPRO_RING(3, 64)
  REPRO_RING(3, 128)
  REPRO_RING(3, 256)
  REPRO_RING(4, 64)
  REPRO_RING(4, 128)
  REPRO_RING(4, 256)
#undef REPRO_RING
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace repro
