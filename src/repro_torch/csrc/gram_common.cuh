// Shared pieces of the Gram-packet and matvec kernels (sampled_rows.cu,
// sampled_cols.cu, gram_dense.cu): the residual pairing and split sum of
// every packet's order, the row gather as the matvecs read it, the cp.async
// helpers, and the matvecs' ring kernel (K5, K6).  The packets K1, K3, K7
// and K8 run dense_tile.cuh's tile, which states the packet contract and
// its summation order.
//
// Matvec contract (K5 / K6): out = scale * Y t for T tenant vectors t (T, K),
// each summed in exactly the order of the packet's r (dense_tile.cuh): the
// same chunks, the same two lanes per sample row over a chunk (even and odd
// steps, each in increasing k, each step one fused multiply-add), the same
// pairing (residual_pair) and the same split sum (split_sum's order).  So
// K6(X, flat, u) == K1's r and K5 == K3's r bit for bit at equal
// (m, K, chunk).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

constexpr int TILE = 32;  // rows of a partial buffer are padded to this

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
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
// threads only copy.  Per chain the order is the packet's (dense_tile's r
// lanes): one fma_rn chain from 0 per lane over k = k_begin + lane, + 2,
// ... in increasing k, the zero-filled steps past the chunk adding nothing;
// the chunk partial is residual_pair(even, odd), written to rp.
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
