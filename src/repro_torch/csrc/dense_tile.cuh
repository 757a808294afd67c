// The register-blocked Gram tile kernel and its reduce pass, shared by the
// dense Gram kernels K7 / K8 (gram_dense.cu, rows of a materialised operand
// A) and the row-sampled packet K1 (sampled_rows.cu, rows X[flat[a]] of X).
//
// Design (dense_tile):
// * Register-blocked tiles.  A block owns one lower BM x BM tile of G over
//   one contraction chunk; each of its (BM/TM)(BM/TN) threads keeps a
//   TM x TN micro-tile in registers, as groups of 4 rows (columns) SEG
//   apart, so that a thread reads its operands with 16-byte shared loads
//   and neighbouring threads read neighbouring addresses.  Per contraction
//   step a block reads 2 BM elements for BM^2 FMAs: at BM = 128, 16 FMAs a
//   byte, about 2.1 TB/s of L2 traffic at the f32 peak.  The host picks BM
//   from m (gram_kernel.dense_geometry).
// * An asynchronous ring.  STAGES shared-memory stages of STEPS contraction
//   steps each, filled by cp.async; STAGES - 1 stages are in flight while
//   the block sums the oldest.  Stages are k-major ([step][row]), so a
//   thread's 4 rows at one step are one 16-byte shared load.
// * Misaligned rows.  K is odd at the real shapes, so a row is only 4-byte
//   (f64: 8-byte) aligned and no 16-byte copy can start on it.  Each
//   element therefore moves as its own 4- (8-) byte cp.async.ca, which also
//   does the transpose into the k-major stage for free; a warp copies 8
//   consecutive steps of 4 rows, so its global reads are 32-byte runs (the
//   L1 keeps the neighbouring sectors for the next copy) and its shared
//   writes hit 32 distinct banks (row stride BM + 4 words).  Rows past m
//   and steps past the chunk are zero-filled (src-size 0).
// * Where a row lies.  Rows are contiguous in both callers, so only a row's
//   base address differs: band + r of A (GATHER = false), or flat[band + r]
//   of X (GATHER = true).  A gathering thread reads the indices of its
//   copied rows once and keeps each row's 64-bit base in a register; then
//   it copies exactly as the dense kernel does.  Duplicate indices need
//   nothing special.
// * Tile order.  The host hands the kernel its list of lower tiles
//   (gram_kernel.dense_tiles): strips of `group` row bands, column by column
//   within a strip, so that the blocks resident at one time touch few row
//   bands.
// * Only the work that is needed.  At one chunk the block writes
//   scale * acc (+ reg on the diagonal) and its mirror straight into G: no
//   partial buffer, no second pass.  At more chunks it writes its chunk
//   partial and dense_reduce sums them, over the lower entries only and
//   with 16 loads in flight.
//
// Every sum is the packet's (gram_common.cuh).  G[a, b] is scale *
// split_sum over the chunks, in index order, of one fma_rn chain per chunk
// over increasing k; r[a] is scale_r * split_sum of residual_pair(even
// lane, odd lane), each lane one fma_rn chain over every other step of the
// chunk (residual_lane's order).  The chunk is the host's pick for
// (m, K) in the row layout, so K1(X, flat, u) equals K7(X[flat], u), K8(A)
// equals K7(A, u)'s G and G equals G^T, bit for bit; the geometry (BM,
// micro-tile, ring, tile order) never moves a sum.  Every offset into the
// operand is 64-bit (A has 1.95e9 elements at real-sim).
#pragma once

#include "gram_common.cuh"

namespace repro {

template <typename T, int BM, int TM, int TN, int STEPS>
struct Tile {
  static constexpr int NTY = BM / TM;  // threads along the tile's rows
  static constexpr int NTX = BM / TN;  // ... along its columns
  static constexpr int THREADS = NTY * NTX;
  static constexpr int SEG_M = 4 * NTY;  // rows between a thread's row groups
  static constexpr int SEG_N = 4 * NTX;
  static constexpr int LD = BM + 16 / static_cast<int>(sizeof(T));
  // a stage: operand i [STEPS][LD], operand j [STEPS][LD], u [STEPS]
  static constexpr int STAGE = 2 * STEPS * LD + STEPS;
  static constexpr int ROW_STEP = THREADS / 8;  // rows apart per copy
  static constexpr int ROW_COPIES = BM / ROW_STEP;
  static constexpr int COPIES = BM * STEPS / THREADS;  // per operand, thread
  static constexpr int LANES = (2 * BM + THREADS - 1) / THREADS;  // r lanes
  static_assert(TM % 4 == 0 && TN % 4 == 0 && BM % TM == 0 && BM % TN == 0);
  static_assert(THREADS % 32 == 0 && BM % ROW_STEP == 0 && STEPS % 8 == 0);
  static_assert(COPIES % ROW_COPIES == 0);
};

template <typename T>
__device__ __forceinline__ void load4s(const T* p, T* o) {
  if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else {
    const double2 v0 = reinterpret_cast<const double2*>(p)[0];
    const double2 v1 = reinterpret_cast<const double2*>(p)[1];
    o[0] = v0.x; o[1] = v0.y; o[2] = v1.x; o[3] = v1.y;
  }
}

// The reduce pass's arithmetic, each step rounded on its own as in
// packet_reduce's machine code (a multiply, then an add on the diagonal:
// never contracted into one fused multiply-add).
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// G[a, b] from its split sum: scale * sum, plus reg on the diagonal.
template <typename T>
__device__ __forceinline__ T g_entry(T sum, T scale, T reg, bool diagonal) {
  const T g = mul_rn(scale, sum);
  return diagonal ? add_rn(g, reg) : g;
}

// split_sum's order (0, then p[0], p[1], ... added one at a time) with the
// loads issued DEPTH at a time ahead of their adds.
constexpr int DEPTH = 16;

template <typename T>
__device__ __forceinline__ T split_sum_deep(const T* __restrict__ p,
                                            int splits, size_t stride) {
  T acc = T(0);
  int s = 0;
  for (; s + DEPTH <= splits; s += DEPTH) {
    T v[DEPTH];
#pragma unroll
    for (int i = 0; i < DEPTH; ++i) v[i] = p[(s + i) * stride];
#pragma unroll
    for (int i = 0; i < DEPTH; ++i) acc = add_rn(acc, v[i]);
  }
  for (; s < splits; ++s) acc = add_rn(acc, p[s * stride]);
  return acc;
}

// Copy one stage of one operand: this thread's COPIES elements, element
// e = tid + THREADS * q at step 8 (q / ROW_COPIES) + tid % 8 and row
// tid / 8 + ROW_STEP (q % ROW_COPIES) of the stage.  `dst` is the thread's
// first slot (step tid % 8, row tid / 8), `src` its first element in A, `rs`
// ROW_STEP rows of A, bit c of `rows_ok` whether row tid / 8 + ROW_STEP c
// lies inside A, and `lim` the steps left in the chunk.  A copy that is not
// valid reads nothing (src-size 0), whatever its address.
template <typename D, typename T>
__device__ __forceinline__ void issue_operand(T* dst, const T* src,
                                              int64_t rs, unsigned rows_ok,
                                              int lim, int klo) {
#pragma unroll
  for (int q = 0; q < D::COPIES; ++q) {
    const int c = q % D::ROW_COPIES, kh = 8 * (q / D::ROW_COPIES);
    cp_async_elem(dst + kh * D::LD + D::ROW_STEP * c, src + c * rs + kh,
                  ((rows_ok >> c) & 1u) && kh + klo < lim);
  }
}

// The same copies from gathered rows: rows[c] is the thread's first
// element of row tid / 8 + ROW_STEP c, `off` the stage's first step.
template <typename D, typename T>
__device__ __forceinline__ void issue_gathered(
    T* dst, const T* const (&rows)[D::ROW_COPIES], int64_t off,
    unsigned rows_ok, int lim, int klo) {
#pragma unroll
  for (int q = 0; q < D::COPIES; ++q) {
    const int c = q % D::ROW_COPIES, kh = 8 * (q / D::ROW_COPIES);
    cp_async_elem(dst + kh * D::LD + D::ROW_STEP * c, rows[c] + off + kh,
                  ((rows_ok >> c) & 1u) && kh + klo < lim);
  }
}

// One block: lower tile tiles[blockIdx.x] = (ti << 16 | tj) of G over
// contraction chunk blockIdx.y.  Row a of the panel is row a of A, or with
// GATHER row flat[a] of A (then A is X, K its row length; flat is read only
// then).  At one chunk (Gp null) the block writes G (and r) itself; else
// its partials Gp[split] (mp x mp, lower tiles only) and rp[split] for
// dense_reduce.
template <typename T, int BM, int TM, int TN, int STAGES, int STEPS,
          bool RESIDUAL, bool GATHER>
__global__ void __launch_bounds__(Tile<T, BM, TM, TN, STEPS>::THREADS,
                                  512 / Tile<T, BM, TM, TN, STEPS>::THREADS)
dense_tile(const T* __restrict__ A, const T* __restrict__ u,
           const int* __restrict__ tiles, int m, int64_t K, int64_t chunk,
           int mp, T scale, T reg, T scale_r, T* __restrict__ Gp,
           T* __restrict__ rp, T* __restrict__ G, T* __restrict__ r,
           const int* __restrict__ flat) {
  using D = Tile<T, BM, TM, TN, STEPS>;
  extern __shared__ __align__(16) unsigned char dense_smem[];
  T* ring = reinterpret_cast<T*>(dense_smem);

  const int packed = tiles[blockIdx.x];
  const int ti = packed >> 16, tj = packed & 0xffff;
  const int band_i = ti * BM, band_j = tj * BM;
  const bool diag = ti == tj;
  const bool with_r = RESIDUAL && tj == 0;  // r rides on one tile per band
  const int split = blockIdx.y;
  const int64_t k_begin = static_cast<int64_t>(split) * chunk;
  const int64_t k_end = min(K, k_begin + chunk);
  const int slabs = static_cast<int>((k_end - k_begin + STEPS - 1) / STEPS);
  const int tid = threadIdx.x;
  const int tx = tid % D::NTX, ty = tid / D::NTX;

  // The copies' addresses, worked out once: this thread's first element of
  // each operand (row band + tid / 8, step k_begin + tid % 8) and slot.
  const int r0 = tid >> 3, klo = tid & 7;
  const int64_t rs = static_cast<int64_t>(D::ROW_STEP) * K;
  const T* src_i = A + static_cast<int64_t>(band_i + r0) * K + k_begin + klo;
  const T* src_j = A + static_cast<int64_t>(band_j + r0) * K + k_begin + klo;
  unsigned ok_i = 0, ok_j = 0;
#pragma unroll
  for (int c = 0; c < D::ROW_COPIES; ++c) {
    ok_i |= static_cast<unsigned>(band_i + r0 + D::ROW_STEP * c < m) << c;
    ok_j |= static_cast<unsigned>(band_j + r0 + D::ROW_STEP * c < m) << c;
  }
  // Gathered rows: the same element of row flat[band + r0 + ROW_STEP c]
  // (A itself for a row past m: its copies read nothing).
  const T* rows_i[D::ROW_COPIES];
  const T* rows_j[D::ROW_COPIES];
  if constexpr (GATHER) {
#pragma unroll
    for (int c = 0; c < D::ROW_COPIES; ++c) {
      const int a = band_i + r0 + D::ROW_STEP * c;
      const int b = band_j + r0 + D::ROW_STEP * c;
      rows_i[c] = a < m ? A + static_cast<int64_t>(flat[a]) * K + k_begin + klo
                        : A;
      rows_j[c] = b < m ? A + static_cast<int64_t>(flat[b]) * K + k_begin + klo
                        : A;
    }
  }
  const int slot0 = klo * D::LD + r0;
  auto issue = [&](int slot, int s) {
    T* st = ring + slot * D::STAGE;
    const int64_t off = static_cast<int64_t>(s) * STEPS;
    const int64_t left = k_end - k_begin - off;
    const int lim = left < STEPS ? static_cast<int>(left) : STEPS;
    if constexpr (GATHER) {
      issue_gathered<D>(st + slot0, rows_i, off, ok_i, lim, klo);
      if (!diag)
        issue_gathered<D>(st + STEPS * D::LD + slot0, rows_j, off, ok_j, lim,
                          klo);
    } else {
      issue_operand<D>(st + slot0, src_i + off, rs, ok_i, lim, klo);
      if (!diag)
        issue_operand<D>(st + STEPS * D::LD + slot0, src_j + off, rs, ok_j,
                         lim, klo);
    }
    if (with_r && tid < STEPS)
      cp_async_elem(st + 2 * STEPS * D::LD + tid, u + k_begin + off + tid,
                    tid < lim);
  };

  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;
  T racc[D::LANES];
#pragma unroll
  for (int p = 0; p < D::LANES; ++p) racc[p] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < slabs) issue(s, s);
    cp_async_commit();
  }
  int cur = 0, nxt = STAGES - 1;
  for (int q = 0; q < slabs; ++q) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of stage q
    __syncthreads();              // everyone's; stage q - 1 consumed
    if (q + STAGES - 1 < slabs) issue(nxt, q + STAGES - 1);
    cp_async_commit();

    const T* si = ring + cur * D::STAGE;
    const T* sj = diag ? si : si + STEPS * D::LD;
#pragma unroll
    for (int kk = 0; kk < STEPS; ++kk) {
      T a[TM], b[TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g)
        load4s(si + kk * D::LD + g * D::SEG_M + 4 * ty, a + 4 * g);
#pragma unroll
      for (int g = 0; g < TN / 4; ++g)
        load4s(sj + kk * D::LD + g * D::SEG_N + 4 * tx, b + 4 * g);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fma_rn(a[i], b[j], acc[i][j]);
    }
    if (with_r) {
      const T* us = si + 2 * STEPS * D::LD;
#pragma unroll
      for (int p = 0; p < D::LANES; ++p) {
        const int lane = tid + D::THREADS * p;
        if (lane < 2 * BM) {
          const int row = lane >> 1, part = lane & 1;
#pragma unroll
          for (int i = 0; i < STEPS / 2; ++i) {
            const int kk = 2 * i + part;
            racc[p] = fma_rn(si[kk * D::LD + row], us[kk], racc[p]);
          }
        }
      }
    }
    cur = cur + 1 == STAGES ? 0 : cur + 1;
    nxt = nxt + 1 == STAGES ? 0 : nxt + 1;
  }
  cp_async_wait<0>();

  // G: this thread's micro-tile, rows a = band_i + g SEG_M + 4 ty + i % 4.
  const bool direct = Gp == nullptr;
  T* Gs = direct ? G : Gp + static_cast<size_t>(split) * mp * mp;
  const int ld = direct ? m : mp;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int a = band_i + (i / 4) * D::SEG_M + 4 * ty + i % 4;
    if (a >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int b = band_j + (j / 4) * D::SEG_N + 4 * tx + j % 4;
      if (b >= m) continue;
      T v = acc[i][j];
      if (direct) {
        v = g_entry(add_rn(T(0), v), scale, reg, a == b);
        if (!diag) G[static_cast<size_t>(b) * m + a] = v;
      }
      Gs[static_cast<size_t>(a) * ld + b] = v;
    }
  }
  if (with_r) {
#pragma unroll
    for (int p = 0; p < D::LANES; ++p) {
      const int lane = tid + D::THREADS * p;
      const T odd = __shfl_down_sync(0xffffffffu, racc[p], 1, 2);
      const int a = band_i + (lane >> 1);
      if (lane < 2 * BM && (lane & 1) == 0 && a < m) {
        const T pair = residual_pair(racc[p], odd);
        if (direct) r[a] = mul_rn(scale_r, add_rn(T(0), pair));
        else rp[static_cast<size_t>(split) * mp + a] = pair;
      }
    }
  }
}

// Second pass at more than one chunk: packet_reduce's sums (split_sum's
// order, then scale, then reg on the diagonal; r = scale_r * its split sum)
// over the lower entries only, each written with its mirror, and the loads
// DEPTH deep in flight.  packet_reduce (K3's) sums every entry of the
// square with its loads 8 deep: about 1.5 times this pass's time over
// K1's 252 partials at m = 8 (PERF.md).
constexpr int REDUCE_THREADS = 128;

template <typename T, bool RESIDUAL>
__global__ void __launch_bounds__(REDUCE_THREADS)
dense_reduce(const T* __restrict__ Gp, const T* __restrict__ rp, int splits,
             int m, int mp, T scale, T reg, T scale_r, T* __restrict__ G,
             T* __restrict__ r) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t mm = static_cast<int64_t>(m) * m;
  if (e < mm) {
    const int a = static_cast<int>(e / m), b = static_cast<int>(e % m);
    if (b > a) return;
    const T g = g_entry(split_sum_deep(Gp + static_cast<size_t>(a) * mp + b,
                                       splits, static_cast<size_t>(mp) * mp),
                        scale, reg, a == b);
    G[static_cast<size_t>(a) * m + b] = g;
    if (a != b) G[static_cast<size_t>(b) * m + a] = g;
  } else if (RESIDUAL && e < mm + m) {
    const int a = static_cast<int>(e - mm);
    r[a] = mul_rn(scale_r, split_sum_deep(rp + a, splits,
                                          static_cast<size_t>(mp)));
  }
}

// Dynamic shared memory of a geometry, in bytes.
template <typename T, int BM, int TM, int TN, int STAGES, int STEPS>
constexpr int ring_bytes() {
  return STAGES * Tile<T, BM, TM, TN, STEPS>::STAGE *
         static_cast<int>(sizeof(T));
}

// Launch dense_tile at one geometry on `stream` and, at more than one
// split, dense_reduce after it.  `smem` is the host's count of the ring's
// bytes: a geometry whose count disagrees is refused with
// cudaErrorInvalidValue before anything is launched.
template <typename T, int BM, int TM, int TN, int STAGES, int STEPS,
          bool RESIDUAL, bool GATHER>
cudaError_t launch_tile(const T* A, const int* flat, const T* u,
                        const int* tiles, int ntiles, int m, int64_t K,
                        int64_t chunk, int splits, int smem, T scale, T reg,
                        T scale_r, T* Gp, T* rp, T* G, T* r,
                        cudaStream_t stream) {
  constexpr int bytes = ring_bytes<T, BM, TM, TN, STAGES, STEPS>();
  if (smem != bytes) return cudaErrorInvalidValue;  // host and kernel disagree
  auto kernel = dense_tile<T, BM, TM, TN, STAGES, STEPS, RESIDUAL, GATHER>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  const int mp = (m + TILE - 1) / TILE * TILE;
  kernel<<<dim3(ntiles, splits), Tile<T, BM, TM, TN, STEPS>::THREADS, bytes,
           stream>>>(A, u, tiles, m, K, chunk, mp, scale, reg, scale_r,
                     splits > 1 ? Gp : nullptr, rp, G, r, flat);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t total = static_cast<int64_t>(m) * m + (RESIDUAL ? m : 0);
  const int blocks =
      static_cast<int>((total + REDUCE_THREADS - 1) / REDUCE_THREADS);
  dense_reduce<T, RESIDUAL><<<blocks, REDUCE_THREADS, 0, stream>>>(
      Gp, rp, splits, m, mp, scale, reg, scale_r, G, r);
  return cudaGetLastError();
}

}  // namespace repro
