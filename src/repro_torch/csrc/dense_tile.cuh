// The register-blocked Gram tile kernel and its reduce pass: the packet of
// every layout.  The dense Gram kernels K7 / K8 (gram_dense.cu) read rows of
// a materialised operand A, the row-sampled packet K1 (sampled_rows.cu) the
// rows X[flat[a]] of X, and the column-sampled packet K3 (sampled_cols.cu)
// the columns X[:, flat[a]] of X, all in place.
//
// Packet contract (every layout): for Y (m, K) the panel,
//   G = scale * Y Y^T + reg * I   (m, m),   r = scale_r * Y u   (m,).
// Rows: Y = X[flat, :] (K = n); columns: Y = X[:, flat]^T (K = d), read from
// X's (d, n) layout with no transposed copy; dense: Y = A, no index.  The
// Gram alone (K8) is the packet with RESIDUAL = false: no u is read, no r
// written, and G is summed exactly as the packet's G.
//
// Summation order (what every packet, and the matvecs K5 / K6 for r, keep):
// the contraction is cut into chunks of `chunk` steps, fixed on the host
// from (m, K, layout) alone (tuning.py).  Per chunk, G[a, b]'s partial is
// one fma_rn chain from 0 over increasing k, and r[a]'s is
// residual_pair(even lane, odd lane), each lane one fma_rn chain from 0 over
// every other step of the chunk in increasing k.  Then G[a, b] = scale *
// split_sum of the partials in chunk order, plus reg on the diagonal, and
// r[a] = scale_r * its split sum, each step rounded on its own.  Blocks run
// in no order, so each (lower tile, chunk) block writes its own partials
// and a second pass sums them: no float atomics, the same bits every run.
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
// * Where a row lies (SRC).  Only a panel row's base address and its step
//   stride differ: band + r of A (DENSE), or row flat[band + r] of X
//   (ROWS), both with steps 1 apart; or column flat[band + r] of X (COLS),
//   its steps a row of X (n elements) apart.  A gathering thread reads the
//   indices of its copied rows once and keeps each row's 64-bit base in a
//   register.  The row gather then copies exactly as the dense kernel
//   does.  A sampled column has no two elements in one sector, so its
//   copies read no runs: there each thread copies one panel row, a warp 32
//   rows at one step (32 elements of one row of X; issue_columns).
//   Duplicate indices need nothing special.
// * Micro-tiles of 2 x 2 (TM = TN = 2, groups of 2 rows SEG apart, 8-byte
//   shared loads) serve the column gather's 16-tile at small m, where a
//   thread's instructions a step bound the block.
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
// bf16 input (K7, K1 and K3 with bf16 A / X and u; f32 sums and outputs)
// runs mma_tile, on the tensor cores (the second half of this file), at
// its own geometry and chunk; dense_reduce sums its chunks.
//
// The chunk is the host's pick for (m, K) in the packet's layout, so K1(X,
// flat, u) equals K7(X[flat], u), K3(X, flat, u) equals K7(X[:, flat]^T, u)
// at K3's chunk, K8(A) equals K7(A, u)'s G and G equals G^T, bit for bit;
// the geometry (BM, micro-tile, ring, tile order) never moves a sum.  Every
// offset into the operand is 64-bit (A has 1.95e9 elements at real-sim).
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "gram_common.cuh"

namespace repro {

// Where the rows of the panel lie (see the head of this file).
enum class Source { DENSE, ROWS, COLS };

template <typename T, int BM, int TM, int TN, int STEPS>
struct Tile {
  static constexpr int NTY = BM / TM;  // threads along the tile's rows
  static constexpr int NTX = BM / TN;  // ... along its columns
  static constexpr int THREADS = NTY * NTX;
  static constexpr int GM = TM < 4 ? TM : 4;  // rows of a thread's row group
  static constexpr int GN = TN < 4 ? TN : 4;
  static constexpr int SEG_M = GM * NTY;  // rows between a thread's row groups
  static constexpr int SEG_N = GN * NTX;
  static constexpr int LD = BM + 16 / static_cast<int>(sizeof(T));
  // a stage: operand i [STEPS][LD], operand j [STEPS][LD], u [STEPS]
  static constexpr int STAGE = 2 * STEPS * LD + STEPS;
  static constexpr int ROW_STEP = THREADS / 8;  // rows apart per copy
  static constexpr int ROW_COPIES = BM / ROW_STEP;
  static constexpr int COPIES = BM * STEPS / THREADS;  // per operand, thread
  static constexpr int LANES = (2 * BM + THREADS - 1) / THREADS;  // r lanes
  // The column gather: a thread copies panel row tid % BM at steps
  // tid / BM + CSTEP q, q < COPIES (per operand and stage).
  static constexpr int CSTEP = THREADS / BM;
  static_assert(THREADS % BM == 0);
  static_assert((GM == 2 || GM == 4) && (GN == 2 || GN == 4));
  static_assert(TM % GM == 0 && TN % GN == 0 && BM % TM == 0 && BM % TN == 0);
  static_assert(THREADS % 32 == 0 && BM % ROW_STEP == 0 && STEPS % 8 == 0);
  static_assert(COPIES % ROW_COPIES == 0);
  static_assert(STEPS <= THREADS);  // one thread copies each step of u
};

template <typename T>
__device__ __forceinline__ void load2s(const T* p, T* o) {
  if constexpr (sizeof(T) == 4) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x; o[1] = v.y;
  } else {
    const double2 v = *reinterpret_cast<const double2*>(p);
    o[0] = v.x; o[1] = v.y;
  }
}

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
// the packet's order (a multiply, then an add on the diagonal: never
// contracted into one fused multiply-add).
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

// The aligned 4-byte word that holds the bf16 element at p: the column
// gather of bf16 input moves it whole (cp.async moves 4, 8 or 16 bytes),
// and the fragment build keeps the element's half.  An aligned word never
// crosses a page, so the neighbour's half is mapped wherever the element is.
__device__ __forceinline__ const float* word_of(const __nv_bfloat16* p) {
  return reinterpret_cast<const float*>(reinterpret_cast<uintptr_t>(p) &
                                        ~static_cast<uintptr_t>(3));
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

// The column gather's copies of one stage of one operand (a sampled column
// has no two elements in one sector, so no copy pattern reads runs): this
// thread's COPIES elements of panel row tid % BM, steps tid / BM + CSTEP q
// of the stage, so that a warp copies 32 panel rows at one step (the
// 16-tile: 16 rows at each of two), i.e. elements of one row of X, and
// writes consecutive shared words.  `dst`
// is the thread's first slot, `src` its first element, `step` CSTEP steps
// in elements of X, `ok` whether its panel row lies inside m, `k0` its
// first step.
template <typename D, typename T>
__device__ __forceinline__ void issue_columns(T* dst, const T* src,
                                              int64_t step, bool ok, int lim,
                                              int k0) {
#pragma unroll
  for (int q = 0; q < D::COPIES; ++q)
    cp_async_elem(dst + q * D::CSTEP * D::LD, src + q * step,
                  ok && k0 + q * D::CSTEP < lim);
}

// One block: lower tile tiles[blockIdx.x] = (ti << 16 | tj) of G over
// contraction chunk blockIdx.y.  Row a of the panel is row a of A (DENSE),
// row flat[a] of A (ROWS: A is X, K its row length), or column flat[a] of A
// (COLS: A is X (K, ldx)); flat is read only by the gathers, ldx only by
// COLS.  At one chunk (Gp null) the block writes G (and r) itself; else its
// partials Gp[split] (mp x mp, lower tiles only) and rp[split] for
// dense_reduce.  In is T in every build (bf16 input runs mma_tile); the
// parameter keeps the kernels' names.
template <typename T, int BM, int TM, int TN, int STAGES, int STEPS,
          bool RESIDUAL, Source SRC, typename In = T>
__global__ void __launch_bounds__(Tile<T, BM, TM, TN, STEPS>::THREADS,
                                  512 / Tile<T, BM, TM, TN, STEPS>::THREADS)
dense_tile(const In* __restrict__ A, const In* __restrict__ u,
           const int* __restrict__ tiles, int m, int64_t K, int64_t chunk,
           int mp, T scale, T reg, T scale_r, T* __restrict__ Gp,
           T* __restrict__ rp, T* __restrict__ G, T* __restrict__ r,
           const int* __restrict__ flat, int64_t ldx) {
  using D = Tile<T, BM, TM, TN, STEPS>;
  static_assert(std::is_same_v<T, In>);
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
  const In* src_i = A + static_cast<int64_t>(band_i + r0) * K + k_begin + klo;
  const In* src_j = A + static_cast<int64_t>(band_j + r0) * K + k_begin + klo;
  unsigned ok_i = 0, ok_j = 0;
#pragma unroll
  for (int c = 0; c < D::ROW_COPIES; ++c) {
    ok_i |= static_cast<unsigned>(band_i + r0 + D::ROW_STEP * c < m) << c;
    ok_j |= static_cast<unsigned>(band_j + r0 + D::ROW_STEP * c < m) << c;
  }
  // Gathered rows: the same element of row flat[band + r0 + ROW_STEP c]
  // (A itself for a row past m: its copies read nothing).
  const In* rows_i[D::ROW_COPIES];
  const In* rows_j[D::ROW_COPIES];
  if constexpr (SRC == Source::ROWS) {
#pragma unroll
    for (int c = 0; c < D::ROW_COPIES; ++c) {
      const int a = band_i + r0 + D::ROW_STEP * c;
      const int b = band_j + r0 + D::ROW_STEP * c;
      rows_i[c] = a < m ? A + static_cast<int64_t>(flat[a]) * K + k_begin + klo
                        : A;
      rows_j[c] = b < m ? A + static_cast<int64_t>(flat[b]) * K + k_begin + klo
                        : A;
    }
  } else if constexpr (SRC == Source::COLS) {
    // Gathered columns: element (a, k) is A[k * ldx + flat[a]]; this thread
    // copies panel row tid % BM from step tid / BM on (issue_columns).
    const int a = band_i + tid % BM, b = band_j + tid % BM;
    const int64_t k0 = (k_begin + tid / BM) * ldx;
    ok_i = a < m;
    ok_j = b < m;
    rows_i[0] = ok_i ? A + k0 + flat[a] : A;
    rows_j[0] = ok_j ? A + k0 + flat[b] : A;
  }
  const int slot0 = klo * D::LD + r0;
  auto limit = [&](int64_t off) {
    const int64_t left = k_end - k_begin - off;
    return left < STEPS ? static_cast<int>(left) : STEPS;
  };
  auto issue = [&](int slot, int s) {
    T* st = ring + slot * D::STAGE;
    const int64_t off = static_cast<int64_t>(s) * STEPS;
    const int lim = limit(off);
    if constexpr (SRC == Source::ROWS) {
      issue_gathered<D>(st + slot0, rows_i, off, ok_i, lim, klo);
      if (!diag)
        issue_gathered<D>(st + STEPS * D::LD + slot0, rows_j, off, ok_j, lim,
                          klo);
    } else if constexpr (SRC == Source::COLS) {
      const int cslot = (tid / BM) * D::LD + tid % BM;
      issue_columns<D>(st + cslot, rows_i[0] + off * ldx, D::CSTEP * ldx,
                       ok_i, lim, tid / BM);
      if (!diag)
        issue_columns<D>(st + STEPS * D::LD + cslot, rows_j[0] + off * ldx,
                         D::CSTEP * ldx, ok_j, lim, tid / BM);
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
      for (int g = 0; g < TM / D::GM; ++g) {
        if constexpr (D::GM == 4)
          load4s(si + kk * D::LD + g * D::SEG_M + 4 * ty, a + 4 * g);
        else
          load2s(si + kk * D::LD + g * D::SEG_M + 2 * ty, a + 2 * g);
      }
#pragma unroll
      for (int g = 0; g < TN / D::GN; ++g) {
        if constexpr (D::GN == 4)
          load4s(sj + kk * D::LD + g * D::SEG_N + 4 * tx, b + 4 * g);
        else
          load2s(sj + kk * D::LD + g * D::SEG_N + 2 * tx, b + 2 * g);
      }
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

  // G: this thread's micro-tile, rows a = band_i + g SEG_M + GM ty + i % GM.
  const bool direct = Gp == nullptr;
  T* Gs = direct ? G : Gp + static_cast<size_t>(split) * mp * mp;
  const int ld = direct ? m : mp;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int a = band_i + (i / D::GM) * D::SEG_M + D::GM * ty + i % D::GM;
    if (a >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int b = band_j + (j / D::GN) * D::SEG_N + D::GN * tx + j % D::GN;
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

// Second pass at more than one chunk: the packet's sums (split_sum's order,
// then scale, then reg on the diagonal; r = scale_r * its split sum) over
// the lower entries only, each written with its mirror, and the loads DEPTH
// deep in flight.
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
// cudaErrorInvalidValue before anything is launched.  `ldx` is X's row
// length for the column gather (unused otherwise).
template <typename T, int BM, int TM, int TN, int STAGES, int STEPS,
          bool RESIDUAL, Source SRC>
cudaError_t launch_tile(const T* A, const int* flat, const T* u,
                        const int* tiles, int ntiles, int m, int64_t K,
                        int64_t chunk, int splits, int smem, T scale, T reg,
                        T scale_r, T* Gp, T* rp, T* G, T* r,
                        cudaStream_t stream, int64_t ldx = 0) {
  constexpr int bytes = ring_bytes<T, BM, TM, TN, STAGES, STEPS>();
  if (smem != bytes) return cudaErrorInvalidValue;  // host and kernel disagree
  auto kernel = dense_tile<T, BM, TM, TN, STAGES, STEPS, RESIDUAL, SRC, T>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  const int mp = (m + TILE - 1) / TILE * TILE;
  kernel<<<dim3(ntiles, splits), Tile<T, BM, TM, TN, STEPS>::THREADS, bytes,
           stream>>>(A, u, tiles, m, K, chunk, mp, scale, reg, scale_r,
                     splits > 1 ? Gp : nullptr, rp, G, r, flat, ldx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t total = static_cast<int64_t>(m) * m + (RESIDUAL ? m : 0);
  const int blocks =
      static_cast<int>((total + REDUCE_THREADS - 1) / REDUCE_THREADS);
  dense_reduce<T, RESIDUAL><<<blocks, REDUCE_THREADS, 0, stream>>>(
      Gp, rp, splits, m, mp, scale, reg, scale_r, G, r);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 input on the tensor cores: mma_tile (K7, K1 and K3 with bf16 A / X
// and u; f32 sums and outputs), its chunks summed by dense_reduce.
//
// What it replaces.  The TPU kernels' bf16 packet is dot_general(bf16,
// bf16, preferred_element_type=f32) on the matrix unit (src/repro/kernels/
// gram/sampled_kernel.py, gram_kernel.py, sampled_colmajor.py); here the
// same product runs on the tensor cores, mma.sync m16n8k16 bf16 x bf16 +
// f32.  The design it replaces widened each element to f32 in shared memory
// and summed on the CUDA cores (f32 FMAs: 18 us of operations at m = 128
// before any stall).
//
// What bounds it.  At the solve's m = 128 the packet's operations take
// about 1.2 us at 989 TFLOP/s and its bytes (the sampled rows once, u, G)
// about 5 us at 3.35 TB/s: mma.sync, at about half wgmma's rate, leaves
// the function bound by its reads, and wgmma (its operands in shared memory
// in its own layout) buys nothing.  What bounds this kernel on the H100 is
// one warp a scheduler building fragments (shared loads and byte permutes,
// their latency exposed) beside the reads of rows of X scattered over 3 GB;
// for K3 the rate at which the memory serves isolated elements, each its
// own DRAM access: the f32 kernel's limit too (PERF.md).
//
// Tiles.  A block owns one lower BM x BM tile of G over one contraction
// chunk: BM = 128 for m > 16, so that at m <= 128 one tile holds G and each
// sampled element is read once (a 32-tile reads each row band from 4
// tiles), and BM = 16 up to m = 16 (at m = 8 rows 8-15 of the m16 fragment
// are zero).  Four warps share a 128-tile's lower triangle: on the
// diagonal tile warps 0 / 1 the lower halves of the two 64 x 64 diagonal
// blocks (every B fragment one of the warp's own A fragments), warps 2 / 3
// the two 64 x 32 halves of the block below them, at most 24 products of
// 16 x 8 x 16 each a 16-step slice; below the diagonal (m > 128, TWO) each
// warp one 64 x 64 quarter.  Each warp runs the block's ring loop with
// accumulators of exactly its share's shape (warp_share; every warp copies
// and meets every barrier), and its slices are straight-line code: rows
// past m are zero in the stage and their products never written, so no
// branch splits the loads from the products they feed.  G is written from
// the lower entries and mirrored: G == G^T whatever mma does with D[a, b]
// against D[b, a].
//
// r = scale_r Y u rides on the tensor cores too: u is column 0 of one more
// 16 x 8 B fragment (the other columns zero) against the warp's A
// fragments, one product a row block a slice, kept where the share starts
// at the tile's column 0.  Its two f32 CUDA-core lanes a row (the f32
// kernel's order) would read every element once more from shared memory,
// as 2-byte loads, in a kernel whose time is its fragment build.  So a bf16
// r is not the f32 kernel's r on the upcast operand; it is the same in K1,
// K7 and K3 (one code path) and within the f32 gate of the f64 plain
// version.
//
// The chunk.  The bf16 chunk is its own pick (tuning.default_chunk with the
// dtype): at the 128-tile about one block a SM for the rows, a third of the
// SMs for the columns (fewer isolated reads in flight read faster); two
// blocks a SM at the rows' 16-tile.  The f32 pick at m = 128 would give K3 13
// blocks of the 128-tile; K5 / K6, which share the f32 chunk to equal K3 /
// K1's r, have no bf16 build.  dense_reduce sums the chunks, as in f32.
//
// The sum order, fixed by (m, K, chunk) alone and the same for every row
// source: per chunk each G entry is one chain of mma products over the
// chunk's 16-step slices in increasing k from +0 (steps past the chunk
// zero-filled); within a slice, thread t's fragments hold steps 4t .. 4t+3
// (slots 2t, 2t+1 and 2t+8, 2t+9 of the m16n8k16 layout), in A and B alike;
// then dense_reduce's order.  So K1(X, flat, u) == K7(X[flat], u), K3(X,
// flat, u) == K7(X[:, flat]^T, u) at K3's chunk, and two runs give the same
// bits.
//
// Rows (K1, K7): X's row stride at real-sim is 72309 x 2 bytes, not a
// multiple of 16, so TMA cannot describe X and a row's chunk starts 2-byte
// aligned.  Each panel row's span of a stage moves as 16-byte cp.async.cg
// chunks from its 16-byte floor (STEPS / 8 + 1 chunks, consecutive threads
// on consecutive chunks of a row, STAGES - 1 stages in flight), the row's
// first step `off` elements into its shared row.  The fragment build
// realigns: a thread's 4 steps of a row are 8 bytes at element off + 4t +
// 16 ks, read as three 32-bit shared loads and two byte permutes (prmt;
// identity permutes when off is even): no shift pass and no barrier of its
// own, at 1.5x the shared-memory wavefronts of ldmatrix on aligned rows.
//
// Columns (K3): a sampled element has no neighbour in its sector, so each
// element's aligned 4-byte word moves by its own cp.async (word_of, through
// L1: the launch asks for no more shared memory than a block needs), into a
// word slot of its panel row; a warp copies 8 panel rows x 4 steps, and the
// slot of step k of row p is word k ^ swz(p) (16-byte groups permuted by
// p's low 3 bits), so those copies and the fragment build's 16-byte loads
// both hit 32 distinct banks.  The fragment build keeps each element's half
// by the parity of its address (flat[a] for even steps, flat[a] + ldx for
// odd ones: one prmt a pair), with no widening pass and no barrier.
//
// u rides with every stage as its own raw row (16-byte chunks, realigned
// like a panel row) in all three sources.  Panel rows past m are never
// copied: their shared rows are zeroed once.

constexpr int MMA_THREADS = 128;  // four warps
constexpr int SMEM_CARVEOUT_MAX = 228 * 1024;  // an SM's largest carve-out

// D += A B for one m16n8k16 bf16 product with f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BM, int STEPS, Source SRC>
struct MmaTile {
  static constexpr int EDGE = BM, SLICES = STEPS / 16;
  static constexpr bool WORDS = SRC == Source::COLS;  // word slots, else raw
  static constexpr int CH = STEPS / 8 + 1;    // 16-byte chunks of a raw row
  static constexpr int LDW = WORDS ? STEPS : 4 * CH;  // words a panel row
  // A stage: operand i's BM panel rows, operand j's BM when the launch has
  // tiles below the diagonal (`two`), then u's raw row.
  __host__ __device__ static constexpr int u_at(bool two) {
    return (two ? 2 : 1) * BM * LDW;
  }
  __host__ __device__ static constexpr int stage(bool two) {
    return u_at(two) + 4 * CH;
  }
  static constexpr int INFO = (2 * BM + 1 + 3) / 4 * 4;  // ints, then
  // each raw row's 16-byte aligned source (u's at 2 BM), then the ring
  static constexpr int PTRS = 2 * BM + 2;
  // the column copies: units of 8 rows x 4 steps, UNITS a warp a stage, and
  // NPTR panel rows a thread (row groups warp + 4 j, or warp % RG)
  static constexpr int RG = BM / 8, KG = STEPS / 4;
  static constexpr int UNITS = RG * KG / 4;
  static constexpr int NPTR = RG >= 4 ? RG / 4 : 1;
  static_assert(BM == 16 || BM == 128);
  static_assert(STEPS % 32 == 0);  // 16-step slices; swz stays in 32 words
  static_assert(RG >= 4 ? RG % 4 == 0 : 4 % RG == 0);
};

// The word slot of step k of panel row p (COLS): 16-byte groups permuted by
// the row's low 3 bits, so that 8 consecutive rows at one group of 4 steps,
// and 2 rows x 16 steps, each fall on 32 distinct banks.
__device__ __forceinline__ int swz(int p) {
  return ((p & 1) << 4) | (((p >> 1) & 3) << 2);
}

// A thread's 4 steps of a raw row (bf16 pairs, the row's first step `off`
// elements in): element e = off + kw and the three words around it, two
// byte permutes (identity when e is even).  lo = steps (kw, kw + 1), hi =
// steps (kw + 2, kw + 3), as two packed bf16 pairs.
__device__ __forceinline__ void window_raw(const uint32_t* row, int e,
                                           uint32_t& lo, uint32_t& hi) {
  const uint32_t* w = row + (e >> 1);
  const uint32_t sel = (e & 1) ? 0x5432u : 0x3210u;
  const uint32_t w0 = w[0], w1 = w[1], w2 = w[2];
  lo = __byte_perm(w0, w1, sel);
  hi = __byte_perm(w1, w2, sel);
}

// The same from a row of word slots (COLS): steps kw .. kw + 3 are one
// 16-byte group; `par` holds the half of an even step's element (bit 0) and
// of an odd step's (bit 1).
__device__ __forceinline__ void window_words(const uint32_t* row, int kw,
                                             int sw, int par, uint32_t& lo,
                                             uint32_t& hi) {
  const uint4 v = *reinterpret_cast<const uint4*>(row + (kw ^ sw));
  const uint32_t sel = 0x5410u + ((par & 1) ? 0x22u : 0u) +
                       ((par & 2) ? 0x2200u : 0u);
  lo = __byte_perm(v.x, v.y, sel);
  hi = __byte_perm(v.z, v.w, sel);
}

// One warp's products over one stage `st`: panel rows r0 .. r0 + 16 NRB
// of operand i against rows c0 .. c0 + 8 NCB of operand j (panel rows from
// `jrow`: 0 on the diagonal tile, where j is i, else BM), only the 16 x 8
// blocks that touch the lower triangle when LOWER (then c0 == r0 and each B
// fragment is one of the warp's own A fragments), and u (the stage's raw
// row su) as column 0 of one more product into racc, zero unless `with_u`;
// info[p] is panel row p's offset (raw rows) or halves (word slots),
// info[2 BM] u's offset.  No branch inside: rows past m are zero in the
// stage, their products are summed and never written, so the slices' loads
// and products form one block of straight-line code that ptxas schedules
// as a whole (one warp a scheduler hides no latency of its own).
template <typename D, int NRB, int NCB, bool LOWER>
__device__ __forceinline__ void stage_mma(
    const uint32_t* st, const uint32_t* su, const int* info, int jrow,
    int r0, int c0, bool with_u, float (&acc)[NRB][NCB][4],
    float (&racc)[NRB][4]) {
  static_assert(!LOWER || NCB == 2 * NRB);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int sw = swz(g);  // every row this thread reads is g modulo 8
  int ia[NRB][2], ib[NCB];
#pragma unroll
  for (int R = 0; R < NRB; ++R)
#pragma unroll
    for (int h = 0; h < 2; ++h) ia[R][h] = info[r0 + 16 * R + 8 * h + g];
#pragma unroll
  for (int C = 0; C < NCB; ++C)
    ib[C] = LOWER ? 0 : info[jrow + c0 + 8 * C + g];
  const int iu = info[2 * D::EDGE];
  const uint32_t umask = with_u && g == 0 ? ~0u : 0u;  // u is column 0
  auto window = [&](const uint32_t* base, int row, int in, int kw,
                    uint32_t& lo, uint32_t& hi) {
    if constexpr (D::WORDS)
      window_words(base + row * D::LDW, kw, sw, in, lo, hi);
    else
      window_raw(base + row * D::LDW, in + kw, lo, hi);
  };
#pragma unroll
  for (int ks = 0; ks < D::SLICES; ++ks) {
    const int kw = 16 * ks + 4 * t;
    uint32_t a[NRB][4];
#pragma unroll
    for (int R = 0; R < NRB; ++R)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        window(st, r0 + 16 * R + 8 * h + g, ia[R][h], kw, a[R][h],
               a[R][2 + h]);
    uint32_t lo, hi;
    window_raw(su, iu + kw, lo, hi);
#pragma unroll
    for (int R = 0; R < NRB; ++R)
      mma_bf16(racc[R], a[R], lo & umask, hi & umask);
#pragma unroll
    for (int C = 0; C < NCB; ++C) {
      uint32_t b0, b1;
      if constexpr (LOWER) {
        b0 = a[C / 2][C % 2];
        b1 = a[C / 2][2 + C % 2];
      } else {
        window(st, jrow + c0 + 8 * C + g, ib[C], kw, b0, b1);
      }
#pragma unroll
      for (int R = 0; R < NRB; ++R)
        if (!LOWER || C <= 2 * R + 1)  // compile-time: the lower blocks
          mma_bf16(acc[R][C], a[R], b0, b1);
    }
  }
}

// What a warp's share of the tile needs besides its shape: the ring and the
// rows' info, the stage size and u's place in it, the slabs of the chunk,
// the share's first row r0 and column c0 and operand j's first panel row,
// the tile's valid rows (ni, nj) and bands, and the outputs.
struct MmaShare {
  const uint32_t* ring;
  const int* info;
  int stage, u, slabs, r0, c0, jrow, ni, nj, band_i, band_j, split, m, mp;
  bool diag, with_u;
  float scale, reg, scale_r;
  float* Gp;
  float* rp;
  float* G;
  float* r;
};

// One warp's share through the whole chunk: the block's ring (every warp
// copies and meets every barrier), this warp's products on each stage into
// accumulators of exactly its shape (NRB row blocks x NCB column blocks; 0
// for a warp without products), then its entries of G (the lower ones on
// the diagonal tile, mirrored) and, with u, of r.
template <typename D, int STAGES, int NRB, int NCB, bool LOWER,
          typename Issue>
__device__ __forceinline__ void warp_share(const MmaShare& x, Issue& issue) {
  constexpr int NR = NRB > 0 ? NRB : 1, NC = NCB > 0 ? NCB : 1;
  float acc[NR][NC][4] = {}, racc[NR][4] = {};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < x.slabs) issue(s, s);
    cp_async_commit();
  }
  int cur = 0, nxt = STAGES - 1;
  for (int q = 0; q < x.slabs; ++q) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of stage q
    __syncthreads();              // everyone's; stage q - 1 consumed
    if (q + STAGES - 1 < x.slabs) issue(nxt, q + STAGES - 1);
    cp_async_commit();
    if constexpr (NRB > 0) {
      const uint32_t* st = x.ring + cur * x.stage;
      stage_mma<D, NR, NC, LOWER>(st, st + x.u, x.info, x.jrow, x.r0, x.c0,
                                  x.with_u, acc, racc);
    }
    cur = cur + 1 == STAGES ? 0 : cur + 1;
    nxt = nxt + 1 == STAGES ? 0 : nxt + 1;
  }
  cp_async_wait<0>();
  if constexpr (NRB > 0) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const bool direct = x.Gp == nullptr;
    float* Gs = direct ? x.G : x.Gp + static_cast<size_t>(x.split) * x.mp *
                                          x.mp;
    const int ld = direct ? x.m : x.mp;
#pragma unroll
    for (int R = 0; R < NRB; ++R)
#pragma unroll
      for (int C = 0; C < NCB; ++C) {
        if (LOWER && C > 2 * R + 1) continue;  // never summed
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ar = x.r0 + 16 * R + g + 8 * (e >> 1);
          const int bc = x.c0 + 8 * C + 2 * t + (e & 1);
          if (ar >= x.ni || bc >= x.nj || (x.diag && bc > ar)) continue;
          const int a = x.band_i + ar, b = x.band_j + bc;
          float v = acc[R][C][e];
          if (direct) {
            v = g_entry(add_rn(0.f, v), x.scale, x.reg, a == b);
            if (a != b) x.G[static_cast<size_t>(b) * x.m + a] = v;
          }
          Gs[static_cast<size_t>(a) * ld + b] = v;
        }
      }
    if (x.with_u && t == 0) {
#pragma unroll
      for (int R = 0; R < NRB; ++R)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ar = x.r0 + 16 * R + g + 8 * h;
          if (ar >= x.ni) continue;
          const int a = x.band_i + ar;
          const float v = racc[R][2 * h];
          if (direct) x.r[a] = mul_rn(x.scale_r, add_rn(0.f, v));
          else x.rp[static_cast<size_t>(x.split) * x.mp + a] = v;
        }
    }
  }
}

// One block of the bf16 packet: lower tile tiles[blockIdx.x] of G over
// contraction chunk blockIdx.y, with dense_tile's arguments (A, u bf16; the
// sums and outputs f32).  TWO: the launch has tiles below the diagonal
// (m > BM), whose operand j has rows of its own.
template <int BM, int STAGES, int STEPS, Source SRC, bool TWO>
__global__ void __launch_bounds__(MMA_THREADS)
mma_tile(const __nv_bfloat16* __restrict__ A,
         const __nv_bfloat16* __restrict__ u, const int* __restrict__ tiles,
         int m, int64_t K, int64_t chunk, int mp, float scale, float reg,
         float scale_r, float* __restrict__ Gp, float* __restrict__ rp,
         float* __restrict__ G, float* __restrict__ r,
         const int* __restrict__ flat, int64_t ldx) {
  using D = MmaTile<BM, STEPS, SRC>;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  int* info = reinterpret_cast<int*>(mma_smem);
  const bf16** srcs = reinterpret_cast<const bf16**>(mma_smem + 4 * D::INFO);
  uint32_t* ring =
      reinterpret_cast<uint32_t*>(mma_smem + 4 * D::INFO + 8 * D::PTRS);

  const int packed = tiles[blockIdx.x];
  const int ti = packed >> 16, tj = packed & 0xffff;
  const int band_i = ti * BM, band_j = tj * BM;
  const bool diag = ti == tj;
  const bool with_r = tj == 0;  // r rides on one tile per band
  const int split = blockIdx.y;
  const int64_t k_begin = static_cast<int64_t>(split) * chunk;
  const int64_t k_end = min(K, k_begin + chunk);
  const int slabs = static_cast<int>((k_end - k_begin + STEPS - 1) / STEPS);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ni = min(BM, m - band_i), nj = min(BM, m - band_j);
  constexpr int U = D::u_at(TWO), STAGE = D::stage(TWO);

  // Panel row p: operand i's rows 0 .. BM - 1, then operand j's.  Its first
  // element at k_begin (raw rows), or its element at step 0 (COLS).
  auto row_ok = [&](int p) {
    return p < BM ? p < ni : (!diag && p - BM < nj);
  };
  auto row_ptr = [&](int p) -> const bf16* {
    const int a = (p < BM ? band_i : band_j - BM) + p;
    if constexpr (SRC == Source::DENSE)
      return A + static_cast<int64_t>(a) * K + k_begin;
    else if constexpr (SRC == Source::ROWS)
      return A + static_cast<int64_t>(flat[a]) * K + k_begin;
    else
      return A + flat[a];
  };
  for (int p = tid; p <= 2 * BM; p += MMA_THREADS) {
    int v = 0;
    const bf16* q = p == 2 * BM ? u + k_begin : row_ok(p) ? row_ptr(p) : A;
    if (p == 2 * BM || !D::WORDS) {
      v = misalign(q);
      srcs[p] = q - v;  // the aligned floor
    } else {
      const int even = static_cast<int>(
          (reinterpret_cast<uintptr_t>(q) >> 1) & 1);
      v = even | ((even ^ static_cast<int>(ldx & 1)) << 1);
    }
    info[p] = v;
  }
  // Rows past m (and j's rows on the diagonal tile) are never copied: zero
  // them once in every stage.
  for (int p = warp; p < (TWO ? 2 : 1) * BM; p += MMA_THREADS / 32) {
    if (row_ok(p) || (diag && p >= BM)) continue;
    for (int s = 0; s < STAGES; ++s)
      for (int w = lane; w < D::LDW; w += 32)
        ring[s * STAGE + p * D::LDW + w] = 0u;
  }

  __syncthreads();  // info and srcs, before the first copies read them

  // The copies.  Raw rows (and u): chunk c of a row's span of a stage from
  // its aligned floor, consecutive threads on consecutive chunks of a row;
  // elements at or past k_end zero-filled, a chunk wholly past the stage
  // skipped.
  const int off_u = info[2 * BM];
  auto issue_raw = [&](uint32_t* dst, const bf16* src, int off, int64_t o,
                       int64_t left0, int c) {
    if (off == 0 && c == D::CH - 1) return;  // past the stage: not read
    const int64_t left = left0 - (8 * c - off);
    const int n = left <= 0 ? 0 : left < 8 ? static_cast<int>(left) : 8;
    cp_async16(dst + 4 * c,
               n ? static_cast<const void*>(src + o + 8 * c)
                 : static_cast<const void*>(src),
               2 * n);
  };
  // Word slots (COLS): units of 8 rows x 4 steps; this thread's rows
  // 8 (warp + 4 j) + lane % 8 (or 8 (warp % RG) + lane % 8) and steps
  // 4 kg + lane / 8.
  const bf16* col_i[D::NPTR];
  const bf16* col_j[D::NPTR];
  bool ok_ci[D::NPTR], ok_cj[D::NPTR];
  auto unit_row = [&](int j) {
    return 8 * (D::RG >= 4 ? warp + 4 * j : warp % D::RG) + (lane & 7);
  };
  if constexpr (D::WORDS) {
#pragma unroll
    for (int j = 0; j < D::NPTR; ++j) {
      const int p = unit_row(j);
      ok_ci[j] = row_ok(p);
      ok_cj[j] = row_ok(BM + p);
      col_i[j] = ok_ci[j] ? row_ptr(p) : A;
      col_j[j] = ok_cj[j] ? row_ptr(BM + p) : A;
    }
  }
  auto issue = [&](int slot, int s) {
    uint32_t* st = ring + slot * STAGE;
    const int64_t o = static_cast<int64_t>(s) * STEPS;
    const int64_t left0 = k_end - k_begin - o;  // chunk steps from this stage
    if constexpr (D::WORDS) {
      const int lim = left0 < STEPS ? static_cast<int>(left0) : STEPS;
#pragma unroll
      for (int q = 0; q < D::UNITS; ++q) {
        const int j = D::RG >= 4 ? q % D::NPTR : 0;
        const int kg = D::RG >= 4 ? q / D::NPTR
                                  : warp / D::RG + (4 / D::RG) * q;
        const int p = unit_row(j), k = 4 * kg + (lane >> 3);
        const int64_t at = (k_begin + o + k) * ldx;
        const bool in = k < lim;
        cp_async_elem(reinterpret_cast<float*>(st + p * D::LDW + (k ^ swz(p))),
                      word_of(in && ok_ci[j] ? col_i[j] + at : col_i[j]),
                      in && ok_ci[j]);
        if (!diag)
          cp_async_elem(
              reinterpret_cast<float*>(st + (BM + p) * D::LDW + (k ^ swz(p))),
              word_of(in && ok_cj[j] ? col_j[j] + at : col_j[j]),
              in && ok_cj[j]);
      }
    } else {
      const int rows = (TWO ? 2 : 1) * BM;
      for (int e = tid; e < rows * D::CH; e += MMA_THREADS) {
        const int p = e / D::CH, c = e - p * D::CH;
        if (row_ok(p))
          issue_raw(st + p * D::LDW, srcs[p], info[p], o, left0, c);
      }
    }
    if (with_r && tid < D::CH)
      issue_raw(st + U, srcs[2 * BM], off_u, o, left0, tid);
  };

  // This warp's share of the tile (the note above): rows r0 + [0, 64) (16
  // at BM = 16) against columns c0 + [0, 8 NCB).
  int r0 = 0, c0 = 0;
  if constexpr (BM == 128) {
    if (diag) {
      r0 = warp == 0 ? 0 : 64;
      c0 = warp < 2 ? r0 : 32 * (warp - 2);
    } else {
      r0 = warp == 0 || warp == 3 ? 0 : 64;
      c0 = warp == 0 || warp == 2 ? 0 : 64;
    }
  }
  const MmaShare x{ring, info, STAGE, U, slabs, r0, c0, diag ? 0 : BM, ni,
                   nj, band_i, band_j, split, m, mp, diag,
                   with_r && c0 == 0, scale, reg, scale_r, Gp, rp, G, r};
  if constexpr (BM == 16) {  // m <= 16: one tile, warp 0's products
    if (warp == 0)
      warp_share<D, STAGES, 1, 2, true>(x, issue);
    else
      warp_share<D, STAGES, 0, 0, true>(x, issue);
  } else if (diag && warp < 2) {
    warp_share<D, STAGES, 4, 8, true>(x, issue);
  } else if (diag) {
    warp_share<D, STAGES, 4, 4, false>(x, issue);
  } else if constexpr (TWO) {
    warp_share<D, STAGES, 4, 8, false>(x, issue);
  }
}

// Its shared memory, in bytes, with or without operand j's rows (`two`).
template <int BM, int STAGES, int STEPS, Source SRC>
constexpr int mma_bytes(bool two) {
  using D = MmaTile<BM, STEPS, SRC>;
  return 4 * D::INFO + 8 * D::PTRS + 4 * STAGES * D::stage(two);
}

// Launch mma_tile at one geometry on `stream`, then dense_reduce at more
// than one split.  `smem` is the host's count of its shared memory (operand
// j's rows only where the launch has more than one tile): a geometry whose
// count disagrees is refused with cudaErrorInvalidValue before anything is
// launched.  `ldx` is X's row length for COLS.
template <int BM, int STAGES, int STEPS, Source SRC, bool TWO>
cudaError_t launch_mma(const __nv_bfloat16* A, const int* flat,
                       const __nv_bfloat16* u, const int* tiles, int ntiles,
                       int m, int64_t K, int64_t chunk, int splits, int smem,
                       float scale, float reg, float scale_r, float* Gp,
                       float* rp, float* G, float* r, cudaStream_t stream,
                       int64_t ldx) {
  constexpr int bytes = mma_bytes<BM, STAGES, STEPS, SRC>(TWO);
  if (smem != bytes) return cudaErrorInvalidValue;  // host and kernel disagree
  auto kernel = mma_tile<BM, STAGES, STEPS, SRC, TWO>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  if constexpr (SRC == Source::COLS) {
    // The column copies go through L1 (4-byte cp.async.ca), one line a
    // sampled element in flight: ask for no more shared memory than one
    // block needs, so that the rest of the SM's 256 KB stays L1.
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (bytes * 100 + SMEM_CARVEOUT_MAX - 1) / SMEM_CARVEOUT_MAX);
    if (err != cudaSuccess) return err;
  }
  const int mp = (m + TILE - 1) / TILE * TILE;
  kernel<<<dim3(ntiles, splits), MMA_THREADS, bytes, stream>>>(
      A, u, tiles, m, K, chunk, mp, scale, reg, scale_r,
      splits > 1 ? Gp : nullptr, rp, G, r, flat, ldx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t total = static_cast<int64_t>(m) * m + m;
  const int blocks =
      static_cast<int>((total + REDUCE_THREADS - 1) / REDUCE_THREADS);
  dense_reduce<float, true><<<blocks, REDUCE_THREADS, 0, stream>>>(
      Gp, rp, splits, m, mp, scale, reg, scale_r, G, r);
  return cudaGetLastError();
}

// launch_mma at one geometry, with operand j's rows where the launch has
// tiles below the diagonal (ntiles > 1).
template <int BM, int STAGES, int STEPS, Source SRC>
cudaError_t launch_mma_tile(const __nv_bfloat16* A, const int* flat,
                            const __nv_bfloat16* u, const int* tiles,
                            int ntiles, int m, int64_t K, int64_t chunk,
                            int splits, int smem, float scale, float reg,
                            float scale_r, float* Gp, float* rp, float* G,
                            float* r, cudaStream_t stream, int64_t ldx = 0) {
  auto launch = ntiles > 1 ? launch_mma<BM, STAGES, STEPS, SRC, true>
                           : launch_mma<BM, STAGES, STEPS, SRC, false>;
  return launch(A, flat, u, tiles, ntiles, m, K, chunk, splits, smem, scale,
                reg, scale_r, Gp, rp, G, r, stream, ldx);
}

}  // namespace repro
