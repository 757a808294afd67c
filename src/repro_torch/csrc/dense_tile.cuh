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
// * bf16 input (In = __nv_bfloat16, T = float; K7, K1 and K3).  The ring
//   holds the accumulation type: each element is widened to f32 as it
//   lands in shared memory, so the multiply-adds and every sum are the f32
//   kernel's, and a bf16 packet equals the f32 packet of the upcast operand
//   bit for bit.  cp.async moves 4, 8 or 16 bytes, not a 2-byte element.
//   Rows (K7, K1): the copying thread moves a bf16 element itself, through
//   registers: it loads its elements of stage q + STAGES - 1 before it
//   sums stage q and widens them into the ring after (fetch_stage,
//   land_stage), so the loads are in flight while it sums; the operand's
//   reads are half the f32 kernel's bytes.  Columns (K3): a sampled
//   element is an isolated read, and one stage of register loads in
//   flight (the rows' scheme) left the column gather twice as slow as
//   f32's STAGES - 1 stages of cp.async.  So each element's aligned 4-byte
//   word (the element and its neighbour) moves by cp.async into the
//   element's f32 slot, as in f32, and once the thread's copies of a stage
//   have landed it keeps the element's half, widened, in that slot
//   (issue_column_words, widen_columns).  An aligned 4-byte word never
//   crosses a page, so the neighbour's half is mapped wherever the element
//   is; its value is dropped.  The sector traffic is f32 K3's.
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

// bf16 input: a thread's elements of one stage of one operand, in the
// copies' order (issue_operand's), loaded into registers (zero where a copy
// is not valid: nothing is read), then widened into the ring.  `addr(c, kh)`
// is the element of row tid / 8 + ROW_STEP c at step kh + tid % 8.
template <typename D, typename In, typename Addr>
__device__ __forceinline__ void fetch_stage(In* v, Addr addr,
                                            unsigned rows_ok, int lim,
                                            int klo) {
#pragma unroll
  for (int q = 0; q < D::COPIES; ++q) {
    const int c = q % D::ROW_COPIES, kh = 8 * (q / D::ROW_COPIES);
    v[q] = ((rows_ok >> c) & 1u) && kh + klo < lim ? *addr(c, kh) : In{};
  }
}

template <typename D>
__device__ __forceinline__ void land_stage(float* dst,
                                           const __nv_bfloat16* v) {
#pragma unroll
  for (int q = 0; q < D::COPIES; ++q) {
    const int c = q % D::ROW_COPIES, kh = 8 * (q / D::ROW_COPIES);
    dst[kh * D::LD + D::ROW_STEP * c] = __bfloat162float(v[q]);
  }
}

// The column gather of bf16 input: issue_columns' copies, each moving the
// aligned 4-byte word that holds its element (word_of) into the element's
// f32 slot; widen_columns then keeps the element's half of each slot as
// f32 (little-endian: the element at the lower address is the low half).
// A copy that is not valid zero-fills its slot, which widens to +0.
__device__ __forceinline__ const float* word_of(const __nv_bfloat16* p) {
  return reinterpret_cast<const float*>(reinterpret_cast<uintptr_t>(p) &
                                        ~static_cast<uintptr_t>(3));
}

__device__ __forceinline__ float widen_half(float word,
                                            const __nv_bfloat16* p) {
  const unsigned bits = __float_as_uint(word);
  return __uint_as_float((reinterpret_cast<uintptr_t>(p) & 2)
                             ? (bits & 0xffff0000u)
                             : (bits << 16));
}

template <typename D>
__device__ __forceinline__ void issue_column_words(
    float* dst, const __nv_bfloat16* src, int64_t step, bool ok, int lim,
    int k0) {
#pragma unroll
  for (int q = 0; q < D::COPIES; ++q)
    cp_async_elem(dst + q * D::CSTEP * D::LD, word_of(src + q * step),
                  ok && k0 + q * D::CSTEP < lim);
}

template <typename D>
__device__ __forceinline__ void widen_columns(float* dst,
                                              const __nv_bfloat16* src,
                                              int64_t step) {
#pragma unroll
  for (int q = 0; q < D::COPIES; ++q) {
    float* slot = dst + q * D::CSTEP * D::LD;
    *slot = widen_half(*slot, src + q * step);
  }
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
// dense_reduce.  A and u are of the input type In (T, or bf16 for T =
// float); the ring, the sums and the outputs are T.
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
  // bf16 input: rows through the registers that carry one stage (both
  // operands and u, STAGED); columns by word copies widened in place
  // (WORDS).
  constexpr bool WIDE = !std::is_same_v<T, In>;
  static_assert(!WIDE || (std::is_same_v<T, float> &&
                          std::is_same_v<In, __nv_bfloat16>));
  constexpr bool STAGED = WIDE && SRC != Source::COLS;
  constexpr bool WORDS = WIDE && SRC == Source::COLS;
  In staged[STAGED ? 2 * D::COPIES + 1 : 1];
  auto fetch = [&](int s) {
    if constexpr (STAGED) {
      const int64_t off = static_cast<int64_t>(s) * STEPS;
      const int lim = limit(off);
      if constexpr (SRC == Source::ROWS) {
        fetch_stage<D>(staged, [&](int c, int kh) {
          return rows_i[c] + off + kh; }, ok_i, lim, klo);
        if (!diag)
          fetch_stage<D>(staged + D::COPIES, [&](int c, int kh) {
            return rows_j[c] + off + kh; }, ok_j, lim, klo);
      } else {
        fetch_stage<D>(staged, [&](int c, int kh) {
          return src_i + off + c * rs + kh; }, ok_i, lim, klo);
        if (!diag)
          fetch_stage<D>(staged + D::COPIES, [&](int c, int kh) {
            return src_j + off + c * rs + kh; }, ok_j, lim, klo);
      }
      if (with_r && tid < STEPS)
        staged[2 * D::COPIES] = tid < lim ? u[k_begin + off + tid] : In{};
    }
  };
  auto land = [&](int slot) {
    if constexpr (STAGED) {
      T* st = ring + slot * D::STAGE;
      land_stage<D>(st + slot0, staged);
      if (!diag) land_stage<D>(st + STEPS * D::LD + slot0, staged + D::COPIES);
      if (with_r && tid < STEPS)
        st[2 * STEPS * D::LD + tid] = __bfloat162float(staged[2 * D::COPIES]);
    }
  };
  auto issue = [&](int slot, int s) {
    if constexpr (STAGED) {
      fetch(s);
      land(slot);
    } else {
      T* st = ring + slot * D::STAGE;
      const int64_t off = static_cast<int64_t>(s) * STEPS;
      const int lim = limit(off);
      if constexpr (SRC == Source::ROWS) {
        issue_gathered<D>(st + slot0, rows_i, off, ok_i, lim, klo);
        if (!diag)
          issue_gathered<D>(st + STEPS * D::LD + slot0, rows_j, off, ok_j,
                            lim, klo);
      } else if constexpr (WORDS) {
        const int cslot = (tid / BM) * D::LD + tid % BM;
        issue_column_words<D>(st + cslot, rows_i[0] + off * ldx,
                              D::CSTEP * ldx, ok_i, lim, tid / BM);
        if (!diag)
          issue_column_words<D>(st + STEPS * D::LD + cslot,
                                rows_j[0] + off * ldx, D::CSTEP * ldx, ok_j,
                                lim, tid / BM);
      } else if constexpr (SRC == Source::COLS) {
        const int cslot = (tid / BM) * D::LD + tid % BM;
        issue_columns<D>(st + cslot, rows_i[0] + off * ldx, D::CSTEP * ldx,
                         ok_i, lim, tid / BM);
        if (!diag)
          issue_columns<D>(st + STEPS * D::LD + cslot,
                           rows_j[0] + off * ldx, D::CSTEP * ldx, ok_j, lim,
                           tid / BM);
      } else {
        issue_operand<D>(st + slot0, src_i + off, rs, ok_i, lim, klo);
        if (!diag)
          issue_operand<D>(st + STEPS * D::LD + slot0, src_j + off, rs, ok_j,
                           lim, klo);
      }
      if constexpr (WORDS) {
        if (with_r && tid < STEPS)
          cp_async_elem(st + 2 * STEPS * D::LD + tid,
                        word_of(u + k_begin + off + tid), tid < lim);
      } else {
        if (with_r && tid < STEPS)
          cp_async_elem(st + 2 * STEPS * D::LD + tid,
                        u + k_begin + off + tid, tid < lim);
      }
    }
  };
  // WORDS: this thread's slots of stage s (in ring slot `slot`), once its
  // copies have landed, each keeping its element's half as f32.
  auto widen = [&](int slot, int s) {
    if constexpr (WORDS) {
      T* st = ring + slot * D::STAGE;
      const int64_t off = static_cast<int64_t>(s) * STEPS;
      const int cslot = (tid / BM) * D::LD + tid % BM;
      widen_columns<D>(st + cslot, rows_i[0] + off * ldx, D::CSTEP * ldx);
      if (!diag)
        widen_columns<D>(st + STEPS * D::LD + cslot, rows_j[0] + off * ldx,
                         D::CSTEP * ldx);
      if (with_r && tid < STEPS) {
        float* us = st + 2 * STEPS * D::LD + tid;
        *us = widen_half(*us, u + k_begin + off + tid);
      }
    }
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
    if constexpr (WORDS) widen(cur, q);  // its slots of stage q as f32
    __syncthreads();              // everyone's; stage q - 1 consumed
    const bool more = q + STAGES - 1 < slabs;
    if constexpr (STAGED) {
      if (more) fetch(q + STAGES - 1);  // lands in slot nxt after the sums
    } else {
      if (more) issue(nxt, q + STAGES - 1);
      cp_async_commit();
    }

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
    if constexpr (STAGED) {
      if (more) land(nxt);  // nxt held stage q - 1, which every thread has
    }                       // summed: the barrier at the loop's head
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
// length for the column gather (unused otherwise).  A and u are of the
// input type In; the ring's bytes are T's.
template <typename T, int BM, int TM, int TN, int STAGES, int STEPS,
          bool RESIDUAL, Source SRC, typename In = T>
cudaError_t launch_tile(const In* A, const int* flat, const In* u,
                        const int* tiles, int ntiles, int m, int64_t K,
                        int64_t chunk, int splits, int smem, T scale, T reg,
                        T scale_r, T* Gp, T* rp, T* G, T* r,
                        cudaStream_t stream, int64_t ldx = 0) {
  constexpr int bytes = ring_bytes<T, BM, TM, TN, STAGES, STEPS>();
  if (smem != bytes) return cudaErrorInvalidValue;  // host and kernel disagree
  auto kernel = dense_tile<T, BM, TM, TN, STAGES, STEPS, RESIDUAL, SRC, In>;
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

}  // namespace repro
