// Fused segmented Gram for Hopper (sm_90a):
//
//     G[b, s] = sum_{n: seg_n = s}  w[b, n] * L_n (x) R_n
//
// Replaces the TPU kernel src/repro/kernels/seg_gram/kernel.py:
// seg_gram_pallas (and, through it, residual_gram/kernel.py:
// residual_gram_pallas).  It computes what that kernel computes; it does
// not carry over its sequential VMEM-resident grid.
//
// Builders.  A template parameter picks how a row's factors (L, R) are
// formed from the raw columns (kernels/seg_gram/ref.py names them):
//
//   DESIGN           L = R = X                      (X the design [X|1|y])
//   GRAM_AND_VEC     L = [wg * X | v],  R = X       (logistic Newton step)
//   RESIDUAL         L = R = [rt * phi | ry]        (final-stage G, b;
//                                                    rt = t - mt, ry = y - my)
//   RESIDUAL_DIRECT  L = R = [rt * phi | ry]        (residuals given)
//   RESIDUAL_MEAT    L = R = e * rt * phi,  e = (w2 *)(ry - <rt*phi, theta>)
//   IV               L = R = [rz * phi | rt * phi | ry]
//   IV_MEAT          L = R = e * rz * phi,  e = (w2 *)(ry - <rt*phi, theta>)
//   PAIR             L = U,  R = V                  (two row matrices: the
//                                                    sweep's MM gradient terms
//                                                    and final stage, the
//                                                    store's accumulators)
//
// build_fold_weighted (G[k] = sum_n Wk[k,n] d_n d_n^T, which the TPU
// kernel gets by widening L to the (n, k*q) kron product) is DESIGN with
// Wk as a batched row weight: no kron operand exists here.
//
// Every builder but PAIR is "one or two scaled copies of X, plus an
// optional appended column", so the per-row scalars (rt, ry, rz, e, wg,
// v) are formed once per row when a chunk of rows is staged, and the
// per-element work is one multiply.  IV is the one builder with two
// copies: column i < dX of its row is rz * phi_i, column dX + i is
// rt * phi_i, column 2 dX is ry.
//
// Rows come in units.  One segment (S = 1): unit p is the rows
// [p*rs, (p+1)*rs).  Several segments: the TPU kernel expands L by the
// weighted one-hot into an (S*qL, qR) output and multiplies the zeros --
// S times the useful work, and at the sweep's S = 320 a per-split buffer
// of gigabytes.  Here every block walks one segment's own rows instead.
// The wrapper (kernel.py: walk_plan) sorts the row ids by segment
// (stable, so each segment keeps its rows in arrival order; ids outside
// [0, S) fall out) and cuts each segment into units of at most rs rows,
// every segment at least one unit; the unit table holds (segment, first,
// last) in that order, and a block reads its rows through the
// permutation in place -- no copy of the row matrices is made.
//
// Units.  rs is fixed by the configuration and never by n, so appending
// zero rows (or rows with seg = -1) leaves every unit's addition
// sequence -- and the result -- bitwise unchanged.
//
// Three kernels, one a configuration (config_of).  Every one accumulates
// with fp32 FMA on the CUDA cores.
//
//   * seg_gram_small (SMALL: both widths <= 16 -- the final stages' 2 x 2
//     to 5 x 5, every builder): a warp per (unit, batch element), its
//     lanes owning the output elements; lane r forms row r of each batch
//     of 32 into the warp's own staging rows.
//   * seg_gram_thin (THIN: pair with qL <= 8 -- the sweep's 5 x 501 and
//     1 x 501 MM gradient terms): a warp per (unit, 128 columns of V),
//     4 columns and qL x 4 accumulators a lane, V read coalesced 8 rows
//     ahead of the FMAs in registers, U and w by shuffle.
//   * seg_gram_big (BIG: every wider output -- the 502-wide nuisance
//     Grams, fold_weighted, the 2049/2561-wide backbone Grams, the
//     store's 503- and 1006-wide accumulators):
//
//   * One triangle.  A symmetric Gram -- every builder but PAIR, and PAIR
//     when U and V are one tensor (the wrapper's flag) -- launches only
//     the 128 x 128 output tiles with tile-row <= tile-col; gram_and_vec
//     ([wg X | v] (x) X: symmetric but for its appended v row) adds the
//     lower tiles of the tile-row that holds row dX.  kernel.py:
//     tile_schedule lists the launched tiles; tile_of below mirrors it.
//     The block writes its upper elements, and their mirror (j, i)
//     through a transpose in shared memory, so every element of the
//     partial (or, seeded, of the output) is written once from one
//     accumulator: the result is bitwise symmetric, and the second pass
//     stays a plain ordered sum.  A diagonal tile also skips its quadrant
//     below the diagonal, and in gram_and_vec's lower tiles the warps
//     that hold no part of row dX skip the FMAs: at q = 502 the design
//     runs 9 tiles' FMAs of the full square's 16.
//   * 8 x 8 outputs per thread (two 4-wide groups 64 apart on each side,
//     so a warp's float4 reads of a staged row are conflict-free
//     broadcasts): 4 float4 shared loads per 64 FMA, 0.25 loads per FMA.
//   * Double-buffered chunks of 16 rows with one barrier per chunk: each
//     thread owns one staged column (128 L + 128 R per block) and
//     prefetches the next chunk's 16 raw values into registers before the
//     current chunk's FMAs, then scales and stores them.  The per-row
//     scalars (and the row ids of a walk) are formed two chunks ahead by
//     the lanes of warp 0 alone, so only warp 0 waits on their loads.
//     Rows of X are dX * 4 bytes apart (8196 at q = 2049), so staging is
//     4-byte loads of one column per row -- a gather through perm in the
//     walk -- never 16-byte copies of a row.
//
// Arithmetic order.  Every output element adds its unit's rows one at a
// time, in row order, with one fp32 FMA each, whatever the kernel, the
// batch or the chunking, L formed as colval * w (pair: U * w) and R
// unscaled; the units then add in a fixed order.  The thin and small
// kernels replaced one shared first design (the template
// seg_gram_kernel) and keep its sequence bit for bit: the same units,
// factors and order, and its masked zero FMAs replayed
// (FIRST_SMALL_CH).  The port's bitwise contracts rest on that:
// chunked == whole, appended zero and seg = -1 rows are no-ops, w = 0
// == zeroed rows, serial == batched (each batch element's arithmetic is
// independent of B), the store's one-shot == incremental for any
// partition and its rollback, and run-to-run repeatability.  That is why the Grams stay off the tensor
// cores: TF32 drops fp32's accuracy, and even an fp32-accurate 3xTF32
// split sums a k-group of rows inside the mma in the hardware's order,
// which breaks one-shot == incremental wherever a day's rows do not end
// on a k boundary.
//
// Reduction.  Unit u writes its partial to partial[u]; a second kernel
// sums each segment's units in their fixed order -- a thread an element
// for the large tile and the thin kernel, a warp an element for the
// small kernel's few elements of up to ~1000 partials.  No atomics: a
// run repeats bitwise.  The partial buffer holds at most ceil(n/rs) + S
// units of (qL, qR).  With init (the store's standing accumulators) the
// walk is not split: one unit per segment, whose accumulators start from
// init[s] and are written straight to the output, so an ingest of rows A
// then rows B runs exactly the addition sequence of one pass over A + B
// -- incremental ingest is bitwise the one-shot pass.  init is only read;
// a symmetric PAIR with init takes the triangle only when init itself is
// symmetric (the wrapper checks), since the mirror copies init[i, j] + sum
// into (j, i).
//
// Batch.  The leading batch dimension carries the k folds of the
// "parallel" cross-fit engine -- and, for the bootstrap, R replicates
// times k folds -- in one launch: w, the per-row scalars and the meats'
// theta come in at batch strides (0: shared), X (and PAIR's Y) is shared.
// Blocks of one unit and tile run side by side for every batch element,
// so the rows they stage come from L2 after the first read.
//
// Bound on the H100 (3.35 TB/s HBM, 67 TFLOP/s fp32 FMA).  At q ~ 500
// the symmetric Gram is 2*n*q(q+1)/2 FLOP for n*q*4 bytes read -- ~125
// FLOP/byte, compute-bound: 18.8 ms for the k = 5 design at n = 1e6; the
// large tile issues its FMAs at ~45 % of that peak (PERF.md).  The
// sweep's gradient terms (qL <= 5) read V (2^20 x 501, 2.1 GB) once and
// are bandwidth-bound, 0.63 ms: the thin kernel keeps several MB of V in
// flight.  The final-stage forms (q <= 5) read a few bytes a row; a
// unit's rows are one warp's serial walk, so they are latency-bound: the
// small kernel loads row ids two batches ahead and prefetches the next
// batch's columns.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum Builder {
  DESIGN = 0, GRAM_AND_VEC = 1, RESIDUAL = 2, RESIDUAL_MEAT = 3,
  RESIDUAL_DIRECT = 4, IV = 5, IV_MEAT = 6, PAIR = 7
};

struct Args {
  long long n;
  int dX;                  // columns of X
  const float* X;          // (n, dX) row-major; PAIR: U
  int dY;
  const float* Y;          // PAIR: V (n, dY); else null
  const float* a0;         // per-row scalars; meaning set by the builder
  const float* a1;
  const float* a2;
  const float* a3;
  const float* a4;         // the meat's optional builder weight (or null)
  long long a_bstride;     // batch stride of a0..a4 (0: shared)
  const float* theta;      // (B, dX) for the meats, at theta_bstride
  long long theta_bstride;
  const float* w;          // (B, n) row weights at w_bstride, or null
  long long w_bstride;
  // the unit table of a segment walk (null: S = 1, fixed row splits)
  const long long* perm;   // row ids sorted by segment
  const int* unit_seg;     // (W,) segment of each unit; >= S: unused
  const long long* unit_lo;  // (W,) [lo, hi) positions in perm
  const long long* unit_hi;
  int S;
  int qL, qR;              // L width, R width
  long long rs;            // rows per unit of the fixed splits
  long long units;         // units launched (P splits, or W table entries)
  int B;
  int sym;                 // BIG: compute one triangle and mirror it
  const float* init;       // (B, S, qL, qR) seeds of an unsplit walk, or null
  float* partial;          // (W, B, qL, qR)
  float* out;              // (B, S, qL, qR), written directly when seeded
};

// Per-row scalars: L_n[i] = c1L * X[n, i] (i < dX), L_n[dX + i] =
// c2L * X[n, i] (IV only), and the appended column L_n[last] = eL; R
// alike.
struct RowScalars {
  float c1L, c2L, eL, c1R, c2R, eR;
};

__device__ __forceinline__ float meat_e(const Args& a, int b, long long row,
                                        float ry, float rt, const float* w2) {
  const float* xr = a.X + row * a.dX;
  const float* th = a.theta + (long long)b * a.theta_bstride;
  float dot = 0.f;
  for (int j = 0; j < a.dX; ++j) dot += (rt * xr[j]) * th[j];
  float e = ry - dot;
  if (w2 != nullptr) e = w2[(long long)b * a.a_bstride + row] * e;
  return e;
}

template <int BUILDER>
__device__ __forceinline__ RowScalars row_scalars(const Args& a, int b,
                                                  long long row) {
  const long long o = (long long)b * a.a_bstride + row;
  RowScalars s = {1.f, 0.f, 0.f, 1.f, 0.f, 0.f};
  if constexpr (BUILDER == GRAM_AND_VEC) {
    s.c1L = a.a0[o]; s.eL = a.a1[o];
  } else if constexpr (BUILDER == RESIDUAL) {
    const float ry = a.a0[o] - a.a2[o];
    const float rt = a.a1[o] - a.a3[o];
    s.c1L = rt; s.eL = ry; s.c1R = rt; s.eR = ry;
  } else if constexpr (BUILDER == RESIDUAL_DIRECT) {
    s.c1L = a.a1[o]; s.eL = a.a0[o]; s.c1R = s.c1L; s.eR = s.eL;
  } else if constexpr (BUILDER == RESIDUAL_MEAT) {
    const float ry = a.a0[o] - a.a2[o];
    const float rt = a.a1[o] - a.a3[o];
    const float e = meat_e(a, b, row, ry, rt, a.a4);
    s.c1L = e * rt; s.c1R = e * rt;
  } else if constexpr (BUILDER == IV) {
    s.c1L = a.a2[o]; s.c2L = a.a1[o]; s.eL = a.a0[o];
    s.c1R = s.c1L; s.c2R = s.c2L; s.eR = s.eL;
  } else if constexpr (BUILDER == IV_MEAT) {
    const float e = meat_e(a, b, row, a.a0[o], a.a1[o], a.a3);
    s.c1L = e * a.a2[o]; s.c1R = s.c1L;
  }
  return s;
}

// Column i of a staged row: c1 * x_i, then (IV) c2 * x_{i - dX}, then e.
template <int BUILDER>
__device__ __forceinline__ float colval(int i, const float* xr, int dX,
                                        float c1, float c2, float e) {
  if (i < dX) return c1 * xr[i];
  if constexpr (BUILDER == IV) {
    if (i < 2 * dX) return c2 * xr[i - dX];
  }
  return e;
}

constexpr unsigned FULL = 0xffffffffu;

// The rows [lo, hi) of unit u and its segment s; false past the unit table.
__device__ __forceinline__ bool unit_range(const Args& a, long long u, int& s,
                                           long long& lo, long long& hi) {
  if (u >= a.units) return false;
  s = 0;
  if (a.unit_seg != nullptr) {
    s = a.unit_seg[u];
    if (s >= a.S) return false;
    lo = a.unit_lo[u];
    hi = a.unit_hi[u];
  } else {
    lo = u * a.rs;
    hi = a.n < lo + a.rs ? a.n : lo + a.rs;
  }
  return true;
}

// Row id of position p0 + lane of a unit's walk, or -1 past its end.
__device__ __forceinline__ long long lane_row(const Args& a, long long p0,
                                              long long hi, int lane) {
  const long long pos = p0 + lane;
  if (pos >= hi) return -1;
  return a.perm != nullptr ? a.perm[pos] : pos;
}

// The thin kernel: pair, qL = QL <= 8, qR > 16 (the sweep's MM gradient
// terms 5 x 501 and 1 x 501).  A warp owns one unit and one stripe of
// 128 columns of V; lane l holds the columns J0 + l + 32 k, k < 4, and
// QL x 4 accumulators.  The warp walks the unit's rows in batches of 32
// from lo: lane r loads row r's id (two batches ahead), then its V offset
// and U * w (one batch ahead); row r's values reach every lane by
// shuffle.  V is read 4 bytes a lane, 128 bytes a warp instruction (rows
// of V are dY * 4 bytes apart, so 16-byte loads would not be aligned),
// THIN_AHEAD rows ahead of the FMAs in a register ring.  No shared
// memory, no barrier.  A batch is the first design's chunk, so the rows
// past the unit's end in its last batch are zero FMAs here as there.
constexpr int THIN_MAX = 8;        // qL at most
constexpr int THIN_CH = 32;        // rows a batch, one a lane
constexpr int THIN_STRIPE = 128;   // columns of V a warp
constexpr int THIN_WARPS = 4;      // stripes a block at most
constexpr int THIN_AHEAD = 8;      // rows of V in flight ahead of the FMAs

// Blocks an SM, so that the sweep's units run in one wave: six up to
// qL = 2 ((b): ~640 units; 85 registers a thread), four up to qL = 6
// ((a): ~512 units; 128 registers), three at qL 7 and 8.
template <int QL>
__global__ void __launch_bounds__(THIN_WARPS * 32,
                                  QL <= 2 ? 6 : (QL <= 6 ? 4 : 3))
seg_gram_thin(Args a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int s;
  long long lo, hi;
  if (!unit_range(a, blockIdx.x, s, lo, hi)) return;
  const int J0 = (blockIdx.y * (blockDim.x >> 5) + warp) * THIN_STRIPE;
  if (J0 >= a.qR) return;
  const int b = blockIdx.z;
  const long long slab = (long long)QL * a.qR;
  const long long ob = ((long long)b * a.S + s) * slab;
  bool ok[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) ok[k] = J0 + lane + 32 * k < a.qR;

  float acc[QL][4];
#pragma unroll
  for (int i = 0; i < QL; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      acc[i][k] = (a.init != nullptr && ok[k])
                      ? a.init[ob + (long long)i * a.qR + J0 + lane + 32 * k]
                      : 0.f;

  const float* wb = a.w != nullptr ? a.w + (long long)b * a.w_bstride : nullptr;
  const float* Vc = a.Y + J0 + lane;
  const long long nb = (hi - lo + THIN_CH - 1) / THIN_CH;
  auto row_id = [&](long long bi) {
    return bi < nb ? lane_row(a, lo + bi * THIN_CH, hi, lane) : -1ll;
  };
  // a lane's row: its offset in V (-1: none) and U * w (0: none)
  auto row_vals = [&](long long row, long long& off, float (&lw)[QL]) {
    off = -1;
#pragma unroll
    for (int i = 0; i < QL; ++i) lw[i] = 0.f;
    if (row >= 0) {
      const float w = wb != nullptr ? wb[row] : 1.f;
      off = row * a.dY;
#pragma unroll
      for (int i = 0; i < QL; ++i) lw[i] = a.X[row * a.dX + i] * w;
    }
  };
  auto load_v = [&](long long off, float (&v)[4]) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = (off >= 0 && ok[k]) ? __ldg(Vc + off + 32 * k) : 0.f;
  };

  if (nb > 0) {
    long long off, offn;
    float lw[QL], lwn[QL], v[THIN_AHEAD][4];
    row_vals(row_id(0), off, lw);
    long long idn = row_id(1);
#pragma unroll
    for (int j = 0; j < THIN_AHEAD; ++j)
      load_v(__shfl_sync(FULL, off, j), v[j]);
    for (long long bi = 0; bi < nb; ++bi) {
      const long long idnn = row_id(bi + 2);     // in flight over the batch
      row_vals(idn, offn, lwn);                   // idn came a batch ago
#pragma unroll
      for (int r = 0; r < THIN_CH; ++r) {
        const int slot = r % THIN_AHEAD;
#pragma unroll
        for (int i = 0; i < QL; ++i) {
          const float l = __shfl_sync(FULL, lw[i], r);
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(l, v[slot][k], acc[i][k]);
        }
        // the freed slot takes the row THIN_AHEAD further on
        const int rn = r + THIN_AHEAD;
        const long long o = rn < THIN_CH ? __shfl_sync(FULL, off, rn)
                                         : __shfl_sync(FULL, offn, rn - THIN_CH);
        load_v(o, v[slot]);
      }
      off = offn;
#pragma unroll
      for (int i = 0; i < QL; ++i) lw[i] = lwn[i];
      idn = idnn;
    }
  }

  float* dst = a.init != nullptr ? a.out + ob
                                 : a.partial + (blockIdx.x * (long long)a.B + b) * slab;
#pragma unroll
  for (int i = 0; i < QL; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (ok[k]) dst[(long long)i * a.qR + J0 + lane + 32 * k] = acc[i][k];
}

// The small kernel: both widths <= 16 (the final stages' 2 x 2 to 5 x 5,
// every builder).  A warp owns one (unit, batch element); lane l owns the
// output elements e = l + 32 m, m < M (M = 1, 2, 4 or 8: the least that
// covers qL qR; a lane past the last element computes on element 0 and
// writes nothing, so the FMAs need no predicate).  The warp walks the
// unit's rows in batches of 32 from lo: lane r forms row r's scalars
// (row_scalars, meat_e) and its L (w applied) and R values into the
// warp's own staging rows in shared memory, which every lane then reads
// for its elements; two staging buffers, one __syncwarp a batch; row ids
// two batches ahead.  A shuffle would not do here: a lane needs L_r[I]
// for its own I, and a shuffle reads one register name in every source
// lane.
constexpr int SMALL_MAX = 16;      // both widths at most
constexpr int SMALL_CH = 32;       // rows a batch, one a lane
constexpr int SMALL_WARPS = 4;     // units a block
constexpr int SMALL_LD = SMALL_MAX + 1;
// The first design's small tile staged chunks of 64 rows from lo and
// ran masked zero FMAs to the end of the last one; fmaf(0, 0, acc) ==
// acc + 0 (it only turns -0 into +0), so one +0 replays them.
constexpr long long FIRST_SMALL_CH = 64;

template <int BUILDER, int M>
__global__ void __launch_bounds__(SMALL_WARPS * 32) seg_gram_small(Args a) {
  __shared__ float sL[SMALL_WARPS][2][SMALL_CH][SMALL_LD];
  __shared__ float sR[SMALL_WARPS][2][SMALL_CH][SMALL_LD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long u = (long long)blockIdx.x * SMALL_WARPS + warp;
  int s;
  long long lo, hi;
  if (!unit_range(a, u, s, lo, hi)) return;
  const int b = blockIdx.z;
  const int nel = a.qL * a.qR;
  const long long ob = ((long long)b * a.S + s) * nel;
  int I[M], J[M];
  float acc[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int e = lane + 32 * m;
    I[m] = e < nel ? e / a.qR : 0;
    J[m] = e < nel ? e % a.qR : 0;
    acc[m] = (a.init != nullptr && e < nel) ? a.init[ob + e] : 0.f;
  }

  const float* wb = a.w != nullptr ? a.w + (long long)b * a.w_bstride : nullptr;
  const long long nb = (hi - lo + SMALL_CH - 1) / SMALL_CH;
  auto row_id = [&](long long bi) {
    return bi < nb ? lane_row(a, lo + bi * SMALL_CH, hi, lane) : -1ll;
  };
  // lane r's row into staging buffer buf: L = colval * w (PAIR: U * w),
  // R = colval (PAIR: V), as the first design staged them; a row past
  // the unit's end is never read
  auto stage = [&](long long row, int buf) {
    if (row < 0) return;
    float* Ls = &sL[warp][buf][lane][0];
    float* Rs = &sR[warp][buf][lane][0];
    const RowScalars sc = row_scalars<BUILDER>(a, b, row);
    const float w = wb != nullptr ? wb[row] : 1.f;
    const float* xr = a.X + row * a.dX;
    for (int i = 0; i < a.qL; ++i) {
      if constexpr (BUILDER == PAIR)
        Ls[i] = xr[i] * w;
      else
        Ls[i] = colval<BUILDER>(i, xr, a.dX, sc.c1L, sc.c2L, sc.eL) * w;
    }
    for (int j = 0; j < a.qR; ++j) {
      if constexpr (BUILDER == PAIR)
        Rs[j] = a.Y[row * a.dY + j];
      else
        Rs[j] = colval<BUILDER>(j, xr, a.dX, sc.c1R, sc.c2R, sc.eR);
    }
  };
  auto fma_row = [&](int buf, int r) {
    const float* Lr = &sL[warp][buf][r][0];
    const float* Rr = &sR[warp][buf][r][0];
#pragma unroll
    for (int m = 0; m < M; ++m) acc[m] = fmaf(Lr[I[m]], Rr[J[m]], acc[m]);
  };

  if (nb > 0) {
    stage(row_id(0), 0);
    long long idn = row_id(1);
    __syncwarp();
    for (long long bi = 0; bi < nb; ++bi) {
      const int cb = (int)(bi & 1);
      const long long idnn = row_id(bi + 2);     // in flight over the batch
      const long long left = hi - lo - bi * SMALL_CH;
      if (left >= SMALL_CH) {
#pragma unroll
        for (int r = 0; r < SMALL_CH; ++r) fma_row(cb, r);
      } else {
        for (int r = 0; r < (int)left; ++r) fma_row(cb, r);
      }
      stage(idn, cb ^ 1);     // read last in batch bi - 1, before its sync
      __syncwarp();
      idn = idnn;
    }
  }
  if ((hi - lo) % FIRST_SMALL_CH != 0) {
#pragma unroll
    for (int m = 0; m < M; ++m) acc[m] += 0.f;
  }

  float* dst = a.init != nullptr ? a.out + ob : a.partial + (u * a.B + b) * nel;
#pragma unroll
  for (int m = 0; m < M; ++m)
    if (lane + 32 * m < nel) dst[lane + 32 * m] = acc[m];
}

// The BIG template's shape: a 128 x 128 output tile, 16 x 16 threads of
// 8 x 8 outputs, chunks of 16 rows.  A thread's outputs are the rows
// (m / 4) * 64 + 4 ty + m % 4 and the columns (k / 4) * 64 + 4 tx + k % 4
// of the tile.
constexpr int BIG_T = 128, BIG_M = 8, BIG_CH = 16;
constexpr int BIG_NT = (BIG_T / BIG_M) * (BIG_T / BIG_M);
constexpr int BIG_H = BIG_T / 2;
constexpr int BIG_LDT = BIG_H + 1;      // the mirror's transpose buffer
constexpr int BIG_STAGE = 2 * 2 * BIG_CH * BIG_T;   // floats: 2 bufs x (L, R)
constexpr int BIG_SMEM = BIG_STAGE > BIG_T * BIG_LDT ? BIG_STAGE
                                                     : BIG_T * BIG_LDT;
static_assert(BIG_NT == 2 * BIG_T, "one thread per staged column");
static_assert(BIG_CH <= 32, "warp 0 forms a chunk's scalars");

// Launched output tiles of a (qL, qR) output (kernel.py: tile_schedule).
// Full: row-major over the grid.  Symmetric: the upper triangle
// (tile-row <= tile-col) row by row, then -- when qL > qR, gram_and_vec's
// appended row dX = qR -- the tiles left of the diagonal in its tile-row.
__host__ __device__ inline int tiles_big(int qL, int qR, bool sym) {
  const int TR = (qR + BIG_T - 1) / BIG_T;
  if (!sym) return ((qL + BIG_T - 1) / BIG_T) * TR;
  return TR * (TR + 1) / 2 + (qL > qR ? qR / BIG_T : 0);
}

__host__ __device__ inline void tile_of(int y, int qR, bool sym, int& ti,
                                       int& tj) {
  const int TR = (qR + BIG_T - 1) / BIG_T;
  if (!sym) {
    ti = y / TR;
    tj = y % TR;
    return;
  }
  const int U = TR * (TR + 1) / 2;
  if (y >= U) {
    ti = qR / BIG_T;
    tj = y - U;
    return;
  }
  ti = 0;
  while (y >= TR - ti) {
    y -= TR - ti;
    ++ti;
  }
  tj = ti + y;
}

template <int BUILDER>
__global__ void __launch_bounds__(BIG_NT, 2) seg_gram_big(Args a) {
  __shared__ __align__(16) float sm[BIG_SMEM];
  // per chunk row: c1L c2L eL c1R c2R eR, w; and the row id (-1: none)
  __shared__ float sSc[2][7][BIG_CH];
  __shared__ long long sRow[2][BIG_CH];

  const long long u = blockIdx.x;
  int s = 0;
  long long lo, hi;
  if (a.unit_seg != nullptr) {
    s = a.unit_seg[u];
    if (s >= a.S) return;            // past the last unit: the whole block
    lo = a.unit_lo[u];
    hi = a.unit_hi[u];
  } else {
    lo = u * a.rs;
    hi = a.n < lo + a.rs ? a.n : lo + a.rs;
  }
  const bool sym = a.sym != 0;
  const int nsym = a.qR;             // rows >= qR (gram_and_vec's v) are not mirrored
  int ti, tj;
  tile_of(blockIdx.y, a.qR, sym, ti, tj);
  const int I0 = ti * BIG_T, J0 = tj * BIG_T;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // a warp is 4 x 8 threads: its staged-row reads touch 64 + 128 bytes
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int tx = (warp & 1) * 8 + (lane & 7);
  const long long slab = (long long)a.qL * a.qR;
  const long long ob = ((long long)b * a.S + s) * slab;

  float acc[BIG_M][BIG_M];
#pragma unroll
  for (int m = 0; m < BIG_M; ++m)
#pragma unroll
    for (int k = 0; k < BIG_M; ++k) {
      const int I = I0 + (m >> 2) * BIG_H + ty * 4 + (m & 3);
      const int J = J0 + (k >> 2) * BIG_H + tx * 4 + (k & 3);
      acc[m][k] = (a.init != nullptr && I < a.qL && J < a.qR)
                      ? a.init[ob + (long long)I * a.qR + J] : 0.f;
    }

  // This thread's staged column: L (tid < 128) or R, its source and the
  // per-row scalar that scales it (0 c1, 1 c2, 2 e alone, 3 zero).
  const bool rside = tid >= BIG_T;
  const int cc = tid & (BIG_T - 1);
  const int col = (rside ? J0 : I0) + cc;
  const int qS = rside ? a.qR : a.qL;
  const float* src = a.X;
  int ld = a.dX, xcol = 0, sel = 3;
  if constexpr (BUILDER == PAIR) {
    if (rside) { src = a.Y; ld = a.dY; }
    if (col < qS) { xcol = col; sel = 0; }
  } else {
    if (col < a.dX) {
      xcol = col; sel = 0;
    } else if (BUILDER == IV && col < 2 * a.dX) {
      xcol = col - a.dX; sel = 1;
    } else if (col < qS) {
      sel = 2;
    }
  }
  const int sidx = (rside ? 3 : 0) + (sel < 3 ? sel : 0);
  const float* wb = a.w != nullptr ? a.w + (long long)b * a.w_bstride : nullptr;
  const long long nch = hi > lo ? (hi - lo + BIG_CH - 1) / BIG_CH : 0;

  // Per-row scalars, two chunks ahead: lane r of warp 0 forms those of
  // row r.  Only warp 0 waits on their loads; the other warps go on to
  // the chunk's FMAs (a thread in every warp would stall every warp).
  auto scalars = [&](long long ci, int buf) {
    if (tid < BIG_CH) {
      const int r = tid;
      const long long pos = lo + ci * BIG_CH + r;
      RowScalars sc = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float w = 0.f;
      long long row = -1;
      if (ci < nch && pos < hi) {
        row = a.perm != nullptr ? a.perm[pos] : pos;
        sc = row_scalars<BUILDER>(a, b, row);
        w = wb != nullptr ? wb[row] : 1.f;
      }
      sSc[buf][0][r] = sc.c1L; sSc[buf][1][r] = sc.c2L; sSc[buf][2][r] = sc.eL;
      sSc[buf][3][r] = sc.c1R; sSc[buf][4][r] = sc.c2R; sSc[buf][5][r] = sc.eR;
      sSc[buf][6][r] = w;
      sRow[buf][r] = row;
    }
  };
  float raw[BIG_CH];
  auto load_raw = [&](int buf) {
#pragma unroll
    for (int r = 0; r < BIG_CH; ++r) {
      const long long row = sRow[buf][r];
      raw[r] = (sel < 2 && row >= 0) ? __ldg(src + row * ld + xcol)
                                     : (sel == 2 ? 1.f : 0.f);
    }
  };
  auto store = [&](int buf) {
    float* dst = sm + buf * 2 * BIG_CH * BIG_T + (rside ? BIG_CH * BIG_T : 0) + cc;
#pragma unroll
    for (int r = 0; r < BIG_CH; ++r) {
      float v = 0.f;
      if (sel < 3) {
        v = raw[r] * sSc[buf][sidx][r];
        if (!rside) v *= sSc[buf][6][r];
      }
      dst[r * BIG_T] = v;
    }
  };
  // A diagonal tile of a symmetric Gram skips the quadrant below the
  // diagonal (rows 64..127 by columns 0..63 of the tile): nothing there
  // is written -- unless the tile holds gram_and_vec's v row.
  auto compute = [&](int buf, auto skip) {
    const float* Lb = sm + buf * 2 * BIG_CH * BIG_T;
    const float* Rb = Lb + BIG_CH * BIG_T;
#pragma unroll
    for (int r = 0; r < BIG_CH; ++r) {
      const float4 l0 = *reinterpret_cast<const float4*>(Lb + r * BIG_T + ty * 4);
      const float4 l1 = *reinterpret_cast<const float4*>(Lb + r * BIG_T + BIG_H + ty * 4);
      const float4 r0 = *reinterpret_cast<const float4*>(Rb + r * BIG_T + tx * 4);
      const float4 r1 = *reinterpret_cast<const float4*>(Rb + r * BIG_T + BIG_H + tx * 4);
      const float lv[BIG_M] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
      const float rv[BIG_M] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
#pragma unroll
      for (int m = 0; m < BIG_M; ++m)
#pragma unroll
        for (int k = 0; k < BIG_M; ++k)
          if (!(decltype(skip)::value && m >= 4 && k < 4))
            acc[m][k] = fmaf(lv[m], rv[k], acc[m][k]);
    }
  };
  const bool diag = sym && ti == tj && (a.qL <= nsym || I0 + BIG_T <= nsym);
  // Left of the diagonal in gram_and_vec's v tile row only row qR is
  // written: the warps that hold no part of it skip the FMAs.  A warp's
  // rows are wr .. wr + 15 and wr + 64 .. wr + 79.
  const int wr = I0 + (warp >> 1) * 16;
  const bool idle = sym && ti > tj &&
                    !(nsym >= wr && nsym < wr + 16) &&
                    !(nsym >= wr + BIG_H && nsym < wr + BIG_H + 16);

  if (nch > 0) {
    scalars(0, 0);
    scalars(1, 1);
    __syncthreads();
    load_raw(0);
    store(0);
    __syncthreads();
    for (long long ci = 0; ci < nch; ++ci) {
      const int cb = (int)(ci & 1), nb = cb ^ 1;
      const bool more = ci + 1 < nch;
      if (more) load_raw(nb);                    // in flight over the FMAs
      if (ci + 2 < nch) scalars(ci + 2, cb);
      if (diag) compute(cb, std::true_type{});
      else if (!idle) compute(cb, std::false_type{});
      if (more) store(nb);
      __syncthreads();
    }
  }

  float* dst = a.init != nullptr ? a.out + ob
                                 : a.partial + (u * a.B + b) * slab;
  // the upper elements (and gram_and_vec's v row) from their accumulators
#pragma unroll
  for (int m = 0; m < BIG_M; ++m) {
    const int I = I0 + (m >> 2) * BIG_H + ty * 4 + (m & 3);
    if (I >= a.qL) continue;
#pragma unroll
    for (int k = 0; k < BIG_M; ++k) {
      const int J = J0 + (k >> 2) * BIG_H + tx * 4 + (k & 3);
      if (J < a.qR && (!sym || I >= nsym || I <= J))
        dst[(long long)I * a.qR + J] = acc[m][k];
    }
  }
  // their mirror (J, I), I < J, through a transpose in shared memory, one
  // half of the tile's rows at a time
  if (sym && ti <= tj) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      __syncthreads();                           // sm is free
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int k = 0; k < BIG_M; ++k)
          sm[((k >> 2) * BIG_H + tx * 4 + (k & 3)) * BIG_LDT + ty * 4 + m] =
              acc[h * 4 + m][k];
      __syncthreads();
      for (int e = tid; e < BIG_T * BIG_H; e += BIG_NT) {
        const int c = e / BIG_H, r = e % BIG_H;
        const int I = I0 + h * BIG_H + r, J = J0 + c;
        if (I < J && J < a.qR && I < nsym)
          dst[(long long)J * a.qR + I] = sm[c * BIG_LDT + r];
      }
    }
  }
}

// out[i] = sum_{p = 0..P-1} partial[p, i], in that fixed order: a
// thread an element (the large tile's many elements, few splits).
__global__ void reduce_splits(const float* __restrict__ partial,
                              float* __restrict__ out, long long m, int P) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= m) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += partial[(long long)p * m + i];
  out[i] = s;
}

// out[b, s, i] = sum of partial[u, b, i] over segment s's units
// u = first[s] .. first[s+1]-1, in that fixed order: a thread an element.
__global__ void reduce_units(const float* __restrict__ partial,
                             const int* __restrict__ first,
                             float* __restrict__ out, int B, int S,
                             long long m) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)B * S * m) return;
  const long long e = i % m;
  const int s = (int)((i / m) % S);
  const long long b = i / ((long long)S * m);
  float acc = 0.f;
  for (int u = first[s]; u < first[s + 1]; ++u)
    acc += partial[((long long)u * B + b) * m + e];
  out[i] = acc;
}

// The same sums a warp an element (the small kernel's few elements, up
// to ~1000 partials each): the lanes load 128 partials a step, the next
// 128 in flight, and every lane adds them one by one in order from
// shuffles -- the one-thread loop's exact sequence, not a chain of
// dependent L2 loads.  sum_{j < count} p[j * stride], j = 0, 1, ...
constexpr int RED_WARPS = 8;

__device__ __forceinline__ float ordered_sum(const float* __restrict__ p,
                                             long long stride, int count,
                                             int lane) {
  float s = 0.f;
  float v[4], nv[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = 32 * q + lane;
    v[q] = j < count ? p[j * stride] : 0.f;
  }
  for (int j0 = 0; j0 < count; j0 += 128) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + 128 + 32 * q + lane;
      nv[q] = j < count ? p[j * stride] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const float x = __shfl_sync(FULL, v[q], t);
        if (j0 + 32 * q + t < count) s += x;
      }
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = nv[q];
  }
  return s;
}

__global__ void __launch_bounds__(RED_WARPS * 32)
reduce_splits_warp(const float* __restrict__ partial, float* __restrict__ out,
                   long long m, int P) {
  const long long i = (long long)blockIdx.x * RED_WARPS + (threadIdx.x >> 5);
  if (i >= m) return;
  const int lane = threadIdx.x & 31;
  const float s = ordered_sum(partial + i, m, P, lane);
  if (lane == 0) out[i] = s;
}

__global__ void __launch_bounds__(RED_WARPS * 32)
reduce_units_warp(const float* __restrict__ partial,
                  const int* __restrict__ first, float* __restrict__ out,
                  int B, int S, long long m) {
  const long long i = (long long)blockIdx.x * RED_WARPS + (threadIdx.x >> 5);
  if (i >= (long long)B * S * m) return;
  const int lane = threadIdx.x & 31;
  const long long e = i % m;
  const int s = (int)((i / m) % S);
  const long long b = i / ((long long)S * m);
  const float acc = ordered_sum(partial + ((long long)first[s] * B + b) * m + e,
                                (long long)B * m, first[s + 1] - first[s],
                                lane);
  if (lane == 0) out[i] = acc;
}

// Configurations (config_of, unchanged from the first design): SMALL --
// both widths <= 16 -- runs seg_gram_small; THIN -- pair with qL <= 8 --
// seg_gram_thin; every wider output seg_gram_big.  Rows per unit stay
// the first design's, so every form keeps its unit partition and with
// it its addition order.
constexpr long long SMALL_RS = 1024, THIN_RS = 2048, BIG_RS = 16384;

enum Config { SMALL = 0, THIN = 1, BIG = 2 };

Config config_of(int qL, int qR) {
  if (qL <= SMALL_MAX && qR <= SMALL_MAX) return SMALL;
  if (qL <= THIN_MAX) return THIN;
  return BIG;
}

long long rows_of(Config c) {
  return c == SMALL ? SMALL_RS : (c == THIN ? THIN_RS : BIG_RS);
}

// pair's thin kernel at its qL: a block of up to THIN_WARPS stripes of
// one unit.
cudaError_t launch_thin(const Args& a, long long units, cudaStream_t st) {
  const int stripes = (a.qR + THIN_STRIPE - 1) / THIN_STRIPE;
  const int warps = stripes < THIN_WARPS ? stripes : THIN_WARPS;
  const dim3 grid((unsigned)units, (stripes + warps - 1) / warps, a.B);
  const int threads = 32 * warps;
  switch (a.qL) {
    case 1: seg_gram_thin<1><<<grid, threads, 0, st>>>(a); break;
    case 2: seg_gram_thin<2><<<grid, threads, 0, st>>>(a); break;
    case 3: seg_gram_thin<3><<<grid, threads, 0, st>>>(a); break;
    case 4: seg_gram_thin<4><<<grid, threads, 0, st>>>(a); break;
    case 5: seg_gram_thin<5><<<grid, threads, 0, st>>>(a); break;
    case 6: seg_gram_thin<6><<<grid, threads, 0, st>>>(a); break;
    case 7: seg_gram_thin<7><<<grid, threads, 0, st>>>(a); break;
    case 8: seg_gram_thin<8><<<grid, threads, 0, st>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int BUILDER>
cudaError_t launch(const Args& a, Config c, long long units,
                   cudaStream_t st) {
  if (c == SMALL) {
    const dim3 grid((unsigned)((units + SMALL_WARPS - 1) / SMALL_WARPS), 1,
                    a.B);
    const int slots = (a.qL * a.qR + 31) / 32;
    if (slots <= 1)
      seg_gram_small<BUILDER, 1><<<grid, SMALL_WARPS * 32, 0, st>>>(a);
    else if (slots <= 2)
      seg_gram_small<BUILDER, 2><<<grid, SMALL_WARPS * 32, 0, st>>>(a);
    else if (slots <= 4)
      seg_gram_small<BUILDER, 4><<<grid, SMALL_WARPS * 32, 0, st>>>(a);
    else
      seg_gram_small<BUILDER, 8><<<grid, SMALL_WARPS * 32, 0, st>>>(a);
  } else if (c == THIN) {
    // every other builder has qL >= qR, so a thin output is pair's
    if constexpr (BUILDER != PAIR) return cudaErrorInvalidValue;
    else return launch_thin(a, units, st);
  } else {
    const dim3 grid((unsigned)units, tiles_big(a.qL, a.qR, a.sym != 0), a.B);
    seg_gram_big<BUILDER><<<grid, BIG_NT, 0, st>>>(a);
  }
  return cudaGetLastError();
}

cudaError_t dispatch(int builder, const Args& a, Config c, long long units,
                     cudaStream_t st) {
  switch (builder) {
    case DESIGN: return launch<DESIGN>(a, c, units, st);
    case GRAM_AND_VEC: return launch<GRAM_AND_VEC>(a, c, units, st);
    case RESIDUAL: return launch<RESIDUAL>(a, c, units, st);
    case RESIDUAL_MEAT: return launch<RESIDUAL_MEAT>(a, c, units, st);
    case RESIDUAL_DIRECT: return launch<RESIDUAL_DIRECT>(a, c, units, st);
    case IV: return launch<IV>(a, c, units, st);
    case IV_MEAT: return launch<IV_MEAT>(a, c, units, st);
    case PAIR: return launch<PAIR>(a, c, units, st);
    default: return cudaErrorInvalidValue;
  }
}

Args base_args(long long n, int dX, const float* X, const float* a0,
               const float* a1, const float* a2, const float* a3,
               const float* a4, const float* theta, const float* w,
               int qL, int qR) {
  Args a = {};
  a.n = n; a.dX = dX; a.X = X;
  a.a0 = a0; a.a1 = a1; a.a2 = a2; a.a3 = a3; a.a4 = a4;
  a.theta = theta; a.w = w; a.S = 1; a.B = 1;
  a.qL = qL; a.qR = qR;
  return a;
}

}  // namespace

extern "C" {

// Rows per unit for a (qL, qR) output: the wrapper sizes the partial
// buffer from it (ceil(n / rs) splits at S = 1; at most
// ceil(n / rs) + S units for a segment walk).
long long seg_gram_split_rows(int qL, int qR) {
  return rows_of(config_of(qL, qR));
}

// The kernel a (qL, qR) output runs on: 0 small, 1 thin, 2 the large tile.
int seg_gram_config(int qL, int qR) { return (int)config_of(qL, qR); }

// One segment, fixed row splits, a leading batch of B.  parts: 1 runs
// the tile kernel, 2 the second pass, 3 both (every caller; kernel.py's
// stage() picks one to time it alone), here and in seg_gram_walk.
int seg_gram_run(int builder, long long n, int dX, const float* X,
                 const float* a0, const float* a1, const float* a2,
                 const float* a3, const float* a4, long long a_bstride,
                 const float* theta, long long theta_bstride,
                 const float* w, long long w_bstride,
                 int B, int qL, int qR,
                 float* partial, int P, float* out, void* stream,
                 int parts) {
  if (builder == PAIR) return (int)cudaErrorInvalidValue;
  Args a = base_args(n, dX, X, a0, a1, a2, a3, a4, theta, w, qL, qR);
  a.a_bstride = a_bstride; a.theta_bstride = theta_bstride;
  a.w_bstride = w_bstride; a.B = B; a.partial = partial;
  a.sym = 1;                 // every one-segment builder is symmetric
  const Config c = config_of(qL, qR);
  a.rs = rows_of(c);
  if (P != (int)((n + a.rs - 1) / a.rs > 0 ? (n + a.rs - 1) / a.rs : 1))
    return (int)cudaErrorInvalidValue;
  a.units = P;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = (parts & 1) ? dispatch(builder, a, c, P, st) : cudaSuccess;
  if (err != cudaSuccess) return (int)err;
  const long long m = (long long)B * qL * qR;
  if (m > 0 && (parts & 2)) {
    if (c == SMALL)
      reduce_splits_warp<<<(unsigned)((m + RED_WARPS - 1) / RED_WARPS),
                           RED_WARPS * 32, 0, st>>>(partial, out, m, P);
    else
      reduce_splits<<<(unsigned)((m + 255) / 256), 256, 0, st>>>(partial, out,
                                                                 m, P);
    err = cudaGetLastError();
  }
  return (int)err;
}

// A segment walk over the unit table of kernel.py's walk_plan: W units,
// segment s owning units first[s] .. first[s+1]-1, and a leading batch
// of B (the scalars, w and theta at their batch strides).  Y / dY are
// PAIR's V; pair_sym says that V is U (the same rows, qL = qR), so that
// PAIR's Gram is symmetric -- and, with init, that init is.  With init
// (B, S, qL, qR) the plan must be unsplit (W = S, unit s = segment s):
// the blocks start from init and write to out; else they write partial
// (W, B, qL, qR) and reduce_units sums each segment's units in order
// into out (B, S, qL, qR).
int seg_gram_walk(int builder, long long n, int dX, const float* X,
                  int dY, const float* Y,
                  const float* a0, const float* a1, const float* a2,
                  const float* a3, const float* a4, long long a_bstride,
                  const float* theta, long long theta_bstride,
                  const float* w, long long w_bstride,
                  const long long* perm, const int* unit_seg,
                  const long long* unit_lo, const long long* unit_hi,
                  const int* first, int W, int S, int B, int qL, int qR,
                  int pair_sym, const float* init, float* partial,
                  float* out, void* stream, int parts) {
  if ((builder == PAIR) != (Y != nullptr)) return (int)cudaErrorInvalidValue;
  if (pair_sym && (builder != PAIR || qL != qR))
    return (int)cudaErrorInvalidValue;
  if (init != nullptr && W != S) return (int)cudaErrorInvalidValue;
  if (W < 1 || S < 1 || B < 1) return (int)cudaErrorInvalidValue;
  Args a = base_args(n, dX, X, a0, a1, a2, a3, a4, theta, w, qL, qR);
  a.a_bstride = a_bstride; a.theta_bstride = theta_bstride;
  a.w_bstride = w_bstride; a.B = B;
  a.dY = dY; a.Y = Y;
  a.perm = perm; a.unit_seg = unit_seg; a.unit_lo = unit_lo;
  a.unit_hi = unit_hi; a.S = S; a.init = init; a.partial = partial;
  a.out = out;
  a.sym = builder != PAIR || pair_sym;
  const Config c = config_of(qL, qR);
  a.rs = rows_of(c);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  a.units = W;
  cudaError_t err = (parts & 1) ? dispatch(builder, a, c, W, st) : cudaSuccess;
  if (err != cudaSuccess || init != nullptr) return (int)err;
  const long long m = (long long)qL * qR;
  if (m > 0 && (parts & 2)) {
    const long long total = (long long)B * S * m;
    if (c == SMALL)
      reduce_units_warp<<<(unsigned)((total + RED_WARPS - 1) / RED_WARPS),
                          RED_WARPS * 32, 0, st>>>(partial, first, out, B, S,
                                                   m);
    else
      reduce_units<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
          partial, first, out, B, S, m);
    err = cudaGetLastError();
  }
  return (int)err;
}

// The large tile's launched output tiles for a (qL, qR) output, as
// tiles_big / tile_of give them (kernel.py's tile_schedule lists the same):
// the count, and (ti[y], tj[y]) for y < min(count, cap).
int seg_gram_tile_schedule(int qL, int qR, int sym, int* ti, int* tj,
                           int cap) {
  const int count = tiles_big(qL, qR, sym != 0);
  for (int y = 0; y < count && y < cap; ++y)
    tile_of(y, qR, sym != 0, ti[y], tj[y]);
  return count;
}

const char* seg_gram_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
