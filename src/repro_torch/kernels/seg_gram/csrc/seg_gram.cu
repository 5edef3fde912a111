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
// Grid.  blockIdx = (unit u, output tile, batch b).  Each block owns one
// TI x TJ tile of the (qL, qR) output of its segment and batch element,
// walks its unit's rows in chunks of CH staged in shared memory -- L-side
// values with w applied, R-side values -- and accumulates with fp32 FMA
// on the CUDA cores, MI x MJ outputs per thread.  No tensor cores: TF32
// would change the numerics.  The ragged tail is masked in the load.
// rs is fixed by the tile configuration and never by n, so appending zero
// rows (or rows with seg = -1) leaves every unit's addition sequence --
// and the result -- bitwise unchanged.
//
// Reduction.  Unit u writes its partial to partial[u]; a second kernel
// sums each segment's units in their fixed order.  No atomics: a run
// repeats bitwise.  The partial buffer holds at most ceil(n/rs) + S
// units of (qL, qR).  With init (the store's standing accumulators) the
// walk is not split: one unit per segment, whose accumulators start from
// init[s] and are written straight to the output, so an ingest of rows A
// then rows B runs exactly the addition sequence of one pass over A + B
// -- incremental ingest is bitwise the one-shot pass.  init is only read.
//
// Batch.  The leading batch dimension carries the k folds of the
// "parallel" cross-fit engine -- and, for the bootstrap, R replicates
// times k folds -- in one launch: w, the per-row scalars and the meats'
// theta come in at batch strides (0: shared), X (and PAIR's Y) is shared.
// Each batch element's arithmetic is the same whatever the batch size.
//
// Bound on the H100 (3.35 TB/s HBM, ~67 TFLOP/s fp32 FMA).  At q ~ 500
// the Gram is 2*n*qL*qR FLOP for n*q*4 bytes read -- about 250 FLOP/byte,
// compute-bound: ~7.5 ms per fold at n = 1e6.  The final-stage forms
// (q <= 3), the sweep's gradient terms (qL <= 5) and its per-segment
// final stage read their operands once and are bandwidth-bound.  This
// first design reads operands from shared memory for every FMA (vector
// loads, 0.5 loads per FMA on the 64x64 tile), computes both triangles
// of a symmetric Gram, and reaches neither bound; both are left to a
// later PR.

#include <cuda_runtime.h>
#include <stdint.h>

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
  int B;
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

// M consecutive floats of shared memory into registers, as float4 /
// float2 loads where the width allows (the tile layouts keep them
// aligned).
template <int M>
__device__ __forceinline__ void load_vec(float (&v)[M], const float* p) {
  if constexpr (M % 4 == 0) {
#pragma unroll
    for (int q = 0; q < M / 4; ++q) {
      const float4 t = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = t.x; v[4 * q + 1] = t.y; v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else if constexpr (M == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
#pragma unroll
    for (int m = 0; m < M; ++m) v[m] = p[m];
  }
}

template <int BUILDER, int TI, int TJ, int MI, int MJ, int CH>
__global__ void __launch_bounds__((TI / MI) * (TJ / MJ))
seg_gram_kernel(Args a) {
  constexpr int TX = TJ / MJ;        // threads along J
  constexpr int NT = (TI / MI) * TX;
  __shared__ __align__(16) float Ls[CH][TI];
  __shared__ __align__(16) float Rs[CH][TJ];
  __shared__ float sCL[CH], sCL2[CH], sEL[CH], sCR[CH], sCR2[CH], sER[CH];
  __shared__ float sW[CH];
  __shared__ long long sRow[CH];

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
  const int tilesJ = (a.qR + TJ - 1) / TJ;
  const int I0 = (blockIdx.y / tilesJ) * TI;
  const int J0 = (blockIdx.y % tilesJ) * TJ;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;
  const long long slab = (long long)a.qL * a.qR;
  // this (batch element, segment)'s slab of init / out: (B, S, qL, qR)
  const long long ob = ((long long)b * a.S + s) * slab;

  float acc[MI][MJ];
#pragma unroll
  for (int m = 0; m < MI; ++m)
#pragma unroll
    for (int k = 0; k < MJ; ++k) {
      const int I = I0 + ty * MI + m, J = J0 + tx * MJ + k;
      acc[m][k] = (a.init != nullptr && I < a.qL && J < a.qR)
                      ? a.init[ob + (long long)I * a.qR + J] : 0.f;
    }

  const float* wb = a.w != nullptr ? a.w + (long long)b * a.w_bstride : nullptr;
  for (long long c0 = lo; c0 < hi; c0 += CH) {
    for (int r = tid; r < CH; r += NT) {
      const long long pos = c0 + r;
      RowScalars sc = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float w = 0.f;
      long long row = -1;
      if (pos < hi) {
        row = a.perm != nullptr ? a.perm[pos] : pos;
        sc = row_scalars<BUILDER>(a, b, row);
        w = wb != nullptr ? wb[row] : 1.f;
      }
      sCL[r] = sc.c1L; sCL2[r] = sc.c2L; sEL[r] = sc.eL;
      sCR[r] = sc.c1R; sCR2[r] = sc.c2R; sER[r] = sc.eR;
      sW[r] = w;
      sRow[r] = row;
    }
    __syncthreads();
    if constexpr (TI == TJ) {
      // square tiles: one pass stages a row's L and R values together
      for (int e = tid; e < CH * TI; e += NT) {
        const int r = e / TI, c = e % TI;
        const long long row = sRow[r];
        float lv = 0.f, rv = 0.f;
        if (row >= 0) {
          const int I = I0 + c, J = J0 + c;
          if constexpr (BUILDER == PAIR) {
            if (I < a.qL) lv = a.X[row * a.dX + I] * sW[r];
            if (J < a.qR) rv = a.Y[row * a.dY + J];
          } else {
            const float* xr = a.X + row * a.dX;
            if (I < a.qL)
              lv = colval<BUILDER>(I, xr, a.dX, sCL[r], sCL2[r], sEL[r]) *
                   sW[r];
            if (J < a.qR)
              rv = colval<BUILDER>(J, xr, a.dX, sCR[r], sCR2[r], sER[r]);
          }
        }
        Ls[r][c] = lv;
        Rs[r][c] = rv;
      }
    } else {
      for (int e = tid; e < CH * TI; e += NT) {
        const int r = e / TI, c = e % TI;
        const long long row = sRow[r];
        const int I = I0 + c;
        float v = 0.f;
        if (row >= 0 && I < a.qL) {
          if constexpr (BUILDER == PAIR)
            v = a.X[row * a.dX + I];
          else
            v = colval<BUILDER>(I, a.X + row * a.dX, a.dX, sCL[r], sCL2[r],
                                sEL[r]);
          v *= sW[r];
        }
        Ls[r][c] = v;
      }
      for (int e = tid; e < CH * TJ; e += NT) {
        const int r = e / TJ, c = e % TJ;
        const long long row = sRow[r];
        const int J = J0 + c;
        float v = 0.f;
        if (row >= 0 && J < a.qR) {
          if constexpr (BUILDER == PAIR)
            v = a.Y[row * a.dY + J];
          else
            v = colval<BUILDER>(J, a.X + row * a.dX, a.dX, sCR[r], sCR2[r],
                                sER[r]);
        }
        Rs[r][c] = v;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < CH; ++r) {
      float lv[MI], rv[MJ];
      load_vec<MI>(lv, &Ls[r][ty * MI]);
      load_vec<MJ>(rv, &Rs[r][tx * MJ]);
#pragma unroll
      for (int m = 0; m < MI; ++m)
#pragma unroll
        for (int k = 0; k < MJ; ++k) acc[m][k] = fmaf(lv[m], rv[k], acc[m][k]);
    }
    __syncthreads();
  }

  float* dst = a.init != nullptr
                   ? a.out + ob
                   : a.partial + (u * a.B + b) * slab;
#pragma unroll
  for (int m = 0; m < MI; ++m) {
    const int I = I0 + ty * MI + m;
    if (I >= a.qL) continue;
#pragma unroll
    for (int k = 0; k < MJ; ++k) {
      const int J = J0 + tx * MJ + k;
      if (J < a.qR) dst[(long long)I * a.qR + J] = acc[m][k];
    }
  }
}

// out[i] = sum_{p = 0..P-1} partial[p, i], in that fixed order.
__global__ void reduce_splits(const float* __restrict__ partial,
                              float* __restrict__ out, long long m, int P) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= m) return;
  float s = 0.f;
  for (int p = 0; p < P; ++p) s += partial[(long long)p * m + i];
  out[i] = s;
}

// out[b, s, i] = sum of partial[u, b, i] over segment s's units
// u = first[s] .. first[s+1]-1, in that fixed order.
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

// Tile configurations.  Small outputs (the final stage's 3x3): one
// output per thread, long row chunks.  Thin outputs (qL <= 8: the
// sweep's gradient terms, 5 x 501 and 1 x 501): all qL rows and two
// columns per thread on an 8 x 256 tile.  Large outputs (the 502-wide
// nuisance Grams, the store's 503- and 1006-wide accumulators): 4x4 per
// thread on a 64x64 tile.
constexpr int SMALL_T = 16, SMALL_CH = 64;
constexpr int THIN_TI = 8, THIN_TJ = 256, THIN_MJ = 2, THIN_CH = 32;
constexpr int BIG_T = 64, BIG_M = 4, BIG_CH = 16;
constexpr long long SMALL_RS = 1024, THIN_RS = 2048, BIG_RS = 16384;

enum Config { SMALL = 0, THIN = 1, BIG = 2 };

Config config_of(int qL, int qR) {
  if (qL <= SMALL_T && qR <= SMALL_T) return SMALL;
  if (qL <= THIN_TI) return THIN;
  return BIG;
}

long long rows_of(Config c) {
  return c == SMALL ? SMALL_RS : (c == THIN ? THIN_RS : BIG_RS);
}

template <int TI, int TJ>
dim3 grid_of(long long units, const Args& a) {
  return dim3((unsigned)units,
              ((a.qL + TI - 1) / TI) * ((a.qR + TJ - 1) / TJ), a.B);
}

template <int BUILDER>
cudaError_t launch(const Args& a, Config c, long long units,
                   cudaStream_t st) {
  if (c == SMALL) {
    seg_gram_kernel<BUILDER, SMALL_T, SMALL_T, 1, 1, SMALL_CH>
        <<<grid_of<SMALL_T, SMALL_T>(units, a), SMALL_T * SMALL_T, 0, st>>>(a);
  } else if (c == THIN) {
    seg_gram_kernel<BUILDER, THIN_TI, THIN_TJ, THIN_TI, THIN_MJ, THIN_CH>
        <<<grid_of<THIN_TI, THIN_TJ>(units, a), THIN_TJ / THIN_MJ, 0, st>>>(a);
  } else {
    seg_gram_kernel<BUILDER, BIG_T, BIG_T, BIG_M, BIG_M, BIG_CH>
        <<<grid_of<BIG_T, BIG_T>(units, a), (BIG_T / BIG_M) * (BIG_T / BIG_M),
           0, st>>>(a);
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

// One segment, fixed row splits, a leading batch of B.
int seg_gram_run(int builder, long long n, int dX, const float* X,
                 const float* a0, const float* a1, const float* a2,
                 const float* a3, const float* a4, long long a_bstride,
                 const float* theta, long long theta_bstride,
                 const float* w, long long w_bstride,
                 int B, int qL, int qR,
                 float* partial, int P, float* out, void* stream) {
  if (builder == PAIR) return (int)cudaErrorInvalidValue;
  Args a = base_args(n, dX, X, a0, a1, a2, a3, a4, theta, w, qL, qR);
  a.a_bstride = a_bstride; a.theta_bstride = theta_bstride;
  a.w_bstride = w_bstride; a.B = B; a.partial = partial;
  const Config c = config_of(qL, qR);
  a.rs = rows_of(c);
  if (P != (int)((n + a.rs - 1) / a.rs > 0 ? (n + a.rs - 1) / a.rs : 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = dispatch(builder, a, c, P, st);
  if (err != cudaSuccess) return (int)err;
  const long long m = (long long)B * qL * qR;
  if (m > 0) {
    reduce_splits<<<(unsigned)((m + 255) / 256), 256, 0, st>>>(partial, out, m, P);
    err = cudaGetLastError();
  }
  return (int)err;
}

// A segment walk over the unit table of kernel.py's walk_plan: W units,
// segment s owning units first[s] .. first[s+1]-1, and a leading batch
// of B (the scalars, w and theta at their batch strides).  Y / dY are
// PAIR's V.  With init (B, S, qL, qR) the plan must be unsplit (W = S,
// unit s = segment s): the blocks start from init and write to out;
// else they write partial (W, B, qL, qR) and reduce_units sums each
// segment's units in order into out (B, S, qL, qR).
int seg_gram_walk(int builder, long long n, int dX, const float* X,
                  int dY, const float* Y,
                  const float* a0, const float* a1, const float* a2,
                  const float* a3, const float* a4, long long a_bstride,
                  const float* theta, long long theta_bstride,
                  const float* w, long long w_bstride,
                  const long long* perm, const int* unit_seg,
                  const long long* unit_lo, const long long* unit_hi,
                  const int* first, int W, int S, int B, int qL, int qR,
                  const float* init, float* partial, float* out,
                  void* stream) {
  if ((builder == PAIR) != (Y != nullptr)) return (int)cudaErrorInvalidValue;
  if (init != nullptr && W != S) return (int)cudaErrorInvalidValue;
  if (W < 1 || S < 1 || B < 1) return (int)cudaErrorInvalidValue;
  Args a = base_args(n, dX, X, a0, a1, a2, a3, a4, theta, w, qL, qR);
  a.a_bstride = a_bstride; a.theta_bstride = theta_bstride;
  a.w_bstride = w_bstride; a.B = B;
  a.dY = dY; a.Y = Y;
  a.perm = perm; a.unit_seg = unit_seg; a.unit_lo = unit_lo;
  a.unit_hi = unit_hi; a.S = S; a.init = init; a.partial = partial;
  a.out = out;
  const Config c = config_of(qL, qR);
  a.rs = rows_of(c);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err = dispatch(builder, a, c, W, st);
  if (err != cudaSuccess || init != nullptr) return (int)err;
  const long long m = (long long)qL * qR;
  if (m > 0) {
    const long long total = (long long)B * S * m;
    reduce_units<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        partial, first, out, B, S, m);
    err = cudaGetLastError();
  }
  return (int)err;
}

const char* seg_gram_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
