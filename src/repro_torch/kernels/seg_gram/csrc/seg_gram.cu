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
//
// build_fold_weighted (G[k] = sum_n Wk[k,n] d_n d_n^T, which the TPU
// kernel gets by widening L to the (n, k*q) kron product) is DESIGN with
// Wk as a batched row weight: no kron operand exists here.
//
// Every builder is "one or two scaled copies of X, plus an optional
// appended column", so the per-row scalars (rt, ry, rz, e, wg, v) are
// formed once per row when a chunk of rows is staged, and the
// per-element work is one multiply.  IV is the one builder with two
// copies: column i < dX of its row is rz * phi_i, column dX + i is
// rt * phi_i, column 2 dX is ry.
//
// Grid.  blockIdx = (row split p, output tile, batch b).  Each block owns
// one TILE x TILE tile of the (S*qL, qR) output of batch b and the rows
// [p*rs, (p+1)*rs).  It walks its rows in chunks of CH staged in shared
// memory -- L-side values with w[b,n]*[seg_n = s] applied, R-side values
// -- and accumulates with fp32 FMA on the CUDA cores, TM x TM outputs per
// thread.  No tensor cores: TF32 would change the numerics.  The ragged
// tail and seg = -1 rows are masked in the load; the row arrays are not
// padded or copied.  The split size rs is fixed by the tile configuration
// and never by n, so appending zero rows (seg = -1, w = 0) leaves every
// split's addition sequence -- and the result -- bitwise unchanged.
//
// Reduction.  Split p writes its partial to partial[p]; a second kernel
// sums the splits in the fixed order 0..P-1.  No atomics: a run repeats
// bitwise.
//
// Batch.  The leading batch dimension carries the k folds of the
// "parallel" cross-fit engine -- and, for the bootstrap, R replicates
// times k folds -- in one launch: w, the per-row scalars and the meats'
// theta come in at batch strides (0: shared), X is shared.  Each batch
// element's arithmetic is the same whatever the batch size.
//
// Bound on the H100 (3.35 TB/s HBM, ~67 TFLOP/s fp32 FMA).  At q ~ 500
// the Gram is 2*n*qL*qR FLOP for n*q*4 bytes read -- about 250 FLOP/byte,
// compute-bound: ~7.5 ms per fold at n = 1e6.  The final-stage forms
// (q <= 3) read ~24 MB and are bandwidth-bound at ~7 us.  This first
// design reads operands from shared memory for every FMA (float4 loads,
// 0.5 loads per FMA on the 64x64 tile) and reaches neither bound; the
// S > 1 path still multiplies the zeros of the one-hot expansion (S times
// the useful work), as the TPU kernel did.  Both are left to a later PR.
// The bootstrap's fold-weighted launches (batch R*k up to 125 at q = 502)
// have the design form's bound times R; its residual_direct, iv and
// meat forms (q <= 5) are bandwidth-bound like the final-stage forms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Builder {
  DESIGN = 0, GRAM_AND_VEC = 1, RESIDUAL = 2, RESIDUAL_MEAT = 3,
  RESIDUAL_DIRECT = 4, IV = 5, IV_MEAT = 6
};

struct Args {
  long long n;
  int dX;                  // columns of X
  const float* X;          // (n, dX) row-major
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
  const int* seg;          // (n,) segment ids, or null for one segment
  int S;
  int qL, qR;              // per-segment L width, R width
  long long rs;            // rows per split
  int B;
  float* partial;          // (P, B, S*qL, qR)
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

template <int BUILDER, int TILE, int TM, int CH>
__global__ void __launch_bounds__((TILE / TM) * (TILE / TM))
seg_gram_kernel(Args a) {
  constexpr int TPR = TILE / TM;   // threads along one side of the tile
  constexpr int NT = TPR * TPR;
  __shared__ __align__(16) float Ls[CH][TILE];
  __shared__ __align__(16) float Rs[CH][TILE];
  __shared__ float sCL[CH], sCL2[CH], sEL[CH], sCR[CH], sCR2[CH], sER[CH];
  __shared__ float sW[CH];
  __shared__ int sSeg[CH];
  __shared__ int colS[TILE], colI[TILE];

  const long long p = blockIdx.x;
  const int tile = blockIdx.y;
  const int b = blockIdx.z;
  const int SqL = a.S * a.qL;
  const int tilesJ = (a.qR + TILE - 1) / TILE;
  const int I0 = (tile / tilesJ) * TILE;
  const int J0 = (tile % tilesJ) * TILE;
  const int tid = threadIdx.x;

  for (int c = tid; c < TILE; c += NT) {
    const int I = I0 + c;
    colS[c] = I < SqL ? I / a.qL : -2;  // -2 matches no row: past the output
    colI[c] = I < SqL ? I % a.qL : 0;
  }

  const int ty = tid / TPR, tx = tid % TPR;
  float acc[TM][TM];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int k = 0; k < TM; ++k) acc[m][k] = 0.f;

  const long long r0 = p * a.rs;
  const long long r1 = a.n < r0 + a.rs ? a.n : r0 + a.rs;
  const float* wb = a.w != nullptr ? a.w + (long long)b * a.w_bstride : nullptr;
  __syncthreads();

  for (long long c0 = r0; c0 < r1; c0 += CH) {
    for (int r = tid; r < CH; r += NT) {
      const long long row = c0 + r;
      RowScalars sc = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float w = 0.f;
      int sg = -1;
      if (row < r1) {
        sc = row_scalars<BUILDER>(a, b, row);
        w = wb != nullptr ? wb[row] : 1.f;
        sg = a.seg != nullptr ? a.seg[row] : 0;
      }
      sCL[r] = sc.c1L; sCL2[r] = sc.c2L; sEL[r] = sc.eL;
      sCR[r] = sc.c1R; sCR2[r] = sc.c2R; sER[r] = sc.eR;
      sW[r] = w;
      sSeg[r] = sg;
    }
    __syncthreads();
    for (int e = tid; e < CH * TILE; e += NT) {
      const int r = e / TILE, c = e % TILE;
      const long long row = c0 + r;
      float lv = 0.f, rv = 0.f;
      if (row < r1) {
        const float* xr = a.X + row * a.dX;
        if (sSeg[r] == colS[c])
          lv = colval<BUILDER>(colI[c], xr, a.dX, sCL[r], sCL2[r], sEL[r]) *
               sW[r];
        const int J = J0 + c;
        if (J < a.qR)
          rv = colval<BUILDER>(J, xr, a.dX, sCR[r], sCR2[r], sER[r]);
      }
      Ls[r][c] = lv;
      Rs[r][c] = rv;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < CH; ++r) {
      float lv[TM], rv[TM];
      if constexpr (TM == 4) {
        const float4 l4 = *reinterpret_cast<const float4*>(&Ls[r][ty * TM]);
        const float4 r4 = *reinterpret_cast<const float4*>(&Rs[r][tx * TM]);
        lv[0] = l4.x; lv[1] = l4.y; lv[2] = l4.z; lv[3] = l4.w;
        rv[0] = r4.x; rv[1] = r4.y; rv[2] = r4.z; rv[3] = r4.w;
      } else {
#pragma unroll
        for (int m = 0; m < TM; ++m) {
          lv[m] = Ls[r][ty * TM + m];
          rv[m] = Rs[r][tx * TM + m];
        }
      }
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int k = 0; k < TM; ++k) acc[m][k] = fmaf(lv[m], rv[k], acc[m][k]);
    }
    __syncthreads();
  }

  float* out = a.partial + (p * a.B + b) * (long long)SqL * a.qR;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int I = I0 + ty * TM + m;
    if (I >= SqL) continue;
#pragma unroll
    for (int k = 0; k < TM; ++k) {
      const int J = J0 + tx * TM + k;
      if (J < a.qR) out[(long long)I * a.qR + J] = acc[m][k];
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

// Small outputs (the final stage's 3x3): one output per thread, long
// row chunks.  Large outputs (the 502-wide nuisance Grams): 4x4 per
// thread on a 64x64 tile.
constexpr int SMALL_TILE = 16, SMALL_TM = 1, SMALL_CH = 64;
constexpr int BIG_TILE = 64, BIG_TM = 4, BIG_CH = 16;
constexpr long long SMALL_RS = 1024, BIG_RS = 16384;

template <int BUILDER>
cudaError_t launch(const Args& a, bool small, int P, cudaStream_t st) {
  const int SqL = a.S * a.qL;
  if (small) {
    const int T = SMALL_TILE;
    dim3 grid(P, ((SqL + T - 1) / T) * ((a.qR + T - 1) / T), a.B);
    seg_gram_kernel<BUILDER, SMALL_TILE, SMALL_TM, SMALL_CH>
        <<<grid, (T / SMALL_TM) * (T / SMALL_TM), 0, st>>>(a);
  } else {
    const int T = BIG_TILE;
    dim3 grid(P, ((SqL + T - 1) / T) * ((a.qR + T - 1) / T), a.B);
    seg_gram_kernel<BUILDER, BIG_TILE, BIG_TM, BIG_CH>
        <<<grid, (T / BIG_TM) * (T / BIG_TM), 0, st>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per split for an output of (S*qL, qR): the wrapper sizes the
// partial buffer (P = ceil(n / rs) splits) from it.
long long seg_gram_split_rows(int SqL, int qR) {
  return (SqL <= SMALL_TILE && qR <= SMALL_TILE) ? SMALL_RS : BIG_RS;
}

int seg_gram_run(int builder, long long n, int dX, const float* X,
                 const float* a0, const float* a1, const float* a2,
                 const float* a3, const float* a4, long long a_bstride,
                 const float* theta, long long theta_bstride,
                 const float* w, long long w_bstride,
                 const int* seg, int S, int B, int qL, int qR,
                 float* partial, int P, float* out, void* stream) {
  Args a;
  a.n = n; a.dX = dX; a.X = X;
  a.a0 = a0; a.a1 = a1; a.a2 = a2; a.a3 = a3; a.a4 = a4;
  a.a_bstride = a_bstride; a.theta = theta; a.theta_bstride = theta_bstride;
  a.w = w; a.w_bstride = w_bstride; a.seg = seg; a.S = S;
  a.qL = qL; a.qR = qR; a.B = B; a.partial = partial;
  const int SqL = S * qL;
  a.rs = seg_gram_split_rows(SqL, qR);
  const bool small = a.rs == SMALL_RS;
  if (P != (int)((n + a.rs - 1) / a.rs > 0 ? (n + a.rs - 1) / a.rs : 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (builder) {
    case DESIGN: err = launch<DESIGN>(a, small, P, st); break;
    case GRAM_AND_VEC: err = launch<GRAM_AND_VEC>(a, small, P, st); break;
    case RESIDUAL: err = launch<RESIDUAL>(a, small, P, st); break;
    case RESIDUAL_MEAT: err = launch<RESIDUAL_MEAT>(a, small, P, st); break;
    case RESIDUAL_DIRECT:
      err = launch<RESIDUAL_DIRECT>(a, small, P, st); break;
    case IV: err = launch<IV>(a, small, P, st); break;
    case IV_MEAT: err = launch<IV_MEAT>(a, small, P, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const long long m = (long long)B * SqL * qR;
  if (m > 0) {
    reduce_splits<<<(unsigned)((m + 255) / 256), 256, 0, st>>>(partial, out, m, P);
    err = cudaGetLastError();
  }
  return (int)err;
}

const char* seg_gram_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
