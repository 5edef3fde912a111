// Chunked recurrent scans for Hopper (sm_90a): the gated-linear-attention
// (GLA) scan in "post" and RWKV-6 "bonus" modes, and the Mamba2 SSD scan.
//
// Replaces the TPU kernels of src/repro/kernels/ssm_scan/kernel.py:
//   gla_pallas (bodies _kernel_post and _kernel_bonus, shared _chunk_math)
//   ssd_pallas (body _ssd_kernel)
// and computes what they compute, chunk by chunk, all in fp32:
//
//   GLA, per chunk of C rows (q, k, w: C x Dk; v: C x Dv; S: Dk x Dv):
//     cum   = cumsum_rows(log(max(w, 1e-22)))           (per channel)
//     qt    = q * exp(cum)          post:  mask s <= t
//           = q * exp(cum - log w)  bonus: mask s <  t
//     kt    = k * exp(-cum),  kf = k * exp(cum_last - cum)
//     o     = (qt kt^T masked) v + qt S     [bonus: + (sum q*u*k) v]
//     S     = exp(cum_last) (.) S + kf^T v
//   SSD, per chunk (q, k: C x N shared by the heads of a batch row;
//   v: C x P; a: C; S: N x P):
//     cum   = cumsum(log(max(a, 1e-37)))
//     o     = (q k^T (.) tril(exp(min(cum_i - cum_j, 0)))) v
//             + (q * exp(cum)) S
//     S     = exp(cum_last) S + (k * exp(cum_last - cum))^T v
//
// Two forms of each, chosen by shape in kernel.py:
//
// The generic kernels (gla_kernel, ssd_kernel): any head size and chunk
// whose tiles fit in shared memory.  The TPU runs a grid (B*H, T/C) whose
// second axis is sequential and carries S in VMEM scratch; here one block
// of 256 threads owns one (b, h) and walks the T/C chunks itself, with S
// in shared memory, one thread per output element and one serial fp32
// dot from shared memory per output.
//
// The tiled kernels (gla_kernel_tiled, ssd_kernel_tiled): head size 64
// (Dk = Dv, N = P) and chunks 1, 2, 4, ..., 32 (the models' 16 and 32 and
// what ops._fit_chunk halves them to), 16-byte aligned rows.  A head is
// 128 threads.  A GLA chunk is three barrier-separated stages:
//   A  the chunk's raw rows (cp.async, requested while the last chunk
//      computed) become the factors: two threads a channel take the log,
//      the cumsum (the second half carries on from the first's sum
//      through a shuffle, so the sum runs in row order) and the three
//      exp factors of their rows.
//   B  the next chunk's raw rows are requested (stage A has read them);
//      the causal scores q_t k_t^T, one chain a lane over d in float4
//      loads, a warp on a 4-row x 8-column tile of pairs, K chains a lane
//      interleaved; and the readout qt S from the state before the update,
//      in registers: TT x TJ outputs a thread (4 x 4 at C = 32, 2 x 4 at
//      C = 16).  The C x 64 operand rows are swizzled per 16-byte chunk so
//      the eight A rows a warp's readout loads (and the eight aligned B
//      rows of a score tile) hit eight distinct groups of banks.
//   C  P v over the causal columns of the readout tile, o stored as
//      vectors; then the update, 8 x 4 state entries a thread, float4
//      loads of kf and v at each of the C steps.
// SSD: one block per (b, group of G = 2 heads): q and k of a chunk are
// loaded once and q k^T is computed once for the G heads (the dot does
// not depend on the head; each head's L factor is applied after it);
// each head keeps its own S, v and a (two buffers, the next chunk's
// loaded ahead), cumsum, M and o.  A chunk is two stages: q k^T with each
// head's M, k flow and the readout q S; then M v and o, and the update.
// Warp 0 of a head computes the next chunk's cumsum at the end of this
// one (lane r holds row r's log and keeps the sum after row r; it waits
// only on its own copy of a), so no stage waits on a one-warp chain.
// Shared memory a block: GLA bf16 bonus at C = 16 52,480 bytes (4 blocks
// an SM), SSD at C = 32, G = 2 108,608 (2 blocks of 256 threads).
//
// What holds them (PERF.md §6, measured on the H100).  A tiled output's
// operands come from shared memory at 1.5–3 bytes a FMA per thread (2 x 4
// readout tile: 24 bytes for 8 FMAs), against the 1 byte a FMA the SM's
// 128 bytes a clock of shared-memory return would need, and each output
// is one dependent fmaf chain.  Larger tiles on 64 threads a head, and
// warps split into readout and update roles, cut those bytes and were
// slower on the card (fewer warps, or registers at the cap); PERF.md §6
// has the variants.
//
// Numerics.  All arithmetic is fp32 FMA on the CUDA cores, expf/logf at
// full precision.  No TF32 and no tensor cores: kt = k * exp(-cum) reaches
// ~1.7e24 under the MAX_LOG_DECAY * 16 contract, and the factorised
// product needs fp32's range and mantissa.  bf16 inputs are widened on
// load; o is stored in v's dtype, the final state in fp32.  In bonus mode
// the u-weighted diagonal term sits on the (otherwise masked) diagonal of
// the score tile, so it is summed with the rest of the row.
//
// The two forms give the same bits.  Every output is one fmaf chain over
// its reduction index in the same order (d, n = 0..63; s = 0..C-1),
// starting from +0, with the same rounded operands: qt, kt, kf, q*u and
// k*flow rounded once as products, m = dot * exp(...), o = acc + inter
// (GLA) or fmaf(exp(cum_i), inter, acc) (SSD), S = fmaf(decay, S, acc),
// the cumsums in row order.  Two liberties do not change a bit: (1) the
// masked terms are skipped — the score tile is +0 above the diagonal and
// a chain's masked terms come after its live ones, and fmaf(+0, v, acc)
// is acc whenever acc is not -0 (a sum that is exactly -0 after its live
// terms could turn +0 in the generic form, which is not the data either
// form meets); (2) SSD's q k^T dot is computed once for G heads.  The
// tiled form's state and o must equal the generic form's byte for byte
// (tests/test_torch_cuda.py, tools/ab_seg_gram.py --forms scans).
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s fp32), as chip_smoke.py counts
// it.  GLA at rwkv6's batch (B 256, H 40, T 256, D 64, chunk 16; r/k/v/o
// bf16, w fp32): 2.18 GB moved, 0.651 ms, and 4.87e10 FLOP (the causal
// pairs of q_t k_t^T and P v, and qt S and kf^T v), 0.726 ms: operations
// bound.  SSD at zamba2's batch (B 256, H 64, T 256, N = P = 64, chunk
// 32, fp32): 2.47 GB, 0.736 ms, and 7.77e10 FLOP (q k^T counted once per
// batch row, the rest per head), 1.160 ms: operations bound.  A
// chunk-parallel or tensor-core form would change the summation order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;              // threads a block of the generic forms
constexpr int SMEM_MAX = 232448;     // dynamic shared memory a block may use

struct Strides {
  long long b, h, t;                 // elements; the last dim is contiguous
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// ---------------------------------------------------------------------------
// GLA, the generic form
// ---------------------------------------------------------------------------

struct GlaArgs {
  const void* q;      // (B, H, T, Dk) through sq
  const void* k;      // (B, H, T, Dk) through sk
  const void* v;      // (B, H, T, Dv) through sv
  const float* w;     // (B, H, T, Dk) through sw
  const float* u;     // (H, Dk) contiguous, bonus mode only
  void* o;            // (B, H, T, Dv) through so, v's dtype
  float* s;           // (B, H, Dk, Dv) contiguous
  Strides sq, sk, sv, sw, so;
  int B, H, T, Dk, Dv, C;
};

// Q, K, Qt, Kt, Kf, Cm: C x (Dk + 1); V: C x Dv; S: Dk x Dv;
// P: C x (C + 1); cum_last: Dk
long long gla_smem_floats(int C, int Dk, int Dv) {
  return 6LL * C * (Dk + 1) + (long long)C * Dv + (long long)Dk * Dv +
         (long long)C * (C + 1) + Dk;
}

template <typename T, bool BONUS>
__global__ void __launch_bounds__(NT) gla_kernel(GlaArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int C = a.C, Dk = a.Dk, Dv = a.Dv, LK = Dk + 1, LP = C + 1;
  float* Q = sm;
  float* K = Q + C * LK;
  float* Qt = K + C * LK;
  float* Kt = Qt + C * LK;
  float* Kf = Kt + C * LK;   // log w on load, then k * exp(cum_last - cum)
  float* Cm = Kf + C * LK;   // inclusive cumsum of log w
  float* V = Cm + C * LK;
  float* S = V + C * Dv;
  float* P = S + Dk * Dv;
  float* CL = P + C * LP;    // cum_last per channel

  const int tid = threadIdx.x;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const T* qb = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const float* wb = a.w + b * a.sw.b + h * a.sw.h;
  T* ob = static_cast<T*>(a.o) + b * a.so.b + h * a.so.h;
  const float* ub = BONUS ? a.u + (long long)h * Dk : nullptr;

  for (int e = tid; e < Dk * Dv; e += NT) S[e] = 0.f;

  for (int c0 = 0; c0 < a.T; c0 += C) {
    __syncthreads();  // the previous chunk's readers are done
    for (int e = tid; e < C * Dk; e += NT) {
      const int r = e / Dk, d = e % Dk;
      const long long t = c0 + r;
      Q[r * LK + d] = ld(qb + t * a.sq.t + d);
      K[r * LK + d] = ld(kb + t * a.sk.t + d);
      Kf[r * LK + d] = logf(fmaxf(wb[t * a.sw.t + d], 1e-22f));
    }
    for (int e = tid; e < C * Dv; e += NT) {
      const int r = e / Dv, j = e % Dv;
      V[e] = ld(vb + (long long)(c0 + r) * a.sv.t + j);
    }
    __syncthreads();

    // per-channel inclusive cumsum down the chunk
    for (int d = tid; d < Dk; d += NT) {
      float cum = 0.f;
      for (int r = 0; r < C; ++r) {
        cum += Kf[r * LK + d];
        Cm[r * LK + d] = cum;
      }
      CL[d] = cum;
    }
    __syncthreads();

    for (int e = tid; e < C * Dk; e += NT) {
      const int i = (e / Dk) * LK + e % Dk;
      const float ci = Cm[i], lw = Kf[i], q = Q[i], k = K[i];
      Qt[i] = q * expf(BONUS ? ci - lw : ci);
      Kt[i] = k * expf(-ci);
      Kf[i] = k * expf(CL[e % Dk] - ci);
    }
    __syncthreads();

    // masked scores; bonus mode puts sum_d q u k on the diagonal
    for (int e = tid; e < C * C; e += NT) {
      const int t = e / C, s = e % C;
      float acc = 0.f;
      if (BONUS ? s < t : s <= t) {
        const float* qr = Qt + t * LK;
        const float* kr = Kt + s * LK;
        for (int d = 0; d < Dk; ++d) acc = fmaf(qr[d], kr[d], acc);
      } else if (BONUS && s == t) {
        const float* qr = Q + t * LK;
        const float* kr = K + t * LK;
        for (int d = 0; d < Dk; ++d) acc = fmaf(qr[d] * ub[d], kr[d], acc);
      }
      P[t * LP + s] = acc;
    }
    __syncthreads();

    // o = P v + qt S (S before this chunk's update)
    for (int e = tid; e < C * Dv; e += NT) {
      const int t = e / Dv, j = e % Dv;
      float acc = 0.f;
      const float* pr = P + t * LP;
      for (int s = 0; s < C; ++s) acc = fmaf(pr[s], V[s * Dv + j], acc);
      float inter = 0.f;
      const float* qr = Qt + t * LK;
      for (int d = 0; d < Dk; ++d) inter = fmaf(qr[d], S[d * Dv + j], inter);
      st(ob + (long long)(c0 + t) * a.so.t + j, acc + inter);
    }
    __syncthreads();

    // S = exp(cum_last) S + kf^T v
    for (int e = tid; e < Dk * Dv; e += NT) {
      const int d = e / Dv, j = e % Dv;
      float acc = 0.f;
      for (int s = 0; s < C; ++s) acc = fmaf(Kf[s * LK + d], V[s * Dv + j], acc);
      S[e] = fmaf(expf(CL[d]), S[e], acc);
    }
  }
  __syncthreads();
  float* sb = a.s + (long long)blockIdx.x * Dk * Dv;
  for (int e = tid; e < Dk * Dv; e += NT) sb[e] = S[e];
}

// ---------------------------------------------------------------------------
// SSD, the generic form
// ---------------------------------------------------------------------------

struct SsdArgs {
  const float* q;     // (B, T, N) through sq (h unused)
  const float* k;     // (B, T, N) through sk (h unused)
  const float* v;     // (B, H, T, P) through sv
  const float* a;     // (B, H, T) through sa (the t stride only)
  float* o;           // (B, H, T, P) through so
  float* s;           // (B, H, N, P) contiguous
  Strides sq, sk, sv, sa, so;
  int B, H, T, N, P, C;
};

// Q, K: C x (N + 1); V: C x P; S: N x P; M: C x (C + 1); cum, flow: C
long long ssd_smem_floats(int C, int N, int P) {
  return 2LL * C * (N + 1) + (long long)C * P + (long long)N * P +
         (long long)C * (C + 1) + 2LL * C;
}

__global__ void __launch_bounds__(NT) ssd_kernel(SsdArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int C = a.C, N = a.N, P = a.P, LN = N + 1, LM = C + 1;
  float* Q = sm;
  float* K = Q + C * LN;
  float* V = K + C * LN;
  float* S = V + C * P;
  float* M = S + N * P;
  float* cum = M + C * LM;
  float* flow = cum + C;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const float* qb = a.q + b * a.sq.b;
  const float* kb = a.k + b * a.sk.b;
  const float* vb = a.v + b * a.sv.b + h * a.sv.h;
  const float* ab = a.a + b * a.sa.b + h * a.sa.h;
  float* ob = a.o + b * a.so.b + h * a.so.h;

  for (int e = tid; e < N * P; e += NT) S[e] = 0.f;

  for (int c0 = 0; c0 < a.T; c0 += C) {
    __syncthreads();  // the previous chunk's readers are done
    for (int e = tid; e < C * N; e += NT) {
      const int r = e / N, n = e % N;
      const long long t = c0 + r;
      Q[r * LN + n] = qb[t * a.sq.t + n];
      K[r * LN + n] = kb[t * a.sk.t + n];
    }
    for (int e = tid; e < C * P; e += NT) {
      const int r = e / P, j = e % P;
      V[e] = vb[(long long)(c0 + r) * a.sv.t + j];
    }
    for (int r = tid; r < C; r += NT)
      cum[r] = logf(fmaxf(ab[(long long)(c0 + r) * a.sa.t], 1e-37f));
    __syncthreads();
    if (tid == 0) {
      float c = 0.f;
      for (int r = 0; r < C; ++r) {
        c += cum[r];
        cum[r] = c;
      }
    }
    __syncthreads();
    for (int r = tid; r < C; r += NT) flow[r] = expf(cum[C - 1] - cum[r]);

    // M = (q k^T) (.) L, L = tril(exp(min(cum_i - cum_j, 0)))
    for (int e = tid; e < C * C; e += NT) {
      const int i = e / C, j = e % C;
      float m = 0.f;
      if (j <= i) {
        const float* qr = Q + i * LN;
        const float* kr = K + j * LN;
        for (int n = 0; n < N; ++n) m = fmaf(qr[n], kr[n], m);
        m *= expf(fminf(cum[i] - cum[j], 0.f));
      }
      M[i * LM + j] = m;
    }
    __syncthreads();

    // o = M v + exp(cum) (q S)   (S before this chunk's update)
    for (int e = tid; e < C * P; e += NT) {
      const int i = e / P, j = e % P;
      float acc = 0.f;
      const float* mr = M + i * LM;
      for (int s = 0; s < C; ++s) acc = fmaf(mr[s], V[s * P + j], acc);
      float inter = 0.f;
      const float* qr = Q + i * LN;
      for (int n = 0; n < N; ++n) inter = fmaf(qr[n], S[n * P + j], inter);
      ob[(long long)(c0 + i) * a.so.t + j] = fmaf(expf(cum[i]), inter, acc);
    }
    __syncthreads();

    // S = exp(cum_last) S + (k * flow)^T v
    const float decay = expf(cum[C - 1]);
    for (int e = tid; e < N * P; e += NT) {
      const int n = e / P, j = e % P;
      float acc = 0.f;
      for (int s = 0; s < C; ++s)
        acc = fmaf(K[s * LN + n] * flow[s], V[s * P + j], acc);
      S[e] = fmaf(decay, S[e], acc);
    }
  }
  __syncthreads();
  float* sb = a.s + (long long)blockIdx.x * N * P;
  for (int e = tid; e < N * P; e += NT) sb[e] = S[e];
}

// ---------------------------------------------------------------------------
// The tiled forms: head size 64, chunks 1, 2, 4, ..., 32
// ---------------------------------------------------------------------------

constexpr int TD = 64;               // Dk = Dv (GLA), N = P (SSD)
constexpr int TNT = 128;             // threads a head

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {   // all but the newest
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// W consecutive floats from shared memory (W = 4, 2 or 1; p aligned to W)
template <int W>
__device__ __forceinline__ void ldn(float* x, const float* p) {
  if constexpr (W == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (W == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = *p;
  }
}
template <int W>
__device__ __forceinline__ void stn(float* p, const float* x) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}
template <int W>
__device__ __forceinline__ void stn(__nv_bfloat16* p, const float* x) {
  if constexpr (W == 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&lo);
    u.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  } else if constexpr (W == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x[0], x[1]);
  } else {
    *p = __float2bfloat16_rn(x[0]);
  }
}

// Warp tiles of 4 rows x 8 columns that cover the causal pairs (column
// <= row) of a C x C score tile: in row block tb, column blocks 0 ..
// min((4 tb + 3) / 8, (C - 1) / 8); all of them, row blocks in order.
__host__ __device__ constexpr int row_tiles(int tb, int C) {
  return ((4 * tb + 3) / 8 < (C - 1) / 8 ? (4 * tb + 3) / 8 : (C - 1) / 8) + 1;
}
constexpr int score_tiles(int C) {
  int n = 0;
  for (int tb = 0; 4 * tb < C; ++tb) n += row_tiles(tb, C);
  return n;
}

// The readout tile (GLA's Qt S and P v, SSD's q S and M v: C x 64
// outputs a head): TT rows x TJ columns a thread, NTT row tiles; the
// thread tid of a head owns row tile tid % NTT and column tile tid / NTT.
// Eight row tiles make a warp's lanes 0..7, so with the swizzle below
// the eight A rows a warp reads at one step lie in eight distinct banks.
template <int C>
struct Tile {
  static constexpr int TJ = C >= 8 ? 4 : (C == 4 ? 2 : 1);
  static constexpr int TT = C * TD / (TNT * TJ) > 0 ? C * TD / (TNT * TJ) : 1;
  static constexpr int NTT = C / TT;
  static constexpr int ACTIVE = NTT * (TD / TJ);   // 128, or 64 at C = 1
  static constexpr int PTN = (C * C + 3) / 4 * 4;  // a C x C tile, padded
  static constexpr int NTILE = score_tiles(C);     // score warp tiles
};

// Float offset of 16-byte chunk c4 of row r of a swizzled C x 64 tile:
// the chunks of a row are permuted (XOR) by a 3-bit key that differs
// between the rows t0 + r of the eight readout row tiles (t0 = 0, TT,
// .., 7 TT) and between eight consecutive rows 8 m .. 8 m + 7 (a score
// warp tile's B rows), so either set of eight float4 loads of one chunk
// column hits eight distinct groups of four banks.
template <int TT>
__device__ __forceinline__ int sw(int r, int c4) {
  return r * TD + ((c4 ^ ((r / TT + (r % TT) * (8 / TT)) & 7)) << 2);
}

// The causal pairs of a lane: warp w takes tiles w, w + NW, ..; lane l of
// tile (row block tb, column block sb) the pair (4 tb + l / 8, 8 sb + l % 8)
// if its column <= its row.  (row, column); row -1 where there is none.
template <int K, int C>
struct Pairs {
  int t[K], s[K];
  __device__ __forceinline__ Pairs(int warp, int nwarps, int lane) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      t[k] = -1;
      s[k] = 0;
      int rem = warp + k * nwarps, tb = 0;
      for (; 4 * tb < C && rem >= row_tiles(tb, C); ++tb)
        rem -= row_tiles(tb, C);
      const int tt = 4 * tb + (lane >> 3), ss = 8 * rem + (lane & 7);
      if (4 * tb < C && tt < C && ss <= tt) {
        t[k] = tt;
        s[k] = ss;
      }
    }
  }
};

// acc[k] = sum_d fmaf(A[k][t_k][d], B[k][s_k][d], acc) over d = 0..63 in
// order, from +0, for the K pairs of a thread at once (K independent
// chains); A, B swizzled C x 64 tiles
template <int TT, int K, int C>
__device__ __forceinline__ void pair_dots(float (&acc)[K],
                                          const Pairs<K, C>& pr,
                                          const float* const (&A)[K],
                                          const float* const (&B)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
#pragma unroll 4
  for (int c4 = 0; c4 < TD / 4; ++c4) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (pr.t[k] >= 0) {
        const float4 x =
            *reinterpret_cast<const float4*>(A[k] + sw<TT>(pr.t[k], c4));
        const float4 y =
            *reinterpret_cast<const float4*>(B[k] + sw<TT>(pr.s[k], c4));
        acc[k] = fmaf(x.x, y.x, acc[k]);
        acc[k] = fmaf(x.y, y.y, acc[k]);
        acc[k] = fmaf(x.z, y.z, acc[k]);
        acc[k] = fmaf(x.w, y.w, acc[k]);
      }
    }
  }
}

// acc[r][j] = sum_d fmaf(A[t0 + r][d], S[d][j0 + j], acc) over d = 0..63
// in order: A a swizzled C x 64 tile, S 64 x 64 row-major
template <int TT, int TJ>
__device__ __forceinline__ void readout(float (&acc)[TT][TJ], const float* A,
                                        const float* S, int t0, int j0) {
#pragma unroll 2
  for (int c4 = 0; c4 < TD / 4; ++c4) {
    float x[TT][4];
#pragma unroll
    for (int r = 0; r < TT; ++r) ldn<4>(x[r], A + sw<TT>(t0 + r, c4));
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      float y[TJ];
      ldn<TJ>(y, S + (4 * c4 + dd) * TD + j0);
#pragma unroll
      for (int r = 0; r < TT; ++r)
#pragma unroll
        for (int j = 0; j < TJ; ++j) acc[r][j] = fmaf(x[r][dd], y[j], acc[r][j]);
    }
  }
}

// acc[r][j] = sum_s fmaf(PT[s][t0 + r], V[s][j0 + j], acc) over the
// causal columns s = 0..t0+TT-1 in order (PT's entries above the
// diagonal are +0, as the masked entries of the first design)
template <int C, int TT, int TJ>
__device__ __forceinline__ void intra(float (&acc)[TT][TJ], const float* PT,
                                      const float* V, int t0, int j0) {
  for (int s = 0; s < t0 + TT; ++s) {
    float x[TT], y[TJ];
    ldn<TT>(x, PT + s * C + t0);
    ldn<TJ>(y, V + s * TD + j0);
#pragma unroll
    for (int r = 0; r < TT; ++r)
#pragma unroll
      for (int j = 0; j < TJ; ++j) acc[r][j] = fmaf(x[r], y[j], acc[r][j]);
  }
}

// S[d0 + i][u0 + j] = fmaf(decay(d0 + i), S, sum_s fmaf(F[s][d0 + i],
// V[s][u0 + j], acc)) over s = 0..C-1 in order: the state update of one
// 8 x 4 tile (F, V: C x 64 row-major)
template <int C, bool PER_ROW>
__device__ __forceinline__ void update(float* S, const float* F,
                                       const float* V, const float* decay,
                                       int d0, int u0) {
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int s = 0; s < C; ++s) {
    float x[8], y[4];
    ldn<4>(x, F + s * TD + d0);
    ldn<4>(x + 4, F + s * TD + d0 + 4);
    ldn<4>(y, V + s * TD + u0);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* p = S + (d0 + i) * TD + u0;
    const float e = PER_ROW ? decay[d0 + i] : decay[0];
    float z[4];
    ldn<4>(z, p);
#pragma unroll
    for (int j = 0; j < 4; ++j) z[j] = fmaf(e, z[j], acc[i][j]);
    stn<4>(p, z);
  }
}

// GLA: one block of 128 threads per (b, h); see the note at the top.
template <typename T, bool BONUS, int C>
constexpr long long gla_tiled_floats() {
  return (long long)TD * TD + 5LL * C * TD + Tile<C>::PTN + TD +
         3LL * C * TD * (long long)sizeof(T) / 4 + (BONUS ? 2LL * C * TD : 0);
}

template <typename T, bool BONUS, int C>
__global__ void __launch_bounds__(TNT, 4) gla_kernel_tiled(GlaArgs a) {
  using TL = Tile<C>;
  constexpr int TT = TL::TT, TJ = TL::TJ, NTT = TL::NTT;
  constexpr int RE = 16 / (int)sizeof(T);     // elements a 16-byte chunk
  constexpr int CH = TD / RE;                 // chunks a row of q, k, v
  constexpr int R0 = (C + 1) / 2;             // rows of a first-half thread
  extern __shared__ __align__(16) float sm[];
  float* S = sm;                   // state, 64 x 64
  float* QT = S + TD * TD;         // qt rows, swizzled
  float* KT = QT + C * TD;         // kt rows, swizzled
  float* KF = KT + C * TD;         // kf rows
  float* V = KF + C * TD;          // v rows, fp32
  float* WR = V + C * TD;          // raw w rows
  float* PT = WR + C * TD;         // P^T (s, t); +0 above the diagonal
  float* ECL = PT + TL::PTN;       // exp(cum_last) per channel
  T* QR = reinterpret_cast<T*>(ECL + TD);   // raw q, k, v rows
  T* KR = QR + C * TD;
  T* VR = KR + C * TD;
  float* QU = reinterpret_cast<float*>(VR + C * TD);   // bonus: q * u
  float* KK = QU + C * TD;                             // bonus: k

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const T* qb = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const float* wb = a.w + b * a.sw.b + h * a.sw.h;
  T* ob = static_cast<T*>(a.o) + b * a.so.b + h * a.so.h;
  // the readout tile; the 8 x 4 state tile; the channel and half of stage A
  const bool ro = tid < TL::ACTIVE;
  const int t0 = (tid % NTT) * TT, j0 = (tid / NTT) * TJ;
  const int d0 = 8 * (2 * warp + (lane >> 4)), u0 = 4 * (lane & 15);
  const int ch = warp * 16 + (lane & 15), hf = lane >> 4;
  const int rb = hf ? R0 : 0, rn = hf ? C - R0 : R0;
  const float uc = BONUS ? a.u[(long long)h * TD + ch] : 0.f;
  constexpr int KP = (TL::NTILE + TNT / 32 - 1) / (TNT / 32);   // a lane
  const Pairs<KP, C> pairs(warp, TNT / 32, lane);
  const float* pa[KP];
  const float* pb[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) {   // bonus mode's diagonal: (q u) . k
    const bool dg = BONUS && pairs.t[k] == pairs.s[k];
    pa[k] = dg ? QU : QT;
    pb[k] = dg ? KK : KT;
  }

  auto load = [&](int c0) {      // raw rows of the chunk at c0
    constexpr int NQ = C * CH, NW = C * (TD / 4);
    for (int e = tid; e < 3 * NQ + NW; e += TNT) {
      if (e < 3 * NQ) {
        const int x = e / NQ, r = (e % NQ) / CH, c = (e % NQ) % CH;
        const long long t = c0 + r;
        const T* src = x == 0 ? qb + t * a.sq.t
                     : x == 1 ? kb + t * a.sk.t : vb + t * a.sv.t;
        T* dst = x == 0 ? QR : x == 1 ? KR : VR;
        cp_async16(dst + r * TD + c * RE, src + c * RE);
      } else {
        const int r = (e - 3 * NQ) / (TD / 4), c = (e - 3 * NQ) % (TD / 4);
        cp_async16(WR + r * TD + 4 * c, wb + (c0 + r) * a.sw.t + 4 * c);
      }
    }
    cp_async_commit();
  };

  for (int e = tid; e < TD * TD; e += TNT) S[e] = 0.f;
  for (int e = tid; e < TL::PTN; e += TNT) PT[e] = 0.f;
  // [stage 1: loads]
  load(0);

  for (int c0 = 0; c0 < a.T; c0 += C) {
    cp_async_wait_all();
    __syncthreads();  // this chunk's rows are in; the last chunk is done
    float lw[R0], cm[R0], cl = 0.f;
#pragma unroll
    for (int i = 0; i < R0; ++i) lw[i] = cm[i] = 0.f;
    // [stage 2: log + cumsum]
    {
      // channel ch: rows 0..R0-1 in lane l, R0..C-1 in lane l + 16; the
      // second half carries on from the first's sum, in row order
      float cum = 0.f;
#pragma unroll
      for (int i = 0; i < R0; ++i)
        if (i < rn) lw[i] = logf(fmaxf(WR[(rb + i) * TD + ch], 1e-22f));
      if (hf == 0) {
#pragma unroll
        for (int i = 0; i < R0; ++i) {
          cum += lw[i];
          cm[i] = cum;
        }
      }
      const float carry = __shfl_sync(0xffffffffu, cum, lane & 15);
      if (hf == 1) {
        cum = carry;
#pragma unroll
        for (int i = 0; i < R0; ++i) {
          if (i < rn) {
            cum += lw[i];
            cm[i] = cum;
          }
        }
      }
      cl = __shfl_sync(0xffffffffu, cum, (lane & 15) | 16);
    }
    // [stage 3: exp factors]
    {
      if (hf == 0) ECL[ch] = expf(cl);
#pragma unroll
      for (int i = 0; i < R0; ++i) {
        if (i < rn) {
          const int r = rb + i, at = sw<TT>(r, ch >> 2) + (ch & 3);
          const float ci = cm[i], q = ld(QR + r * TD + ch),
                      k = ld(KR + r * TD + ch);
          QT[at] = q * expf(BONUS ? ci - lw[i] : ci);
          KT[at] = k * expf(-ci);
          KF[r * TD + ch] = k * expf(cl - ci);
          V[r * TD + ch] = ld(VR + r * TD + ch);
          if (BONUS) {
            QU[at] = q * uc;
            KK[at] = k;
          }
        }
      }
    }
    __syncthreads();  // qt, kt, kf, v in; the raw rows are free
    // [stage 1: loads]
    if (c0 + C < a.T) load(c0 + C);

    float inter[TT][TJ];
#pragma unroll
    for (int r = 0; r < TT; ++r)
#pragma unroll
      for (int j = 0; j < TJ; ++j) inter[r][j] = 0.f;
    // [stage 4: scores]
    {
      // masked scores, the causal pairs only; bonus mode's diagonal is
      // sum_d (q u) k
      float p[KP];
      pair_dots<TT, KP, C>(p, pairs, pa, pb);
#pragma unroll
      for (int k = 0; k < KP; ++k)
        if (pairs.t[k] >= 0) PT[pairs.s[k] * C + pairs.t[k]] = p[k];
    }
    // [stage 5: Qt S]
    if (ro) readout<TT, TJ>(inter, QT, S, t0, j0);
    __syncthreads();  // P in; the readers of S are done

    // [stage 6: P v + o]
    if (ro) {
      float acc[TT][TJ];
#pragma unroll
      for (int r = 0; r < TT; ++r)
#pragma unroll
        for (int j = 0; j < TJ; ++j) acc[r][j] = 0.f;
      intra<C, TT, TJ>(acc, PT, V, t0, j0);
#pragma unroll
      for (int r = 0; r < TT; ++r) {
        float o[TJ];
#pragma unroll
        for (int j = 0; j < TJ; ++j) o[j] = acc[r][j] + inter[r][j];
        stn<TJ>(ob + (long long)(c0 + t0 + r) * a.so.t + j0, o);
      }
    }
    // [stage 7: state update]
    update<C, true>(S, KF, V, ECL, d0, u0);
  }
  __syncthreads();
  float* sb = a.s + (long long)blockIdx.x * TD * TD;
  for (int e = 4 * tid; e < TD * TD; e += 4 * TNT)
    *reinterpret_cast<float4*>(sb + e) = *reinterpret_cast<const float4*>(S + e);
}

// SSD: one block of 128 G threads per (b, group of G heads); q k^T of a
// chunk is computed once for the G heads.
template <int C, int G>
constexpr long long ssd_tiled_floats() {
  constexpr long long C4 = (C + 3) / 4 * 4;
  return 2LL * C * TD +
         G * ((long long)TD * TD + 3LL * C * TD + Tile<C>::PTN + 8 * C4 + 8);
}

template <int C, int G>
__global__ void __launch_bounds__(TNT * G, G == 1 ? 3 : 2)
    ssd_kernel_tiled(SsdArgs a) {
  using TL = Tile<C>;
  constexpr int TT = TL::TT, TJ = TL::TJ, NTT = TL::NTT;
  constexpr int C4 = (C + 3) / 4 * 4;
  constexpr int HEADF = TD * TD + 3 * C * TD + TL::PTN + 8 * C4 + 8;
  extern __shared__ __align__(16) float sm[];
  float* Q = sm;                   // q rows, swizzled (shared by the heads)
  float* K = Q + C * TD;           // k rows, swizzled
  const int tid = threadIdx.x, hl = tid / TNT, th = tid % TNT;
  const int lane = tid & 31, warp = th >> 5;
  float* H0 = K + C * TD;          // head 0's arrays; head g's at + g HEADF
  float* Sh = H0 + hl * HEADF;     // this head's state, 64 x 64
  float* Vh = Sh + TD * TD;        // v rows, two buffers
  float* KFh = Vh + 2 * C * TD;    // (k * flow) rows
  float* MT = KFh + C * TD;        // M^T (j, i); +0 above the diagonal
  float* Ah = MT + TL::PTN;        // raw a, two buffers
  float* CUM = Ah + 2 * C4;        // per chunk parity: cum, exp(cum),
  float* ECUM = CUM + 2 * C4;      // flow = exp(cum_last - cum) and
  float* FLOW = ECUM + 2 * C4;     // exp(cum_last)
  float* DEC = FLOW + 2 * C4;

  const int groups = a.H / G;
  const int b = blockIdx.x / groups, h = (blockIdx.x % groups) * G + hl;
  const float* qb = a.q + b * a.sq.b;
  const float* kb = a.k + b * a.sk.b;
  const float* vb = a.v + b * a.sv.b + h * a.sv.h;
  const float* ab = a.a + b * a.sa.b + h * a.sa.h;
  float* ob = a.o + b * a.so.b + h * a.so.h;
  const bool ro = th < TL::ACTIVE;
  const int t0 = (th % NTT) * TT, j0 = (th / NTT) * TJ;
  const int d0 = 8 * (2 * warp + (lane >> 4)), u0 = 4 * (lane & 15);
  constexpr int NW = TNT * G / 32;                     // warps a block
  constexpr int KP = (TL::NTILE + NW - 1) / NW;        // pairs a lane
  const Pairs<KP, C> pairs(tid >> 5, NW, lane);
  const float* pa[KP];
  const float* pb[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    pa[k] = Q;
    pb[k] = K;
  }

  auto load_qk = [&](int c0) {   // q and k rows of the chunk at c0
    for (int e = tid; e < 2 * C * 16; e += TNT * G) {
      const int x = e / (C * 16), r = (e % (C * 16)) / 16, c = e % 16;
      const long long t = c0 + r;
      cp_async16((x ? K : Q) + sw<TT>(r, c),
                 (x ? kb + t * a.sk.t : qb + t * a.sq.t) + 4 * c);
    }
    cp_async_commit();
  };
  auto load_va = [&](int c0, int buf) {   // this head's v rows and a
    for (int e = th; e < C * 16; e += TNT) {
      const int r = e / 16, c = e % 16;
      cp_async16(Vh + buf * C * TD + r * TD + 4 * c,
                 vb + (long long)(c0 + r) * a.sv.t + 4 * c);
    }
    if (th < C)                    // row r by lane r of warp 0
      cp_async4(Ah + buf * C4 + th, ab + (long long)(c0 + th) * a.sa.t);
    cp_async_commit();
  };
  // warp 0 of a head: the cumsum of the chunk whose a is in buffer nb;
  // lane r holds row r's log, every lane adds them up in row order, and
  // lane r keeps the sum after row r
  auto cumsum = [&](int nb) {
    const float l = lane < C ? logf(fmaxf(Ah[nb * C4 + lane], 1e-37f)) : 0.f;
    float c = 0.f, mine = 0.f;
#pragma unroll
    for (int r = 0; r < C; ++r) {
      c += __shfl_sync(0xffffffffu, l, r);
      if (lane == r) mine = c;
    }
    if (lane < C) {
      CUM[nb * C4 + lane] = mine;
      ECUM[nb * C4 + lane] = expf(mine);
      FLOW[nb * C4 + lane] = expf(c - mine);
    }
    if (lane == 0) DEC[nb * 4] = expf(c);
  };

  for (int e = th; e < TD * TD; e += TNT) Sh[e] = 0.f;
  for (int e = th; e < TL::PTN; e += TNT) MT[e] = 0.f;
  // [stage 1: loads]
  {
    load_qk(0);
    load_va(0, 0);
  }
  cp_async_wait_all();
  // [stage 2: log + cumsum + flow]
  if (warp == 0) cumsum(0);

  for (int c0 = 0, it = 0; c0 < a.T; c0 += C, ++it) {
    const int buf = it & 1;
    cp_async_wait_all();
    __syncthreads();  // this chunk's rows and cumsum are in; the last
                      // chunk is done
    // [stage 1: loads]
    if (c0 + C < a.T) load_va(c0 + C, buf ^ 1);
    // [stage 3: scores + M]
    {
      // q k^T over the causal pairs, once for the G heads; each head's M
      float p[KP];
      pair_dots<TT, KP, C>(p, pairs, pa, pb);
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        if (pairs.t[k] >= 0) {
          const int i = pairs.t[k], j = pairs.s[k];
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float* cg = CUM + (g - hl) * HEADF + buf * C4;
            MT[(g - hl) * HEADF + j * C + i] =
                p[k] * expf(fminf(cg[i] - cg[j], 0.f));
          }
        }
      }
    }
    // [stage 4: k flow]
    for (int e = th; e < C * TD; e += TNT) {
      const int r = e / TD, n = e % TD;
      KFh[e] = K[sw<TT>(r, n >> 2) + (n & 3)] * FLOW[buf * C4 + r];
    }
    float inter[TT][TJ];
#pragma unroll
    for (int r = 0; r < TT; ++r)
#pragma unroll
      for (int j = 0; j < TJ; ++j) inter[r][j] = 0.f;
    // [stage 5: q S]
    if (ro) readout<TT, TJ>(inter, Q, Sh, t0, j0);
    __syncthreads();  // M, k flow in; the readers of S, q and k are done
    // [stage 1: loads]
    if (c0 + C < a.T) load_qk(c0 + C);
    // [stage 6: M v + o]
    if (ro) {
      float acc[TT][TJ];
#pragma unroll
      for (int r = 0; r < TT; ++r)
#pragma unroll
        for (int j = 0; j < TJ; ++j) acc[r][j] = 0.f;
      intra<C, TT, TJ>(acc, MT, Vh + buf * C * TD, t0, j0);
#pragma unroll
      for (int r = 0; r < TT; ++r) {
        const float e = ECUM[buf * C4 + t0 + r];
        float o[TJ];
#pragma unroll
        for (int j = 0; j < TJ; ++j) o[j] = fmaf(e, inter[r][j], acc[r][j]);
        stn<TJ>(ob + (long long)(c0 + t0 + r) * a.so.t + j0, o);
      }
    }
    // [stage 7: state update]
    update<C, false>(Sh, KFh, Vh + buf * C * TD, DEC + buf * 4, d0, u0);
    // [stage 2: log + cumsum + flow]
    if (warp == 0 && c0 + C < a.T) {   // the next chunk's, from its a
      cp_async_wait_one();             // (this lane's own copy)
      cumsum(buf ^ 1);
    }
  }
  __syncthreads();
  float* sb = a.s + ((long long)b * a.H + h) * TD * TD;
  for (int e = 4 * th; e < TD * TD; e += 4 * TNT)
    *reinterpret_cast<float4*>(sb + e) = *reinterpret_cast<const float4*>(Sh + e);
}

template <typename Kern, typename Args>
cudaError_t launch(Kern kern, const Args& a, long long floats, long long grid,
                   int threads, cudaStream_t st) {
  const long long bytes = floats * (long long)sizeof(float);
  if (bytes > SMEM_MAX || grid <= 0 || grid > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  kern<<<(unsigned)grid, threads, (size_t)bytes, st>>>(a);
  return cudaGetLastError();
}

template <typename T, bool BONUS, int C>
cudaError_t gla_tiled_c(const GlaArgs& a, cudaStream_t st) {
  return launch(gla_kernel_tiled<T, BONUS, C>, a,
                gla_tiled_floats<T, BONUS, C>(), (long long)a.B * a.H, TNT,
                st);
}

template <typename T, bool BONUS>
cudaError_t gla_tiled(const GlaArgs& a, cudaStream_t st) {
  switch (a.C) {
    case 1: return gla_tiled_c<T, BONUS, 1>(a, st);
    case 2: return gla_tiled_c<T, BONUS, 2>(a, st);
    case 4: return gla_tiled_c<T, BONUS, 4>(a, st);
    case 8: return gla_tiled_c<T, BONUS, 8>(a, st);
    case 16: return gla_tiled_c<T, BONUS, 16>(a, st);
    case 32: return gla_tiled_c<T, BONUS, 32>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool BONUS>
long long gla_tiled_floats_of(int C) {
  switch (C) {
    case 1: return gla_tiled_floats<T, BONUS, 1>();
    case 2: return gla_tiled_floats<T, BONUS, 2>();
    case 4: return gla_tiled_floats<T, BONUS, 4>();
    case 8: return gla_tiled_floats<T, BONUS, 8>();
    case 16: return gla_tiled_floats<T, BONUS, 16>();
    case 32: return gla_tiled_floats<T, BONUS, 32>();
    default: return -1;
  }
}

template <int G>
cudaError_t ssd_tiled(const SsdArgs& a, cudaStream_t st) {
  const long long grid = (long long)a.B * (a.H / G);
  switch (a.C) {
    case 1: return launch(ssd_kernel_tiled<1, G>, a, ssd_tiled_floats<1, G>(), grid, TNT * G, st);
    case 2: return launch(ssd_kernel_tiled<2, G>, a, ssd_tiled_floats<2, G>(), grid, TNT * G, st);
    case 4: return launch(ssd_kernel_tiled<4, G>, a, ssd_tiled_floats<4, G>(), grid, TNT * G, st);
    case 8: return launch(ssd_kernel_tiled<8, G>, a, ssd_tiled_floats<8, G>(), grid, TNT * G, st);
    case 16: return launch(ssd_kernel_tiled<16, G>, a, ssd_tiled_floats<16, G>(), grid, TNT * G, st);
    case 32: return launch(ssd_kernel_tiled<32, G>, a, ssd_tiled_floats<32, G>(), grid, TNT * G, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int G>
long long ssd_tiled_floats_of(int C) {
  switch (C) {
    case 1: return ssd_tiled_floats<1, G>();
    case 2: return ssd_tiled_floats<2, G>();
    case 4: return ssd_tiled_floats<4, G>();
    case 8: return ssd_tiled_floats<8, G>();
    case 16: return ssd_tiled_floats<16, G>();
    case 32: return ssd_tiled_floats<32, G>();
    default: return -1;
  }
}

Strides strides(const long long* s, int i) {
  Strides r;
  r.b = s[3 * i];
  r.h = s[3 * i + 1];
  r.t = s[3 * i + 2];
  return r;
}

bool bad_sizes(int B, int H, int T, int C) {
  return B <= 0 || H <= 0 || T <= 0 || C <= 0 || T % C != 0 ||
         (long long)B * H > 0x7fffffffLL;
}

// The tiled forms read and write 16-byte chunks: every pointer 16-byte
// aligned and every (b, h, t) stride a multiple of 16 bytes.
bool chunked(const void* p, const Strides& s, int elem) {
  const long long q = 16 / elem;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % q == 0 &&
         s.h % q == 0 && s.t % q == 0;
}

}  // namespace

extern "C" {

// Forms: 0 the generic kernels (any head size and chunk the shared memory
// takes), 1 the tiled kernels (head size 64, chunks 1, 2, 4, ..., 32,
// 16-byte aligned rows).  Shared memory (bytes) a block of a launch of
// these sizes needs, or -1 where the form does not take them.
long long ssm_gla_smem_bytes(int form, int dtype, int bonus, int C, int Dk,
                             int Dv) {
  if (C <= 0 || Dk <= 0 || Dv <= 0) return -1;
  if (form == 0) return gla_smem_floats(C, Dk, Dv) * (long long)sizeof(float);
  if (form != 1 || Dk != TD || Dv != TD) return -1;
  long long fl = -1;
  if (dtype == 0)
    fl = bonus ? gla_tiled_floats_of<float, true>(C)
               : gla_tiled_floats_of<float, false>(C);
  else if (dtype == 1)
    fl = bonus ? gla_tiled_floats_of<__nv_bfloat16, true>(C)
               : gla_tiled_floats_of<__nv_bfloat16, false>(C);
  return fl < 0 ? -1 : fl * (long long)sizeof(float);
}
long long ssm_ssd_smem_bytes(int form, int G, int C, int N, int P) {
  if (C <= 0 || N <= 0 || P <= 0) return -1;
  if (form == 0) return ssd_smem_floats(C, N, P) * (long long)sizeof(float);
  if (form != 1 || N != TD || P != TD) return -1;
  const long long fl = G == 1 ? ssd_tiled_floats_of<1>(C)
                       : G == 2 ? ssd_tiled_floats_of<2>(C) : -1;
  return fl < 0 ? -1 : fl * (long long)sizeof(float);
}
int ssm_smem_max() { return SMEM_MAX; }

// dtype of q, k, v and o: 0 fp32, 1 bf16.  w, u and the state are fp32.
// str: 15 strides in elements, (b, h, t) of q, k, v, w, o.  u is null in
// post mode.  Returns a cudaError_t (0 on success).
int ssm_gla_run(int form, int dtype, const void* q, const void* k,
                const void* v, const float* w, const float* u, void* o,
                float* s, const long long* str, int B, int H, int T, int Dk,
                int Dv, int C, void* stream) {
  if (bad_sizes(B, H, T, C) || Dk <= 0 || Dv <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  GlaArgs a;
  a.q = q; a.k = k; a.v = v; a.w = w; a.u = u; a.o = o; a.s = s;
  a.sq = strides(str, 0); a.sk = strides(str, 1); a.sv = strides(str, 2);
  a.sw = strides(str, 3); a.so = strides(str, 4);
  a.B = B; a.H = H; a.T = T; a.Dk = Dk; a.Dv = Dv; a.C = C;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool bonus = u != nullptr;
  if (form == 0) {
    const long long fl = gla_smem_floats(C, Dk, Dv);
    const long long grid = (long long)B * H;
    if (dtype == 0)
      return (int)(bonus ? launch(gla_kernel<float, true>, a, fl, grid, NT, st)
                         : launch(gla_kernel<float, false>, a, fl, grid, NT, st));
    return (int)(bonus
                     ? launch(gla_kernel<__nv_bfloat16, true>, a, fl, grid, NT, st)
                     : launch(gla_kernel<__nv_bfloat16, false>, a, fl, grid, NT, st));
  }
  const int elem = dtype == 0 ? 4 : 2;
  if (form != 1 || Dk != TD || Dv != TD || !chunked(q, a.sq, elem) ||
      !chunked(k, a.sk, elem) || !chunked(v, a.sv, elem) ||
      !chunked(w, a.sw, 4) || !chunked(o, a.so, elem) ||
      reinterpret_cast<uintptr_t>(s) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)(bonus ? gla_tiled<float, true>(a, st)
                       : gla_tiled<float, false>(a, st));
  return (int)(bonus ? gla_tiled<__nv_bfloat16, true>(a, st)
                     : gla_tiled<__nv_bfloat16, false>(a, st));
}

// All fp32.  str: 15 strides in elements, (b, h, t) of q, k, v, a, o
// (q's and k's h stride is not read).  G: heads a block of the tiled form
// (1 or 2, dividing H).
int ssm_ssd_run(int form, int G, const float* q, const float* k,
                const float* v, const float* a_, float* o, float* s,
                const long long* str, int B, int H, int T, int N, int P, int C,
                void* stream) {
  if (bad_sizes(B, H, T, C) || N <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  SsdArgs a;
  a.q = q; a.k = k; a.v = v; a.a = a_; a.o = o; a.s = s;
  a.sq = strides(str, 0); a.sk = strides(str, 1); a.sv = strides(str, 2);
  a.sa = strides(str, 3); a.so = strides(str, 4);
  a.B = B; a.H = H; a.T = T; a.N = N; a.P = P; a.C = C;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (form == 0)
    return (int)launch(ssd_kernel, a, ssd_smem_floats(C, N, P),
                       (long long)B * H, NT, st);
  if (form != 1 || N != TD || P != TD || (G != 1 && G != 2) || H % G != 0 ||
      !chunked(q, a.sq, 4) || !chunked(k, a.sk, 4) || !chunked(v, a.sv, 4) ||
      !chunked(o, a.so, 4) || reinterpret_cast<uintptr_t>(s) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return (int)(G == 1 ? ssd_tiled<1>(a, st) : ssd_tiled<2>(a, st));
}

const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
