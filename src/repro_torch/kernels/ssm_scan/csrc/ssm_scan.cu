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
// Layout.  The TPU runs a grid (B*H, T/C) whose second axis is sequential
// and carries S in VMEM scratch.  Here one block of 256 threads owns one
// (b, h) and walks the T/C chunks itself, with S in shared memory for the
// whole sequence: blocks share nothing, so they run in any order.  At
// rwkv6's shape (B 256 x H 40) that is 10,240 blocks, at zamba2's (256 x
// 64) 16,384, enough to fill 132 SMs.  Every tensor is read through its
// own (b, h, t) strides with a contiguous last dimension, so the models'
// (B, T, H, D) activations are read where they lie, without a transpose,
// and o is written into the caller's layout the same way.  SSD's q and k
// are indexed by b only: the H blocks of one batch row read the same rows,
// which L2 serves, so there is no per-head copy.  The (C x D) tiles are
// stored with a leading dimension of D + 1, so the score loop (rows of kt
// in neighbouring lanes) hits distinct banks; every other loop walks
// neighbouring columns in neighbouring lanes.
//
// Numerics.  All arithmetic is fp32 FMA on the CUDA cores, expf/logf at
// full precision.  No TF32 and no tensor cores: kt = k * exp(-cum) reaches
// ~1.7e24 under the MAX_LOG_DECAY * 16 contract, and the factorised
// product needs fp32's range and mantissa.  bf16 inputs are widened on
// load; o is stored in v's dtype, the final state in fp32.  In bonus mode
// the u-weighted diagonal term sits on the (otherwise masked) diagonal of
// the score tile, so it is summed with the rest of the row.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s fp32).  GLA at rwkv6's batch
// (B 256, H 40, T 256, D 64; r/k/v/o bf16, w fp32): ~2.18 GB moved, 0.65 ms,
// and ~5.5e10 FLOP, 0.82 ms: operations bound.  SSD at zamba2's batch
// (B 256, H 64, T 256, N = P = 64, fp32): ~2.47 GB, 0.74 ms, and ~1.0e11
// FLOP (the shared scores are recomputed per head, as on the TPU), 1.5 ms:
// operations bound.  This first design reads both products' operands from
// shared memory (about one shared load per FMA) and runs the per-channel
// cumsum on Dk threads; register tiling, a chunk-parallel formulation and
// tensor cores where the numerics allow are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;              // threads per block
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
// GLA
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
// SSD
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

template <typename Kern, typename Args>
cudaError_t launch(Kern kern, const Args& a, long long floats,
                   cudaStream_t st) {
  const long long bytes = floats * (long long)sizeof(float);
  if (bytes > SMEM_MAX) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  kern<<<(unsigned)((long long)a.B * a.H), NT, (size_t)bytes, st>>>(a);
  return cudaGetLastError();
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

}  // namespace

extern "C" {

// Shared memory (bytes) a launch of these sizes needs.
long long ssm_gla_smem_bytes(int C, int Dk, int Dv) {
  return gla_smem_floats(C, Dk, Dv) * (long long)sizeof(float);
}
long long ssm_ssd_smem_bytes(int C, int N, int P) {
  return ssd_smem_floats(C, N, P) * (long long)sizeof(float);
}
int ssm_smem_max() { return SMEM_MAX; }

// dtype of q, k, v and o: 0 fp32, 1 bf16.  w, u and the state are fp32.
// str: 15 strides in elements, (b, h, t) of q, k, v, w, o.  u is null in
// post mode.  Returns a cudaError_t (0 on success).
int ssm_gla_run(int dtype, const void* q, const void* k, const void* v,
                const float* w, const float* u, void* o, float* s,
                const long long* str, int B, int H, int T, int Dk, int Dv,
                int C, void* stream) {
  if (bad_sizes(B, H, T, C) || Dk <= 0 || Dv <= 0)
    return (int)cudaErrorInvalidValue;
  GlaArgs a;
  a.q = q; a.k = k; a.v = v; a.w = w; a.u = u; a.o = o; a.s = s;
  a.sq = strides(str, 0); a.sk = strides(str, 1); a.sv = strides(str, 2);
  a.sw = strides(str, 3); a.so = strides(str, 4);
  a.B = B; a.H = H; a.T = T; a.Dk = Dk; a.Dv = Dv; a.C = C;
  const long long fl = gla_smem_floats(C, Dk, Dv);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool bonus = u != nullptr;
  if (dtype == 0)
    return (int)(bonus ? launch(gla_kernel<float, true>, a, fl, st)
                       : launch(gla_kernel<float, false>, a, fl, st));
  if (dtype == 1)
    return (int)(bonus ? launch(gla_kernel<__nv_bfloat16, true>, a, fl, st)
                       : launch(gla_kernel<__nv_bfloat16, false>, a, fl, st));
  return (int)cudaErrorInvalidValue;
}

// All fp32.  str: 15 strides in elements, (b, h, t) of q, k, v, a, o
// (q's and k's h stride is not read).
int ssm_ssd_run(const float* q, const float* k, const float* v,
                const float* a_, float* o, float* s, const long long* str,
                int B, int H, int T, int N, int P, int C, void* stream) {
  if (bad_sizes(B, H, T, C) || N <= 0 || P <= 0)
    return (int)cudaErrorInvalidValue;
  SsdArgs a;
  a.q = q; a.k = k; a.v = v; a.a = a_; a.o = o; a.s = s;
  a.sq = strides(str, 0); a.sk = strides(str, 1); a.sv = strides(str, 2);
  a.sa = strides(str, 3); a.so = strides(str, 4);
  a.B = B; a.H = H; a.T = T; a.N = N; a.P = P; a.C = C;
  return (int)launch(ssd_kernel, a, ssd_smem_floats(C, N, P),
                     reinterpret_cast<cudaStream_t>(stream));
}

const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
