// Flash-attention forward for Hopper (sm_90a), GQA-aware, causal or not,
// optional tanh softcap:
//
//     o[b, i, h] = sum_j softmax_j(s_ij) v[b, j, h // (H/KV)]
//     s_ij = cap(scale * <q[b, i, h], k[b, j, h // (H/KV)]>),  masked
//            to -1e30 where causal and i < j
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention_pallas (body _fa_kernel).  It computes what that kernel
// computes -- the FA-2 online softmax over key blocks with the running
// max, normaliser and accumulator in fp32, blocks wholly above the causal
// diagonal skipped, the diagonal masked per element to -1e30, the output
// acc / max(l, 1e-30) written in the input dtype -- but not block by
// block: it reads q/k/v in the model's (B, S, heads, D) layout directly
// (no transposes), and it masks ragged tails (Sq, Sk need not be
// multiples of the tile) instead of refusing them.  Keys past Sk get
// -inf, so they add exactly 0.
//
// Layout.  One block of 128 threads per (64-row query tile, head, batch).
// The query tile is staged once in shared memory as fp32, transposed
// (Qt[d][i]); each 64-key block of K (transposed) and V (row-major) is
// staged in turn.  Thread (ty, tx) of a 16 x 8 grid owns query rows
// 4*ty .. 4*ty+3, score columns tx + 8c and output columns tx + 8c, so a
// row's max and sum reduce over 8 neighbouring lanes with shuffles.  The
// odd leading dimension (65) of the transposed tiles and of the
// probability tile keeps the transposing stores and the reads free of
// bank conflicts.
//
// Numerics.  Both products run in fp32 FMA on the CUDA cores.  bf16
// inputs are widened to fp32 on staging, so q.k is exact products summed
// in fp32, as the TPU kernel's fp32 math; p stays fp32 in the P.V product,
// as the TPU kernel keeps it.  Putting p in bf16 on the tensor cores would
// change the numerics and is a later, measured decision.
//
// Bound on the H100.  At the backbone's shape (B = 256, S = 256, H = 32,
// KV = 8, D = 64, causal, bf16) the call moves ~0.67 GB (q, k, v read
// once, o written once: 0.20 ms at 3.35 TB/s) and needs ~69 GFLOP for the
// two products under the causal half (0.07 ms at the 989 TFLOP/s bf16
// tensor-core peak): it is bytes-bound.  This first design runs both
// products from shared memory on the CUDA cores (12 shared loads per 32
// FMA) and reaches neither bound; tensor cores (mma/wgmma with bf16 q.k),
// cp.async/TMA staging and a larger tile are left to a later PR.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64, BK = 64;  // query rows and keys per tile
constexpr int NT = 128;          // threads per block
constexpr int TX = 8;            // lanes sharing one query row
constexpr int RM = 4;            // query rows per thread (16 x 4 = 64)
constexpr int CN = BK / TX;      // score columns per thread
constexpr int LDT = BQ + 1;      // leading dim of Qt, Kt and Ps
constexpr float NEG = -1e30f;    // the TPU kernel's mask value

static_assert(BQ == BK, "stage() stages 64-row tiles of either");
static_assert((NT / TX) * RM == BQ, "the thread grid covers the tile");

struct Args {
  const void* q;  // (B, Sq, H, D)
  const void* k;  // (B, Sk, KV, D)
  const void* v;  // (B, Sk, KV, D)
  void* o;        // (B, Sq, H, D), q's dtype
  int B, Sq, Sk, H, KV;
  float scale, softcap;  // softcap 0: none
  int causal;
};

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

// 16 bytes of a row as fp32.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Stage rows [r0, r0 + 64) of one head (rows row_stride apart) into
// shared memory as fp32: transposed dst[d * LDT + r] or row-major
// dst[r * D + d].  Rows at or past S are zeros.
template <typename T, int D, bool TRANS>
__device__ __forceinline__ void stage(const T* base, long long row_stride,
                                      int r0, int S, float* dst) {
  constexpr int V = Vec<T>::N, CH = D / V;
  for (int e = threadIdx.x; e < BQ * CH; e += NT) {
    const int r = e / CH, c = (e % CH) * V;
    float x[V];
    if (r0 + r < S) {
      load16(base + (long long)(r0 + r) * row_stride + c, x);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) x[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (TRANS) dst[(c + i) * LDT + r] = x[i];
      else dst[r * D + c + i] = x[i];
    }
  }
}

template <int D>
constexpr int smem_floats() { return 2 * D * LDT + BK * D + BQ * LDT; }

template <typename T, int D>
__global__ void __launch_bounds__(NT) fa_fwd_kernel(Args a) {
  constexpr int ON = D / TX;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;            // D x LDT
  float* Kt = Qt + D * LDT;    // D x LDT
  float* Vs = Kt + D * LDT;    // BK x D
  float* Ps = Vs + BK * D;     // BQ x LDT

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const long long qs = (long long)a.H * D, ks = (long long)a.KV * D;
  const T* qb = static_cast<const T*>(a.q) + ((long long)b * a.Sq * a.H + h) * D;
  const T* kb = static_cast<const T*>(a.k) + ((long long)b * a.Sk * a.KV + kvh) * D;
  const T* vb = static_cast<const T*>(a.v) + ((long long)b * a.Sk * a.KV + kvh) * D;

  stage<T, D, true>(qb, qs, q0, a.Sq, Qt);

  float o[RM][ON], m[RM], l[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < ON; ++c) o[i][c] = 0.f;
  }

  // causal: keys past the tile's last query row are masked for every
  // row of the tile -- those key blocks are skipped
  int kend = a.Sk;
  if (a.causal) kend = min(kend, min(q0 + BQ, a.Sq));
  const int nkb = (kend + BK - 1) / BK;

  for (int kbi = 0; kbi < nkb; ++kbi) {
    const int k0 = kbi * BK;
    __syncthreads();  // the previous block's readers of Kt, Vs, Ps are done
    stage<T, D, true>(kb, ks, k0, a.Sk, Kt);
    stage<T, D, false>(vb, ks, k0, a.Sk, Vs);
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int c = 0; c < CN; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = Qt[d * LDT + ty * RM + i];
#pragma unroll
      for (int c = 0; c < CN; ++c) kv[c] = Kt[d * LDT + tx + TX * c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < CN; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qi = q0 + ty * RM + i;
      float mx = NEG;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const int kj = k0 + tx + TX * c;
        float x = s[i][c] * a.scale;
        if (a.softcap != 0.f) x = tanhf(x / a.softcap) * a.softcap;
        if (kj >= a.Sk) x = -INFINITY;
        else if (a.causal && qi < kj) x = NEG;
        s[i][c] = x;
        mx = fmaxf(mx, x);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const float p = expf(s[i][c] - mn);
        Ps[(ty * RM + i) * LDT + tx + TX * c] = p;
        rs += p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < ON; ++c) o[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[RM], vv[ON];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = Ps[(ty * RM + i) * LDT + j];
#pragma unroll
      for (int c = 0; c < ON; ++c) vv[c] = Vs[j * D + tx + TX * c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < ON; ++c) o[i][c] = fmaf(pv[i], vv[c], o[i][c]);
    }
  }

  T* ob = static_cast<T*>(a.o) + ((long long)b * a.Sq * a.H + h) * D;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + ty * RM + i;
    if (qi >= a.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < ON; ++c)
      store1(ob + (long long)qi * qs + tx + TX * c, o[i][c] / den);
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a, cudaStream_t st) {
  constexpr int bytes = smem_floats<D>() * (int)sizeof(float);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        fa_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  fa_fwd_kernel<T, D><<<grid, NT, bytes, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Args& a, int D, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(a, st);
    case 32: return launch<T, 32>(a, st);
    case 64: return launch<T, 64>(a, st);
    case 128: return launch<T, 128>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16.  Returns a cudaError_t (0 on success).
int flash_attention_run(int dtype, const void* q, const void* k,
                        const void* v, void* o, int B, int Sq, int Sk, int H,
                        int KV, int D, float scale, float softcap, int causal,
                        void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.H = H; a.KV = KV;
  a.scale = scale; a.softcap = softcap; a.causal = causal;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_d<float>(a, D, st);
  if (dtype == 1) return (int)launch_d<__nv_bfloat16>(a, D, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
