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
// -inf, so they add exactly 0.  The dtype picks one of two templates.
//
// bf16 (fa_bf16_kernel): the tensor cores.  One block per (query tile,
// head, batch) of 8 warps (a 128-row tile; 4 warps, 64 rows, at q.k^T
// head dims above 64, where registers and shared memory allow no more);
// each warp owns 16 query rows.
//   * q.k^T: mma.sync.m16n8k16 bf16 x bf16 -> fp32.  bf16 products are
//     exact in fp32, so this is the TPU kernel's fp32 math (kernel.py
//     l.47-50) up to summation order.  q's fragments are loaded once
//     (ldmatrix); a k-step's k fragments are all loaded by ldmatrix
//     before its mmas, so the mmas issue back to back.
//   * The score tile, the running max m, the normaliser l and the
//     accumulator stay in registers in fp32; scale, softcap (tanh in
//     fp32) and the masks apply to the score fragment -- the masks only
//     in a key block that reaches past Sk or across the warp's diagonal
//     -- and a row's max and sum reduce over the four lanes that hold it
//     (quad shuffles).  Scores are kept in log2 units, so exp(x - m) is
//     one ex2 (2^(x log2 e - m log2 e), as FA-2 computes it: ~1e-6
//     relative from e^x).  A key block wholly above a warp's rows is
//     skipped by that warp.
//   * p.v without rounding p to bf16: the TPU kernel keeps p in fp32
//     (l.62).  p is split into p_hi = bf16(p) and p_lo = bf16(p - p_hi),
//     both taken straight from the score fragment as the A operand, and
//     o += p_hi.v + p_lo.v (two mmas, v by ldmatrix.trans; all p_hi
//     mmas of a k-step, then all p_lo, so no mma waits on the one
//     before).  The pair carries ~16 bits of p: its error (~2^-16
//     relative) sits far below the bf16 rounding of the output.  It
//     costs 1.5x the FLOPs of one bf16 p.
//   * Staging: the q tile once, then each 64-key block of K and V into a
//     ring of two shared buffers by 16-byte cp.async, the next block in
//     flight while the current one computes.  Rows are padded by 16
//     bytes, which makes every ldmatrix (8 rows of one 16-byte column)
//     conflict-free at each head dim -- what a XOR swizzle does, without
//     its per-D masks.  Rows past Sq / Sk are zero-filled.
//   * The output goes through shared memory and out as 16-byte stores in
//     the (B, S, H, D) layout.
//   * GQA: the G = H / KV query heads of a group are neighbouring blocks
//     of the grid (x: query tile, y: head), so their reads of one K/V
//     block hit L2; a block does not share a staged tile across heads.
//
// LSE.  Given a non-null lse pointer, either template also writes each
// query row's logsumexp of its scores, m + ln(max(l, 1e-30)) in the units
// of the scaled, soft-capped scores (fp32, (B, H, Sq)): the row statistic
// the reference's blocked backward (src/repro/models/attention.py:
// _flash_xla_bwd) recomputes probabilities from.  It is one 4-byte store
// a row in the epilogue; o is computed as before, so a launch without it
// is bit for bit what it was.
//
// Head dims.  q and k share one head dim (DQK: the q.k^T k-steps, the q
// and k tiles), v and o another (DV: the p.v column tiles, the v tile,
// the accumulator); both templates take the square dims 16, 32, 64, 128
// and MLA's (192, 128) (deepseek-v3: qk_nope 128 + qk_rope 64 against
// v 128).  At (192, 128) the bf16 block is 4 warps with 111,616 bytes
// of shared memory (two blocks fit an SM) and holds 48 registers of q
// fragments and 64 of accumulator a thread; the fp32 one stages 149,248
// bytes (one block an SM).  The square instantiations compute what they
// computed before the split, bit for bit.
//
// fp32 (fa_fwd_kernel): the first design, on the CUDA cores.  The query
// tile is staged once in shared memory, transposed (Qt[d][i]); each
// 64-key block of K (transposed) and V (row-major) is staged in turn.
// Thread (ty, tx) of a 16 x 8 grid owns query rows 4*ty .. 4*ty+3,
// score columns tx + 8c and output columns tx + 8c; a row's max and sum
// reduce over 8 neighbouring lanes.  The odd leading dimension (65) keeps
// the transposing stores and the reads free of bank conflicts.  Both
// products are fp32 FMA.
//
// Bound on the H100.  At the backbone's shape (B = 256, S = 256, H = 32,
// KV = 8, D = 64, causal, bf16) the call moves ~0.67 GB (q, k, v read
// once, o written once: 0.20 ms at 3.35 TB/s) and needs ~69 GFLOP for the
// two products under the causal half (0.07 ms at the 989 TFLOP/s bf16
// tensor-core peak; the hi/lo split makes it ~103 GFLOP, 0.10 ms): it is
// bytes-bound.  mma.sync, not wgmma.  Measured (PERF.md), the kernel is
// neither: it runs ~95 TFLOP/s at this shape and ~180 at S = 4096, held
// by the softmax's per-element work beside each mma and the masked
// diagonal blocks; one staged K/V tile per head group, a third staging
// buffer and wgmma are the levers left.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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
  const void* q;  // (B, Sq, H, Dqk)
  const void* k;  // (B, Sk, KV, Dqk)
  const void* v;  // (B, Sk, KV, Dv)
  void* o;        // (B, Sq, H, Dv), q's dtype
  float* lse;     // (B, H, Sq) fp32, or null: not written
  int B, Sq, Sk, H, KV;
  float scale, softcap;  // softcap 0: none
  int causal;
};

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };

// 16 bytes of a row as fp32.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

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

template <int DQK, int DV>
constexpr int smem_floats() { return 2 * DQK * LDT + BK * DV + BQ * LDT; }

template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(NT) fa_fwd_kernel(Args a) {
  constexpr int ON = DV / TX;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;              // DQK x LDT
  float* Kt = Qt + DQK * LDT;    // DQK x LDT
  float* Vs = Kt + DQK * LDT;    // BK x DV
  float* Ps = Vs + BK * DV;      // BQ x LDT

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  // row strides of q, k (DQK wide) and v, o (DV wide)
  const long long qs = (long long)a.H * DQK, ks = (long long)a.KV * DQK;
  const long long vs = (long long)a.KV * DV, os = (long long)a.H * DV;
  const T* qb = static_cast<const T*>(a.q) + ((long long)b * a.Sq * a.H + h) * DQK;
  const T* kb = static_cast<const T*>(a.k) + ((long long)b * a.Sk * a.KV + kvh) * DQK;
  const T* vb = static_cast<const T*>(a.v) + ((long long)b * a.Sk * a.KV + kvh) * DV;

  stage<T, DQK, true>(qb, qs, q0, a.Sq, Qt);

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
    stage<T, DQK, true>(kb, ks, k0, a.Sk, Kt);
    stage<T, DV, false>(vb, vs, k0, a.Sk, Vs);
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int c = 0; c < CN; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DQK; ++d) {
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
      for (int c = 0; c < ON; ++c) vv[c] = Vs[j * DV + tx + TX * c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < ON; ++c) o[i][c] = fmaf(pv[i], vv[c], o[i][c]);
    }
  }

  T* ob = static_cast<T*>(a.o) + ((long long)b * a.Sq * a.H + h) * DV;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + ty * RM + i;
    if (qi >= a.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < ON; ++c)
      store1(ob + (long long)qi * os + tx + TX * c, o[i][c] / den);
    if (a.lse != nullptr && tx == 0)
      a.lse[((long long)b * a.H + h) * a.Sq + qi] = m[i] + logf(den);
  }
}

template <typename T, int DQK, int DV>
cudaError_t launch(const Args& a, cudaStream_t st) {
  constexpr int bytes = smem_floats<DQK, DV>() * (int)sizeof(float);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        fa_fwd_kernel<T, DQK, DV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
  fa_fwd_kernel<T, DQK, DV><<<grid, NT, bytes, st>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 template on the tensor cores.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a (16 x 16, row) * b (16 x 8, col); bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Rows [r0, r0 + R) of one head (rows row_stride elements apart) into an
// (R, D + 8) bf16 tile by 16-byte cp.async, NT threads; rows at or past S
// are zeros.
template <int D, int R, int NT_>
__device__ __forceinline__ void stage_async(const __nv_bfloat16* base,
                                            long long row_stride, int r0,
                                            int S, __nv_bfloat16* dst) {
  constexpr int CPR = D / 8, LDS = D + 8;
  for (int e = threadIdx.x; e < R * CPR; e += NT_) {
    const int r = e / CPR, c = (e % CPR) * 8;
    const bool ok = r0 + r < S;
    cp_async16(smem_addr(dst + r * LDS + c),
               base + (ok ? (long long)(r0 + r) * row_stride + c : 0), ok);
  }
}

// Warps per block (16 query rows each): 8 -- a 128-row query tile, so a
// staged key block serves twice the rows -- where its shared memory and
// registers allow two blocks per SM, else 4 (q.k^T head dims above 64).
template <int DQK>
__host__ __device__ constexpr int tc_warps() { return DQK <= 64 ? 8 : 4; }

// The q tile and two K buffers (rows of DQK + 8), two V buffers (rows of
// DV + 8), bf16.  (192, 128): 111,616 bytes, two blocks in an SM's 228 KB.
template <int DQK, int DV>
__host__ __device__ constexpr int tc_smem_bytes() {
  return ((16 * tc_warps<DQK>() + 2 * BK) * (DQK + 8) +
          2 * BK * (DV + 8)) * 2;
}
static_assert(2 * (tc_smem_bytes<192, 128>() + 1024) <= 233472,
              "two (192, 128) blocks fit an SM");

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// 2^x in one MUFU op (flushing results below 2^-126 to 0, which adds
// nothing to a sum of p).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int DQK, int DV>
__global__ void __launch_bounds__(32 * tc_warps<DQK>(), 2)
fa_bf16_kernel(Args a) {
  constexpr int NW = tc_warps<DQK>(), NTB = 32 * NW, BQT = 16 * NW;
  constexpr int LDQ = DQK + 8;    // padded q / k row, bf16 elements
  constexpr int LDV = DV + 8;     // padded v / o row
  constexpr int KS = DQK / 16;    // k-steps of q.k^T
  constexpr int NO = DV / 8;      // 8-wide column tiles of o
  constexpr int NS = BK / 8;      // 8-wide key tiles of a score block
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(tc_smem);  // BQT x LDQ
  __nv_bfloat16* Ks = Qs + BQT * LDQ;                               // 2 x BK x LDQ
  __nv_bfloat16* Vs = Ks + 2 * BK * LDQ;                            // 2 x BK x LDV

  const int q0 = blockIdx.x * BQT, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;   // fragment row group, column pair
  // row strides of q, k (DQK wide) and v, o (DV wide)
  const long long qs = (long long)a.H * DQK, ks = (long long)a.KV * DQK;
  const long long vs = (long long)a.KV * DV, os = (long long)a.H * DV;
  const __nv_bfloat16* qb =
      static_cast<const __nv_bfloat16*>(a.q) + ((long long)b * a.Sq * a.H + h) * DQK;
  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(a.k) + ((long long)b * a.Sk * a.KV + kvh) * DQK;
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(a.v) + ((long long)b * a.Sk * a.KV + kvh) * DV;

  int kend = a.Sk;
  if (a.causal) kend = min(kend, min(q0 + BQT, a.Sq));
  const int nkb = (kend + BK - 1) / BK;

  stage_async<DQK, BQT, NTB>(qb, qs, q0, a.Sq, Qs);
  stage_async<DQK, BK, NTB>(kb, ks, 0, a.Sk, Ks);
  stage_async<DV, BK, NTB>(vb, vs, 0, a.Sk, Vs);
  cp_async_commit();
  if (nkb > 1) {
    stage_async<DQK, BK, NTB>(kb, ks, BK, a.Sk, Ks + BK * LDQ);
    stage_async<DV, BK, NTB>(vb, vs, BK, a.Sk, Vs + BK * LDV);
  }
  cp_async_commit();             // (an empty group when there is one block)

  // ldmatrix row addresses: lanes 0-7, 8-15, 16-23, 24-31 address the
  // four 8 x 8 matrices of an x4 load
  const int lr = lane & 7, lm = lane >> 3;
  const int w0 = q0 + warp * 16;              // the warp's first query row
  const int rowA = w0 + g, rowB = rowA + 8;
  // scores in log2 units: exp(x - m) = 2^(x log2e - m log2e), as FA-2
  // computes it
  const float sl2 = a.scale * LOG2E;
  uint32_t qf[KS][4];
  float o[NO][4], m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  cp_async_wait<1>();            // q and the first key block have landed
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(smem_addr(Qs + (warp * 16 + lr + 8 * (lm & 1)) * LDQ + 16 * kk +
                      8 * (lm >> 1)),
            qf[kk]);

  for (int kbi = 0; kbi < nkb; ++kbi) {
    if (kbi > 0) {
      cp_async_wait<1>();        // this block's group has landed
      __syncthreads();
    }
    const int k0 = kbi * BK;
    // a key block wholly above this warp's rows adds nothing to them
    if (!(a.causal && k0 > w0 + 15)) {
      const __nv_bfloat16* Kb = Ks + (kbi & 1) * BK * LDQ;
      const __nv_bfloat16* Vb = Vs + (kbi & 1) * BK * LDV;

      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t kf[NS / 2][4];
#pragma unroll
        for (int jp = 0; jp < NS / 2; ++jp)
          ldsm_x4(smem_addr(Kb + (16 * jp + lr + 8 * (lm >> 1)) * LDQ +
                            16 * kk + 8 * (lm & 1)),
                  kf[jp]);
#pragma unroll
        for (int jp = 0; jp < NS / 2; ++jp) {
          mma_bf16(s[2 * jp], qf[kk], kf[jp][0], kf[jp][1]);
          mma_bf16(s[2 * jp + 1], qf[kk], kf[jp][2], kf[jp][3]);
        }
      }

      // scale, softcap, masks (only where a key can be masked), in log2
      // units; the online softmax of rows A (e = 0, 1) and B (e = 2, 3),
      // each reduced over its quad
      float mx[2] = {NEG, NEG};
      auto scores = [&](auto cap, auto mask) {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x;
            if constexpr (decltype(cap)::value)
              x = tanhf(s[j][e] * a.scale / a.softcap) * a.softcap * LOG2E;
            else
              x = s[j][e] * sl2;
            if constexpr (decltype(mask)::value) {
              const int qi = e < 2 ? rowA : rowB;
              const int kj = k0 + 8 * j + 2 * t + (e & 1);
              if (kj >= a.Sk) x = -INFINITY;
              else if (a.causal && qi < kj) x = NEG;
            }
            s[j][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
      };
      const bool masked = k0 + BK > a.Sk || (a.causal && k0 + BK - 1 > w0);
      if (a.softcap != 0.f) {
        if (masked) scores(std::true_type{}, std::true_type{});
        else scores(std::true_type{}, std::false_type{});
      } else {
        if (masked) scores(std::false_type{}, std::true_type{});
        else scores(std::false_type{}, std::false_type{});
      }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float mn = fmaxf(m[r], mx[r]);
        alpha[r] = ex2(m[r] - mn);
        m[r] = mn;
      }
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(s[j][e] - m[e >> 1]);
          s[j][e] = p;
          rs[e >> 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l[r] = l[r] * alpha[r] + rs[r];
      }
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][0] *= alpha[0]; o[j][1] *= alpha[0];
        o[j][2] *= alpha[1]; o[j][3] *= alpha[1];
      }

      // o += p_hi.v + p_lo.v: the score fragments of keys 16kk .. 16kk+15
      // are the A fragment of that k-step
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* sv = s[2 * kk + (i >> 1)] + 2 * (i & 1);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(sv[0], sv[1]);
          const float2 hf = __bfloat1622float2(hi);
          ph[i] = *reinterpret_cast<const uint32_t*>(&hi);
          pl[i] = pack_bf16(sv[0] - hf.x, sv[1] - hf.y);
        }
        uint32_t vf[NO / 2][4];
#pragma unroll
        for (int jp = 0; jp < NO / 2; ++jp)
          ldsm_x4_t(smem_addr(Vb + (16 * kk + lr + 8 * (lm & 1)) * LDV +
                              16 * jp + 8 * (lm >> 1)),
                    vf[jp]);
#pragma unroll
        for (int jp = 0; jp < NO / 2; ++jp) {
          mma_bf16(o[2 * jp], ph, vf[jp][0], vf[jp][1]);
          mma_bf16(o[2 * jp + 1], ph, vf[jp][2], vf[jp][3]);
        }
#pragma unroll
        for (int jp = 0; jp < NO / 2; ++jp) {
          mma_bf16(o[2 * jp], pl, vf[jp][0], vf[jp][1]);
          mma_bf16(o[2 * jp + 1], pl, vf[jp][2], vf[jp][3]);
        }
      }
    }
    __syncthreads();             // every warp is done with this buffer
    if (kbi + 2 < nkb) {
      stage_async<DQK, BK, NTB>(kb, ks, (kbi + 2) * BK, a.Sk,
                                Ks + (kbi & 1) * BK * LDQ);
      stage_async<DV, BK, NTB>(vb, vs, (kbi + 2) * BK, a.Sk,
                               Vs + (kbi & 1) * BK * LDV);
    }
    cp_async_commit();
  }

  // o / l as bf16 into the warp's own rows of Qs (16 rows of LDV within
  // its 16 of LDQ >= LDV), then 16-byte stores
  const float den[2] = {fmaxf(l[0], 1e-30f), fmaxf(l[1], 1e-30f)};
  if (a.lse != nullptr && t == 0) {
    // m is in log2 units: lse = m ln 2 + ln l, in the units of the
    // scaled (soft-capped) scores
    float* lb = a.lse + ((long long)b * a.H + h) * a.Sq;
    if (rowA < a.Sq) lb[rowA] = m[0] * LN2 + logf(den[0]);
    if (rowB < a.Sq) lb[rowB] = m[1] * LN2 + logf(den[1]);
  }
  __nv_bfloat16* Os = Qs + warp * 16 * LDQ;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    *reinterpret_cast<uint32_t*>(Os + g * LDV + 8 * j + 2 * t) =
        pack_bf16(o[j][0] / den[0], o[j][1] / den[0]);
    *reinterpret_cast<uint32_t*>(Os + (g + 8) * LDV + 8 * j + 2 * t) =
        pack_bf16(o[j][2] / den[1], o[j][3] / den[1]);
  }
  __syncwarp();
  __nv_bfloat16* ob =
      static_cast<__nv_bfloat16*>(a.o) + ((long long)b * a.Sq * a.H + h) * DV;
  constexpr int CPR = DV / 8;
  for (int e = lane; e < 16 * CPR; e += 32) {
    const int r = e / CPR, c = (e % CPR) * 8;
    const int qi = w0 + r;
    if (qi < a.Sq)
      *reinterpret_cast<uint4*>(ob + (long long)qi * os + c) =
          *reinterpret_cast<const uint4*>(Os + r * LDV + c);
  }
}

template <int DQK, int DV>
cudaError_t launch_tc(const Args& a, cudaStream_t st) {
  constexpr int bytes = tc_smem_bytes<DQK, DV>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        fa_bf16_kernel<DQK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  constexpr int BQT = 16 * tc_warps<DQK>();
  const dim3 grid((a.Sq + BQT - 1) / BQT, a.H, a.B);
  fa_bf16_kernel<DQK, DV><<<grid, 32 * tc_warps<DQK>(), bytes, st>>>(a);
  return cudaGetLastError();
}

// (q.k^T head dim, v head dim): the square dims, and MLA's (192, 128)
// (deepseek-v3: qk_nope 128 + qk_rope 64 against v 128).
cudaError_t launch_fp32(const Args& a, int Dqk, int Dv, cudaStream_t st) {
  if (Dqk == 192 && Dv == 128) return launch<float, 192, 128>(a, st);
  if (Dqk != Dv) return cudaErrorInvalidValue;
  switch (Dqk) {
    case 16: return launch<float, 16, 16>(a, st);
    case 32: return launch<float, 32, 32>(a, st);
    case 64: return launch<float, 64, 64>(a, st);
    case 128: return launch<float, 128, 128>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_bf16(const Args& a, int Dqk, int Dv, cudaStream_t st) {
  if (Dqk == 192 && Dv == 128) return launch_tc<192, 128>(a, st);
  if (Dqk != Dv) return cudaErrorInvalidValue;
  switch (Dqk) {
    case 16: return launch_tc<16, 16>(a, st);
    case 32: return launch_tc<32, 32>(a, st);
    case 64: return launch_tc<64, 64>(a, st);
    case 128: return launch_tc<128, 128>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16; q, k (..., Dqk), v, o (..., Dv); lse (B, H, Sq)
// fp32 -- each query row's logsumexp of its scaled, soft-capped, masked
// scores, which a backward pass reads -- or null (nothing is written, and
// o is the same bits either way).  Returns a cudaError_t (0 on success).
int flash_attention_run(int dtype, const void* q, const void* k,
                        const void* v, void* o, void* lse, int B, int Sq,
                        int Sk, int H, int KV, int Dqk, int Dv, float scale,
                        float softcap, int causal, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.lse = static_cast<float*>(lse);
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.H = H; a.KV = KV;
  a.scale = scale; a.softcap = softcap; a.causal = causal;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_fp32(a, Dqk, Dv, st);
  if (dtype == 1) return (int)launch_bf16(a, Dqk, Dv, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
