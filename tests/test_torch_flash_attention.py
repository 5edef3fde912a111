"""The port's flash attention (repro_torch.kernels.flash_attention) held
against the JAX package's.

  * the plain version against the Pallas kernel run in interpret mode
    (``flash_attention_pallas(..., interpret=True)``) and against the
    reference's ``attention_ref``: causal and not, GQA (H != KV) and
    MQA, softcap, fp32 and bf16 inputs; and against ``attention_ref``
    alone at whisper's encoder form, bidirectional at a ragged length;
  * ``ops.flash_attention`` in the model's (B, S, heads, D) layout
    against the reference's ``ops.flash_attention`` (the layout round
    trip), and a device that is neither CPU nor CUDA is refused;
  * a value head dim of its own (MLA's prefill: q/k 24 wide, v 16),
    causal and softcapped, GQA and MHA, against the reference's dense
    ``models.attention._sdpa`` — the reference's flash oracle reshapes o
    to q's head dim and cannot take that shape;
  * the card's bf16 rounding, emulated here in plain torch (q·kᵀ of
    bf16 values summed in fp32, the online softmax in fp32 over key
    blocks, p split into bf16 hi + lo for the P·V product), against the
    Pallas kernel in interpret mode.

The same inputs, made with numpy, go to both packages.  Tolerance: fp32
outputs rtol 1e-5 with atol 1e-5·max|o| (fp32 sums in another order);
bf16 outputs 8e-3·max|o| — both packages round an fp32 result to bf16,
and a sum that straddles a rounding boundary lands one bf16 step
(2^-8 relative) apart.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import kernel as jfa_kernel  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.kernels.flash_attention import ops as jfa_ops  # noqa: E402
from repro.kernels.flash_attention import ref as jfa_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402

# B, Sq, Sk, H, KV, D, causal, softcap, block
_CASES = [
    (1, 64, 64, 4, 2, 16, True, 0.0, 32),    # GQA, causal, 2 key blocks
    (2, 32, 64, 2, 2, 32, False, 0.0, 32),   # MHA, rectangular, not causal
    (1, 64, 64, 4, 1, 16, True, 30.0, 32),   # MQA, softcap
]


def _inputs(B, Sq, Sk, H, KV, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, D)).astype(np.float32),
            rng.standard_normal((B, KV, Sk, D)).astype(np.float32),
            rng.standard_normal((B, KV, Sk, D)).astype(np.float32))


def _close(got, want, bf16: bool):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = 8e-3 if bf16 else 1e-5
    np.testing.assert_allclose(got, want, rtol=0 if bf16 else tol,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", _CASES)
def test_plain_matches_reference(case, dtype):
    B, Sq, Sk, H, KV, D, causal, cap, blk = case
    arrs = _inputs(B, Sq, Sk, H, KV, D)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jd) for a in arrs)
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in arrs)
    got = ref.attention_ref(tq, tk, tv, causal=causal, softcap=cap)
    assert got.dtype == td and tuple(got.shape) == (B, H, Sq, D)
    got = got.float().numpy()
    want_pallas = jfa_kernel.flash_attention_pallas(
        jq, jk, jv, causal=causal, softcap=cap, block_q=blk, block_k=blk,
        interpret=True)
    want_ref = jfa_ref.attention_ref(jq, jk, jv, causal=causal, softcap=cap)
    _close(got, np.asarray(want_pallas.astype(jnp.float32)),
           dtype == "bfloat16")
    _close(got, np.asarray(want_ref.astype(jnp.float32)),
           dtype == "bfloat16")


@pytest.mark.parametrize("causal", [True, False])
def test_ops_layout_round_trip(causal):
    B, S, H, KV, D = 2, 48, 4, 2, 16
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal)
    assert tuple(got.shape) == (B, S, H, D)
    want = jfa_ops.flash_attention(*map(jnp.asarray, (q, k, v)),
                                   causal=causal, backend="ref")
    _close(got.numpy(), np.asarray(want), False)
    # the layout is only a transpose of the (B, heads, S, D) function
    direct = ref.attention_ref(*(torch.from_numpy(a).transpose(1, 2)
                                 for a in (q, k, v)), causal=causal)
    assert torch.equal(got, direct.transpose(1, 2))


@pytest.mark.parametrize("H,KV,cap", [(4, 2, 0.0), (4, 4, 0.0),
                                      (4, 2, 20.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_value_head_dim_of_its_own(H, KV, cap, dtype):
    """q/k (..., 24), v (..., 16): o is (..., 16), scaled by 1/sqrt(24)."""
    B, S, D, Dv = 2, 40, 24, 16
    rng = np.random.default_rng(2)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, Dv)).astype(np.float32)
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    got = ops.flash_attention(*(torch.from_numpy(a).to(td)
                                for a in (q, k, v)), causal=True,
                              softcap=cap)
    assert tuple(got.shape) == (B, S, H, Dv) and got.dtype == td
    want = jattn._sdpa(*(jnp.asarray(a, jd) for a in (q, k, v)),
                       causal=True, softcap=cap)
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
           dtype == "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_bidirectional_ragged_matches_reference(dtype):
    """whisper's encoder form — not causal, 6/6 heads × 64 — at Sq = Sk =
    75, a multiple of no tile (the Pallas kernel asserts Sq % block_q ==
    0, so its interpret mode cannot take it): the plain version against
    the reference's ``attention_ref``, and the card's bf16 rounding,
    emulated over a ragged last key block, within 1e-4 of the plain
    version on the same bf16 inputs."""
    B, S, H, D = 2, 75, 6, 64
    arrs = _inputs(B, S, S, H, H, D, seed=4)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in arrs)
    got = ref.attention_ref(tq, tk, tv, causal=False)
    want = jfa_ref.attention_ref(*(jnp.asarray(a).astype(jd) for a in arrs),
                                 causal=False)
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
           dtype == "bfloat16")
    bq, bk, bv = (t.to(torch.bfloat16) for t in (tq, tk, tv))
    o32 = _tensor_core_rounding(bq, bk, bv, causal=False, softcap=0.0,
                                block=32)
    plain = ref.attention_ref(bq.float(), bk.float(), bv.float(),
                              causal=False)
    np.testing.assert_allclose(o32.numpy(), plain.numpy(), rtol=0,
                               atol=1e-4 * float(plain.abs().max()))


def test_ops_refuses_other_devices():
    q = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.flash_attention(q, q[:, :, :1], q[:, :, :1])


LOG2E = 1.4426950408889634


def _tensor_core_rounding(q, k, v, *, causal, softcap, block):
    """csrc/flash_attention.cu's bf16 template in plain torch, (B, H, S,
    D) bf16 in, fp32 out (the kernel rounds it to bf16): per key block,
    s = q·kᵀ with bf16 products (exact in fp32) summed in fp32; scale,
    softcap and the masks in fp32, the scores in log2 units (p =
    2^(s·log2 e - m), as FA-2 computes exp); the running max, normaliser
    and accumulator in fp32; p split into p_hi = bf16(p) and
    p_lo = bf16(p - p_hi), acc += p_hi·v + p_lo·v in fp32;
    o = acc / max(l, 1e-30)."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, KV, H // KV, Sq, D)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    m = torch.full((B, KV, H // KV, Sq, 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    qi = torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, block):
        kb, vb = kf[..., k0:k0 + block, :], vf[..., k0:k0 + block, :]
        s = qf @ kb.transpose(-1, -2)
        if softcap:
            s = torch.tanh(s * (1.0 / D ** 0.5) / softcap) * softcap * LOG2E
        else:
            s = s * ((1.0 / D ** 0.5) * LOG2E)
        if causal:
            kj = torch.arange(k0, k0 + kb.shape[-2])[None, :]
            s = torch.where(qi >= kj, s, torch.full_like(s, -1e30))
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - mn)
        p = torch.exp2(s - mn)
        p_hi = p.to(torch.bfloat16).float()
        p_lo = (p - p_hi).to(torch.bfloat16).float()
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p_hi @ vb + p_lo @ vb
        m = mn
    o = acc / torch.clamp(l, min=1e-30)
    return o.reshape(B, H, Sq, D)


@pytest.mark.parametrize("case", _CASES)
def test_tensor_core_rounding_matches_pallas(case):
    """The kernel's bf16 arithmetic (bf16 q·kᵀ summed in fp32, p as bf16
    hi + lo) stays within the bf16 tolerance of the Pallas kernel's fp32
    math, and the split carries p far below bf16's own rounding."""
    B, Sq, Sk, H, KV, D, causal, cap, blk = case
    arrs = _inputs(B, Sq, Sk, H, KV, D, seed=3)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    o32 = _tensor_core_rounding(tq, tk, tv, causal=causal, softcap=cap,
                                block=blk)
    got = o32.to(torch.bfloat16)
    assert tuple(got.shape) == (B, H, Sq, D)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrs)
    want = jfa_kernel.flash_attention_pallas(
        jq, jk, jv, causal=causal, softcap=cap, block_q=blk, block_k=blk,
        interpret=True)
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), True)
    # before that rounding, the hi + lo split of p leaves o within ~2^-16
    # of the fp32 function of the same bf16 inputs: far below bf16's step
    plain = ref.attention_ref(tq.float(), tk.float(), tv.float(),
                              causal=causal, softcap=cap)
    np.testing.assert_allclose(o32.numpy(), plain.numpy(), rtol=0,
                               atol=1e-4 * float(plain.abs().max()))
