"""Tests of the port that need the CUDA card (marked ``cuda``; they skip
without one).  This file imports neither jax nor the JAX package, so it
runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

The seg_gram kernel against its plain version for the four main-path
builders (one segment, k-fold batch, three segments) and the four
inference forms (fold_weighted, residual_direct, iv and iv_meat, with
per-replicate columns, weights and theta, and iv with three segments),
its refusal of a split-partial buffer that does not fit, and the DML
fit on the card against the same fit on the CPU.  Replicate inference
on the card: the default config's pairs bootstrap and the multiplier
bootstrap against the same replicates on the CPU (the draws come from
CPU generators, so both see the same folds and weights), serial and
batched executors bitwise equal, and OrthoIV's jackknife and bootstrap
against the CPU.  Tolerance: 1e-5·max|G| on Grams (fp32 row sums in
another order), 1e-4 relative on theta and replicates.

The segment walk (every S > 1 form, and ``segment_outer``'s pair
form) against its plain version at the sweep's and the store's shapes
(thin 5 x q and 1 x q terms, the 2 x 2 final stage, seeded
accumulators, a segment longer than a unit), its bitwise invariants
(repeat, appended seg = -1 and zero rows, an empty segment, power-of-two
weights, two seeded ingests against one pass), the unit table's bound;
the segmented sweep and the effect store on the card against the CPU
(1e-4), and the store's incremental ingest bitwise against one pass.

The thin kernel (pair, qL 1–8 by qR 17, 128, 129 and 501) and the small
kernel's pair form (both widths <= 16, U with itself too) over segments
of rs - 1, rs and rs + 1 rows and n not a multiple of rs: unweighted,
weighted and seeded against the CPU (1e-4), then bitwise a second run,
appended seg = -1 and zero rows, an empty segment and two seeded ingests
against one pass; residual_direct and residual_meat at B = 25 bitwise
the 25 single launches; and a walk plans once per ids tensor (the small
sweep: once per tensor and rows per unit, not once per walk).

The large-tile template (every output wider than 8): each symmetric
builder's Gram, the symmetric pair (one tensor with itself, split and
seeded) and gram_and_vec's X block bitwise equal to their transposes
(one triangle computed and mirrored), gram_and_vec's v row and every
form against plain at widths that are not a multiple of the tile,
pair with an asymmetric seed or two distinct tensors on the full square,
a symmetric walk's result written in place read for symmetry again, and
the tiles the library launches equal to ``kernel.tile_schedule``.

The flash-attention kernel against its plain version (causal and not,
GQA and MQA, bf16 and fp32, softcap, ragged Sq/Sk, several key blocks),
the bf16 tensor-core template at every head dim, G = 1, 4, 8, ragged
Sq and Sk and several key blocks per tile, against plain and fp64 and
bitwise plain's on nearly all of its output (which p as one bf16 fails),
both templates at MLA's head dims (q.k 192, v 128),
a small bf16 ``Model.features`` through the kernel against the same
run through the plain attention, whisper-smoke and pixtral-smoke with
their extras on the card against the CPU (flash launches by form), and
the refusal of dense attention on the card (``Model(cfg)`` without
``use_flash_attention=True``).
Tolerance: fp32 outputs 1e-5 (fp32 sums in another order); bf16 outputs 8e-3 relative to max|o| — both
round the same fp32 value to bf16, so they differ by at most one bf16
step (2^-8 relative) where the fp32 sums straddle a rounding boundary;
features 2e-2 relative to max|feature| (such one-step flips at each
layer's attention output, carried through the layers; see chip_smoke.py
for the full-depth gate).

The scan kernels (GLA in post and bonus modes, SSD) against their plain
chunked versions: bf16 and fp32, strided (B, T, H, D) views as the
models pass them, ragged T (the chunk halved), the strong-decay clamp,
the refusals; and small rwkv6 / zamba2 features through the kernels
against the same model through the plain versions, with the launches
counted (one scan per layer).  Tolerances as above.  The scans' two
forms (kernel.py): the tiled form at head size 64 and chunks 1–32
byte for byte the generic form, both within those tolerances of plain
and of the fp64 oracle; the generic form at Dk != Dv, N = 8 and D = 128;
which form each shape takes; batch and head slices and a second run
bitwise; the plans' shared memory equal to the library's.

The doubly-robust estimators: DRLearner's and DRIV's fits and bootstraps
on the card against the CPU (1e-4), with their seg_gram launches by form
and no fallback, serial ≡ batched bitwise on the card.  Serving: the
wave scorer on the card bitwise ``score_single`` at every wave shape of
the server's ladder, through the server too.  ``Tracer.sync`` on the
card waits for the work (a span around a large matmul lasts longer than
its launch alone).

The task runtime on the card: the DML bootstrap's memory model probed
by running chunks under the allocator's peak counter has a positive
slope, and a budget at its peak for 3 replicates chunks below B,
bitwise the explicit chunk; every path of a map (chunked, downgraded,
map_product, zero-length) keeps its tensors on the card; the refuters'
q = 503 nuisance design through the large tile against plain and
bitwise symmetric.

The metalearners, tuning and the mlp nuisance: each S/T/X fit on the
card against the CPU (1e-4) through fold_weighted launches only, its
bootstrap replicates bitwise serial ≡ batched ≡ chunked on the card;
the penalty grid's scores against the CPU (1e-4) and the same winner;
the mlp's batched fit bitwise each model alone on the card and within
1e-3 of the CPU after 30 AdamW steps.

The data mesh (runtime.distributed): two gloo ranks on cuda:0 reduce
the kernel forms one seg_gram launch a block, the accumulators staged
through host memory — bitwise the 1-rank mesh, within 1e-5·max of one
kernel pass over all rows; two NCCL ranks on one card refuse to build a
mesh, naming gloo.  ``segment_outer(row_block=)`` with no mesh is the
one-pass call bitwise; a store under the card's one-rank mesh ingests
one pair launch a block, one-shot ≡ incremental bitwise.

LM serving on the card (small bf16 models of the three families): a
served wave's prefill launches one kernel per attention or scan block
(scans on the tiled form) and its decode steps none; the prefill's
logits and cache leaves against the plain versions and the CPU
(2e-2·max, the features rule; the first layer's fp32 scan state 1e-4);
dense attention refused on the card for train and prefill, decode
attention on the card against the CPU (1e-5).

LM training on the card: flash with its LSE and its plain backward;
the scans under autograd (``ops.gla`` / ``ops.ssd`` through their
Functions: one kernel launch, o and the state bitwise the no-grad
launch's, gradients within 1e-4·max of autograd through the plain fp32
scan, bf16 gradients one bf16 step more; two launches under
``torch.utils.checkpoint``, the same gradients); one train step of the
smoke models, rwkv6 and zamba2 included, against the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.seg_gram import ops, ref  # noqa: E402

_N, _P, _S = 3001, 7, 3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(dev):
    g = torch.Generator().manual_seed(0)
    r = {k: torch.randn((_N, 1), generator=g) for k in ("y", "t", "my", "mt")}
    r["phi"] = torch.randn((_N, _P), generator=g)
    r["D"] = torch.randn((_N, _P), generator=g)
    r["W"] = torch.rand((4, _N), generator=g)
    r["w"] = torch.rand((_N, 1), generator=g)
    r["theta"] = torch.randn((1, _P), generator=g)
    r["seg"] = torch.randint(-1, _S, (_N,), generator=g)
    return {k: v.to(dev) for k, v in r.items()}


def _close(got, want):
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["design", "gram_and_vec", "residual",
                                  "residual_meat"])
def test_kernel_matches_plain(card, name):
    a = _inputs(card)
    col = {"design": [a["D"]],
           "gram_and_vec": [a["D"], a["W"][..., None],
                            (0.5 * a["W"])[..., None]],
           "residual": [a["y"], a["t"], a["my"], a["mt"], a["phi"]],
           "residual_meat": [a["y"], a["t"], a["my"], a["mt"], a["phi"],
                             a["theta"], a["w"]]}[name]
    builder = getattr(ref, f"build_{name}")
    cases = [{}, dict(seg=a["seg"], n_segments=_S)]
    if name != "gram_and_vec":
        cases.append(dict(w=a["W"]))
    for kw in cases:
        got = ops.seg_reduce(builder, col, **kw)
        want = ops.seg_reduce(builder, [c.cpu() for c in col],
                              **{k: v.cpu() if torch.is_tensor(v) else v
                                 for k, v in kw.items()})
        assert got.shape == want.shape
        _close(got, want)


@pytest.mark.cuda
def test_fit_on_card_matches_cpu(card):
    from repro_torch.config import CausalConfig
    from repro_torch.core.dml import DML
    from repro_torch.data.causal_dgp import paper_demo_data

    d = paper_demo_data(n=4000, p=10, seed=2, device="cpu")
    cfg = CausalConfig(cate_features=2, inference="jackknife", row_block=512,
                       row_block_strategy="pallas")
    out = [DML(cfg, device=dev).fit(d.y, d.t, d.X,
                                    gen=torch.Generator().manual_seed(1))
           for dev in ("cpu", card)]
    np.testing.assert_allclose(out[1].theta.cpu().numpy(),
                               out[0].theta.numpy(), rtol=1e-4)


_FA_CASES = [
    # B, Sq, Sk, H, KV, D, causal, dtype, softcap
    (2, 128, 128, 4, 2, 64, True, "bfloat16", 0.0),
    (2, 128, 128, 4, 4, 64, False, "float32", 0.0),
    (1, 200, 200, 8, 2, 32, True, "bfloat16", 0.0),
    (1, 96, 160, 4, 1, 16, False, "float32", 0.0),
    (1, 256, 256, 4, 2, 128, True, "float32", 30.0),
    (3, 64, 64, 2, 2, 64, True, "bfloat16", 50.0),
    (2, 320, 320, 32, 8, 64, True, "bfloat16", 0.0),
]


def _qkv(dev, B, Sq, Sk, H, KV, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dev).to(dt)
    return mk(B, Sq, H, D), mk(B, Sk, KV, D), mk(B, Sk, KV, D)


def _fa_plain(q, k, v, causal=True, softcap=0.0, scale=None, chunk=None):
    from repro_torch.kernels.flash_attention import ref as fa_ref
    return fa_ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                softcap=softcap,
                                scale=scale).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", _FA_CASES)
def test_flash_kernel_matches_plain(card, case):
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops

    B, Sq, Sk, H, KV, D, causal, dtype, cap = case
    q, k, v = _qkv(card, B, Sq, Sk, H, KV, D, dtype)
    n0 = fa_kernel.LAUNCHES["flash_attention"]
    got = fa_ops.flash_attention(q, k, v, causal=causal, softcap=cap)
    torch.cuda.synchronize()
    assert fa_kernel.LAUNCHES["flash_attention"] == n0 + 1
    want = _fa_plain(q, k, v, causal=causal, softcap=cap)
    assert got.dtype == q.dtype and got.shape == q.shape
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    tol = 8e-3 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


# B, Sq, Sk, H, KV, D, causal, softcap: every head dim, G = H / KV of 1,
# 4 and 8, ragged Sq and Sk, several key blocks per query tile
_FA_TC_CASES = [
    (1, 200, 200, 8, 8, 16, True, 0.0),
    (2, 320, 320, 8, 2, 32, False, 0.0),
    (1, 200, 320, 8, 1, 64, False, 30.0),
    (2, 320, 320, 16, 4, 128, True, 50.0),
    (1, 96, 200, 8, 1, 128, True, 0.0),
    (2, 320, 200, 4, 1, 16, False, 0.0),
    (1, 256, 256, 32, 8, 64, True, 0.0),
]


# least share of a bf16 output that equals the plain version's bitwise
# (chip_smoke.py's FA_BF16_SAME)
FA_BF16_SAME = 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("case", _FA_TC_CASES)
def test_flash_bf16_tensor_cores_match_plain(card, case):
    """bf16 q.k^T on the tensor cores, p as bf16 hi + lo: within one bf16
    step of the plain fp32 function (8e-3·max|o|), and within bf16's
    half step of the fp64 one, as the plain version is: 2^-8 of an
    element's magnitude, so at most 2^-8·max|o| (plus ~1e-6 of fp32),
    and no more than 10 % above plain's own error; bitwise equal to
    plain on at least FA_BF16_SAME of the elements."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    B, Sq, Sk, H, KV, D, causal, cap = case
    q, k, v = _qkv(card, B, Sq, Sk, H, KV, D, "bfloat16", seed=5)
    got = fa_kernel.flash_attention_cuda(q, k, v, causal=causal,
                                         softcap=cap)
    want = _fa_plain(q, k, v, causal=causal, softcap=cap)
    exact = _fa_plain(q.double(), k.double(), v.double(), causal=causal,
                      softcap=cap)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    top = float(exact.abs().max())
    assert float((got.double() - want.double()).abs().max()) <= 8e-3 * top
    err_k = float((got.double() - exact).abs().max())
    err_p = float((want.double() - exact).abs().max())
    assert err_k <= 3.91e-3 * top and err_k <= 1.1 * err_p
    # p carried as hi + lo is p to ~2^-17: the kernel's bf16 output is the
    # plain one on all but a few elements (fp32 sums in another order);
    # with p rounded to one bf16 (~2^-9) a large share of them moves
    same = float((got == want).double().mean())
    assert same >= FA_BF16_SAME, f"{same:.4f} of o bitwise plain's"


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_does_not_take(card):
    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    q, k, v = _qkv(card, 1, 64, 64, 4, 2, 64, "bfloat16")
    with pytest.raises(TypeError):
        fa_kernel.flash_attention_cuda(q, k.float(), v)
    with pytest.raises(ValueError, match="contiguous"):
        fa_kernel.flash_attention_cuda(q.transpose(1, 2), k, v)
    q48, k48, v48 = _qkv(card, 1, 64, 64, 4, 2, 48, "float32")
    with pytest.raises(ValueError, match="head dim"):
        fa_kernel.flash_attention_cuda(q48, k48, v48)
    q3, k3, v3 = _qkv(card, 1, 64, 64, 3, 2, 64, "float32")
    with pytest.raises(ValueError, match="group"):
        fa_kernel.flash_attention_cuda(q3, k3, v3)


# B, S, H, causal, softcap at MLA's head dims (q.k 192, v 128): one
# query tile and a ragged one, several key blocks, a softcap
_FA_MLA_CASES = [
    (1, 128, 16, True, 0.0),
    (2, 200, 8, True, 0.0),
    (1, 320, 4, False, 30.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", _FA_MLA_CASES)
def test_flash_mla_head_dims_match_plain(card, case, dtype):
    """q and k 192 wide, v 128 (deepseek-v3's MLA prefill): o is 128
    wide, scaled by 1/sqrt(192); against plain within the square dims'
    tolerances, and bf16 within bf16's half step of fp64 and bitwise
    plain's on >= FA_BF16_SAME of o.  A pair not instantiated is
    refused."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    B, S, H, causal, cap = case
    rng = np.random.default_rng(7)
    dt = getattr(torch, dtype)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(card).to(dt)
    q, k, v = mk(B, S, H, 192), mk(B, S, H, 192), mk(B, S, H, 128)
    n0 = fa_kernel.LAUNCHES["flash_attention"]
    got = fa_kernel.flash_attention_cuda(q, k, v, causal=causal,
                                         softcap=cap)
    want = _fa_plain(q, k, v, causal=causal, softcap=cap)
    torch.cuda.synchronize()
    assert fa_kernel.LAUNCHES["flash_attention"] == n0 + 1
    assert got.dtype == dt and tuple(got.shape) == (B, S, H, 128)
    tol = 8e-3 if dtype == "bfloat16" else 1e-5
    top = float(want.float().abs().max())
    assert float((got.double() - want.double()).abs().max()) <= tol * top
    if dtype == "bfloat16":
        exact = _fa_plain(q.double(), k.double(), v.double(), causal=causal,
                          softcap=cap)
        err_k = float((got.double() - exact).abs().max())
        err_p = float((want.double() - exact).abs().max())
        assert err_k <= 3.91e-3 * float(exact.abs().max())
        assert err_k <= 1.1 * err_p
        assert float((got == want).double().mean()) >= FA_BF16_SAME
    with pytest.raises(ValueError, match="head dims"):
        fa_kernel.flash_attention_cuda(q, k, v[..., :64].contiguous())


@pytest.mark.cuda
def test_model_on_card_needs_flash(card):
    from repro_torch.config import ParallelConfig
    from repro_torch.configs import get_config
    from repro_torch.models import attention
    from repro_torch.models.model import Model

    cfg = get_config("granite-3-2b-smoke")
    with pytest.raises(NotImplementedError, match="use_flash_attention"):
        Model(cfg, device=card)
    q, k, v = _qkv(card, 1, 64, 64, 4, 2, 16, "float32")
    with pytest.raises(NotImplementedError, match="use_flash_attention"):
        attention._maybe_flash(cfg, ParallelConfig(), q, k, v, causal=True)


@pytest.mark.cuda
def test_features_kernel_matches_plain(card, monkeypatch):
    import dataclasses

    from repro_torch.config import ParallelConfig
    from repro_torch.configs import get_config
    from repro_torch.data.event_dgp import make_event_data
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(get_config("granite-3-2b-smoke"),
                              d_model=128, num_heads=4, num_kv_heads=2,
                              head_dim=32, num_layers=3,
                              compute_dtype=torch.bfloat16)
    model = Model(cfg, ParallelConfig(use_flash_attention=True),
                  device=card, seed=3)
    d = make_event_data(24, 160, cfg.vocab_size, seed=1, device=card)
    n0 = fa_kernel.LAUNCHES["flash_attention"]
    got = model.features(d.tokens)
    assert fa_kernel.LAUNCHES["flash_attention"] == n0 + cfg.num_layers
    monkeypatch.setattr(fa_ops, "flash_attention", _fa_plain)
    want = model.features(d.tokens)
    assert fa_kernel.LAUNCHES["flash_attention"] == n0 + cfg.num_layers
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-tiny-smoke", "pixtral-12b-smoke"])
def test_extras_models_on_card_match_cpu(card, arch):
    """whisper-smoke (frames) and pixtral-smoke (patch embeddings), fp32,
    on the card through the fp32 flash template against the same weights
    on the CPU through the plain version: prefill logits and caches, two
    decode steps, features; the prefill's flash launches by form
    (whisper's encoder bidirectional, the decoders causal).  Tolerance
    3e-4·max, ``tests/test_torch_encdec.py``'s end-to-end bound: the
    untrained whisper encoder carries fp32 sums in another order (~1e-6
    an attention) to ~1e-4 of its output."""
    import collections

    from repro_torch.config import ParallelConfig
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.models.model import Model

    cfg, par = get_config(arch), ParallelConfig(use_flash_attention=True)
    gpu = Model(cfg, par, device=card, seed=3)
    cpu = Model(cfg, par, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, 256, (2, 18)))
    shape = (2, cfg.max_source_positions if cfg.is_encdec else 4, 64)
    x = torch.from_numpy((0.1 * rng.standard_normal(shape)).astype(
        np.float32))
    extras = {"frames" if cfg.is_encdec else "patch_embeds": x}
    on_card = {k: v.to(card) for k, v in extras.items()}

    def close(got, want, what):
        got, want = got.float().cpu().numpy(), want.float().numpy()
        np.testing.assert_allclose(got, want, rtol=3e-4,
                                   atol=3e-4 * np.abs(want).max(),
                                   err_msg=what)

    forms0 = collections.Counter(fa_kernel.LAUNCHES_BY_FORM)
    gl, gc = gpu.prefill(toks[:, :16].to(card), **on_card)
    forms = dict(collections.Counter(fa_kernel.LAUNCHES_BY_FORM) - forms0)
    want_forms = {"causal": cfg.num_layers}
    if cfg.is_encdec:
        want_forms["bidirectional"] = cfg.encoder_layers
    assert forms == want_forms
    cl, cc = cpu.prefill(toks[:, :16], **extras)
    close(gl, cl, "prefill logits")
    from repro_torch.convert import _flatten
    from repro_torch.launch.serve import _splice_prefill
    gf, cf = _flatten(gc), _flatten(cc)
    for key in cf:
        close(gf[key], cf[key], key)
    gc = _splice_prefill(gpu.init_cache(2, 18), gc, 16)
    cc = _splice_prefill(cpu.init_cache(2, 18), cc, 16)
    for pos in (16, 17):
        gl, gc = gpu.decode_step(toks[:, pos:pos + 1].to(card), gc, pos)
        cl, cc = cpu.decode_step(toks[:, pos:pos + 1], cc, pos)
        close(gl, cl, f"decode {pos}")
    close(gpu.features(toks.to(card), **on_card),
          cpu.features(toks, **extras), "features")


# ---------------------------------------------------------------------------
# The scan kernels (csrc/ssm_scan.cu).  Tolerance: fp32 1e-5·max (fp32
# sums in another order); bf16 o 8e-3·max (one bf16 step), states fp32.
# ---------------------------------------------------------------------------

_GLA_CASES = [
    # B, H, T, Dk, Dv, chunk, dtype, bonus, strided (B,T,H,D) views
    (2, 4, 256, 64, 64, 16, "bfloat16", True, True),
    (2, 4, 256, 64, 64, 16, "bfloat16", False, True),
    (1, 3, 96, 64, 64, 16, "float32", True, False),
    (2, 2, 48, 32, 16, 32, "float32", False, False),   # ops halves to 16
    # the tiled forms at the main-path head size, chunks 16 and 32
    (2, 4, 256, 64, 64, 32, "bfloat16", True, True),
    (2, 4, 256, 64, 64, 32, "bfloat16", False, True),
    (2, 3, 128, 64, 64, 16, "float32", True, True),
    (2, 3, 128, 64, 64, 16, "float32", False, True),
    (2, 3, 128, 64, 64, 32, "float32", True, False),
    (2, 3, 128, 64, 64, 32, "float32", False, False),
    (2, 4, 200, 64, 64, 16, "bfloat16", True, True),   # ragged: 16 -> 8
    (1, 2, 64, 128, 128, 16, "float32", True, True),   # generic, D = 128
]


def _gla_case(dev, B, H, T, Dk, Dv, dtype, strided, seed=0):
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)

    def mk(D, lo=None):
        shape = (B, T, H, D) if strided else (B, H, T, D)
        x = (rng.uniform(lo, 1.0, shape) if lo is not None
             else rng.standard_normal(shape)).astype(np.float32)
        x = torch.from_numpy(x).to(dev)
        return x.transpose(1, 2) if strided else x

    q, k, v = (mk(D).to(dt) for D in (Dk, Dk, Dv))
    w = mk(Dk, lo=float(np.exp(-3.49)))
    u = torch.from_numpy(rng.standard_normal((H, Dk)).astype(np.float32)).to(dev)
    return q, k, v, w, u


@pytest.mark.cuda
@pytest.mark.parametrize("case", _GLA_CASES)
def test_gla_kernel_matches_plain(card, case):
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.kernels.ssm_scan import ref as sref

    B, H, T, Dk, Dv, chunk, dtype, bonus, strided = case
    q, k, v, w, u = _gla_case(card, B, H, T, Dk, Dv, dtype, strided)
    uu = u if bonus else None
    n0 = sk.LAUNCHES["gla"]
    o, s = sops.gla(q, k, v, w, uu, chunk=chunk)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["gla"] == n0 + 1
    assert o.dtype == v.dtype and o.shape == v.shape and o.stride() == v.stride()
    fit = chunk
    while T % fit:
        fit //= 2
    po, ps = sref.gla_chunked_ref(q, k, v, w, uu, chunk=fit)
    tol = 8e-3 if dtype == "bfloat16" else 1e-5
    for got, want, t in ((o, po, tol), (s, ps, 1e-5)):
        got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
        np.testing.assert_allclose(got, want, rtol=t,
                                   atol=t * np.abs(want).max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,T,N,P,chunk,strided", [
    (2, 8, 256, 64, 64, 32, True), (1, 3, 96, 8, 64, 32, False),
    (2, 2, 48, 16, 32, 32, True), (1, 2, 64, 128, 128, 32, True)])
def test_ssd_kernel_matches_plain(card, B, H, T, N, P, chunk, strided):
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.kernels.ssm_scan import ref as sref

    rng = np.random.default_rng(1)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(card)
    q, k = f(B, T, N), f(B, T, N)
    if strided:
        v = f(B, T, H, P).transpose(1, 2)
        a = torch.from_numpy(rng.uniform(1e-3, 1, (B, T, H)).astype(
            np.float32)).to(card).transpose(1, 2)
    else:
        v = f(B, H, T, P)
        a = torch.from_numpy(rng.uniform(1e-3, 1, (B, H, T)).astype(
            np.float32)).to(card)
    n0 = sk.LAUNCHES["ssd"]
    o, s = sops.ssd(q, k, v, a, chunk=chunk)
    torch.cuda.synchronize()
    assert sk.LAUNCHES["ssd"] == n0 + 1
    fit = chunk
    while T % fit:
        fit //= 2
    po, ps = sref.ssd_chunked_ref(q, k, v, a, chunk=fit)
    for got, want in ((o, po), (s, ps)):
        _close(got, want)


@pytest.mark.cuda
def test_scan_kernels_refuse_what_they_do_not_take(card):
    from repro_torch.kernels.ssm_scan import kernel as sk

    q, k, v, w, u = _gla_case(card, 1, 2, 64, 64, 64, "bfloat16", False)
    with pytest.raises(TypeError):
        sk.gla_cuda(q, k.float(), v, w, u, chunk=16)
    with pytest.raises(TypeError):
        sk.gla_cuda(q, k, v, w.bfloat16(), u, chunk=16)
    with pytest.raises(ValueError, match="multiple"):
        sk.gla_cuda(q, k, v, w, u, chunk=48)
    with pytest.raises(ValueError, match="contiguous last"):
        sk.gla_cuda(q, k.transpose(2, 3), v, w, u, chunk=16)
    with pytest.raises(ValueError, match="shared memory"):
        big = torch.zeros((1, 1, 64, 256), device=card)
        sk.gla_cuda(big, big, big, big, None, chunk=64)
    # the tiled form takes head size 64 only, and aligned rows
    q32, k32, v32, w32, u32 = _gla_case(card, 1, 2, 64, 32, 32, "bfloat16",
                                        False)
    with pytest.raises(ValueError, match="does not take"):
        sk.gla_cuda(q32, k32, v32, w32, u32, chunk=16, form="tiled")
    with pytest.raises(ValueError, match="forms are"):
        sk.gla_cuda(q, k, v, w, u, chunk=16, form="fast")
    qo, ko, vo, wo, uo = _gla_case(card, 1, 2, 64, 65, 65, "float32", False)
    with pytest.raises(ValueError, match="does not take"):
        sk.gla_cuda(qo[..., 1:], ko[..., 1:], vo[..., 1:], wo[..., 1:],
                    uo[:, 1:], chunk=16, form="tiled")
    q64, k64, v64, a64 = _ssd_case(card, 1, 2, 64, 64, 64)
    with pytest.raises(ValueError, match="does not take"):
        sk.ssd_cuda(q64, k64, v64, a64, chunk=64, form="tiled")
    qs = torch.zeros((1, 64, 8), device=card)
    with pytest.raises(TypeError):
        sk.ssd_cuda(qs, qs, torch.zeros((1, 2, 64, 8), device=card).bfloat16(),
                    torch.ones((1, 2, 64), device=card), chunk=32)


def _ssd_case(dev, B, H, T, N, P, strided=True, seed=1):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dev)
    q, k = f(B, T, N), f(B, T, N)
    if strided:
        v = f(B, T, H, P).transpose(1, 2)
        a = torch.from_numpy(rng.uniform(1e-3, 1, (B, T, H)).astype(
            np.float32)).to(dev).transpose(1, 2)
    else:
        v = f(B, H, T, P)
        a = torch.from_numpy(rng.uniform(1e-3, 1, (B, H, T)).astype(
            np.float32)).to(dev)
    return q, k, v, a


def _rel(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


# The two forms of each scan (kernel.py): the tiled form at head size 64
# and chunks 1..32, the generic form elsewhere.  Tiled and generic agree
# byte for byte (the source note says why); both within the tolerances
# above of plain and of the fp64 naive oracle.
_TILED_GLA = [
    # B, H, T, chunk asked, dtype, bonus
    (2, 4, 256, 16, "bfloat16", True), (2, 4, 256, 16, "bfloat16", False),
    (2, 4, 256, 32, "bfloat16", True), (2, 4, 256, 32, "float32", False),
    (2, 3, 200, 16, "float32", True),                 # 16 -> 8
    (2, 3, 40, 8, "bfloat16", True), (2, 3, 12, 4, "float32", False),
    (2, 3, 6, 2, "bfloat16", False), (2, 3, 5, 1, "float32", True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _TILED_GLA)
def test_gla_tiled_form(card, case):
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.kernels.ssm_scan import ref as sref

    B, H, T, chunk, dtype, bonus = case
    q, k, v, w, u = _gla_case(card, B, H, T, 64, 64, dtype, True)
    uu = u if bonus else None
    fit = sops._fit_chunk(chunk, T)
    n0 = sk.LAUNCHES["gla:tiled"]
    got = sops.gla(q, k, v, w, uu, chunk=chunk)
    assert sk.LAUNCHES["gla:tiled"] == n0 + 1
    gen = sk.gla_cuda(q, k, v, w, uu, chunk=fit, form="generic")
    torch.cuda.synchronize()
    for x, y in zip(got, gen):
        assert torch.equal(x, y)
    tol = 8e-3 if dtype == "bfloat16" else 1e-5
    plain = sref.gla_chunked_ref(q, k, v, w, uu, chunk=fit)
    exact = sref.gla_naive(*(None if x is None else x.double()
                             for x in (q, k, v, w, uu)))
    for x, p, e, t in zip(got, plain, exact, (tol, 1e-5)):
        assert _rel(x, p) <= t and _rel(x, e) <= t


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,T,chunk", [
    (2, 8, 256, 32), (2, 3, 256, 32), (2, 4, 200, 32), (2, 2, 48, 16),
    (1, 2, 40, 8), (2, 3, 12, 4), (1, 2, 6, 2), (2, 1, 5, 1)])
def test_ssd_tiled_form(card, B, H, T, chunk):
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.kernels.ssm_scan import ref as sref

    q, k, v, a = _ssd_case(card, B, H, T, 64, 64)
    fit = sops._fit_chunk(chunk, T)
    n0 = sk.LAUNCHES["ssd:tiled"]
    got = sops.ssd(q, k, v, a, chunk=chunk)
    assert sk.LAUNCHES["ssd:tiled"] == n0 + 1
    assert sk.ssd_plan(B, H, T, 64, 64, fit).group == (2 if H % 2 == 0 else 1)
    gen = sk.ssd_cuda(q, k, v, a, chunk=fit, form="generic")
    torch.cuda.synchronize()
    for x, y in zip(got, gen):
        assert torch.equal(x, y)
    plain = sref.ssd_chunked_ref(q, k, v, a, chunk=fit)
    exact = sref.ssd_naive(*(x.double() for x in (q, k, v, a)))
    for x, p, e in zip(got, plain, exact):
        assert _rel(x, p) <= 1e-5 and _rel(x, e) <= 1e-5


@pytest.mark.cuda
def test_scan_route_by_shape(card):
    """Which form each shape takes, as LAUNCHES counts it: the tiled form
    at head size 64 with 16-byte aligned rows, the generic form at
    Dk != Dv, N = 8, D = 128, a chunk of 64 and rows off the 16-byte grid."""
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan import ops as sops

    def route(fn):
        before = dict(sk.LAUNCHES)
        fn()
        torch.cuda.synchronize()
        return sorted(k for k, n in sk.LAUNCHES.items()
                      if ":" in k and n > before.get(k, 0))

    q, k, v, w, u = _gla_case(card, 1, 2, 64, 64, 64, "bfloat16", True)
    assert route(lambda: sops.gla(q, k, v, w, u, chunk=16)) == ["gla:tiled"]
    assert route(lambda: sk.gla_cuda(q, k, v, w, u, chunk=64)) == [
        "gla:generic"]
    for Dk, Dv in ((64, 32), (128, 128), (8, 8)):
        q, k, v, w, u = _gla_case(card, 1, 2, 64, Dk, Dv, "float32", True)
        assert route(lambda: sops.gla(q, k, v, w, u, chunk=16)) == [
            "gla:generic"]
    # a view whose rows start 4 bytes off the 16-byte grid
    q, k, v, w, u = _gla_case(card, 1, 2, 64, 65, 64, "float32", False)
    q1, k1, w1 = (x[..., 1:] for x in (q, k, w))
    assert route(lambda: sops.gla(q1, k1, v, w1, u[:, 1:], chunk=16)) == [
        "gla:generic"]
    qs, ks, vs, a = _ssd_case(card, 1, 2, 64, 64, 64)
    assert route(lambda: sops.ssd(qs, ks, vs, a, chunk=32)) == ["ssd:tiled"]
    for N, P in ((8, 64), (128, 128)):
        qs, ks, vs, a = _ssd_case(card, 1, 2, 64, N, P)
        assert route(lambda: sops.ssd(qs, ks, vs, a, chunk=32)) == [
            "ssd:generic"]


@pytest.mark.cuda
@pytest.mark.parametrize("scan", ["gla-bonus", "gla-post", "ssd"])
def test_tiled_scan_is_batch_invariant_and_deterministic(card, scan):
    """The tiled form on a slice of the batch and the heads equals the same
    slice of the run on the whole (torch.equal on o and the state), and
    a second run gives the same bytes."""
    from repro_torch.kernels.ssm_scan import ops as sops

    hs = slice(2, 6)
    if scan == "ssd":       # heads 1..4: other pairs than the whole's
        hs = slice(1, 5)
        q, k, v, a = _ssd_case(card, 4, 6, 128, 64, 64)
        whole = sops.ssd(q, k, v, a, chunk=32)
        again = sops.ssd(q, k, v, a, chunk=32)
        part = sops.ssd(q[1:3], k[1:3], v[1:3, hs], a[1:3, hs], chunk=32)
    else:
        q, k, v, w, u = _gla_case(card, 4, 6, 128, 64, 64, "bfloat16", True)
        uu = u if scan == "gla-bonus" else None

        def run(b, h):
            return sops.gla(q[b, h], k[b, h], v[b, h], w[b, h],
                            None if uu is None else uu[h], chunk=16)
        whole = run(slice(None), slice(None))
        again = run(slice(None), slice(None))
        part = run(slice(1, 3), hs)
    torch.cuda.synchronize()
    for x, y, z in zip(whole, again, part):
        assert torch.equal(x, y)
        assert torch.equal(x[1:3, hs], z)


@pytest.mark.cuda
def test_scan_plan_shared_memory_is_the_library_s(card):
    """kernel.py's plans (which the CPU tests check) count the shared
    memory the library asks for, and SMEM_MAX is the library's."""
    from repro_torch.kernels.ssm_scan import kernel as sk

    lib = sk.library()
    assert lib.ssm_smem_max() == sk.SMEM_MAX
    for C in sk.TILED_CHUNKS:
        for item, dt in ((4, 0), (2, 1)):
            for bonus in (0, 1):
                for form in ("tiled", "generic"):
                    p = sk.gla_plan(1, 2, 64, 64, 64, C, item, bool(bonus),
                                    form=form)
                    assert lib.ssm_gla_smem_bytes(sk.FORMS[form], dt, bonus,
                                                  C, 64, 64) == p.smem
        for H in (2, 3):
            p = sk.ssd_plan(1, H, 64, 64, 64, C)
            assert lib.ssm_ssd_smem_bytes(1, p.group, C, 64, 64) == p.smem
    assert lib.ssm_gla_smem_bytes(1, 1, 1, 16, 32, 32) == -1
    assert lib.ssm_ssd_smem_bytes(1, 2, 64, 64, 64) == -1
    assert lib.ssm_ssd_smem_bytes(0, 1, 32, 8, 64) == sk.ssd_plan(
        1, 2, 64, 8, 64, 32).smem


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-3b-smoke", "zamba2-1.2b-smoke"])
def test_recurrent_features_kernel_matches_plain(card, arch, monkeypatch):
    import dataclasses

    from repro_torch.config import ParallelConfig
    from repro_torch.configs import get_config
    from repro_torch.data.event_dgp import make_event_data
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.kernels.ssm_scan import ref as sref
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(get_config(arch), d_model=128, num_layers=3,
                              compute_dtype=torch.bfloat16)
    # rwkv6 has no attention, so it needs no flash flag on the card
    par = (ParallelConfig() if cfg.family == "ssm"
           else ParallelConfig(use_flash_attention=True))
    model = Model(cfg, par, device=card, seed=3)
    d = make_event_data(24, 96, cfg.vocab_size, seed=1, device=card)
    key = "gla" if cfg.family == "ssm" else "ssd"
    n0 = sk.LAUNCHES[key]
    got = model.features(d.tokens)
    assert sk.LAUNCHES[key] == n0 + cfg.num_layers
    monkeypatch.setattr(sops, "gla", lambda *a, chunk, **kw: sref.gla_chunked_ref(
        *a, chunk=chunk, **kw))
    monkeypatch.setattr(sops, "ssd", lambda *a, chunk: sref.ssd_chunked_ref(
        *a, chunk=chunk))
    monkeypatch.setattr(fa_ops, "flash_attention", _fa_plain)
    want = model.features(d.tokens)
    assert sk.LAUNCHES[key] == n0 + cfg.num_layers
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


def _inference_case(a, name):
    """(builder, inputs, seg_reduce keywords) of one inference form with
    per-replicate columns (R, n, 1), weights (R, n) and theta (R, 1, p)."""
    W = a["W"]
    rep = lambda x: torch.stack([x * (1 + 0.25 * b)          # noqa: E731
                                 for b in range(W.shape[0])])
    if name == "fold_weighted":
        return ref.build_fold_weighted, [W.T.contiguous(), a["D"]], {}
    if name == "residual_direct":
        return (ref.build_residual_direct, [rep(a["y"]), rep(a["t"]),
                                            a["phi"]], dict(w=W))
    if name == "residual_meat":
        th = torch.stack([a["theta"] * (1 + 0.5 * b)
                          for b in range(W.shape[0])])
        zero = torch.zeros_like(rep(a["y"]))
        return (ref.build_residual_meat, [rep(a["y"]), rep(a["t"]), zero,
                                          zero, a["phi"], th, rep(a["w"])],
                {})
    if name == "iv":
        return (ref.build_iv, [rep(a["y"]), rep(a["t"]), rep(a["my"]),
                               a["phi"]], dict(w=W))
    if name == "iv_segmented":
        return (ref.build_iv, [a["y"], a["t"], a["my"], a["phi"]],
                dict(seg=a["seg"], n_segments=_S))
    th = torch.stack([a["theta"] * (1 + 0.5 * b) for b in range(W.shape[0])])
    return (ref.build_iv_meat, [rep(a["y"]), rep(a["t"]), rep(a["my"]),
                                a["phi"], th, rep(a["w"])], {})


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fold_weighted", "residual_direct",
                                  "residual_meat", "iv", "iv_segmented",
                                  "iv_meat"])
def test_inference_form_matches_plain(card, name):
    from repro_torch.kernels.seg_gram import kernel as kern

    a = _inputs(card)
    builder, col, kw = _inference_case(a, name)
    kern.LAUNCHES.clear()
    got = ops.seg_reduce(builder, col, **kw)
    assert dict(kern.LAUNCHES) == {name: 1}
    want = ops.seg_reduce(builder, [c.cpu() for c in col],
                          **{k: v.cpu() if torch.is_tensor(v) else v
                             for k, v in kw.items()})
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.cuda
def test_partial_buffer_that_does_not_fit_raises(card):
    from repro_torch.kernels.seg_gram import kernel as kern

    X = torch.randn((10, 2000), device=card)
    w = torch.ones((10_000, 10), device=card)          # 160 GB of partials
    with pytest.raises(RuntimeError, match=r"\(1, 10000, 2000, 2000\)"):
        kern.seg_gram_cuda("design", X, w=w)


def _boot_data(n=3000, p=6):
    from repro_torch.data.causal_dgp import make_iv_data

    return make_iv_data(n, p, seed=4, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["bootstrap", "multiplier"])
def test_bootstrap_on_card_matches_cpu(card, method):
    from repro_torch.config import CausalConfig
    from repro_torch.core.dml import DML
    from repro_torch.kernels.seg_gram import kernel as kern

    d = _boot_data()
    cfg = CausalConfig(cate_features=2, inference=method, n_bootstrap=6,
                       runtime_chunk=4, row_block=1024,
                       row_block_strategy="pallas")
    out = {}
    for dev in ("cpu", card):
        res = DML(cfg, device=dev).fit(d.y, d.t, d.X)
        kern.LAUNCHES.clear()
        inf = res.inference()
        out[str(dev)] = (inf, res.ate_interval(), res.cate_interval(d.X[:4]))
    launches = dict(kern.LAUNCHES)
    cpu, gpu = out["cpu"], out[str(card)]
    np.testing.assert_allclose(gpu[0].replicates.cpu().numpy(),
                               cpu[0].replicates.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(gpu[1], cpu[1], rtol=1e-4)
    # two chunks of 4 and 2 replicates: ridge 1 + logistic 2 x 16
    # fold-weighted Grams, the weighted final stage and its meat, each
    assert launches == {"fold_weighted": 2 * 33, "residual_direct": 2,
                        "residual_meat": 2}


@pytest.mark.cuda
def test_serial_equals_batched_on_card(card):
    from repro_torch.config import CausalConfig
    from repro_torch.core.dml import DML

    d = _boot_data()
    cfg = CausalConfig(cate_features=2, n_bootstrap=4, runtime_chunk=3,
                       row_block=1024, row_block_strategy="pallas")
    res = DML(cfg, device=card).fit(d.y, d.t, d.X)
    batched = res.inference(executor="vmap")
    serial = res.inference(executor="serial")
    assert torch.equal(serial.replicates, batched.replicates)
    assert torch.equal(serial.replicate_se, batched.replicate_se)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["jackknife", "bootstrap"])
def test_orthoiv_on_card_matches_cpu(card, method):
    from repro_torch.config import CausalConfig
    from repro_torch.core.iv import OrthoIV

    d = _boot_data()
    cfg = CausalConfig(inference=method, n_bootstrap=4, row_block=1024,
                       row_block_strategy="pallas")
    out = []
    for dev in ("cpu", card):
        res = OrthoIV(cfg, device=dev).fit(d.y, d.t, d.z, d.X)
        out.append((res.theta.cpu(), res.inference().replicates.cpu(),
                    res.late_interval()))
    for got, want in zip(out[1][:2], out[0][:2]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(out[1][2], out[0][2], rtol=1e-4)


# ---------------------------------------------------------------------------
# The segment walk: build_pair (segment_outer) and every S > 1 form.
# ---------------------------------------------------------------------------

# (qU, qV or None for U = V, S, n, weighted, seeded): the sweep's MM
# terms (5 x q, 1 x q), its final stage (2 x 2), the store's
# accumulators (seeded), and one segment longer than a unit's rows
_PAIR_CASES = [
    (5, 301, 7, 3001, False, False),
    (1, 300, 20, 3001, True, False),
    (2, None, 4, 3001, False, False),
    (40, None, 6, 3001, False, True),
    (70, None, 3, 40_000, True, False),
    (3, 250, 2, 9000, False, True),
]


def _pair_inputs(dev, qU, qV, S, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    U = torch.randn((n, qU), generator=g)
    V = U if qV is None else torch.randn((n, qV), generator=g)
    seg = torch.randint(-1, S, (n,), generator=g)
    w = torch.rand(n, generator=g)
    init = torch.randn((S, qU, qU if qV is None else qV), generator=g)
    return [x.to(dev) for x in (U, V, seg, w, init)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _PAIR_CASES)
def test_pair_kernel_matches_plain(card, case):
    from repro_torch.kernels.seg_gram import kernel as kern

    qU, qV, S, n, weighted, seeded = case
    U, V, seg, w, init = _pair_inputs(card, qU, qV, S, n)
    kw = dict(w=w if weighted else None, init=init if seeded else None)
    kern.LAUNCHES.clear()
    got = ops.segment_outer(U, V, seg, S, **kw)
    assert dict(kern.LAUNCHES) == {"pair": 1}
    want = ops.segment_outer(U.cpu(), V.cpu(), seg.cpu(), S,
                             **{k: None if v is None else v.cpu()
                                for k, v in kw.items()})
    assert got.shape == want.shape == (S, qU, qU if qV is None else qV)
    _close(got, want)


@pytest.mark.cuda
def test_segment_walk_invariants(card):
    """Bitwise on the card: a second run, appended rows with seg = -1
    and appended zero rows, an empty segment, power-of-two weights, and
    two seeded ingests against one pass over both."""
    U, V, seg, w, _ = _pair_inputs(card, 6, 37, 5, 50_000, seed=3)
    seg = torch.where(seg == 2, torch.ones_like(seg), seg)   # 2 is empty
    G = ops.segment_outer(U, V, seg, 5, w=w)
    assert torch.equal(G, ops.segment_outer(U, V, seg, 5, w=w))
    assert bool((G[2] == 0).all())
    pad = 20_000
    Up = torch.cat([U, torch.randn((pad, 6), device=card)])
    Vp = torch.cat([V, torch.randn((pad, 37), device=card)])
    segp = torch.cat([seg, torch.full((pad,), -1, device=card)])
    wp = torch.cat([w, torch.rand(pad, device=card)])
    assert torch.equal(G, ops.segment_outer(Up, Vp, segp, 5, w=wp))
    Uz = torch.cat([U, torch.zeros((pad, 6), device=card)])
    Vz = torch.cat([V, torch.zeros((pad, 37), device=card)])
    segz = torch.cat([seg, torch.randint(0, 5, (pad,), device=card)])
    wz = torch.cat([w, torch.ones(pad, device=card)])
    assert torch.equal(G, ops.segment_outer(Uz, Vz, segz, 5, w=wz))
    assert torch.equal(2.0 * G, ops.segment_outer(U, V, seg, 5, w=2.0 * w))
    zero = torch.zeros((5, 6, 37), device=card)
    half = 23_456
    one = ops.segment_outer(U, V, seg, 5, w=w, init=zero)
    first = ops.segment_outer(U[:half], V[:half], seg[:half], 5,
                              w=w[:half], init=zero)
    both = ops.segment_outer(U[half:], V[half:], seg[half:], 5,
                             w=w[half:], init=first)
    assert torch.equal(one, both)
    assert bool((zero == 0).all())            # init is only read
    _close(one, G)


@pytest.mark.cuda
def test_walk_plan_bounds_the_partials(card):
    """A segment far longer than a unit's rows is split; the unit table
    has ceil(n / rs) + S entries whatever the segment sizes."""
    from repro_torch.kernels.seg_gram import kernel as kern

    n, S = 100_000, 3
    seg = torch.zeros(n, dtype=torch.long, device=card)
    seg[-5:] = 2                                # 1 is empty
    rs = int(kern.library().seg_gram_split_rows(502, 502))
    plan = kern.walk_plan(seg, S, rs)
    assert plan.useg.shape[0] == -(-n // rs) + S
    first = plan.first.tolist()
    assert first[1] - first[0] == -(-(n - 5) // rs)
    assert first[2] - first[1] == 1 and first[3] - first[2] == 1
    D = torch.randn((n, 70), device=card)
    G = ops.seg_reduce(ref.build_design, [D], seg=seg, n_segments=S)
    want = ops.seg_reduce(ref.build_design, [D.cpu()], seg=seg.cpu(),
                          n_segments=S)
    _close(G, want)
    assert bool((G[1] == 0).all())


def _sweep_data(n=3000, p=6, E=4, seed=0):
    from repro_torch.data.causal_dgp import paper_demo_data

    d = paper_demo_data(n=n, p=p, seed=seed, device="cpu")
    sids = torch.randint(0, E, (n,), generator=torch.Generator()
                         .manual_seed(seed + 1))
    return d, sids


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["chunked", "pallas"])
def test_sweep_on_card_matches_cpu(card, strategy):
    from repro_torch.config import CausalConfig
    from repro_torch.sweep import SweepSpec, sweep

    d, sids = _sweep_data()
    cfg = CausalConfig(n_folds=3, inference="none", row_block=512,
                       row_block_strategy=strategy, newton_iters=4)
    spec = SweepSpec(4, (("dml", cfg), ("drlearner", cfg)))
    out = [sweep(spec, X=d.X, y=d.y, t=d.t, segment_ids=sids,
                 mode="segmented", device=dev) for dev in ("cpu", card)]
    got, want = out[1].columns[0], out[0].columns[0]
    assert got.events == ("segmented",)
    np.testing.assert_allclose(got.thetas.cpu().numpy(),
                               want.thetas.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.ses.cpu().numpy(), want.ses.numpy(),
                               rtol=1e-4, atol=1e-6)
    # the drlearner column has no segmented kernel: it runs as masked
    # cells, on the same per-cell folds on both devices
    dr, dr_cpu = out[1].columns[1], out[0].columns[1]
    assert not dr.failed and dr.events == ()
    np.testing.assert_allclose(dr.thetas.cpu().numpy(),
                               dr_cpu.thetas.numpy(), rtol=1e-4, atol=1e-5)


def _store_data(n=4096, p=8, seed=0):
    from repro_torch.data.causal_dgp import make_causal_data

    d = make_causal_data(n=n, p=p, seed=seed, device="cpu",
                         discrete_treatment=False)
    sids = torch.randint(0, 6, (n,), generator=torch.Generator()
                         .manual_seed(seed + 1))
    return d, sids


def _store(card, strategy, cuts, d, sids):
    from repro_torch.config import CausalConfig
    from repro_torch.store import MomentStore
    from repro_torch.sweep import SweepSpec

    cfg = CausalConfig(n_folds=3, inference="none", row_block=512,
                       row_block_strategy=strategy, nuisance_t="ridge",
                       discrete_treatment=False, cate_features=2)
    s = MomentStore(SweepSpec(6, (("dml", cfg),)), n_features=d.p,
                    device=card)
    bounds = [0, *cuts, d.n]
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        s.ingest(X=d.X[lo:hi], y=d.y[lo:hi], t=d.t[lo:hi],
                 segment_ids=sids[lo:hi])
    return s


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["chunked", "pallas"])
def test_store_on_card(card, strategy):
    """Card against CPU (1e-4); incremental against one-shot, bitwise:
    aligned cuts on "chunked", any cuts on the card's seeded walk."""
    d, sids = _store_data()
    cuts = (1024, 3072) if strategy == "chunked" else (1000, 2777)
    one = _store(card, strategy, (), d, sids)
    inc = _store(card, strategy, cuts, d, sids)
    cpu = _store("cpu", strategy, cuts, d, sids)
    a, b = one.state_dict()["col0"], inc.state_dict()["col0"]
    for key in ("ng", "vg", "counts"):
        assert torch.equal(a[key], b[key]), key
    pa, pc = inc.refresh(), cpu.refresh()
    assert torch.equal(one.refresh().columns[0].thetas, pa.columns[0].thetas)
    np.testing.assert_allclose(pa.columns[0].thetas.cpu().numpy(),
                               pc.columns[0].thetas.numpy(), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.cuda
def test_segment_outer_row_block_without_mesh_is_one_pass(card):
    """With no data mesh ``row_block`` changes nothing: the pair form at
    the store's seeded shape and the sweep's final stage is bitwise the
    call without it, in one launch each."""
    from repro_torch.kernels.seg_gram import kernel as kern

    g = torch.Generator().manual_seed(11)
    n, q, S = 20_000, 37, 12
    U = torch.randn((n, q), generator=g).to(card)
    seg = torch.randint(-1, S, (n,), generator=g).to(card)
    init = torch.randn((S, q, q), generator=g).to(card)
    for kw in ({}, {"init": init}):
        want = ops.segment_outer(U, U, seg, S, **kw)
        kern.LAUNCHES.clear()
        got = ops.segment_outer(U, U, seg, S, row_block=4096, **kw)
        assert dict(kern.LAUNCHES) == {"pair": 1}
        assert torch.equal(got, want), kw


@pytest.mark.cuda
def test_store_ingest_one_rank_mesh_on_card(card):
    """A store under the card's one-rank mesh ("pallas"): each block of
    row_block rows one pair launch a Gram, one-shot ≡ two aligned
    ingests bitwise, within 1e-5 relative plus 1e-5·max of the store
    with no mesh (there init seeds the kernel's accumulator, here the
    blocks' fold)."""
    from repro_torch.config import CausalConfig
    from repro_torch.kernels.seg_gram import kernel as kern
    from repro_torch.runtime import make_data_mesh
    from repro_torch.store import MomentStore
    from repro_torch.sweep import SweepSpec

    d, sids = _store_data()
    cfg = CausalConfig(n_folds=3, inference="none", row_block=512,
                       row_block_strategy="pallas", nuisance_t="ridge",
                       discrete_treatment=False, cate_features=2)
    spec = SweepSpec(6, (("dml", cfg),))
    dm = make_data_mesh(device=card)

    def store(cuts, mesh):
        s = MomentStore(spec, n_features=d.p, data_mesh=mesh, device=card)
        bounds = [0, *cuts, d.n]
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            s.ingest(X=d.X[lo:hi], y=d.y[lo:hi], t=d.t[lo:hi],
                     segment_ids=sids[lo:hi])
        return s

    kern.LAUNCHES.clear()
    inc = store((2048,), dm)
    assert dict(kern.LAUNCHES) == {"pair": 2 * (d.n // 512)}
    one, plain = store((), dm), store((), None)
    a, b, c = (x.state_dict()["col0"] for x in (one, inc, plain))
    for key in ("ng", "vg", "counts"):
        assert torch.equal(a[key], b[key]), key
        _close(a[key], c[key])
    assert bool(torch.isfinite(inc.refresh().columns[0].thetas).all())


# ---------------------------------------------------------------------------
# The large-tile template: one triangle of a symmetric Gram, mirrored.
# ---------------------------------------------------------------------------

def _big_inputs(q, n=20_000, seed=0):
    g = torch.Generator().manual_seed(seed)
    r = {k: torch.randn((n, 1), generator=g) for k in ("y", "t", "my", "mt",
                                                       "rz", "w")}
    r["w"] = r["w"].abs()
    r["X"] = torch.randn((n, q), generator=g)
    r["W"] = torch.rand((3, n), generator=g)
    r["theta"] = torch.randn((1, q), generator=g)
    r["seg"] = torch.randint(-1, 4, (n,), generator=g)
    return r


def _big_cases(a, q):
    """(name, builder, arrays, keywords) of every symmetric builder at
    output width q (iv: 2·dX + 1 = q or q - 1)."""
    X, dX = a["X"], (q - 1) // 2
    cols = [a["y"], a["t"], a["my"], a["mt"]]
    return [
        ("design k=3", ref.build_design, [X], dict(w=a["W"])),
        ("design S=4", ref.build_design, [X], dict(seg=a["seg"],
                                                   n_segments=4)),
        ("fold_weighted", ref.build_fold_weighted, [a["W"].T.contiguous(), X],
         {}),
        ("residual", ref.build_residual, cols + [X[:, :q - 1]], {}),
        ("residual_direct", ref.build_residual_direct,
         [a["y"], a["t"], X[:, :q - 1]], dict(w=a["W"])),
        ("residual_meat", ref.build_residual_meat,
         cols + [X, a["theta"], a["w"]], {}),
        ("iv", ref.build_iv, [a["y"], a["t"], a["rz"], X[:, :dX]],
         dict(w=a["W"])),
        ("iv S=4", ref.build_iv, [a["y"], a["t"], a["rz"], X[:, :dX]],
         dict(seg=a["seg"], n_segments=4)),
        ("iv_meat", ref.build_iv_meat,
         [a["y"], a["t"], a["rz"], X, a["theta"]], {}),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("q", [130, 502])
def test_big_tile_symmetric_grams_are_bitwise_symmetric(card, q):
    """Every symmetric builder at a width that is not a multiple of the
    128-wide tile: bitwise equal to its transpose, and within 1e-4 of
    plain (chip_smoke.py's KERNEL_TOL: at q = 502 the meats' residual e
    is a 502-term fp32 dot, which the kernel sums row by row and the
    plain version by torch's reduction -- 2e-5 of the largest element
    apart); gram_and_vec's X block bitwise symmetric and its v row (and
    all of it) against plain (1e-5)."""
    a = _big_inputs(q)
    dev = {k: v.to(card) for k, v in a.items()}
    for name, builder, arrays, kw in _big_cases(dev, q):
        got = ops.seg_reduce(builder, [x.contiguous() for x in arrays], **kw)
        want = ops.seg_reduce(builder, [x.cpu().contiguous() for x in arrays],
                              **{k: v.cpu() if torch.is_tensor(v) else v
                                 for k, v in kw.items()})
        assert got.shape == want.shape, name
        np.testing.assert_allclose(
            got.double().cpu().numpy(), want.double().numpy(), rtol=1e-4,
            atol=1e-4 * float(want.abs().max()), err_msg=name)
        got = got.reshape(-1, got.shape[-1], got.shape[-1])   # fold_weighted
        assert torch.equal(got, got.transpose(-1, -2)), name
    X, W = dev["X"], dev["W"]
    G, b = ops.gram_and_vec(X, W, 0.5 - W)
    assert torch.equal(G, G.transpose(-1, -2))
    Gc, bc = ops.gram_and_vec(X.cpu(), W.cpu(), 0.5 - W.cpu())
    _close(G, Gc)
    _close(b, bc)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [130, 503])
def test_big_tile_symmetric_pair(card, q):
    """pair of one tensor with itself takes the triangle: bitwise
    symmetric, split and seeded with a symmetric init, two seeded
    ingests bitwise one pass; with an asymmetric init, or V a copy of U
    (another tensor), the full square — each against plain."""
    g = torch.Generator().manual_seed(q)
    n, S = 30_000, 5
    U = torch.randn((n, q), generator=g)
    seg = torch.randint(-1, S, (n,), generator=g)
    w = torch.rand(n, generator=g)
    init = torch.randn((S, q, q), generator=g)
    Ud, segd, wd, initd = (x.to(card) for x in (U, seg, w, init))
    sym = initd + initd.transpose(1, 2)
    for kw in (dict(), dict(w=wd), dict(init=sym)):
        got = ops.segment_outer(Ud, Ud, segd, S, **kw)
        assert torch.equal(got, got.transpose(1, 2))
        want = ops.segment_outer(U, U, seg, S, **{
            k: v.cpu() for k, v in kw.items()})
        _close(got, want)
    half = 12_345
    first = ops.segment_outer(Ud[:half], Ud[:half], segd[:half], S, init=sym)
    both = ops.segment_outer(Ud[half:], Ud[half:], segd[half:], S,
                             init=first)
    assert torch.equal(both, ops.segment_outer(Ud, Ud, segd, S, init=sym))
    for V, kw in ((Ud, dict(init=initd)), (Ud.clone(), dict(w=wd))):
        got = ops.segment_outer(Ud, V, segd, S, **kw)
        want = ops.segment_outer(U, U, seg, S, **{
            k: v.cpu() for k, v in kw.items()})
        _close(got, want)


@pytest.mark.cuda
def test_big_tile_seeded_pair_rechecks_a_written_init(card):
    """A symmetric walk's own result seeds the next walk without a
    symmetry check; written in place since (and asymmetric now), it is
    read for symmetry again and takes the full square — against plain."""
    from repro_torch.kernels.seg_gram import kernel as kern

    g = torch.Generator().manual_seed(7)
    n, S, q = 20_000, 4, 130
    U = torch.randn((n, q), generator=g)
    seg = torch.randint(0, S, (n,), generator=g)
    Ud, segd = U.to(card), seg.to(card)
    first = ops.segment_outer(Ud, Ud, segd, S)
    assert kern._known_symmetric(first)
    first[:, 0, 1] += 1.0
    assert not kern._known_symmetric(first)
    got = ops.segment_outer(Ud, Ud, segd, S, init=first)
    assert not torch.equal(got, got.transpose(1, 2))
    _close(got, first.cpu() + ops.segment_outer(U, U, seg, S))


@pytest.mark.cuda
def test_big_tile_schedule_is_kernel_py_s(card):
    """The tiles that csrc/seg_gram.cu's tiles_big / tile_of launch (read
    through the library's seg_gram_tile_schedule) are kernel.py's
    tile_schedule, whose coverage tests/test_torch_seg_gram.py proves."""
    import ctypes

    from repro_torch.kernels.seg_gram import kernel as kern

    lib = kern.library()
    for qL, qR, sym in ((130, 130, True), (131, 130, True), (128, 128, True),
                        (502, 502, True), (503, 502, True),
                        (1006, 1006, True), (2050, 2049, True),
                        (257, 256, True), (37, 37, False), (5, 37, False),
                        (502, 502, False), (2561, 2561, False)):
        cap = lib.seg_gram_tile_schedule(qL, qR, int(sym), None, None, 0)
        ti, tj = (ctypes.c_int * cap)(), (ctypes.c_int * cap)()
        lib.seg_gram_tile_schedule(qL, qR, int(sym), ti, tj, cap)
        assert list(zip(ti, tj)) == kern.tile_schedule(qL, qR, sym), (qL, qR)


# ---------------------------------------------------------------------------
# The thin and small kernels: every launch of the THIN and SMALL
# configurations, against the CPU and bitwise against themselves.
# ---------------------------------------------------------------------------

def _walk_ids(rs, extra, S, seed):
    """Segment ids of 3·rs + extra rows: segments 0, 1 and 2 hold rs - 1,
    rs and rs + 1 rows, the extra rows go to segments 3 .. S-2 or to -1,
    segment S - 1 is empty; in shuffled order."""
    g = torch.Generator().manual_seed(seed)
    rest = torch.randint(3, S - 1, (extra,), generator=g)
    rest[torch.rand(extra, generator=g) < 0.05] = -1
    ids = torch.cat([torch.full((rs - 1,), 0), torch.full((rs,), 1),
                     torch.full((rs + 1,), 2), rest])
    return ids[torch.randperm(ids.shape[0], generator=g)]


def _walk_kernel_checks(card, qL, qR, sym=False, seed=0):
    """pair at (qL, qR) over segments of rs - 1, rs and rs + 1 rows, n not
    a multiple of rs: unweighted, weighted, seeded and both against the
    CPU (1e-4); then bitwise a second run, appended seg = -1 rows and
    zero rows, the empty segment, and two seeded ingests against one
    pass."""
    from repro_torch.kernels.seg_gram import kernel as kern

    rs = int(kern.library().seg_gram_split_rows(qL, qR))
    S = 7
    seg = _walk_ids(rs, 3001, S, seed)
    n = seg.shape[0]
    g = torch.Generator().manual_seed(seed + 1)
    U = torch.randn((n, qL), generator=g)
    V = U if sym else torch.randn((n, qR), generator=g)
    w = torch.rand(n, generator=g)
    init = torch.randn((S, qL, qR), generator=g)
    if sym:
        init = init + init.transpose(1, 2)
    Ud, segd, wd, initd = (x.to(card) for x in (U, seg, w, init))
    Vd = Ud if sym else V.to(card)
    for kw in (dict(), dict(w=wd), dict(init=initd), dict(w=wd, init=initd)):
        got = ops.segment_outer(Ud, Vd, segd, S, **kw)
        want = ops.segment_outer(U, V, seg, S, **{
            k: v.cpu() for k, v in kw.items()})
        assert got.shape == want.shape == (S, qL, qR)
        np.testing.assert_allclose(
            got.double().cpu().numpy(), want.double().numpy(), rtol=1e-4,
            atol=1e-4 * float(want.abs().max()), err_msg=str(kw.keys()))
    G = ops.segment_outer(Ud, Vd, segd, S, w=wd)
    assert torch.equal(G, ops.segment_outer(Ud, Vd, segd, S, w=wd))
    assert bool((G[S - 1] == 0).all())
    pad = 3000

    def padded(fill):
        Up = torch.cat([Ud, fill((pad, qL))])
        Vp = Up if sym else torch.cat([Vd, fill((pad, qR))])
        return Up, Vp

    Up, Vp = padded(lambda s: torch.randn(s, device=card))
    segp = torch.cat([segd, torch.full((pad,), -1, device=card)])
    wp = torch.cat([wd, torch.rand(pad, device=card)])
    assert torch.equal(G, ops.segment_outer(Up, Vp, segp, S, w=wp))
    Uz, Vz = padded(lambda s: torch.zeros(s, device=card))
    segz = torch.cat([segd, torch.randint(0, S - 1, (pad,), device=card)])
    wz = torch.cat([wd, torch.ones(pad, device=card)])
    assert torch.equal(G, ops.segment_outer(Uz, Vz, segz, S, w=wz))
    zero = torch.zeros((S, qL, qR), device=card)
    one = ops.segment_outer(Ud, Vd, segd, S, w=wd, init=zero)
    h = n // 3 + 17
    first = ops.segment_outer(Ud[:h], Vd[:h], segd[:h], S, w=wd[:h],
                              init=zero)
    assert torch.equal(one, ops.segment_outer(Ud[h:], Vd[h:], segd[h:], S,
                                              w=wd[h:], init=first))


@pytest.mark.cuda
@pytest.mark.parametrize("qR", [17, 128, 129, 501])
@pytest.mark.parametrize("qL", range(1, 9))
def test_thin_kernel(card, qL, qR):
    """The thin kernel (pair, qL <= 8): every qL against V narrower than
    a warp's stripe, one stripe, one past it and the sweep's 501."""
    from repro_torch.kernels.seg_gram import kernel as kern

    assert kern.design_of(qL, qR) == "thin"
    _walk_kernel_checks(card, qL, qR, seed=qL * 1000 + qR)


@pytest.mark.cuda
@pytest.mark.parametrize("qL,qR,sym", [
    (1, 1, False), (2, 2, True), (3, 3, False), (5, 5, True), (7, 13, False),
    (16, 16, False), (16, 16, True)])
def test_small_pair_kernel(card, qL, qR, sym):
    """The small kernel's pair form (both widths <= 16), U with itself
    too, up to 8 output elements a lane."""
    from repro_torch.kernels.seg_gram import kernel as kern

    assert kern.design_of(qL, qR) == "small"
    _walk_kernel_checks(card, qL, qR, sym=sym, seed=qL * 100 + qR)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["residual_direct", "residual_meat"])
def test_small_kernel_serial_equals_batched(card, form):
    """The bootstrap's per-replicate final stage at B = 25: one batched
    launch bitwise the 25 single ones, and against the CPU (1e-4)."""
    n, R = 5000, 25
    g = torch.Generator().manual_seed(5)
    ry, rt = torch.randn((R, n), generator=g), torch.randn((R, n), generator=g)
    phi = torch.cat([torch.ones((n, 1)), torch.randn((n, 1), generator=g)], 1)
    w = torch.rand((R, n), generator=g)
    theta = torch.randn((R, 2), generator=g)
    zero = torch.zeros_like(ry)

    def run(b, dev):
        sel = (lambda x: x.to(dev)) if b is None else (lambda x: x[b].to(dev))
        if form == "residual_direct":
            return ops.residual_weighted_gram(sel(ry), sel(rt), phi.to(dev),
                                              sel(w))[0]
        return ops.residual_meat(sel(ry), sel(rt), sel(zero), sel(zero),
                                 phi.to(dev), sel(theta), w=sel(w))

    batched = run(None, card)
    assert torch.equal(batched, torch.stack([run(b, card) for b in range(R)]))
    _close(batched, run(None, "cpu"))


@pytest.mark.cuda
def test_walk_plans_once_per_id_tensor(card):
    """A walk plans once per (id tensor, S, rows per unit): repeated walks
    of one ids tensor plan once, another tensor or an in-place write plans
    again; the segmented sweep plans each of its two id tensors once per
    rows per unit, not once per walk (2·iters + 4 of them)."""
    from repro_torch.config import CausalConfig
    from repro_torch.kernels.seg_gram import kernel as kern
    from repro_torch.sweep import SweepSpec, sweep

    U, V, seg, _, _ = _pair_inputs(card, 5, 301, 7, 3001)
    kern.clear_plan_cache()
    kern.PLANS.clear()
    first = ops.segment_outer(U, V, seg, 7)
    for _ in range(3):
        assert torch.equal(first, ops.segment_outer(U, V, seg, 7))
    assert sum(kern.PLANS.values()) == 1
    ops.segment_outer(U, V, seg.clone(), 7)
    seg[0] = seg[0]
    ops.segment_outer(U, V, seg, 7)
    assert sum(kern.PLANS.values()) == 3
    d, sids = _sweep_data()
    cfg = CausalConfig(n_folds=3, inference="none", row_block=512,
                       row_block_strategy="pallas", newton_iters=4)
    kern.PLANS.clear()
    kern.LAUNCHES.clear()
    sweep(SweepSpec(4, (("dml", cfg),)), X=d.X, y=d.y, t=d.t,
          segment_ids=sids, mode="segmented", device=card)
    assert dict(kern.LAUNCHES) == {"design_segmented": 2, "pair": 2 * 8 + 2}
    rows = kern.library().seg_gram_split_rows
    q, E, k = d.p + 1, 4, 3
    # sids: t1 (k x q) and the final stage; comb: t2 and fold_gram's two
    want = {(E, rows(k, q)), (E, rows(2, 2)), (E * k, rows(1, q)),
            (E * k, rows(q + 1, q + 1)), (E * k, rows(q, q))}
    assert dict(kern.PLANS) == {key: 1 for key in want}


# ---------------------------------------------------------------------------
# The doubly-robust estimators, serving and the tracer on the card.
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_dr_and_driv_on_card_match_cpu(card):
    from repro_torch.config import CausalConfig
    from repro_torch.core import moments
    from repro_torch.core.drlearner import DRLearner
    from repro_torch.core.iv import DRIV
    from repro_torch.kernels.seg_gram import kernel as kern

    d = _boot_data()
    cfg = CausalConfig(cate_features=2, inference="bootstrap", n_bootstrap=4,
                       runtime_chunk=4, row_block=1024,
                       row_block_strategy="pallas")
    it = cfg.newton_iters
    want = {
        "dr": {"fold_weighted": 2 * (2 + 2 * it), "design": 1,
               "residual_direct": 1, "residual_meat": 1},
        "driv": {"design": 3, "gram_and_vec": 2 * it, "iv": 2,
                 "iv_meat": 1, "fold_weighted": 1 + 4 * it + 4,
                 "residual_direct": 1, "residual_meat": 1}}
    for name in ("dr", "driv"):
        out = {}
        for dev in ("cpu", card):
            kern.LAUNCHES.clear()
            moments.FALLBACKS.clear()
            if name == "dr":
                res = DRLearner(cfg, device=dev).fit(d.y, d.t, d.X)
            else:
                res = DRIV(cfg, device=dev).fit(d.y, d.t, d.z, d.X)
            inf = res.inference()
            out[str(dev)] = (torch.cat([res.theta.cpu(),
                                        torch.tensor([res.ate])]),
                             inf.replicates.cpu(), inf.ate_replicates.cpu(),
                             res.pseudo.cpu())
            if dev == card:
                assert dict(kern.LAUNCHES) == want[name], name
                assert not any(moments.FALLBACKS.values())
                serial = res.inference(executor="serial")
                assert torch.equal(serial.replicates, inf.replicates)
                assert torch.equal(serial.ate_replicates, inf.ate_replicates)
        for got, ref_ in zip(out[str(card)], out["cpu"]):
            np.testing.assert_allclose(
                got.numpy(), ref_.numpy(), rtol=1e-4,
                atol=1e-4 * float(ref_.abs().max()), err_msg=name)


@pytest.mark.cuda
def test_serving_batched_equals_single_on_card(card):
    from repro_torch.serve_effects import (EffectServer, ServingPanel,
                                           score_batch, score_single)

    g = torch.Generator().manual_seed(3)
    E, p = 64, 500
    thetas = torch.randn((E, 2), generator=g)
    ses = torch.rand((E, 2), generator=g) * 0.1
    ok = torch.rand(E, generator=g) > 0.1
    panel = ServingPanel(thetas=thetas.to(card), ses=ses.to(card),
                         ok=ok.to(card), n_features=p, cate_features=2)
    X = torch.randn((64, p), generator=g).numpy()
    sids = torch.randint(-1, E + 1, (64,), generator=g).numpy()
    single = [score_single(panel, X[i], int(sids[i]), 1.96)
              for i in range(64)]
    for w in (8, 64):
        for lo in range(0, 64, w):
            out = score_batch(panel, X[lo:lo + w], sids[lo:lo + w], 1.96)
            for i in range(w):
                for f in ("cate", "lo", "hi", "se", "ok"):
                    assert torch.equal(out[f][i], single[lo + i][f]), (w, f)
    srv = EffectServer(panel, wave_sizes=(8, 64), max_queue=100)
    for r, s in zip(srv.score(X[:37], sids[:37]), single):
        assert (r.cate, r.se, r.ok) == (float(s["cate"]), float(s["se"]),
                                        bool(s["ok"]))


@pytest.mark.cuda
def test_tracer_sync_waits_for_the_card(card):
    from repro_torch.obs import Tracer

    x = torch.randn((8192, 8192), device=card)
    x @ x
    torch.cuda.synchronize()
    tr = Tracer()
    with tr.span("launch"):
        y = x @ x
    torch.cuda.synchronize()
    with tr.span("synced"):
        y = tr.sync(x @ x)
    launch, synced = (s.duration_s for s in tr.spans)
    # 2 * 8192^3 FLOP: >= 16 ms at the H100's 67 TFLOP/s fp32
    assert synced > 4 * launch and synced > 5e-3, (launch, synced)
    assert y.shape == x.shape


# ---------------------------------------------------------------------------
# The task runtime on the card.
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_card_probe_slope_is_positive(card):
    """The memory model of the DML bootstrap's replicate function, probed
    on the card (chunks of 1, 1 and 8 run under the allocator's peak
    counter): first-call allocations do not inflate the chunk-1 probe into
    a slope <= 0, and a budget at its peak of 3 replicates chunks below B,
    bitwise the explicit chunk's replicates."""
    from repro_torch.config import CausalConfig
    from repro_torch.core.dml import DML
    from repro_torch.inference.bootstrap import (dml_bootstrap,
                                                 make_dml_replicate_fn)
    from repro_torch.runtime import TaskRuntime

    d = _boot_data()
    cfg = CausalConfig(cate_features=2, row_block=1024,
                       row_block_strategy="pallas")
    c = DML(cfg, device=card).fit(d.y, d.t, d.X).fit_ctx
    B = 12
    kw = dict(n_folds=cfg.n_folds, XW=c.XW, y=c.y, t=c.t, phi=c.phi, seed=5,
              n_replicates=B, row_block=1024, strategy="pallas")
    fn = make_dml_replicate_fn(c.nuis_y, c.nuis_t, cfg.n_folds, seed=5,
                               row_block=1024, strategy="pallas")
    _, model = TaskRuntime("vmap", memory_budget=1 << 50).plan_chunk(
        fn, torch.arange(B), (c.XW, c.y, c.t, c.phi), B)
    assert model is not None and model.slope > 0, model
    budget = int(model.peak(3))
    rt = TaskRuntime("vmap", memory_budget=budget)
    out = dml_bootstrap(c.nuis_y, c.nuis_t, executor=rt, **kw)
    chunk = int([e.detail for e in rt.events
                 if e.action == "chunk"][0].split("chunk=")[1])
    assert 1 <= chunk < B
    want = dml_bootstrap(c.nuis_y, c.nuis_t, chunk=chunk, **kw)
    assert torch.equal(out.replicates, want.replicates)


@pytest.mark.cuda
def test_runtime_keeps_every_tensor_on_the_card(card):
    """A map of CUDA inputs returns CUDA outputs on every path: chunked,
    downgraded, map_product, and the zero-length axis (meta evaluation,
    materialized on the inputs' card)."""
    from repro_torch.inference.executor import BatchedExecutor
    from repro_torch.runtime import TaskRuntime

    class Flaky(BatchedExecutor):
        calls = 0

        def map(self, fn, xs, *args):
            self.calls += 1
            if self.calls == 1:
                raise RuntimeError("lost")
            return super().map(fn, xs, *args)

    xs = torch.randn((7, 3), device=card)
    c = torch.tensor(1.0, device=card)

    def fn(x, c_):
        return {"y": x * 2 + c_, "s": x.sum(-1)}

    outs = [TaskRuntime("vmap", chunk=3).map(fn, xs, c),
            TaskRuntime(Flaky(), chunk=3).map(fn, xs, c),
            TaskRuntime("vmap").map(fn, xs[:0], c),
            TaskRuntime("vmap").map_product(
                lambda a, b, c_: {"y": a * b + c_}, xs[:, 0], xs[:2, 1], c)]
    for out in outs:
        for v in out.values():
            assert v.device.type == "cuda", v.device
    assert torch.equal(outs[0]["y"], outs[1]["y"])


@pytest.mark.cuda
def test_q503_design_big_tile_matches_plain(card):
    """The refuters' nuisance design at q = 503 (500 covariates, the
    noise column, the intercept and y) through the large tile, with k = 5
    fold weights: against plain (1e-5·max|G|) and bitwise symmetric."""
    from repro_torch.kernels.seg_gram import kernel as kern

    g = torch.Generator().manual_seed(4)
    n = 20_000
    D = torch.randn((n, 503), generator=g).to(card)
    W = (torch.rand((5, n), generator=g) > 0.2).float().to(card)
    assert kern.design_of(503, 503) == "big"
    got = ops.fold_weighted_design_gram(D, W)
    want = ops.fold_weighted_design_gram(D.cpu(), W.cpu())
    assert got.shape == (5, 503, 503)
    _close(got, want)
    assert torch.equal(got, got.transpose(1, 2))


def _small_demo(seed=3, n=4096, p=16):
    from repro_torch.data.causal_dgp import paper_demo_data
    return paper_demo_data(n=n, p=p, seed=seed, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("learner", ["s_learner", "t_learner", "x_learner"])
def test_metalearners_on_card_match_cpu(card, learner):
    """Each learner's fit on the card ("pallas": the seg_gram kernel)
    against the CPU (1e-4 on the ATE and the CATE), with fold_weighted
    launches only; its bootstrap replicates on the card bitwise serial ≡
    batched ≡ chunked."""
    from repro_torch.config import CausalConfig
    from repro_torch.core import metalearners as meta
    from repro_torch.kernels.seg_gram import kernel as kern

    d = _small_demo()
    cfg = CausalConfig(row_block=1024, row_block_strategy="pallas")
    fn = getattr(meta, learner)
    kern.LAUNCHES.clear()
    got = fn(d.y, d.t, d.X, cfg=cfg, device=card)
    assert set(kern.LAUNCHES) == {"fold_weighted"}
    want = fn(d.y, d.t, d.X, cfg=cfg, device="cpu")
    assert abs(got.ate - want.ate) <= 1e-4 * abs(want.ate)
    np.testing.assert_allclose(got.cate.cpu().numpy(), want.cate.numpy(),
                               rtol=1e-4, atol=1e-4)
    ctx = got.fit_ctx
    kw = dict(y=ctx["y"], t=ctx["t"], X=ctx["X"], seed=5, n_replicates=3)
    ser = meta.meta_bootstrap(ctx["core"], executor="serial", **kw)
    vec = meta.meta_bootstrap(ctx["core"], executor="vmap", **kw)
    chunked = meta.meta_bootstrap(ctx["core"], chunk=2, **kw)
    assert torch.equal(ser.ate_replicates, vec.ate_replicates)
    assert torch.equal(chunked.ate_replicates, vec.ate_replicates)
    assert vec.ate_replicates.device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["reg", "clf"])
def test_tune_penalty_on_card_matches_cpu(card, task):
    """The penalty grid on the card (design / gram_and_vec at 20 weight
    rows) against the CPU on the same folds: scores within 1e-4, the
    same winner."""
    from repro_torch.core import tuning
    from repro_torch.kernels.seg_gram import kernel as kern

    d = _small_demo()
    target = d.y if task == "reg" else d.t
    kw = dict(n_folds=5, row_block=1024, strategy="pallas")
    kern.LAUNCHES.clear()
    got = tuning.tune_penalty(task, [1e-4, 1e-2, 1.0, 30.0], d.X, target,
                              gen=torch.Generator().manual_seed(0),
                              device=card, **kw)
    assert dict(kern.LAUNCHES) == ({"design": 1} if task == "reg"
                                   else {"gram_and_vec": 16})
    want = tuning.tune_penalty(task, [1e-4, 1e-2, 1.0, 30.0], d.X, target,
                               gen=torch.Generator().manual_seed(0),
                               device="cpu", **kw)
    np.testing.assert_allclose(got.scores.cpu().numpy(), want.scores.numpy(),
                               rtol=1e-4)
    assert got.best_index == want.best_index


@pytest.mark.cuda
def test_mlp_batched_fit_bitwise_each_model_on_card(card):
    """The mlp's batched fit on the card (3 fold models in one fit) is
    bitwise each model fitted alone, and within 1e-3 of the CPU's."""
    from repro_torch.core.crossfit import fold_ids, fold_weights
    from repro_torch.core.nuisance import make_mlp
    from repro_torch.inference.executor import tree_map

    d = _small_demo(n=2048)
    nuis = make_mlp("clf", hidden=(32, 16), steps=30, lr=3e-3)
    W = fold_weights(fold_ids(torch.Generator().manual_seed(1), d.n, 3), 3)
    states = [nuis.init(torch.Generator().manual_seed(j), d.p)
              for j in range(3)]
    batch = tree_map(lambda *xs: torch.stack(xs), states[0], *states[1:])
    X, t = d.X.to(card), d.t.to(card)
    fitted = nuis.fit(tree_map(lambda x: x.to(card), batch), X, t,
                      W.to(card))
    preds = nuis.predict(fitted, X)
    for j in range(3):
        alone = nuis.fit(tree_map(lambda x: x.to(card), states[j]), X, t,
                         W[j].to(card))
        assert torch.equal(nuis.predict(alone, X), preds[j]), j
    cpu = nuis.predict(nuis.fit(batch, d.X, d.t, W), d.X)
    np.testing.assert_allclose(preds.cpu().numpy(), cpu.numpy(), rtol=1e-3,
                               atol=1e-3)


# ---------------------------------------------------------------------------
# LM serving on the card: prefill through the kernels, decode through none.
# ---------------------------------------------------------------------------

def _serve_model(card, arch):
    import dataclasses

    from repro_torch.config import ParallelConfig
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model

    over = dict(d_model=128, num_layers=3, compute_dtype=torch.bfloat16)
    if arch.startswith("granite"):
        over.update(num_heads=4, num_kv_heads=2, head_dim=32)
    if arch.startswith("zamba2"):       # the SSD's tiled form: N = P = 64
        over.update(ssm_state=64)
    cfg = dataclasses.replace(get_config(arch), **over)
    return Model(cfg, ParallelConfig(use_flash_attention=True), device=card,
                 seed=3)


def _serve_launches():
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.seg_gram import kernel as sg_kernel
    from repro_torch.kernels.ssm_scan import kernel as sk
    return {**dict(fa_kernel.LAUNCHES), **dict(sk.LAUNCHES),
            **dict(sg_kernel.LAUNCHES)}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-3-2b-smoke", "rwkv6-3b-smoke",
                                  "zamba2-1.2b-smoke"])
def test_serve_prefill_launches_kernels_and_decode_none(card, arch):
    """A served wave on the card: its prefill launches one kernel per
    attention / scan block (scans on the tiled form), its decode steps
    launch none; the prefill's logits and cache leaves against the same
    prefill through the plain versions (2e-2·max: one-step bf16 flips
    carried through the layers, as the features test; the first layer's
    fp32 scan state, whose inputs are the same in both runs, 1e-4), and
    against the same prefill on the CPU (2e-2·max)."""
    import collections

    from repro_torch.convert import _flatten
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.kernels.ssm_scan import ref as sref
    from repro_torch.launch.serve import BatchServer, Request

    model = _serve_model(card, arch)
    cfg = model.cfg
    rng = np.random.default_rng(0)
    prompts = [torch.from_numpy(rng.integers(0, 250, (n,))) for n in (32, 20)]
    server = BatchServer(model, max_seq=64)
    seen = []
    prefill, decode = server._prefill, server._decode

    def counted(fn, tag):
        def run(*a):
            before = collections.Counter(_serve_launches())
            out = fn(*a)
            torch.cuda.synchronize()
            seen.append((tag, dict(collections.Counter(_serve_launches())
                                   - before)))
            return out
        return run

    server._prefill = counted(prefill, "prefill")
    server._decode = counted(decode, "decode")
    outs = server.serve_wave([Request(p, max_new_tokens=6) for p in prompts])
    L = cfg.num_layers
    want = ({"flash_attention": L} if cfg.family == "dense" else
            {"gla": L, "gla:tiled": L} if cfg.family == "ssm" else
            {"ssd": L, "ssd:tiled": L, "flash_attention": L})
    assert seen[0] == ("prefill", want)
    assert [s for s in seen[1:]] == [("decode", {})] * 5
    assert [len(o.tokens) for o in outs] == [6, 6]

    toks = torch.stack([torch.nn.functional.pad(p, (32 - len(p), 0))
                        for p in prompts]).to(card)
    logits, cache = model.prefill(toks)
    saved = (fa_ops.flash_attention, sops.gla, sops.ssd)
    try:
        fa_ops.flash_attention = _fa_plain
        sops.gla = lambda *a, chunk: sref.gla_chunked_ref(*a, chunk=chunk)
        sops.ssd = lambda *a, chunk: sref.ssd_chunked_ref(*a, chunk=chunk)
        plain_l, plain_c = model.prefill(toks)
    finally:
        fa_ops.flash_attention, sops.gla, sops.ssd = saved

    def rel(a, b):
        a, b = a.float(), b.float()
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    V = cfg.vocab_size                    # padded slots hold -1e30
    assert rel(logits[..., :V], plain_l[..., :V]) <= 2e-2
    got, ref_ = _flatten(cache), _flatten(plain_c)
    for key in got:
        assert rel(got[key], ref_[key]) <= 2e-2, key
    # the first layer's scan state sees the same inputs in both runs
    if cfg.family != "dense":
        key = "tm.s" if cfg.family == "ssm" else "mamba.ssm"
        assert rel(got[key][0], ref_[key][0]) <= 1e-4
    # the same prefill on the CPU (the plain versions)
    cpu = _serve_model(torch.device("cpu"), arch)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    l_cpu, _ = cpu.prefill(toks.cpu())
    assert rel(logits[..., :V].cpu(), l_cpu[..., :V]) <= 2e-2


@pytest.mark.cuda
def test_dense_attention_refused_on_card_for_train_and_prefill(card):
    """Off the CPU, train and prefill attention run through the flash
    kernel or raise; decode attention (no kernel in the reference) runs
    as plain tensor code on the card."""
    from repro_torch.config import ParallelConfig
    from repro_torch.configs import get_config
    from repro_torch.models import attention

    cfg = get_config("granite-3-2b-smoke")
    rng = np.random.default_rng(1)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32) * s[0] ** -0.5).to(card)
    p = {"wq": mk(64, 4, 16), "wk": mk(64, 2, 16), "wv": mk(64, 2, 16),
         "wo": mk(4, 16, 64)}
    x = mk(2, 8, 64)
    for fn in (attention.gqa_train, attention.gqa_prefill):
        with pytest.raises(NotImplementedError, match="use_flash_attention"):
            fn(p, cfg, x, ParallelConfig())
    cache = {"k": mk(2, 12, 2, 16), "v": mk(2, 12, 2, 16)}
    cpu = {k: v.cpu() for k, v in cache.items()}
    got, _ = attention.gqa_decode(p, cfg, x[:, :1], cache, 5)
    want, _ = attention.gqa_decode({k: v.cpu() for k, v in p.items()}, cfg,
                                   x[:, :1].cpu(), cpu, 5)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


# ---------------------------------------------------------------------------
# The data mesh on the card (runtime.distributed): ranks on cuda:0
# ---------------------------------------------------------------------------

_MESH_N, _MESH_P, _MESH_RB = 100_003, 31, 16_384


def _mesh_rank_kernel(rank: int) -> dict:
    """Rank side of the gloo mesh test: the kernel forms per block on
    cuda:0 under a 1-rank and a 2-rank mesh, with the launches counted."""
    import hashlib

    import torch.distributed as dist
    from repro_torch.core import moments
    from repro_torch.kernels.seg_gram import kernel as kern
    from repro_torch.runtime import make_data_mesh, use_data_mesh
    from repro_torch.runtime.distributed import TRAFFIC

    dev = torch.device("cuda", torch.cuda.current_device())
    g1 = dist.new_group([0])
    g = torch.Generator(device=dev).manual_seed(3)
    X = torch.randn((_MESH_N, _MESH_P), generator=g, device=dev)
    w = torch.rand(_MESH_N, generator=g, device=dev)
    folds = torch.randint(0, 5, (_MESH_N,), generator=g, device=dev)

    def forms():
        kw = dict(row_block=_MESH_RB, strategy="pallas")
        return (moments.weighted_gram(X, w, intercept=True, **kw)[0],
                moments.fold_gram(X, folds, 5, intercept=True, **kw)[0])

    def digest(ts):
        return [hashlib.sha256(t.contiguous().cpu().numpy().tobytes())
                .hexdigest() for t in ts]

    out = {"rank": rank}
    meshes = {2: make_data_mesh(device=dev, backend="gloo")}
    if rank == 0:
        meshes[1] = make_data_mesh(group=g1, device=dev)
        out["single"] = [t.cpu() for t in forms()]
    for s, dm in sorted(meshes.items()):
        kern.LAUNCHES.clear()
        b0 = TRAFFIC["staged_bytes"]
        with use_data_mesh(dm):
            got = forms()
        torch.cuda.synchronize()
        out[s] = {"digest": digest(got), "launches": dict(kern.LAUNCHES),
                  "staged": TRAFFIC["staged_bytes"] - b0,
                  "values": [t.cpu() for t in got]}
    return out


@pytest.mark.cuda
def test_mesh_gloo_two_ranks_kernel_blocks_bitwise(card):
    """Two gloo ranks on cuda:0: every block partial is a seg_gram launch
    on the card (design, and design_segmented for fold_gram), the
    accumulators staged through host memory; the result is bitwise the
    1-rank mesh's and within 1e-5·max of one kernel pass over all rows."""
    from repro_torch.kernels.seg_gram import kernel as kern
    from repro_torch.launch.dist_smoke import spawn_ranks

    kern.library()                  # built here, loaded by the ranks
    r0, r1 = spawn_ranks(_mesh_rank_kernel, 2, backend="gloo",
                         device="cuda", timeout=300)
    blocks = -(-_MESH_N // _MESH_RB)
    per_rank = -(-blocks // 2)
    assert r0[2]["digest"] == r1[2]["digest"] == r0[1]["digest"]
    for r in (r0, r1):
        assert r[2]["launches"] == {"design": per_rank,
                                    "design_segmented": per_rank}
        assert r[2]["staged"] > 0
    assert r0[1]["launches"] == {"design": blocks,
                                 "design_segmented": blocks}
    for got, want in zip(r0[2]["values"], r0["single"]):
        _close(got, want)


def _nccl_one_card(rank: int) -> str:
    from repro_torch.runtime import make_data_mesh

    torch.cuda.set_device(0)            # both ranks on one card
    try:
        make_data_mesh(device="cuda:0")
    except RuntimeError as e:
        return str(e)
    return ""


@pytest.mark.cuda
def test_mesh_nccl_two_ranks_on_one_card_raises(card):
    """NCCL cannot hold two ranks on one device: the mesh refuses to be
    built, naming the shared card and gloo, instead of falling back."""
    from repro_torch.launch.dist_smoke import spawn_ranks

    msgs = spawn_ranks(_nccl_one_card, 2, backend="nccl", device="cuda",
                       timeout=120)
    for m in msgs:
        assert "card of its own" in m and "gloo" in m, m


# B, Sq (= Sk), H, KV, Dqk, Dv, causal, softcap: LM training's forms —
# GQA, a ragged bidirectional length, MLA's (192, 128), a softcap, and a
# length shorter than one tile
_FA_TRAIN_CASES = [
    (2, 256, 8, 2, 64, 64, True, 0.0),
    (2, 300, 6, 6, 64, 64, False, 0.0),
    (1, 200, 8, 8, 192, 128, True, 0.0),
    (1, 130, 4, 2, 128, 128, True, 30.0),
    (1, 75, 4, 4, 16, 16, False, 0.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", _FA_TRAIN_CASES)
def test_flash_lse_and_backward(card, case, dtype):
    """With ``return_lse`` the kernel's o is bitwise its o without, and
    its LSE within 1e-3 (bf16) / 1e-4 (fp32) of the plain fp32
    logsumexp; under autograd ``ops.flash_attention`` (the kernel's
    forward, the plain blocked backward over key blocks of 64) gives
    (dq, dk, dv) within 1e-2·max (bf16: the grads and o rounded to bf16,
    ~3e-3 measured on the CPU) / 1e-4·max (fp32) of autograd through the
    plain version in fp32, and launches the kernel once, with its LSE."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    B, S, H, KV, D, Dv, causal, cap = case
    rng = np.random.default_rng(11)
    dt = getattr(torch, dtype)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(card).to(dt)
    q, k, v, do = mk(B, S, H, D), mk(B, S, KV, D), mk(B, S, KV, Dv), \
        mk(B, S, H, Dv)
    o0 = fa_kernel.flash_attention_cuda(q, k, v, causal=causal, softcap=cap)
    o, lse = fa_kernel.flash_attention_cuda(q, k, v, causal=causal,
                                            softcap=cap, return_lse=True)
    want = fa_ref.attention_lse(q.transpose(1, 2), k.transpose(1, 2),
                                causal=causal, softcap=cap)
    torch.cuda.synchronize()
    assert torch.equal(o, o0)
    assert lse.dtype == torch.float32 and lse.shape == (B, H, S)
    lse_tol = 1e-3 if dtype == "bfloat16" else 1e-4
    assert float((lse - want).abs().max()) <= lse_tol

    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    n0 = dict(fa_kernel.LAUNCHES)
    out = fa_ops.flash_attention(*leaves, causal=causal, softcap=cap,
                                 chunk=64)
    out.backward(do)
    assert torch.equal(out.detach(), o0)
    assert fa_kernel.LAUNCHES["flash_attention"] == \
        n0.get("flash_attention", 0) + 1
    assert fa_kernel.LAUNCHES["flash_attention[lse]"] == \
        n0.get("flash_attention[lse]", 0) + 1
    refs = [x.float().requires_grad_() for x in (q, k, v)]
    _fa_plain(*refs, causal=causal, softcap=cap).backward(do.float())
    tol = 1e-2 if dtype == "bfloat16" else 1e-4
    for name, got, ref_ in zip("qkv", leaves, refs):
        assert got.grad.dtype == dt
        err = float((got.grad.double() - ref_.grad.double()).abs().max()
                    / ref_.grad.double().abs().max())
        assert err <= tol, (name, err)


# The scans under autograd: (scan, B, H, T, D, chunk, dtype, strided) —
# rwkv6's GLA bonus and post forms in bf16 (the tiled form), fp32 and
# the generic form (D = 32), zamba2's SSD (N = P = 64, tiled) and the
# generic SSD (N = 16, P = 32) at a T that halves the chunk
_SCAN_GRAD_CASES = [
    ("gla-bonus", 2, 4, 256, 64, 16, "bfloat16", True),
    ("gla-post", 2, 4, 256, 64, 16, "bfloat16", True),
    ("gla-bonus", 2, 4, 128, 64, 16, "float32", False),
    ("gla-bonus", 1, 3, 96, 32, 16, "float32", True),
    ("ssd", 2, 4, 256, 64, 32, "float32", True),
    ("ssd", 1, 3, 80, 16, 32, "float32", False),
]


def _scan_inputs(card, case):
    """(function of the leaves -> (o, s), plain fp32 version, inputs)."""
    from repro_torch.kernels.ssm_scan import ops as sops
    from repro_torch.kernels.ssm_scan import ref as sref

    scan, B, H, T, D, chunk, dtype, strided = case
    if scan == "ssd":
        N, P = (D, D) if D == 64 else (D, 2 * D)
        xs = list(_ssd_case(card, B, H, T, N, P, strided=strided, seed=4))
        return (lambda *a: sops.ssd(*a, chunk=chunk),
                lambda *a: sref.ssd_chunked_ref(*a, chunk=sops._fit_chunk(
                    chunk, T)), xs)
    q, k, v, w, u = _gla_case(card, B, H, T, D, D, dtype, strided, seed=4)
    xs = [q, k, v, w] + ([u] if scan == "gla-bonus" else [])
    return (lambda *a: sops.gla(*a, chunk=chunk),
            lambda *a: sref.gla_chunked_ref(*a, chunk=sops._fit_chunk(
                chunk, T)), xs)


@pytest.mark.cuda
@pytest.mark.parametrize("with_ds", [True, False], ids=["ds", "no-ds"])
@pytest.mark.parametrize("case", _SCAN_GRAD_CASES)
def test_scans_under_grad_on_card(card, case, with_ds):
    """Under grad, ``ops.gla`` / ``ops.ssd`` launch the kernel once (a
    tensor with the Function's grad_fn), o and the state bitwise the
    no-grad launch's; the gradients within 1e-4·max of autograd through
    the plain chunked scan in fp32 on the card (the same sums in another
    order) — for bf16 inputs the backward's fp32 values
    (``*_bwd_chunks``) at 1e-4·max, and the Function's bf16 gradients at
    one bf16 step (2^-7 of the element) plus 1e-4·max."""
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.kernels.ssm_scan import ops as sops

    fn, plain, xs = _scan_inputs(card, case)
    scan = case[0].split("-")[0]
    with torch.no_grad():
        o0, s0 = fn(*xs)
    g = torch.Generator(device=card).manual_seed(5)
    do = torch.randn(o0.shape, generator=g, device=card).to(o0.dtype)
    ds = (torch.randn(s0.shape, generator=g, device=card) if with_ds
          else None)
    leaves = [x.detach().requires_grad_() for x in xs]
    n0 = sk.LAUNCHES[scan]
    o, s = fn(*leaves)
    assert sk.LAUNCHES[scan] == n0 + 1
    assert "Scan" in type(o.grad_fn).__name__
    assert torch.equal(o.detach(), o0) and torch.equal(s.detach(), s0)
    torch.autograd.backward([o] + ([s] if with_ds else []),
                            [do] + ([ds] if with_ds else []))
    assert sk.LAUNCHES[scan] == n0 + 1
    refs = [x.detach().float().requires_grad_() for x in xs]
    po, ps = plain(*refs)
    torch.autograd.backward([po] + ([ps] if with_ds else []),
                            [do.float()] + ([ds] if with_ds else []))
    chunk = sops._fit_chunk(case[5], case[3])
    if scan == "gla":
        u = xs[4] if len(xs) == 5 else None
        direct = sops.gla_bwd_chunks(*xs[:4], u, do, ds, chunk)
    else:
        direct = sops.ssd_bwd_chunks(*xs, do, ds, chunk)
    for name, leaf, d, r in zip("qkvwu", leaves, direct, refs):
        want = r.grad.double()
        top = float(want.abs().max())
        assert leaf.grad.dtype == leaf.dtype, name
        assert float((d.double() - want).abs().max()) <= 1e-4 * top, name
        lim = 1e-4 * top + (2.0 ** -7 * want.abs()
                            if leaf.dtype == torch.bfloat16 else 0.0)
        assert bool(((leaf.grad.double() - want).abs() <= lim).all()), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", [_SCAN_GRAD_CASES[0], _SCAN_GRAD_CASES[4]],
                         ids=["gla", "ssd"])
def test_scans_launch_twice_under_checkpoint(card, case):
    """Under ``torch.utils.checkpoint`` (the remat policies) the backward
    applies the Function again: two launches, and the same gradients
    as without the checkpoint."""
    from torch.utils import checkpoint as ckpt

    from repro_torch.kernels.ssm_scan import kernel as sk

    fn, _, xs = _scan_inputs(card, case)
    scan = case[0].split("-")[0]

    def loss(*a):
        return fn(*a)[0].float().square().sum()

    grads = []
    for remat in (False, True):
        leaves = [x.detach().requires_grad_() for x in xs]
        n0 = sk.LAUNCHES[scan]
        out = (ckpt.checkpoint(loss, *leaves, use_reentrant=False) if remat
               else loss(*leaves))
        out.backward()
        torch.cuda.synchronize()
        assert sk.LAUNCHES[scan] == n0 + (2 if remat else 1)
        grads.append([x.grad for x in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,impl", [
    ("granite-3-2b-smoke", "flash"), ("granite-3-2b-smoke", "chunked"),
    ("whisper-tiny-smoke", "flash"), ("deepseek-v3-671b-smoke", "flash"),
    ("rwkv6-3b-smoke", "flash"), ("zamba2-1.2b-smoke", "flash")])
def test_train_step_on_card_matches_cpu(card, arch, impl):
    """One ``make_train_step`` step (fp32, remat "nothing") on the card
    against the same step on the CPU from the same weights and batch:
    loss rel 1e-5, params rtol 1e-5 / atol 5e-2·lr (the AdamW ratio where
    the moments nearly cancel; tests/test_torch_train.py).  On the card
    each remat'd block's kernel runs twice (the forward and remat's
    recompute): flash with its LSE on the flash route, rwkv6's GLA and
    zamba2's SSD under their Functions; zamba2's shared attention block,
    applied outside remat, once a use.  The scan archs take 4 x 64
    tokens (4 GLA chunks, 2 SSD chunks)."""
    from repro_torch.config import ParallelConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data.lm_data import lm_batch, step_generator
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.ssm_scan import kernel as sk
    from repro_torch.launch.train import init_state, make_train_step
    from repro_torch.models.model import Model

    cfg = get_config(arch)
    pc = (ParallelConfig(use_flash_attention=True, attention_chunk=8)
          if impl == "flash" else
          ParallelConfig(attention_impl="chunked", attention_chunk=8))
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    scans = cfg.family in ("ssm", "hybrid")
    batch = lm_batch(step_generator(0, 0), 4, 64 if scans else 16,
                     cfg.vocab_size)
    if cfg.is_encdec:
        batch["frames"] = 0.1 * torch.randn(
            (4, cfg.max_source_positions, cfg.d_model),
            generator=torch.Generator().manual_seed(1))
    cpu = Model(cfg, pc, device="cpu", seed=2)
    gpu = Model(cfg, pc, device=card, seed=2)
    gpu.load_state_dict(cpu.state_dict())

    def counts():
        return {"flash_attention[lse]": fa_kernel.LAUNCHES[
            "flash_attention[lse]"], "gla": sk.LAUNCHES["gla"],
            "ssd": sk.LAUNCHES["ssd"]}

    out = []
    for model in (cpu, gpu):
        st = init_state(model)
        dev = model.device
        n0 = counts()
        p, _, met = make_train_step(model, tcfg)(
            st.params, st.opt, {k: x.to(dev) for k, x in batch.items()})
        out.append((p, met, {k: c - n0[k] for k, c in counts().items()}))
    (pc_, mc, nc), (pg, mg, ng) = out
    assert not any(nc.values())
    layers = cfg.num_layers + cfg.encoder_layers
    want = {"flash_attention[lse]": 0, "gla": 0, "ssd": 0}
    if cfg.family == "ssm":
        want["gla"] = 2 * layers
    elif cfg.family == "hybrid":
        want["ssd"] = 2 * layers
        want["flash_attention[lse]"] = -(-layers // cfg.shared_attn_every)
    elif impl == "flash":
        want["flash_attention[lse]"] = 2 * layers
    assert ng == want
    assert abs(float(mg["loss"]) - float(mc["loss"])) <= 1e-5 * float(
        mc["loss"])
    for path, x in pc_.items():
        np.testing.assert_allclose(pg[path].cpu().numpy(), x.numpy(),
                                   rtol=1e-5, atol=5e-2 * tcfg.learning_rate,
                                   err_msg=path)
