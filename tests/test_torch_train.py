"""The port's LM training held against the JAX package's on the CPU, on
the reference's weights (``convert.model_params``), optimizer states
(``convert.adamw_state``) and the same numpy tokens:

  * ``Model.loss_fn`` and every parameter's gradient against
    ``jax.value_and_grad`` of the reference's ``loss_fn``: granite-3-2b-
    smoke in fp32 compute and in its config's bf16, deepseek-v3-smoke
    with ``mtp_depth=1`` (MLA, the MoE aux, the MTP loss), rwkv6-smoke
    and zamba2-smoke (the GLA and SSD scans' Functions: the plain
    forward, ``gla_bwd_chunks`` / ``ssd_bwd_chunks``) and whisper-smoke
    (frames);
  * ``_chunked_attn`` (output and (dq, dk, dv)) against ``jax.vjp`` of
    the reference's, causal and bidirectional, GQA, q.k 192 / v 128, and
    its dense fallback; ``flash_attention_bwd_blocks`` fed the plain LSE
    against autograd of ``attention_ref``, softcap included;
  * one ``make_train_step`` step (clip, cosine LR, AdamW) against the
    reference's jitted step from the same params, state and tokens, for
    granite-smoke and for rwkv6-smoke and zamba2-smoke;
    microbatch 2 ≡ 1; the remat policies alike;
  * ``compress_decompress`` and ``compressed_psum_mean`` (2 gloo ranks,
    spawned once for the module) against the reference's (under a vmap
    with an axis name); the schedules; the token stream; elastic resume
    bitwise an uninterrupted run and both against the reference's
    losses; a short run learns.

Tolerances, each one function on the same inputs: fp32 compute, loss
rel 1e-5 and each gradient leaf 1e-4·max|g| of its leaf (fp32 sums in
another order, through a few layers).  whisper's leaves 5e-3·max: its
untrained encoder has scores of std ~30 and near one-hot rows, which
amplify fp32 sum-order noise (``tests/test_torch_encdec.py``); the
reference's own gradients lie 3.8e-3·max (the port's 1.3e-3) from an
fp64 run of the port.  bf16 compute (granite's config, through the
dense attention, which rounds p to bf16 where the reference does): loss
rel 1e-3 and each leaf 1e-1·max|g|.  At this init the bf16 gradients
are mostly rounding noise — the reference's bf16 gradients lie 55 %
(median leaf) from its own fp32 ones — and the port's lie 4 % (median;
8 % worst) from the reference's: the case holds the port to rounding
where the reference rounds, not to a value.  Attention alone: 1e-5·max (fp32 online softmax
against the reference's).  An optimizer step: moments rtol 1e-5, atol
1e-4·max (sums of the gradients, held as those); params rtol 1e-5, atol 5e-2·lr — the
update is lr·m̂/(√v̂ + ε), a ratio, and where m̂ nearly cancels over the
two steps the gradients' 1e-5 differences move it by up to 3.6e-2·lr
(21 of granite-smoke's 16,384 embedding entries); a schedule rel 1e-6.  Over six steps, losses rel 1e-4.
"""
import concurrent.futures
import dataclasses
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.data import lm_data as jlm_data  # noqa: E402
from repro.launch.train import make_train_step as jmake_train_step  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro.optim import compression as jcompression  # noqa: E402
from repro.optim import schedule as jschedule  # noqa: E402
from repro.optim.adamw import adamw_init as jadamw_init  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.config import ParallelConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import lm_data  # noqa: E402
from repro_torch.data.pipeline import ShardedFeed, batch_sharding  # noqa: E402
from repro_torch.distributed.sharding import default_rules  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.launch import elastic  # noqa: E402
from repro_torch.launch.dist_smoke import spawn_ranks  # noqa: E402
from repro_torch.launch.train import (TrainState, init_state,  # noqa: E402
                                      loss_and_grads, make_train_step,
                                      train_loop)
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.layers import softmax_cross_entropy  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import flatten  # noqa: E402
from repro_torch.optim import compression, schedule  # noqa: E402

F32_TOL = (1e-5, 1e-4)      # (loss rel, gradient leaf / max|g|)
WHISPER_TOL = (1e-5, 5e-3)
BF16_TOL = (1e-3, 1e-1)
STEP_RTOL, STEP_ATOL, STEP_P_ATOL = 1e-5, 1e-4, 5e-2
B, S = 2, 16


def _cfg(arch, fp32=True, **kw):
    """(reference config, port config) of ``arch`` in fp32 compute, or
    in bf16 (the full configs') if ``fp32`` is False."""
    jcfg = dataclasses.replace(jget_config(arch), compute_dtype=(
        jnp.float32 if fp32 else jnp.bfloat16), **kw)
    return jcfg, dataclasses.replace(get_config(arch), compute_dtype=(
        torch.float32 if fp32 else torch.bfloat16), **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(cfg, seed=0, b=B, s=S):
    """numpy tokens and labels (and whisper's frames)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_encdec:
        out["frames"] = (0.1 * rng.standard_normal(
            (b, cfg.max_source_positions, cfg.d_model))).astype(np.float32)
    return out


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _ref(arch, fp32=True, mtp=0, seed=1):
    """(reference model, its init params as numpy)."""
    jcfg, _ = _cfg(arch, fp32, **({"mtp_depth": mtp} if mtp else {}))
    jm = build_model(jcfg)
    return jm, _np(jax.jit(jm.init)(jax.random.PRNGKey(seed)))


def _port(arch, fp32=True, mtp=0, parallel=None, seed=1):
    _, cfg = _cfg(arch, fp32, **({"mtp_depth": mtp} if mtp else {}))
    model = Model(cfg, parallel or ParallelConfig(use_flash_attention=True),
                  device="cpu")
    model.load_state_dict(convert.model_params(cfg, _ref(
        arch, fp32, mtp, seed)[1], device="cpu"))
    return model


def _cast(cfg, params):
    """The reference train step's cast-before-use, as the port's."""
    ct = cfg.compute_dtype
    return jax.tree_util.tree_map(
        lambda p: p.astype(ct) if p.ndim >= 2 else p, params)


def _leaf_close(got, want, tol, msg):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, msg
    top = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / top
    assert err <= tol, f"{msg}: {err:.3e} > {tol:g}"


@pytest.mark.parametrize("arch,fp32,mtp,tol", [
    ("granite-3-2b-smoke", True, 0, F32_TOL),
    ("granite-3-2b-smoke", False, 0, BF16_TOL),
    ("deepseek-v3-671b-smoke", True, 1, F32_TOL),
    ("rwkv6-3b-smoke", True, 0, F32_TOL),
    ("whisper-tiny-smoke", True, 0, WHISPER_TOL),
    ("zamba2-1.2b-smoke", True, 0, F32_TOL)],
    ids=["granite-fp32", "granite-bf16", "deepseek-mtp", "rwkv6", "whisper",
         "zamba2"])
def test_loss_and_grads_match_reference(arch, fp32, mtp, tol):
    jm, params = _ref(arch, fp32, mtp)
    model = _port(arch, fp32, mtp, parallel=ParallelConfig(
        use_flash_attention=fp32))
    batch = _batch(model.cfg, seed=3)

    def jloss(p, b):
        return jm.loss_fn(_cast(jm.cfg, p), b)

    (jl, jparts), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    metrics, grads = loss_and_grads(model, dict(model.state_dict()),
                                    _t(batch))
    loss_tol, grad_tol = tol
    for key, want in (("loss", jl), ("ce", jparts["ce"]),
                      ("aux", jparts["aux"])):
        got = float(metrics[key])
        assert abs(got - float(want)) <= loss_tol * max(abs(float(want)),
                                                        1e-6), key
    if mtp:
        assert float(metrics["aux"]) > 0.0
    want = convert._flatten(_np(jg))
    assert set(grads) == set(want)
    for path, g in grads.items():
        _leaf_close(g.float(), want[path], grad_tol, path)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("H,KV,D,Dv", [(4, 2, 16, 16), (2, 2, 192, 128)],
                         ids=["gqa", "mla"])
def test_chunked_attention_matches_reference_vjp(causal, H, KV, D, Dv):
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 32, H, D)).astype(np.float32)
    k = rng.standard_normal((2, 32, KV, D)).astype(np.float32)
    v = rng.standard_normal((2, 32, KV, Dv)).astype(np.float32)
    do = rng.standard_normal((2, 32, H, Dv)).astype(np.float32)
    f = functools.partial(jattn._chunked_attn, causal=causal, chunk=8)
    jo, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o = attention._chunked_attn(tq, tk, tv, causal=causal, chunk=8)
    o.backward(torch.from_numpy(do))
    _leaf_close(o.detach(), jo, 1e-5, "o")
    for name, got, want in zip("qkv", (tq, tk, tv), jgrads):
        _leaf_close(got.grad, want, 1e-5, f"d{name}")


def test_chunked_attention_dense_fallback():
    """Keys not a multiple of the chunk take the dense ``_sdpa`` on the
    CPU, as in the reference."""
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal((1, 12, 2, 8)).astype(np.float32)
               for _ in range(3))
    want = jattn._chunked_attn(*map(jnp.asarray, (q, k, v)), causal=True,
                               chunk=8)
    got = attention._chunked_attn(*map(torch.from_numpy, (q, k, v)),
                                  causal=True, chunk=8)
    _leaf_close(got, want, 1e-5, "fallback")


@pytest.mark.parametrize("causal,cap,Dv,chunk", [
    (True, 0.0, 16, 16), (False, 0.0, 8, 16), (True, 5.0, 16, 7),
    (False, 3.0, 16, 10)], ids=["causal", "bidir-dv8", "causal-softcap",
                                "bidir-softcap"])
def test_flash_backward_blocks_match_autograd(causal, cap, Dv, chunk):
    """The card's backward fed the plain version's LSE: (dq, dk, dv)
    within 1e-5·max of autograd through ``attention_ref`` (fp32)."""
    g = torch.Generator().manual_seed(4)
    q = torch.randn(2, 40, 4, 16, generator=g)
    k = torch.randn(2, 40, 2, 16, generator=g)
    v = torch.randn(2, 40, 2, Dv, generator=g)
    do = torch.randn(2, 40, 4, Dv, generator=g)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o = fa_ops.flash_attention(*leaves, causal=causal, softcap=cap)
    o.backward(do)
    lse = fa_ref.attention_lse(q.transpose(1, 2), k.transpose(1, 2),
                               causal=causal, softcap=cap)
    got = fa_ops.flash_attention_bwd_blocks(
        q, k, v, o.detach(), lse, do, causal=causal, softcap=cap,
        chunk=chunk)
    for name, a, leaf in zip("qkv", got, leaves):
        _leaf_close(a, leaf.grad, 1e-5, f"d{name}")


def _step_against_reference(arch, gnorm_tol=STEP_RTOL):
    """A second step, from the reference's own first step's params and
    AdamW state, clip and cosine LR included (warmup 1 of 10); the
    metrics within STEP_RTOL, the pre-clip grad norm within
    ``gnorm_tol``."""
    jm, params = _ref(arch)
    jt = JTrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10,
                      grad_clip=0.5)
    b0, b1 = (_batch(jm.cfg, seed=s, b=4) for s in (5, 6))
    jstep = jax.jit(jmake_train_step(jm, jt))
    p1, o1, _ = jstep(params, jadamw_init(params), b0)
    p2, o2, jmet = jstep(p1, o1, b1)
    p1, o1 = _np(p1), _np(o1)

    model = _port(arch)
    step = make_train_step(model, TrainConfig(**dataclasses.asdict(jt)))
    tp = convert.model_params(model.cfg, p1, device="cpu")
    topt = convert.adamw_state(o1, device="cpu")
    tp, topt, met = step(tp, topt, _t(b1))
    for key in ("loss", "ce", "grad_norm", "lr"):
        tol = gnorm_tol if key == "grad_norm" else STEP_RTOL
        assert abs(float(met[key]) - float(jmet[key])) <= tol * abs(
            float(jmet[key])), key
    assert int(topt["step"]) == int(o2.step) == 2
    want = {"p": convert._flatten(_np(p2)), "m": convert._flatten(_np(o2.m)),
            "v": convert._flatten(_np(o2.v))}
    for name, got in (("m", topt["m"]), ("v", topt["v"]), ("p", tp)):
        for path, x in got.items():
            w = want[name][path]
            atol = (STEP_P_ATOL * jt.learning_rate if name == "p" else
                    STEP_ATOL * max(float(np.abs(w).max()), 1e-30))
            np.testing.assert_allclose(x.numpy(), w, rtol=STEP_RTOL,
                                       atol=atol, err_msg=f"{name} {path}")


def test_train_step_matches_reference():
    _step_against_reference("granite-3-2b-smoke")


@pytest.mark.parametrize("arch", ["rwkv6-3b-smoke", "zamba2-1.2b-smoke"],
                         ids=["rwkv6", "zamba2"])
def test_scan_train_step_matches_reference(arch):
    """The same step through the scans' Functions (``ssm_scan.ops``:
    the plain forward on the CPU, the plain chunked backward).  The grad
    norm is held at the gradient leaves' 1e-4 (F32_TOL): zamba2-smoke's
    is 54.50699 against the reference's 54.50765 (1.2e-5), the same to
    the last bit through the Function and through autograd of the plain
    SSD scan — 97 % of its square is the embedding's gradient, the LM
    head's fp32 sums, whose leaf lies 4.4e-5·max from the reference's."""
    _step_against_reference(arch, gnorm_tol=F32_TOL[1])


def test_microbatched_step_matches_full_batch():
    """Gradient accumulation over 2 microbatches is the same step (the
    reference's test_microbatched_step_matches_full_batch, its
    tolerances)."""
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    batch = _t(_batch(get_config("granite-3-2b-smoke"), seed=9, b=8))
    out = []
    for m in (1, 2):
        model = _port("granite-3-2b-smoke", parallel=ParallelConfig(
            use_flash_attention=True, microbatch=m))
        st = init_state(model)
        out.append(make_train_step(model, tcfg)(st.params, st.opt, batch))
    (p1, _, m1), (p2, _, m2) = out
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)
    for path in p1:
        np.testing.assert_allclose(p1[path].numpy(), p2[path].numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=path)


@pytest.mark.parametrize("arch", ["granite-3-2b-smoke",
                                  "whisper-tiny-smoke"])
def test_remat_policies_agree(arch):
    """"nothing", "dots" and "full_save" recompute the same functions:
    the same loss and gradients, bitwise."""
    batch = _t(_batch(get_config(arch), seed=2))
    res = {}
    for policy in ("nothing", "dots", "full_save"):
        model = _port(arch, parallel=ParallelConfig(
            use_flash_attention=True, remat_policy=policy))
        res[policy] = loss_and_grads(model, dict(model.state_dict()), batch)
    (m0, g0) = res["full_save"]
    for policy in ("nothing", "dots"):
        m, g = res[policy]
        assert torch.equal(m["loss"], m0["loss"]), policy
        for path in g0:
            assert torch.equal(g[path], g0[path]), (policy, path)


def test_chunked_model_matches_flash_route():
    """``attention_impl="chunked"`` (the reference's XLA attention) and
    the flash route through a whole model's loss and gradients."""
    batch = _t(_batch(get_config("granite-3-2b-smoke"), seed=4))
    runs = []
    for pc in (ParallelConfig(use_flash_attention=True),
               ParallelConfig(attention_impl="chunked", attention_chunk=8)):
        model = _port("granite-3-2b-smoke", parallel=pc)
        runs.append(loss_and_grads(model, dict(model.state_dict()), batch))
    (ma, ga), (mb, gb) = runs
    assert abs(float(ma["loss"]) - float(mb["loss"])) <= 1e-5 * float(
        ma["loss"])
    for path in ga:
        _leaf_close(gb[path], ga[path].numpy(), 1e-4, path)


def test_softmax_cross_entropy_masked():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    from repro.models.layers import softmax_cross_entropy as jce
    for mask in (None, (rng.random((2, 5)) < 0.5).astype(np.float32),
                 np.zeros((2, 5), np.float32)):
        want = jce(jnp.asarray(logits), jnp.asarray(labels),
                   None if mask is None else jnp.asarray(mask))
        got = softmax_cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if mask is None else torch.from_numpy(mask))
        assert abs(float(got) - float(want)) <= 1e-6 * max(
            abs(float(want)), 1.0)


@pytest.mark.parametrize("method", ["none", "bf16", "int8"])
def test_compress_decompress_matches_reference(method):
    g = np.random.default_rng(1).standard_normal((37, 5)).astype(np.float32)
    want = jcompression.compress_decompress(jnp.asarray(g), method)
    got = compression.compress_decompress(torch.from_numpy(g), method)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _psum_rank(rank, grads, method):
    """One rank's compressed mean of its own grads, with and without
    error feedback (a residual of 0.01·its grads)."""
    mine = {k: torch.from_numpy(v[rank]) for k, v in grads.items()}
    out, _ = compression.compressed_psum_mean(mine, method=method)
    ef = compression.ErrorFeedback({k: 0.01 * v for k, v in mine.items()})
    out_ef, new = compression.compressed_psum_mean(mine, method=method,
                                                   ef=ef)
    return {"out": out, "out_ef": out_ef, "res": new.residual}


@pytest.fixture(scope="module")
def psum_ranks():
    rng = np.random.default_rng(2)
    grads = {"a": rng.standard_normal((2, 6, 3)).astype(np.float32),
             "b": rng.standard_normal((2, 4)).astype(np.float32)}
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        futs = {m: pool.submit(spawn_ranks, _psum_rank, 2, grads, m,
                               backend="gloo", device="cpu", timeout=300)
                for m in ("none", "int8")}
        return grads, {m: f.result() for m, f in futs.items()}


@pytest.mark.parametrize("method", ["none", "int8"])
def test_compressed_psum_mean_matches_reference(psum_ranks, method):
    """2 gloo ranks against the reference under ``vmap(axis_name=)``."""
    grads, ranks = psum_ranks
    jg = {k: jnp.asarray(v) for k, v in grads.items()}

    def ref(g, with_ef):
        ef = (jcompression.ErrorFeedback(
            jax.tree_util.tree_map(lambda x: 0.01 * x, g))
              if with_ef else None)
        out, new = jcompression.compressed_psum_mean(g, "i", method, ef)
        return out, (new.residual if new is not None else None)

    for with_ef, key in ((False, "out"), (True, "out_ef")):
        out, res = jax.vmap(lambda g: ref(g, with_ef), axis_name="i")(jg)
        for r in range(2):
            for k in grads:
                np.testing.assert_allclose(
                    ranks[method][r][key][k].numpy(), np.asarray(out[k][r]),
                    rtol=1e-6, atol=1e-7)
                if with_ef:
                    np.testing.assert_allclose(
                        ranks[method][r]["res"][k].numpy(),
                        np.asarray(res[k][r]), rtol=1e-6, atol=1e-7)


def test_schedules_match_reference():
    kw = dict(peak=3e-3, warmup=10, total=100)
    for s in (0, 5, 10, 40, 100, 150):
        for port, ref in ((schedule.cosine_schedule, jschedule.cosine_schedule),
                          (schedule.linear_schedule,
                           jschedule.linear_schedule)):
            got = port(torch.tensor(s, dtype=torch.int32), **kw)
            want = ref(jnp.int32(s), **kw)
            assert got.dtype == torch.float32
            assert abs(float(got) - float(want)) <= 1e-6 * max(
                abs(float(want)), 1e-12), (port.__name__, s)


def test_token_stream(monkeypatch):
    """lm_batch splits tokens as the reference's does; the stream is
    deterministic in (seed, step); its share of bigram transitions is
    within 3 se of 1 - eps + eps / V."""
    V = 97
    jt = jlm_data.synthetic_tokens(jax.random.PRNGKey(0), 4, 16, V)
    jb = jlm_data.lm_batch(jax.random.PRNGKey(0), 4, 16, V)
    monkeypatch.setattr(lm_data, "synthetic_tokens",
                        lambda *a: torch.from_numpy(np.array(jt)))
    b = lm_data.lm_batch(lm_data.step_generator(0, 0), 4, 16, V)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))
    monkeypatch.undo()

    a = lm_data.lm_batch(lm_data.step_generator(3, 7), 8, 64, V)
    again = next(lm_data.lm_batch_stream(3, 8, 64, V, start_step=7))
    other = lm_data.lm_batch(lm_data.step_generator(3, 8), 8, 64, V)
    assert all(torch.equal(a[k], again[k]) for k in a)
    assert not torch.equal(a["tokens"], other["tokens"])
    assert a["tokens"].dtype == torch.int32
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])

    toks = lm_data.synthetic_tokens(lm_data.step_generator(1, 0), 64, 512,
                                    V).long()
    hit = ((lm_data.A_MULT * toks[:, :-1] + lm_data.C_ADD) % V
           == toks[:, 1:]).double()
    p = 1 - lm_data.EPS_NOISE + lm_data.EPS_NOISE / V
    se = (p * (1 - p) / hit.numel()) ** 0.5
    assert abs(float(hit.mean()) - p) <= 3 * se
    assert abs(lm_data.bigram_ce_floor(V)
               - jlm_data.bigram_ce_floor(V)) <= 1e-12


def _feed(cfg, start=0):
    return ShardedFeed(lambda s: lm_data.lm_batch(
        lm_data.step_generator(0, s), 4, S, cfg.vocab_size), device="cpu",
        start_step=start)


def test_elastic_resume_is_bitwise(tmp_path):
    """3 steps, a save, ``elastic_restore``, 3 more on a feed from step 3:
    bitwise 6 uninterrupted steps; both match the reference's losses on
    the same batches from the same init."""
    arch = "granite-3-2b-smoke"
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=6)
    losses = {}

    def logger(name):
        return lambda line: losses.setdefault(name, []).append(
            float(line.split("loss")[1].split()[0]))

    model = _port(arch)
    feed = _feed(model.cfg)
    whole = train_loop(model, tcfg, feed, log_every=1, log=logger("whole"))
    feed.close()

    model = _port(arch)
    manager = CheckpointManager(str(tmp_path))
    feed = _feed(model.cfg)
    train_loop(model, dataclasses.replace(tcfg, total_steps=3), feed,
               manager=manager, ckpt_every=3, log_every=1, log=logger("a"))
    feed.close()
    restored, meta = elastic.elastic_restore(manager, _port(arch))
    assert meta["step"] == 3
    feed = _feed(model.cfg, start=3)
    resumed = train_loop(model, tcfg, feed, log_every=1, log=logger("a"),
                         state=TrainState(params=restored["params"],
                                          opt=restored["opt"], step=3))
    feed.close()
    assert resumed.step == whole.step == 6
    for path, x in whole.params.items():
        assert torch.equal(resumed.params[path], x), path
    for name in ("m", "v"):
        for path, x in whole.opt[name].items():
            assert torch.equal(resumed.opt[name][path], x), (name, path)
    assert losses["a"] == losses["whole"]

    jm, params = _ref(arch)
    step = jax.jit(jmake_train_step(jm, JTrainConfig(**dataclasses.asdict(
        tcfg))))
    opt, want = jadamw_init(params), []
    for s in range(6):
        b = lm_data.lm_batch(lm_data.step_generator(0, s), 4, S,
                             model.cfg.vocab_size)
        params, opt, met = step(params, opt,
                                {k: jnp.asarray(v.numpy())
                                 for k, v in b.items()})
        want.append(float(met["loss"]))
    np.testing.assert_allclose(losses["whole"], want, rtol=1e-4)


def test_state_template_and_refusals():
    model = _port("granite-3-2b-smoke")
    tmpl = elastic.state_template(model)
    st = init_state(model)
    assert set(tmpl["params"]) == set(st.params)
    for path, x in st.params.items():
        t = tmpl["params"][path]
        assert t.device.type == "meta" and t.shape == x.shape
        assert t.dtype == x.dtype
    # the shardings are specs on the mesh's axis names (the placement
    # on gloo ranks: tests/test_torch_elastic.py)
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    rules = default_rules(fsdp=True)
    sh = elastic.state_shardings(model, rules, mesh)
    specs = flatten(model.param_specs(rules, mesh))
    assert set(sh["params"]) == set(tmpl["params"]) == set(specs)
    for part in (sh["params"], sh["opt"]["m"], sh["opt"]["v"]):
        assert {k: v.spec for k, v in part.items()} == specs
        assert all(v.mesh is mesh for v in part.values())
    assert sh["opt"]["step"].spec == ()
    assert batch_sharding(mesh).spec == ("data",)
    pods = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert batch_sharding(pods, multi_pod=True).spec == (("pod", "data"),)
    assert batch_sharding(mesh, multi_pod=True).spec == ("data",)


def test_short_run_learns():
    """The reference's test_training_reduces_loss at its size: 2 layers,
    vocab 97, 8 × 32 tokens a step, 150 steps at lr 3e-3."""
    cfg = dataclasses.replace(get_config("granite-3-2b-smoke"),
                              num_layers=2, vocab_size=97)
    model = Model(cfg, ParallelConfig(use_flash_attention=True),
                  device="cpu", seed=0)
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=5, total_steps=150)
    feed = ShardedFeed(lambda s: lm_data.lm_batch(
        lm_data.step_generator(1, s), 8, 32, 97), device="cpu")
    losses = []
    train_loop(model, tcfg, feed, log_every=1, log=lambda line: losses.append(
        float(line.split("loss")[1].split()[0])))
    feed.close()
    assert len(losses) == 150
    assert losses[-1] < losses[0] - 0.4, (losses[0], losses[-1])
