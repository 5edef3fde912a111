"""The port's LM serving path (``Model.prefill`` / ``decode_step`` /
``init_cache``, the blocks' prefill and decode forms, and
``launch/serve.py``'s ``BatchServer``) held against the JAX package's
``repro.models`` and ``repro.launch.serve``, at granite-3-2b-smoke (2
layers, d 64, 4/2 heads × 16), rwkv6-3b-smoke (2 layers, one 64-wide
head, chunk 16) and zamba2-1.2b-smoke (2 mamba layers each followed by
the shared MHA block, state 8, chunk 32).

  * each serving function against its reference: ``gqa_prefill``,
    ``gqa_decode`` (H != KV and H = KV, with and without a softcap, a
    write index past the cache clamped), ``_sdpa`` with a key mask and a
    query offset, ``unembed`` (tied and untied, softcap, padded vocab),
    ``time_mix_*`` / ``channel_mix_*``, ``mamba_*``, ``_causal_conv``
    with a state, ``gla_decode_step`` / ``ssd_decode_step`` (bf16 keys
    against an fp32 state too), ``init_cache`` leaf for leaf;
  * ``Model.prefill``, then 4 ``decode_step``s on the reference's own
    cache carried across by ``convert.cache``: the logits and every
    cache leaf at each step, in fp32 and in bf16 compute;
  * the port's teacher-forced decode against its own train path (a port
    of ``tests/test_models.py::test_prefill_decode_matches_train_logits``);
  * ``BatchServer``'s greedy tokens against the reference server's on
    ragged prompts, a wave against each request alone on same-length
    prompts (a port of ``tests/test_serve_and_train.py``'s), and
    temperature sampling reproducible from one generator seed;
  * the device rule: decode attention takes a non-CPU tensor, train and
    prefill dense attention refuse one; extras a model does not read
    are refused.

The rwkv6 and zamba2 weights have their zero / one leaves (token-shift
mixes, bonus, decay base, conv bias, A_log, dt_bias, D) drawn at random
on both sides, so the carried shift inputs, the bonus and the skip are
exercised.

Tolerances (``tests/test_torch_models.py``'s): fp32 compute rtol 1e-5
with atol 1e-5·max|x| — fp32 sums in another order; the untrained
models' attention scores are large, so an ulp of a score moves p by
~1e-5 relative, which this bound still holds.  bf16 compute:
3e-2·max|x| — every product's output is rounded to bf16 in both
packages, at different points, and such one-step differences carry
through the layers.  Greedy tokens and the wave against its requests
alone are compared exactly.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import ParallelConfig as JParallelConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels.ssm_scan import ops as jscan  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.config import ParallelConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as scan_ops  # noqa: E402
from repro_torch.launch.serve import BatchServer, Request  # noqa: E402
from repro_torch.models import attention, layers, rwkv, ssm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

_GRANITE, _RWKV, _ZAMBA = ("granite-3-2b-smoke", "rwkv6-3b-smoke",
                           "zamba2-1.2b-smoke")
_ARCHS = [_GRANITE, _RWKV, _ZAMBA]
_FLASH = dict(use_flash_attention=True)
_BF16_TOL = 3e-2

# leaf name -> numpy draw replacing the reference's zeros / ones init
_RANDOM_LEAVES = {
    "mu_r": lambda r, s: r.uniform(0, 1, s),
    "mu_k": lambda r, s: r.uniform(0, 1, s),
    "mu_v": lambda r, s: r.uniform(0, 1, s),
    "mu_g": lambda r, s: r.uniform(0, 1, s),
    "mu_w": lambda r, s: r.uniform(0, 1, s),
    "u": lambda r, s: r.standard_normal(s),
    "w0": lambda r, s: r.uniform(-2.5, 2.0, s),
    "ln_bias": lambda r, s: 0.1 * r.standard_normal(s),
    "A_log": lambda r, s: 0.5 * r.standard_normal(s),
    "dt_bias": lambda r, s: 0.5 * r.standard_normal(s),
    "D": lambda r, s: 1.0 + 0.3 * r.standard_normal(s),
    "conv_b": lambda r, s: 0.1 * r.standard_normal(s),
}


def _close(got, want, tol=1e-5, msg=""):
    got = np.asarray(torch.as_tensor(got).float() if isinstance(
        got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30), err_msg=msg)


def _bf16_close(got, want, msg=""):
    got = np.asarray(got.float(), np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, err_msg=msg,
                               atol=_BF16_TOL * float(np.abs(want).max()))


def _randomize(tree, seed):
    rng = np.random.default_rng(seed)

    def walk(node):
        return {k: (walk(v) if isinstance(v, dict) else
                    _RANDOM_LEAVES[k](rng, v.shape).astype(np.float32)
                    if k in _RANDOM_LEAVES else np.asarray(v))
                for k, v in node.items()}
    return walk(tree)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tt(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _flat(tree):
    return convert._flatten(tree)


def _port_model(cfg, tree):
    m = Model(cfg, ParallelConfig(**_FLASH), device="cpu")
    m.load_state_dict(convert.model_params(cfg, tree, device="cpu"))
    return m


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference model at ``arch`` and its weights, zero / one leaves
    drawn at random (a numpy tree)."""
    jmodel = build_model(jget_config(arch), JParallelConfig(**_FLASH))
    return jmodel, _randomize(_np(jmodel.init(jax.random.PRNGKey(0))), seed=5)


@pytest.fixture(scope="module", params=_ARCHS)
def ref(request):
    """(arch, reference model, its params, the numpy tree, the port's
    model on the same weights)."""
    arch = request.param
    jmodel, tree = _reference(arch)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    return arch, jmodel, params, tree, _port_model(get_config(arch), tree)


def _layer0(tree, *path):
    node = tree
    for p in path:
        node = node[p]
    return jax.tree_util.tree_map(lambda a: np.array(a[0]), node)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attn_params(rng, d, h, kv, hd):
    return {"wq": _rand(rng, d, h, hd, scale=d ** -0.5),
            "wk": _rand(rng, d, kv, hd, scale=d ** -0.5),
            "wv": _rand(rng, d, kv, hd, scale=d ** -0.5),
            "wo": _rand(rng, h, hd, d, scale=(h * hd) ** -0.5)}


def test_gqa_prefill_matches_reference():
    cfg_t, cfg_j = get_config(_GRANITE), jget_config(_GRANITE)
    rng = np.random.default_rng(0)
    p = _attn_params(rng, 64, 4, 2, 16)
    x = _rand(rng, 2, 24, 64)
    got, gc = attention.gqa_prefill(_tt(p), cfg_t, torch.from_numpy(x),
                                    ParallelConfig(**_FLASH))
    want, wc = jattn.gqa_prefill(p, cfg_j, jnp.asarray(x),
                                 parallel=JParallelConfig(**_FLASH))
    _close(got, want, msg="out")
    for key in ("k", "v"):
        _close(gc[key], wc[key], msg=key)


@pytest.mark.parametrize("kv,softcap,pos", [(2, 0.0, 9), (2, 5.0, 9),
                                            (4, 0.0, 9), (4, 5.0, 0),
                                            (2, 0.0, 15)])
def test_gqa_decode_matches_reference(kv, softcap, pos):
    """Grouped (H != KV) and MHA (H = KV) decode, softcap on and off;
    the cache holds random values past ``pos`` (masked), and pos 15 on a
    12-slot cache writes at the clamped last slot."""
    cfg_t = dataclasses.replace(get_config(_GRANITE), num_kv_heads=kv,
                                logits_softcap=softcap)
    cfg_j = dataclasses.replace(jget_config(_GRANITE), num_kv_heads=kv,
                                logits_softcap=softcap)
    rng = np.random.default_rng(kv + int(softcap) + pos)
    p = _attn_params(rng, 64, 4, kv, 16)
    x = _rand(rng, 3, 1, 64)
    ck, cv = _rand(rng, 3, 12, kv, 16, scale=3), _rand(rng, 3, 12, kv, 16)
    cache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    got, gc = attention.gqa_decode(_tt(p), cfg_t, torch.from_numpy(x), cache,
                                   pos)
    want, wc = jattn.gqa_decode(p, cfg_j, jnp.asarray(x),
                                {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
                                jnp.int32(pos))
    _close(got, want, msg="out")
    for key in ("k", "v"):
        _close(gc[key], wc[key], msg=key)
        assert gc[key] is cache[key]          # written in place


@pytest.mark.parametrize("kv", [1, 2, 4])
def test_sdpa_kv_mask_and_q_offset_match_reference(kv):
    rng = np.random.default_rng(kv)
    q = _rand(rng, 2, 3, 4, 16)
    k, v = _rand(rng, 2, 7, kv, 16), _rand(rng, 2, 7, kv, 16)
    mask = rng.uniform(size=(2, 7)) < 0.7
    mask[:, 0] = True
    got = attention._sdpa(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True, q_offset=4,
                          kv_mask=torch.from_numpy(mask), softcap=3.0)
    want = jattn._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=True, q_offset=4, kv_mask=jnp.asarray(mask),
                       softcap=3.0)
    _close(got, want)
    # one query, no causal mask, grouped heads: the reference takes its
    # grouped decode form; the port's _sdpa repeats k/v (same function)
    got = attention._sdpa(torch.from_numpy(q[:, :1]), torch.from_numpy(k),
                          torch.from_numpy(v), causal=False,
                          kv_mask=torch.from_numpy(mask))
    want = jattn._sdpa(jnp.asarray(q[:, :1]), jnp.asarray(k), jnp.asarray(v),
                       causal=False, kv_mask=jnp.asarray(mask))
    _close(got, want)


@pytest.mark.parametrize("tied,vocab,softcap", [(True, 256, 0.0),
                                                (False, 256, 0.0),
                                                (True, 250, 30.0),
                                                (False, 200, 5.0)])
def test_unembed_matches_reference(tied, vocab, softcap):
    over = dict(tie_embeddings=tied, vocab_size=vocab, logits_softcap=softcap)
    cfg_t = dataclasses.replace(get_config(_GRANITE), **over)
    cfg_j = dataclasses.replace(jget_config(_GRANITE), **over)
    rng = np.random.default_rng(vocab)
    p = {"embedding": _rand(rng, 256, 64, scale=0.5)}
    if not tied:
        p["unembed"] = _rand(rng, 64, 256, scale=0.5)
    x = _rand(rng, 2, 3, 64)
    got = layers.unembed(_tt(p), cfg_t, torch.from_numpy(x))
    want = np.asarray(jlayers.unembed({k: jnp.asarray(v) for k, v in
                                       p.items()}, cfg_j, jnp.asarray(x)))
    assert got.shape == want.shape == (2, 3, 256)
    # the real vocabulary by value; the padded slots, -1e30 in fp32, by bits
    _close(got[..., :vocab], want[..., :vocab])
    assert np.array_equal(got[..., vocab:].numpy(), want[..., vocab:])
    assert (got[..., vocab:] == float(np.float32(-1e30))).all()


def test_attention_device_rule():
    """Decode attention is plain tensor code on any device (the meta
    device stands in for the card); train and prefill dense attention
    refuse off the CPU, MLA's expanded form too; MLA's latent cache."""
    cfg = get_config(_GRANITE)
    p = {k: torch.empty(v.shape, device="meta") for k, v in
         _attn_params(np.random.default_rng(0), 64, 4, 2, 16).items()}
    cache = {"k": torch.empty((1, 8, 2, 16), device="meta"),
             "v": torch.empty((1, 8, 2, 16), device="meta")}
    out, _ = attention.gqa_decode(p, cfg, torch.empty((1, 1, 64),
                                                      device="meta"), cache, 3)
    assert out.shape == (1, 1, 64) and out.device.type == "meta"
    x = torch.empty((1, 8, 64), device="meta")
    with pytest.raises(NotImplementedError, match="use_flash_attention"):
        attention.gqa_prefill(p, cfg, x, ParallelConfig())
    with pytest.raises(NotImplementedError, match="use_flash_attention"):
        attention.gqa_train(p, cfg, x, ParallelConfig())
    mla = get_config("deepseek-v3-671b-smoke")
    c = attention.init_cache(mla, 1, 8, 2, device="meta")
    assert {k: tuple(v.shape) for k, v in c.items()} == \
        {"c_kv": (2, 1, 8, 16), "k_rope": (2, 1, 8, 8)}
    mp = {k: torch.empty(d.shape, device="meta")
          for k, d in attention.mla_schema(mla).items()}
    with pytest.raises(NotImplementedError, match="use_flash_attention"):
        attention.mla_train(mp, mla, x, ParallelConfig())


# ---------------------------------------------------------------------------
# recurrent blocks and the decode steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_reference(dtype):
    """gla_decode_step (bonus and post) and ssd_decode_step; in bf16 the
    keys, values and queries are bf16 against an fp32 state and decay,
    as rwkv6's decode hands them over."""
    rng = np.random.default_rng(1)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    B, H, D = 2, 3, 8
    s = _rand(rng, B, H, D, D)
    q, k, v = (_rand(rng, B, H, D) for _ in range(3))
    w = rng.uniform(0.3, 1.0, (B, H, D)).astype(np.float32)
    u = _rand(rng, H, D)
    tol = 1e-5 if dtype == "float32" else _BF16_TOL
    for uu in (u, None):
        gs, go = scan_ops.gla_decode_step(
            torch.from_numpy(s), *(torch.from_numpy(a).to(tdt) for a in
                                   (q, k, v)), torch.from_numpy(w),
            None if uu is None else torch.from_numpy(uu))
        ws, wo = jscan.gla_decode_step(
            jnp.asarray(s), *(jnp.asarray(a, jdt) for a in (q, k, v)),
            jnp.asarray(w), None if uu is None else jnp.asarray(uu))
        assert gs.dtype == torch.float32 and go.dtype == torch.float32
        assert ws.dtype == jnp.float32 and wo.dtype == jnp.float32
        _close(gs, ws, tol, msg="state")
        _close(go, wo, tol, msg="o")
    N, P = 4, 8
    s = _rand(rng, B, H, N, P)
    q, k = _rand(rng, B, N), _rand(rng, B, N)
    v, a = _rand(rng, B, H, P), rng.uniform(0.1, 1, (B, H)).astype(np.float32)
    gs, go = scan_ops.ssd_decode_step(*map(torch.from_numpy, (s, q, k, v, a)))
    ws, wo = jscan.ssd_decode_step(*map(jnp.asarray, (s, q, k, v, a)))
    _close(gs, ws)
    _close(go, wo)


def test_causal_conv_with_state_matches_reference():
    rng = np.random.default_rng(2)
    xb, w, b = _rand(rng, 2, 5, 6), _rand(rng, 4, 6), _rand(rng, 6)
    st = _rand(rng, 2, 3, 6)
    for state in (None, st):
        got, gs = ssm._causal_conv(*map(torch.from_numpy, (xb, w, b)),
                                   None if state is None else
                                   torch.from_numpy(state))
        want, ws = jssm._causal_conv(*map(jnp.asarray, (xb, w, b)),
                                     None if state is None else
                                     jnp.asarray(state))
        _close(got, want)
        _close(gs, ws)
    # a state carried one token at a time equals the whole sequence
    whole, _ = ssm._causal_conv(*map(torch.from_numpy, (xb, w, b)))
    carry = None
    for t in range(5):
        out, carry = ssm._causal_conv(torch.from_numpy(xb[:, t:t + 1]),
                                      torch.from_numpy(w), torch.from_numpy(b),
                                      carry)
        assert torch.equal(out[:, 0], whole[:, t])


def _mix_case(arch, dtype):
    cfg_t, cfg_j = get_config(arch), jget_config(arch)
    if dtype == "bfloat16":
        cfg_t = dataclasses.replace(cfg_t, compute_dtype=torch.bfloat16)
        cfg_j = dataclasses.replace(cfg_j, compute_dtype=jnp.bfloat16)
    _, tree = _reference(arch)
    x = _rand(np.random.default_rng(4), 2, 33, 64)
    xt = torch.from_numpy(x).to(cfg_t.compute_dtype)
    xj = jnp.asarray(x, cfg_j.compute_dtype)
    return cfg_t, cfg_j, tree, xt, xj


def _check(got, want, dtype, msg):
    if dtype == "float32":
        _close(got, want, msg=msg)
    else:
        _bf16_close(got, want, msg=msg)


def _check_state(got, want, dtype, what):
    """Leaf for leaf: the reference's dtype, and the values."""
    gf, wf = _flat(got), _flat(want)
    assert sorted(gf) == sorted(wf), what
    for key in gf:
        assert str(gf[key].dtype).replace("torch.", "") == \
            jnp.dtype(wf[key].dtype).name, (what, key)
        _check(gf[key], jnp.asarray(wf[key], jnp.float32), dtype,
               f"{what} {key}")


def _from_j(tree, like):
    """A reference state as torch tensors of ``like``'s dtypes."""
    return jax.tree_util.tree_map(
        lambda a, t: torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))
        .to(t.dtype), tree, like)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_mixes_match_reference(dtype):
    """time_mix / channel_mix prefill over 32 tokens, then one decode step
    on the reference's state; the state's dtypes are the reference's
    (s fp32, x_prev the compute dtype)."""
    cfg_t, cfg_j, tree, xt, xj = _mix_case(_RWKV, dtype)
    tm = _layer0(tree, "stack", "layers", "tm")
    cm = _layer0(tree, "stack", "layers", "cm")
    ch = cfg_t.ssm_chunk
    # time-mix
    got, gs = rwkv.time_mix_prefill(_tt(tm), cfg_t, xt[:, :32], chunk=ch)
    want, ws = jrwkv.time_mix_prefill(tm, cfg_j, xj[:, :32], chunk=ch)
    _check(got, want, dtype, "time-mix prefill")
    _check_state(gs, ws, dtype, "time-mix state")
    got, gs = rwkv.time_mix_decode(_tt(tm), cfg_t, xt[:, 32:],
                                   _from_j(ws, gs))
    want, ws = jrwkv.time_mix_decode(tm, cfg_j, xj[:, 32:], ws)
    _check(got, want, dtype, "time-mix decode")
    _check_state(gs, ws, dtype, "time-mix decode state")
    # channel-mix
    got, gs = rwkv.channel_mix_prefill(_tt(cm), cfg_t, xt[:, :32])
    want, ws = jrwkv.channel_mix_prefill(cm, cfg_j, xj[:, :32])
    _check(got, want, dtype, "channel-mix prefill")
    got, gs = rwkv.channel_mix_decode(_tt(cm), cfg_t, xt[:, 32:],
                                      _from_j(ws, gs))
    want, ws = jrwkv.channel_mix_decode(cm, cfg_j, xj[:, 32:], ws)
    _check(got, want, dtype, "channel-mix decode")
    _check_state(gs, ws, dtype, "channel-mix state")
    # the carried shift: channel_mix_train with x_prev, and _shift
    last = xt[:, :1]
    _check(rwkv.channel_mix_train(_tt(cm), cfg_t, xt[:, 1:], x_prev=last),
           jrwkv.channel_mix_train(cm, cfg_j, xj[:, 1:], x_prev=xj[:, :1]),
           dtype, "x_prev")
    assert torch.equal(rwkv._shift(xt[:, 1:], last), xt[:, :-1])
    init = rwkv.rwkv_init_state(cfg_t, 2, cfg_t.compute_dtype)
    _check_state(init, jrwkv.rwkv_init_state(cfg_j, 2, cfg_j.compute_dtype),
                 dtype, "init")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_matches_reference(dtype):
    """mamba_prefill over 32 tokens (its chunk), then one decode step on
    the reference's state, and the initial state."""
    cfg_t, cfg_j, tree, xt, xj = _mix_case(_ZAMBA, dtype)
    mb = _layer0(tree, "stack", "mamba_layers", "mamba")
    got, gs = ssm.mamba_prefill(_tt(mb), cfg_t, xt[:, :32])
    want, ws = jssm.mamba_prefill(mb, cfg_j, xj[:, :32])
    _check(got, want, dtype, "prefill")
    _check_state(gs, ws, dtype, "prefill state")
    got, gs = ssm.mamba_decode(_tt(mb), cfg_t, xt[:, 32:], _from_j(ws, gs))
    want, ws = jssm.mamba_decode(mb, cfg_j, xj[:, 32:], ws)
    _check(got, want, dtype, "decode")
    _check_state(gs, ws, dtype, "decode state")
    _check_state(ssm.mamba_init_state(cfg_t, 2, cfg_t.compute_dtype),
                 jssm.mamba_init_state(cfg_j, 2, cfg_j.compute_dtype),
                 dtype, "init")


# ---------------------------------------------------------------------------
# the model: cache, prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", _ARCHS)
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_init_cache_matches_reference(arch, compute):
    cfg_t = dataclasses.replace(get_config(arch),
                                compute_dtype=getattr(torch, compute))
    cfg_j = dataclasses.replace(jget_config(arch),
                                compute_dtype=getattr(jnp, compute))
    got = _flat(Model(cfg_t, ParallelConfig(**_FLASH), device="cpu")
                .init_cache(3, 20))
    want = _flat(build_model(cfg_j).init_cache(3, 20))
    assert sorted(got) == sorted(want)
    for key, g in got.items():
        w = want[key]
        assert tuple(g.shape) == tuple(w.shape), key
        assert str(g.dtype).replace("torch.", "") == jnp.dtype(w.dtype).name
        assert not bool(g.any())


def test_prefill_then_decode_matches_reference(ref):
    """Model.prefill, then 4 decode steps on the reference's cache carried
    by convert.cache: the logits and every cache leaf at each step."""
    arch, jmodel, params, tree, model = ref
    toks = np.random.default_rng(6).integers(0, 256, (2, 20)).astype(np.int32)
    want_l, want_c = jmodel.prefill(params, {"tokens": jnp.asarray(toks[:, :16])})
    got_l, got_c = model.prefill(torch.from_numpy(toks[:, :16]))
    assert got_l.shape == (2, 1, 256)
    _close(got_l, want_l, msg="prefill logits")
    gf, wf = _flat(got_c), _flat(_np(want_c))
    assert sorted(gf) == sorted(wf)
    for key in gf:
        _close(gf[key], wf[key], msg=f"prefill cache {key}")
    jc = jserve._splice_prefill(jmodel.init_cache(2, 24), want_c, 16)
    cache = convert.cache(get_config(arch), _np(jc), device="cpu")
    for s in range(4):
        tok = toks[:, 16 + s:17 + s]
        want_l, jc = jmodel.decode_step(params, jnp.asarray(tok), jc,
                                        jnp.int32(16 + s))
        got_l, cache = model.decode_step(torch.from_numpy(tok), cache, 16 + s)
        _close(got_l, want_l, msg=f"step {s} logits")
        gf, wf = _flat(cache), _flat(_np(jc))
        for key in gf:
            _close(gf[key], wf[key], msg=f"step {s} cache {key}")


def test_prefill_then_decode_bf16_matches_reference(ref):
    arch, _, params, tree, _ = ref
    cfg_t = dataclasses.replace(get_config(arch), compute_dtype=torch.bfloat16)
    cfg_j = dataclasses.replace(jget_config(arch), compute_dtype=jnp.bfloat16)
    jmodel = build_model(cfg_j, JParallelConfig(**_FLASH))
    model = _port_model(cfg_t, tree)
    toks = np.random.default_rng(7).integers(0, 256, (2, 18)).astype(np.int32)
    want_l, want_c = jmodel.prefill(params, {"tokens": jnp.asarray(toks[:, :16])})
    got_l, got_c = model.prefill(torch.from_numpy(toks[:, :16]))
    assert got_l.dtype == torch.bfloat16
    _bf16_close(got_l, want_l, "prefill logits")
    jc = jserve._splice_prefill(jmodel.init_cache(2, 20), want_c, 16)
    cache = convert.cache(cfg_t, _np(jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32), jc)), device="cpu")
    for key, leaf in _flat(cache).items():
        assert leaf.dtype == _flat(model.init_cache(2, 20))[key].dtype
    for s in range(2):
        tok = toks[:, 16 + s:17 + s]
        want_l, jc = jmodel.decode_step(params, jnp.asarray(tok), jc,
                                        jnp.int32(16 + s))
        got_l, cache = model.decode_step(torch.from_numpy(tok), cache, 16 + s)
        _bf16_close(got_l, want_l, f"step {s} logits")
        wf = _flat(_np(jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float32), jc)))
        for key, leaf in _flat(cache).items():
            _bf16_close(leaf, wf[key], f"step {s} cache {key}")


def test_teacher_forced_decode_matches_train(ref):
    """Prefill half the sequence, decode the rest teacher-forced: each
    step's logits equal the train path's at that position (the port
    alone; the reference's own serving check)."""
    arch, _, _, _, model = ref
    toks = torch.from_numpy(
        np.random.default_rng(8).integers(0, 256, (2, 32)).astype(np.int64))
    from repro_torch.models.layers import embed_tokens
    with torch.no_grad():
        full = model._logits(model.decoder_stack.train_hidden(
            model.stack, embed_tokens(model.embed, model.cfg, toks)))
    logits, cache = model.prefill(toks[:, :16])
    _close(logits[:, 0], full[:, 15], msg="prefill")
    big = model.init_cache(2, 32)
    from repro_torch.launch.serve import _splice_prefill
    cache = _splice_prefill(big, cache, 16)
    for pos in range(16, 32):
        logits, cache = model.decode_step(toks[:, pos:pos + 1], cache, pos)
        _close(logits[:, 0], full[:, pos], msg=f"pos {pos}")


def test_convert_cache_refuses_other_layouts(ref):
    arch, jmodel, *_ = ref
    cfg = get_config(arch)
    good = _np(jmodel.init_cache(2, 8))
    leaf = sorted(_flat(good))[0]
    bad = jax.tree_util.tree_map(lambda a: a, good)
    node = bad
    *head, name = leaf.split(".")
    for k in head:
        node = node[k]
    node[name] = np.zeros(node[name].shape[:-1] + (node[name].shape[-1] + 1,),
                          np.float32)
    with pytest.raises(ValueError, match="shape"):
        convert.cache(cfg, bad, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        convert.cache(cfg, {"x": {"y": np.zeros((2, 2, 8))}}, device="cpu")


# ---------------------------------------------------------------------------
# BatchServer
# ---------------------------------------------------------------------------

def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 250, (n,)).astype(np.int32) for n in lengths]


def test_batch_server_matches_reference(ref):
    """Greedy tokens of a ragged wave (left-padded, unmasked) equal the
    reference server's."""
    arch, jmodel, params, _, model = ref
    prompts = _prompts(9, (12, 7, 10))
    want = jserve.BatchServer(jmodel, params, max_seq=64).serve_wave(
        [jserve.Request(jnp.asarray(p), max_new_tokens=n)
         for p, n in zip(prompts, (6, 4, 6))])
    got = BatchServer(model, max_seq=64).serve_wave(
        [Request(torch.from_numpy(p), max_new_tokens=n)
         for p, n in zip(prompts, (6, 4, 6))])
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert [len(c.tokens) for c in got] == [6, 4, 6]
    assert all(c.latency_s > 0 for c in got)


def test_wave_equals_solo(ref):
    """Same-length prompts: the wave's greedy tokens equal each request
    served alone."""
    *_, model = ref
    server = BatchServer(model, max_seq=64)
    prompts = [torch.from_numpy(p) for p in _prompts(10, (8, 8, 8))]
    outs = server.serve_wave([Request(p, max_new_tokens=5) for p in prompts])
    for i, p in enumerate(prompts):
        solo = server.serve_wave([Request(p, max_new_tokens=5)])
        assert outs[i].tokens == solo[0].tokens, i


def test_temperature_sampling_is_reproducible():
    cfg = get_config(_GRANITE)
    model = Model(cfg, ParallelConfig(**_FLASH), device="cpu", seed=3)
    prompts = [torch.from_numpy(p) for p in _prompts(11, (6, 9))]

    def serve(seed):
        gen = torch.Generator().manual_seed(seed)
        server = BatchServer(model, max_seq=32, generator=gen)
        return [c.tokens for c in server.serve_wave(
            [Request(p, max_new_tokens=8, temperature=0.8) for p in prompts])]

    a, b, c = serve(1), serve(1), serve(2)
    assert a == b and a != c
    assert all(0 <= t < cfg.vocab_size for row in a for t in row)
    # the default generator is seeded 0
    default = BatchServer(model, max_seq=32).serve_wave(
        [Request(p, max_new_tokens=8, temperature=0.8) for p in prompts])
    assert [r.tokens for r in default] == serve(0)


def test_serving_refusals():
    """A wave's extras the model does not read, and a family with no
    decoder-only stack, are refused."""
    model = Model(get_config(_RWKV), device="cpu")
    with pytest.raises(ValueError, match="frames"):
        BatchServer(model).serve_wave(
            [Request(torch.zeros(4, dtype=torch.long))],
            extras={"frames": torch.zeros((1, 8, 64))})
    with pytest.raises(ValueError, match="patch_embeds"):
        BatchServer(model).serve_wave(
            [Request(torch.zeros(4, dtype=torch.long))],
            extras={"patch_embeds": torch.zeros((1, 2, 64))})
    from repro_torch.models.transformer import DecoderStack
    audio = dataclasses.replace(get_config(_GRANITE), family="audio")
    with pytest.raises(ValueError, match="encdec"):
        DecoderStack(audio, ParallelConfig())
