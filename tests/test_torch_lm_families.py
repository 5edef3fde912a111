"""The rest of the decoder-only LM families held against the JAX
package's ``repro.models``: yi-34b (dense GQA), phi4-mini-3.8b (partial
NeoX RoPE, 0.75 of the head), chatglm3-6b (interleaved RoPE on half the
head), arctic-480b (MoE with a dense residual MLP) and deepseek-v3-671b
(MLA with a q-LoRA, a sigmoid-routed MoE with a shared expert, a first
dense layer), each at its ``-smoke`` config (2 layers, d 64, 4 heads;
MLA 8 + 8 / 16; 4 experts, top-2).

  * the registry: every field of the five configs (and of pixtral-12b
    and whisper-tiny), full and ``-smoke``, against the reference's;
    every architecture of the reference's registry builds and prefills;
  * the schema's paths and shapes against the reference's;
  * with ``use_flash_attention`` True and False on both sides, on the
    reference's weights (through ``convert.model_params``):
    ``Model.prefill``'s logits and cache, 4 ``decode_step``s on the
    reference's own cache (``convert.cache``), ``features``, and the
    moe stack's aux loss from ``train_hidden``;
  * RoPE as the reference selects it: phi4's partial NeoX halves and
    chatglm's interleaved pairs through ``gqa_project_qkv``;
  * MLA: the absorbed decode, teacher-forced, against the expanded
    train path, and ``mla_decode`` against the reference's;
  * ``BatchServer``'s greedy tokens against the reference server's.

Tolerances: fp32 compute rtol 1e-5 with atol 1e-5·max|x| — fp32 sums in
another order; the smoke MoE keeps every pick (capacity factor 8.0), so
no drop sets the two apart.  MLA's absorbed decode against its expanded
form: 1e-5 too — both are fp32 here, and the two only associate the
same products differently ((q·wk_b)·c against q·(c·wk_b)).  Greedy
tokens are compared exactly.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import ParallelConfig as JParallelConfig  # noqa: E402
from repro.configs import ARCH_IDS as JARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.config import ParallelConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.serve import BatchServer, Request  # noqa: E402
from repro_torch.launch.serve import _splice_prefill  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.layers import embed_tokens  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import map_schema  # noqa: E402

_FULL = ["yi-34b", "phi4-mini-3.8b", "chatglm3-6b", "arctic-480b",
         "deepseek-v3-671b"]
_ARCHS = [a + "-smoke" for a in _FULL]
_MOE = ["arctic-480b-smoke", "deepseek-v3-671b-smoke"]


def _close(got, want, tol=1e-5, msg=""):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30), err_msg=msg)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return convert._flatten(tree)


def _by_name(cfg):
    """The config's fields, dtypes by name."""
    def norm(v):
        if isinstance(v, torch.dtype):
            return str(v).replace("torch.", "")
        if v in (jnp.float32, jnp.bfloat16):
            return jnp.dtype(v).name
        return v
    return {k: norm(v) for k, v in dataclasses.asdict(cfg).items()}


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The reference's init of ``arch`` (a numpy tree)."""
    return _np(jax.jit(build_model(jget_config(arch)).init)(
        jax.random.PRNGKey(1)))


@functools.lru_cache(maxsize=None)
def _reference(arch, flash):
    """The reference model at ``arch`` and its weights (a numpy tree)."""
    return (build_model(jget_config(arch),
                        JParallelConfig(use_flash_attention=flash)),
            _weights(arch))


def _port(arch, tree, flash):
    cfg = get_config(arch)
    m = Model(cfg, ParallelConfig(use_flash_attention=flash), device="cpu")
    m.load_state_dict(convert.model_params(cfg, tree, device="cpu"))
    return m


@pytest.fixture(scope="module", params=[(a, f) for a in _ARCHS
                                        for f in (True, False)],
                ids=lambda p: f"{p[0]}-{'flash' if p[1] else 'dense'}")
def ref(request):
    """(arch, reference model, its params, the port's model)."""
    arch, flash = request.param
    jmodel, tree = _reference(arch, flash)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    return arch, jmodel, params, _port(arch, tree, flash)


_ENCODER = ["pixtral-12b", "whisper-tiny"]


@pytest.mark.parametrize("arch", _FULL + _ARCHS + _ENCODER
                         + [a + "-smoke" for a in _ENCODER])
def test_config_matches_reference(arch):
    t, j = get_config(arch), jget_config(arch)
    assert _by_name(t) == _by_name(j)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()


@pytest.mark.parametrize("arch", JARCH_IDS)
def test_every_registry_arch_builds(arch):
    """Every architecture of the reference's registry builds at its
    ``-smoke`` config, on the reference's weights, and serves a token."""
    cfg = get_config(arch + "-smoke")
    model = _port(arch + "-smoke", _weights(arch + "-smoke"), False)
    extras = {}
    if cfg.is_encdec:
        extras["frames"] = torch.zeros((1, 8, cfg.d_model))
    logits, cache = model.prefill(torch.zeros((1, 4), dtype=torch.long),
                                  **extras)
    assert tuple(logits.shape) == (1, 1, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", _ARCHS + [a + "-smoke" for a in _ENCODER])
def test_schema_matches_reference(arch):
    got = {}
    map_schema(lambda p, d: got.__setitem__(p, tuple(d.shape)),
               Model.schema_of(get_config(arch)))
    want = {".".join(k.key for k in path): tuple(a.shape) for path, a in
            jax.tree_util.tree_flatten_with_path(
                build_model(jget_config(arch)).abstract_params())[0]}
    assert got == want


def test_prefill_decode_features_match_reference(ref):
    """prefill's logits and every cache leaf, then 4 decode steps on the
    reference's cache carried across by convert.cache, then features."""
    arch, jmodel, params, model = ref
    toks = np.random.default_rng(6).integers(0, 256, (2, 20)).astype(
        np.int32)
    decode, prefill = jax.jit(jmodel.decode_step), jax.jit(jmodel.prefill)
    want_l, want_c = prefill(params, {"tokens": jnp.asarray(toks[:, :16])})
    got_l, got_c = model.prefill(torch.from_numpy(toks[:, :16]))
    _close(got_l, want_l, msg="prefill logits")
    gf, wf = _flat(got_c), _flat(_np(want_c))
    assert sorted(gf) == sorted(wf)
    for key in gf:
        _close(gf[key], wf[key], msg=f"prefill cache {key}")
    jc = jserve._splice_prefill(jmodel.init_cache(2, 24), want_c, 16)
    cache = convert.cache(get_config(arch), _np(jc), device="cpu")
    for s in range(4):
        tok = toks[:, 16 + s:17 + s]
        want_l, jc = decode(params, jnp.asarray(tok), jc, jnp.int32(16 + s))
        got_l, cache = model.decode_step(torch.from_numpy(tok), cache,
                                         16 + s)
        _close(got_l, want_l, msg=f"step {s} logits")
        wf = _flat(_np(jc))
        for key, leaf in _flat(cache).items():
            _close(leaf, wf[key], msg=f"step {s} cache {key}")
    want = jax.jit(jmodel.features)(params, {"tokens": jnp.asarray(toks)})
    _close(model.features(torch.from_numpy(toks)), want, msg="features")


@pytest.mark.parametrize("arch", _MOE)
def test_moe_aux_matches_reference(arch):
    jmodel, tree = _reference(arch, True)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    model = _port(arch, tree, True)
    toks = np.random.default_rng(7).integers(0, 256, (2, 16))
    x = embed_tokens(model.embed, model.cfg, torch.from_numpy(toks))
    h, aux = model.decoder_stack.train_hidden(model.stack, x, with_aux=True)
    jx = jnp.asarray(x.numpy())
    jh, jaux = jmodel.stack.train_hidden(params["stack"], jx)
    _close(h, jh, msg="hidden")
    _close(aux, jaux, msg="aux")
    assert float(aux) > 0
    assert torch.equal(model.decoder_stack.train_hidden(model.stack, x), h)


@pytest.mark.parametrize("arch,interleaved", [("phi4-mini-3.8b-smoke", False),
                                              ("chatglm3-6b-smoke", True)])
def test_rope_selection_matches_reference(arch, interleaved):
    """phi4-mini rotates 12 of 16 dims in NeoX halves, chatglm3 8 of 16
    in interleaved pairs — selected by the reference's name test."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    rng = np.random.default_rng(8)
    p = {n: (rng.standard_normal((64, h, 16)) / 8).astype(np.float32)
         for n, h in (("wq", 4), ("wk", 2), ("wv", 2))}
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9) + 5, (2, 9)).copy()
    got = attention.gqa_project_qkv({k: torch.from_numpy(v)
                                     for k, v in p.items()}, cfg,
                                    torch.from_numpy(x),
                                    torch.from_numpy(pos))
    want = jattn.gqa_project_qkv({k: jnp.asarray(v) for k, v in p.items()},
                                 jcfg, jnp.asarray(x), jnp.asarray(pos))
    for g, w, name in zip(got, want, "qkv"):
        _close(g, w, msg=name)
    # the rotated slice moved, the rest passed through, in the named form
    rot = int(16 * cfg.rope_fraction)
    q0 = np.einsum("bsd,dhk->bshk", x, p["wq"])
    assert np.allclose(got[0][..., rot:].numpy(), q0[..., rot:], atol=1e-5)
    other = dataclasses.replace(cfg, name="renamed")
    flipped = attention.gqa_project_qkv(
        {k: torch.from_numpy(v) for k, v in p.items()}, other,
        torch.from_numpy(x), torch.from_numpy(pos))[0]
    assert not torch.allclose(flipped, got[0]) if interleaved else \
        torch.equal(flipped, got[0])


def test_mla_absorbed_decode_matches_expanded():
    """deepseek-v3-smoke: prefill half the sequence, decode the rest
    teacher-forced through the absorbed latent attention; each step's
    logits equal the expanded train path's at that position."""
    arch = "deepseek-v3-671b-smoke"
    model = _port(arch, _reference(arch, True)[1], True)
    toks = torch.from_numpy(
        np.random.default_rng(9).integers(0, 256, (2, 24)).astype(np.int64))
    with torch.no_grad():
        full = model._logits(model.decoder_stack.train_hidden(
            model.stack, embed_tokens(model.embed, model.cfg, toks)))
    logits, cache = model.prefill(toks[:, :12])
    _close(logits[:, 0], full[:, 11], msg="prefill")
    cache = _splice_prefill(model.init_cache(2, 24), cache, 12)
    assert sorted(_flat(cache)) == ["dense.c_kv", "dense.k_rope",
                                    "moe.c_kv", "moe.k_rope"]
    for pos in range(12, 24):
        logits, cache = model.decode_step(toks[:, pos:pos + 1], cache, pos)
        _close(logits[:, 0], full[:, pos], msg=f"pos {pos}")


@pytest.mark.parametrize("pos", [5, 40])
def test_mla_decode_matches_reference(pos):
    """One absorbed step on a random latent cache (``pos`` past the cache
    writes the clamped last slot, as ``dynamic_update_slice``)."""
    cfg, jcfg = (get_config("deepseek-v3-671b-smoke"),
                 jget_config("deepseek-v3-671b-smoke"))
    rng = np.random.default_rng(10)
    p = map_schema(lambda _, d: (rng.standard_normal(d.shape) / 4).astype(
        np.float32), attention.mla_schema(cfg))
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    c = {"c_kv": rng.standard_normal((2, 8, 16)).astype(np.float32),
         "k_rope": rng.standard_normal((2, 8, 8)).astype(np.float32)}
    out, new = attention.mla_decode(
        {k: torch.from_numpy(v) for k, v in p.items()}, cfg,
        torch.from_numpy(x), {k: torch.from_numpy(v.copy())
                              for k, v in c.items()}, pos)
    jout, jnew = jattn.mla_decode({k: jnp.asarray(v) for k, v in p.items()},
                                  jcfg, jnp.asarray(x),
                                  {k: jnp.asarray(v) for k, v in c.items()},
                                  jnp.int32(pos))
    _close(out, jout, msg="out")
    for k in c:
        _close(new[k], jnew[k], msg=k)


@pytest.mark.parametrize("arch", ["chatglm3-6b-smoke"] + _MOE)
def test_batch_server_matches_reference(arch):
    """Greedy tokens of a ragged wave equal the reference server's (the
    nested moe caches, MLA's latent cache, chatglm's RoPE)."""
    jmodel, tree = _reference(arch, True)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 250, (n,)).astype(np.int32)
               for n in (10, 6, 9)]
    want = jserve.BatchServer(jmodel, params, max_seq=32).serve_wave(
        [jserve.Request(jnp.asarray(q), max_new_tokens=n)
         for q, n in zip(prompts, (5, 3, 5))])
    got = BatchServer(_port(arch, tree, True), max_seq=32).serve_wave(
        [Request(torch.from_numpy(q), max_new_tokens=n)
         for q, n in zip(prompts, (5, 3, 5))])
    assert [c.tokens for c in got] == [c.tokens for c in want]
