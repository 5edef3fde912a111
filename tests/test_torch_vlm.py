"""The port's vlm (pixtral-12b) held against the JAX package's
``repro.models.model``, at pixtral-12b-smoke (2 dense layers, d 64, 4/2
heads × 16, SwiGLU, RoPE θ 1e9, untied embeddings), on the reference's
weights (``convert.model_params``), with patch embeddings (B, P, d_model)
drawn as the reference's own tests draw them (0.1 · normal).  The
front end is a stub in both packages: the patches take the first P
positions of the token stream.

  * ``Model._embed_in``'s splice against the reference's;
  * with ``use_flash_attention`` True and False on both sides:
    ``Model.prefill``'s logits and cache, 4 ``decode_step``s on the
    reference's own cache (``convert.cache``), ``features`` and
    ``backbone_features(extras=)`` in batches;
  * teacher-forced decode against the reference's ``forward_train``;
  * ``BatchServer``'s greedy tokens with patches against the reference
    server's on a ragged wave (the patches overwrite the left pads);
  * ``state_dict()`` keys the reference's pytree paths, and a vlm without
    patches (the token path alone).

Tolerance: fp32 rtol 1e-5 with atol 1e-5·max|x| (fp32 sums in another
order), as ``tests/test_torch_lm_families.py``.  Teacher-forced decode
against the reference's train path crosses both packages and both paths
(one query row over the cache against attention over the whole
sequence), each pair within ~1e-5: up to 1.5e-5·max over 6 draws, flash
and dense; ``TF_TOL`` 5e-5.  Greedy tokens are compared exactly.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import ParallelConfig as JParallelConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import nuisance as jnuisance  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.config import ParallelConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.nuisance import backbone_features  # noqa: E402
from repro_torch.launch.serve import BatchServer, Request  # noqa: E402
from repro_torch.launch.serve import _splice_prefill  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

ARCH = "pixtral-12b-smoke"
TF_TOL = 5e-5


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


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _weights():
    return _np(jax.jit(build_model(jget_config(ARCH)).init)(
        jax.random.PRNGKey(1)))


def _patches(seed, B=2, P=4, d=64):
    return (0.1 * np.random.default_rng(seed).standard_normal(
        (B, P, d))).astype(np.float32)


def _tokens(seed, B=2, S=20):
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(
        np.int32)


@pytest.fixture(scope="module", params=[True, False],
                ids=["flash", "dense"])
def ref(request):
    """(reference model, its params, the port's model)."""
    flash = request.param
    jmodel = build_model(jget_config(ARCH),
                         JParallelConfig(use_flash_attention=flash))
    tree = _weights()
    cfg = get_config(ARCH)
    model = Model(cfg, ParallelConfig(use_flash_attention=flash),
                  device="cpu")
    model.load_state_dict(convert.model_params(cfg, tree, device="cpu"))
    return jmodel, jax.tree_util.tree_map(jnp.asarray, tree), model


def test_patch_splice_matches_reference(ref):
    jmodel, params, model = ref
    toks, pe = _tokens(1, S=12), _patches(1)
    want = jmodel._embed_in(params, {"tokens": jnp.asarray(toks),
                                     "patch_embeds": jnp.asarray(pe)})
    got = model._embed_in(_t(toks), None, _t(pe))
    _close(got, want)
    assert torch.equal(got[:, :4], _t(pe))
    assert torch.equal(got[:, 4:], model._embed_in(_t(toks), None,
                                                   None)[:, 4:])


def test_prefill_decode_features_match_reference(ref):
    """prefill's logits and cache with patches, then 4 decode steps on
    the reference's cache carried across by convert.cache, then features
    and backbone_features in batches of one."""
    jmodel, params, model = ref
    toks, pe = _tokens(6), _patches(6)
    decode, prefill = jax.jit(jmodel.decode_step), jax.jit(jmodel.prefill)
    want_l, want_c = prefill(params, {"tokens": jnp.asarray(toks[:, :16]),
                                      "patch_embeds": jnp.asarray(pe)})
    got_l, got_c = model.prefill(_t(toks[:, :16]), patch_embeds=_t(pe))
    _close(got_l, want_l, msg="prefill logits")
    gf, wf = convert._flatten(got_c), convert._flatten(_np(want_c))
    assert sorted(gf) == sorted(wf) == ["k", "v"]
    for key in gf:
        _close(gf[key], wf[key], msg=f"prefill cache {key}")
    jc = jserve._splice_prefill(jmodel.init_cache(2, 24), want_c, 16)
    cache = convert.cache(model.cfg, _np(jc), device="cpu")
    for s in range(4):
        tok = toks[:, 16 + s:17 + s]
        want_l, jc = decode(params, jnp.asarray(tok), jc, jnp.int32(16 + s))
        got_l, cache = model.decode_step(_t(tok), cache, 16 + s)
        _close(got_l, want_l, msg=f"step {s} logits")
        wf = convert._flatten(_np(jc))
        for key, leaf in convert._flatten(cache).items():
            _close(leaf, wf[key], msg=f"step {s} cache {key}")
    full = {"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(pe)}
    _close(model.features(_t(toks), patch_embeds=_t(pe)),
           jax.jit(jmodel.features)(params, full), msg="features")
    _close(model.features(_t(toks)),
           jax.jit(jmodel.features)(params, {"tokens": jnp.asarray(toks)}),
           msg="features without patches")
    want = jnuisance.backbone_features(
        jmodel, params, jnp.asarray(toks), batch_size=1,
        extras={"patch_embeds": jnp.asarray(pe)})
    got = backbone_features(model, _t(toks), batch_size=1,
                            extras={"patch_embeds": _t(pe)})
    _close(got, want, msg="backbone_features")


def test_teacher_forced_decode_matches_reference_train(ref):
    """The port's prefill over 12 tokens (4 of them patches), then
    teacher-forced decode to 24: each step's logits against the
    reference's ``forward_train`` logits at that position."""
    jmodel, params, model = ref
    toks, pe = _tokens(7, S=24), _patches(7)
    want, _ = jax.jit(jmodel.forward_train)(
        params, {"tokens": jnp.asarray(toks),
                 "patch_embeds": jnp.asarray(pe)})
    want = np.asarray(want)
    logits, cache = model.prefill(_t(toks[:, :12]), patch_embeds=_t(pe))
    _close(logits[:, 0], want[:, 11], msg="prefill")
    cache = _splice_prefill(model.init_cache(2, 24), cache, 12)
    for pos in range(12, 24):
        logits, cache = model.decode_step(_t(toks[:, pos:pos + 1]), cache,
                                          pos)
        _close(logits[:, 0], want[:, pos], tol=TF_TOL, msg=f"pos {pos}")


def test_batch_server_matches_reference(ref):
    """Greedy tokens of a ragged wave with 4 patches a request: the
    patches overwrite the first positions of the left-padded wave, pads
    included, in both packages."""
    jmodel, params, model = ref
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 250, (n,)).astype(np.int32)
               for n in (10, 6, 9)]
    pe = _patches(11, B=3)
    want = jserve.BatchServer(jmodel, params, max_seq=32).serve_wave(
        [jserve.Request(jnp.asarray(q), max_new_tokens=n)
         for q, n in zip(prompts, (5, 3, 5))],
        extras={"patch_embeds": jnp.asarray(pe)})
    got = BatchServer(model, max_seq=32).serve_wave(
        [Request(_t(q), max_new_tokens=n)
         for q, n in zip(prompts, (5, 3, 5))],
        extras={"patch_embeds": _t(pe)})
    assert [c.tokens for c in got] == [c.tokens for c in want]


def test_state_dict_keys_are_reference_paths():
    model = Model(get_config(ARCH), device="cpu")
    keys = set(model.state_dict())
    assert keys == set(convert._flatten(_weights()))
    assert {"embed.unembed", "stack.layers.attn.wq",
            "stack.layers.mlp.wi_gate", "ln_f.scale"} <= keys
    with pytest.raises(ValueError, match="frames"):
        model.prefill(torch.zeros((1, 4), dtype=torch.long),
                      frames=torch.zeros((1, 8, 64)))
