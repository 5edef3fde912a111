"""The port's encoder-decoder (whisper-tiny) held against the JAX
package's ``repro.models.encdec`` / ``repro.models.model``, at
whisper-tiny-smoke (2 encoder + 2 decoder layers, d 64, 4/2 heads × 16,
64 source positions, LayerNorm, GELU, learned positions, tied
embeddings), on the reference's weights (``convert.model_params``) and
frames drawn as the reference's own tests draw them (0.1 · normal).

  * ``layernorm`` and the learned positions of ``embed_tokens`` (at an
    offset too);
  * each encoder layer on the same input, ``encode`` end to end,
    ``encoder_cross_kv``, ``cross_attn`` (a prompt, and one query row,
    which the reference routes to its grouped single-query form);
  * with ``use_flash_attention`` True and False on both sides:
    ``Model.prefill``'s logits and both caches, 4 ``decode_step``s on the
    reference's own cache (``convert.cache``), ``features`` and
    ``backbone_features(extras=)`` in batches;
  * teacher-forced decode against the reference's ``forward_train``;
  * ``BatchServer``'s greedy tokens with frames against the reference
    server's, at fewer frames than ``max_source_positions`` (the cross
    cache spliced into zeros, as the reference splices it);
  * bf16 compute layer by layer (each encoder layer, each decoder
    layer's prefill over the same cross K/V);
  * ``init_cache`` leaf for leaf, ``state_dict()`` keys the reference's
    pytree paths, and the refusals.

Tolerances: one function on the same inputs, fp32 rtol 1e-5 with atol
1e-5·max|x| (fp32 sums in another order).  Through the whole encoder,
3e-4·max (``E2E_TOL``): at the reference's init the stacked weights take
fan-in from the layer axis (std 1/sqrt(2) here), so the bidirectional
attention over 64 frames has scores of std ~30 and near one-hot rows; an
ulp of a score moves such a row's p by ~1e-6 relative (one encoder
layer: 3.7e-6·max), and the second layer, the final norm and the
decoder's cross-attention over the large encoder keys carry it to up to
7.3e-5·max (16 draws of weights and inputs, flash and dense); the
reference's own whisper test allows 2e-3 between its serving and train
paths.  bf16 compute, layer by layer: 3e-2·max, as
``tests/test_torch_serve.py``.
Greedy tokens are compared exactly.
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
from repro.core import nuisance as jnuisance  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.config import ParallelConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.nuisance import backbone_features  # noqa: E402
from repro_torch.launch.serve import BatchServer, Request  # noqa: E402
from repro_torch.launch.serve import _splice_prefill  # noqa: E402
from repro_torch.models import attention, encdec, layers  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import layer_slice  # noqa: E402

ARCH = "whisper-tiny-smoke"
E2E_TOL = 3e-4
_BF16_TOL = 3e-2


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
def _weights(arch=ARCH):
    return _np(jax.jit(build_model(jget_config(arch)).init)(
        jax.random.PRNGKey(1)))


def _port(tree, flash, cfg=None):
    cfg = cfg or get_config(ARCH)
    m = Model(cfg, ParallelConfig(use_flash_attention=flash), device="cpu")
    m.load_state_dict(convert.model_params(cfg, tree, device="cpu"))
    return m


def _frames(seed, B=2, T=64, d=64):
    return (0.1 * np.random.default_rng(seed).standard_normal(
        (B, T, d))).astype(np.float32)


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
    return (jmodel, jax.tree_util.tree_map(jnp.asarray, tree),
            _port(tree, flash))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal((2, 7, 64)) + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    got = layers.layernorm({k: _t(v) for k, v in p.items()},
                           _t(x).to(getattr(torch, dtype)), 1e-5)
    want = jlayers.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x).astype(getattr(jnp, dtype)),
                             1e-5)
    assert str(got.dtype).endswith(dtype)
    _close(got, np.asarray(want.astype(jnp.float32)),
           tol=1e-5 if dtype == "float32" else _BF16_TOL)


@pytest.mark.parametrize("offset", [0, 5])
def test_learned_positions_match_reference(offset):
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    tree = _weights()
    toks = _tokens(1, S=9)
    got = layers.embed_tokens({k: _t(v) for k, v in tree["embed"].items()},
                              cfg, _t(toks), pos_offset=offset)
    want = jlayers.embed_tokens(jax.tree_util.tree_map(jnp.asarray,
                                                       tree["embed"]),
                                jcfg, jnp.asarray(toks), pos_offset=offset)
    _close(got, want)
    no_pos = layers.embed_tokens(
        {k: _t(v) for k, v in tree["embed"].items()},
        dataclasses.replace(cfg, learned_pos_emb=False), _t(toks))
    _close(got - no_pos, np.broadcast_to(
        tree["embed"]["pos"][offset:offset + 9], got.shape))


def test_encoder_matches_reference(ref):
    """Each encoder layer on the same input at 1e-5, then ``encode``
    end to end, and the cross K/V of the reference's encoder output."""
    jmodel, params, model = ref
    cfg, jcfg = model.cfg, jmodel.cfg
    fr = _frames(2)
    one, jone = (dataclasses.replace(cfg, encoder_layers=1),
                 dataclasses.replace(jcfg, encoder_layers=1))
    jenc = params["encoder"]
    for i in range(cfg.encoder_layers):
        jtree = {**jenc, "layers": jax.tree_util.tree_map(
            lambda a: a[i:i + 1], jenc["layers"])}
        want = jencdec.encode(jtree, jone, jnp.asarray(fr), None,
                              jmodel.parallel)
        tree = {"pos": model.encoder["pos"], "ln_f": model.encoder["ln_f"],
                "layers": layer_slice(model.encoder["layers"],
                                      slice(i, i + 1))}
        got = encdec.encode(tree, one, _t(fr), model.parallel)
        _close(got, want, msg=f"encoder layer {i}")
    want = jencdec.encode(jenc, jcfg, jnp.asarray(fr), None, jmodel.parallel)
    got = encdec.encode(model.encoder, cfg, _t(fr), model.parallel)
    _close(got, want, tol=E2E_TOL, msg="encode")
    jkv = jencdec.encoder_cross_kv(params["decoder"], jcfg, want)
    kv = encdec.encoder_cross_kv(model.decoder, cfg, _t(want))
    for n in ("k", "v"):
        assert tuple(kv[n].shape) == (2, 2, 64, 2, 16)
        _close(kv[n], jkv[n], msg=f"cross {n}")


@pytest.mark.parametrize("S", [5, 1])
def test_cross_attn_matches_reference(S):
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    rng = np.random.default_rng(3)
    p = {n: (rng.standard_normal(s) / 4).astype(np.float32) for n, s in
         (("wq", (64, 4, 16)), ("wk", (64, 2, 16)), ("wv", (64, 2, 16)),
          ("wo", (4, 16, 64)))}
    x = rng.standard_normal((2, S, 64)).astype(np.float32)
    enc = rng.standard_normal((2, 24, 64)).astype(np.float32)
    tp = {k: _t(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    kv = attention.cross_kv(tp, cfg, _t(enc))
    jkv = jattn.cross_kv(jp, jcfg, jnp.asarray(enc))
    _close(attention.cross_attn(tp, cfg, _t(x), kv),
           jattn.cross_attn(jp, jcfg, jnp.asarray(x), jkv))


def test_prefill_decode_features_match_reference(ref):
    """prefill's logits and both caches, then 4 decode steps on the
    reference's cache carried across by convert.cache, then features and
    backbone_features in batches of one."""
    jmodel, params, model = ref
    toks, fr = _tokens(6), _frames(6)
    decode, prefill = jax.jit(jmodel.decode_step), jax.jit(jmodel.prefill)
    batch = {"tokens": jnp.asarray(toks[:, :16]), "frames": jnp.asarray(fr)}
    want_l, want_c = prefill(params, batch)
    got_l, got_c = model.prefill(_t(toks[:, :16]), frames=_t(fr))
    _close(got_l, want_l, tol=E2E_TOL, msg="prefill logits")
    gf, wf = convert._flatten(got_c), convert._flatten(_np(want_c))
    assert sorted(gf) == ["cross.k", "cross.v", "self.k", "self.v"]
    assert sorted(gf) == sorted(wf)
    for key in gf:
        _close(gf[key], wf[key], tol=E2E_TOL, msg=f"prefill cache {key}")
    jc = jserve._splice_prefill(jmodel.init_cache(2, 24), want_c, 16)
    cache = convert.cache(model.cfg, _np(jc), device="cpu")
    for s in range(4):
        tok = toks[:, 16 + s:17 + s]
        want_l, jc = decode(params, jnp.asarray(tok), jc, jnp.int32(16 + s))
        got_l, cache = model.decode_step(_t(tok), cache, 16 + s)
        _close(got_l, want_l, tol=E2E_TOL, msg=f"step {s} logits")
        wf = convert._flatten(_np(jc))
        for key, leaf in convert._flatten(cache).items():
            _close(leaf, wf[key], msg=f"step {s} cache {key}")
    full = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(fr)}
    want = jax.jit(jmodel.features)(params, full)
    _close(model.features(_t(toks), frames=_t(fr)), want, tol=E2E_TOL,
           msg="features")
    want = jnuisance.backbone_features(jmodel, params, jnp.asarray(toks),
                                       batch_size=1,
                                       extras={"frames": jnp.asarray(fr)})
    got = backbone_features(model, _t(toks), batch_size=1,
                            extras={"frames": _t(fr)})
    _close(got, want, tol=E2E_TOL, msg="backbone_features")


def test_teacher_forced_decode_matches_reference_train(ref):
    """The port's prefill over 12 tokens, then teacher-forced decode to
    24: each step's logits against the reference's ``forward_train``
    logits at that position."""
    jmodel, params, model = ref
    toks, fr = _tokens(7, S=24), _frames(7)
    want, _ = jax.jit(jmodel.forward_train)(
        params, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(fr)})
    want = np.asarray(want)
    logits, cache = model.prefill(_t(toks[:, :12]), frames=_t(fr))
    _close(logits[:, 0], want[:, 11], tol=E2E_TOL, msg="prefill")
    cache = _splice_prefill(model.init_cache(2, 24), cache, 12)
    for pos in range(12, 24):
        logits, cache = model.decode_step(_t(toks[:, pos:pos + 1]), cache,
                                          pos)
        _close(logits[:, 0], want[:, pos], tol=E2E_TOL, msg=f"pos {pos}")


def test_batch_server_matches_reference(ref):
    """Greedy tokens of a ragged wave with 40 frames a request (of 64
    source positions: the cross cache lands at the front of zeros, which
    the unmasked cross-attention then reads, as in the reference)."""
    jmodel, params, model = ref
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 250, (n,)).astype(np.int32)
               for n in (10, 6, 9)]
    fr = _frames(11, B=3, T=40)
    want = jserve.BatchServer(jmodel, params, max_seq=32).serve_wave(
        [jserve.Request(jnp.asarray(q), max_new_tokens=n)
         for q, n in zip(prompts, (5, 3, 5))],
        extras={"frames": jnp.asarray(fr)})
    got = BatchServer(model, max_seq=32).serve_wave(
        [Request(_t(q), max_new_tokens=n)
         for q, n in zip(prompts, (5, 3, 5))], extras={"frames": _t(fr)})
    assert [c.tokens for c in got] == [c.tokens for c in want]
    assert [len(c.tokens) for c in got] == [5, 3, 5]


def test_bf16_layers_match_reference():
    """bf16 compute (whisper-tiny's own dtypes), layer by layer on the
    same inputs: each encoder layer (with the final norm), then each
    decoder layer's prefill over the same cross K/V — the layernorms'
    fp32 statistics, the positions cast to bf16, the flash route.  End
    to end the untrained stack carries one-step bf16 differences through
    its layers into every value (0.04–0.35·max measured), so only the
    dtypes are checked there."""
    cfg = dataclasses.replace(get_config(ARCH), compute_dtype=torch.bfloat16)
    jcfg = dataclasses.replace(jget_config(ARCH), compute_dtype=jnp.bfloat16)
    jmodel = build_model(jcfg, JParallelConfig(use_flash_attention=True))
    tree = _weights()
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    model = _port(tree, True, cfg)
    toks, fr = _tokens(12, S=16), _frames(12)
    f32 = lambda a: np.asarray(a.astype(jnp.float32))        # noqa: E731
    one, jone = (dataclasses.replace(cfg, encoder_layers=1, num_layers=1),
                 dataclasses.replace(jcfg, encoder_layers=1, num_layers=1))
    x = layers.embed_tokens(model.embed, cfg, _t(toks))
    jx = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    for i in range(cfg.encoder_layers):
        jtree = {**params["encoder"], "layers": jax.tree_util.tree_map(
            lambda a: a[i:i + 1], params["encoder"]["layers"])}
        want = jencdec.encode(jtree, jone, jnp.asarray(fr), None,
                              jmodel.parallel)
        got = encdec.encode({"pos": model.encoder["pos"],
                             "ln_f": model.encoder["ln_f"],
                             "layers": layer_slice(model.encoder["layers"],
                                                   slice(i, i + 1))},
                            one, _t(fr), model.parallel)
        assert got.dtype == torch.bfloat16
        _close(got, f32(want), tol=_BF16_TOL, msg=f"encoder layer {i}")
    enc = jencdec.encode(params["encoder"], jcfg, jnp.asarray(fr), None,
                         jmodel.parallel)
    jcross = jencdec.encoder_cross_kv(params["decoder"], jcfg, enc)
    for i in range(cfg.num_layers):
        jl = jax.tree_util.tree_map(lambda a: a[i:i + 1], params["decoder"])
        jkv = jax.tree_util.tree_map(lambda a: a[i:i + 1], jcross)
        want, wc = jencdec.decoder_prefill(jl, jone, jx, jkv, None,
                                           jmodel.parallel)
        got, gc = encdec.decoder_prefill(
            layer_slice(model.decoder, slice(i, i + 1)), one, x,
            {n: _t(f32(t)).to(torch.bfloat16) for n, t in jkv.items()},
            model.parallel)
        _close(got, f32(want), tol=_BF16_TOL, msg=f"decoder layer {i}")
        for n in ("k", "v"):
            assert gc[n].dtype == torch.bfloat16
            _close(gc[n], f32(wc[n]), tol=_BF16_TOL, msg=f"layer {i} {n}")
    logits, cache = model.prefill(_t(toks), frames=_t(fr))
    assert logits.dtype == torch.bfloat16
    assert all(v.dtype == torch.bfloat16
               for v in convert._flatten(cache).values())


def test_init_cache_and_state_dict_match_reference():
    cfg, jmodel = get_config(ARCH), build_model(jget_config(ARCH))
    model = Model(cfg, device="cpu")
    got = convert._flatten(model.init_cache(3, 24))
    want = convert._flatten(_np(jmodel.init_cache(3, 24)))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert got["cross.k"].shape[2] == cfg.max_source_positions
    assert all(v.dtype == cfg.compute_dtype and not v.any()
               for v in got.values())
    keys = set(model.state_dict())
    assert keys == set(convert._flatten(_weights()))
    assert {"decoder.self.wq", "decoder.cross.wk", "encoder.pos",
            "encoder.layers.attn.wq", "encoder.ln_f.bias", "embed.pos",
            "ln_f.bias"} <= keys
    assert model.decoder_stack is None


def test_encdec_refusals():
    model = Model(get_config(ARCH), device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="frames"):
        model.prefill(toks)
    with pytest.raises(ValueError, match="patch_embeds"):
        model.features(toks, frames=torch.zeros((1, 8, 64)),
                       patch_embeds=torch.zeros((1, 2, 64)))
