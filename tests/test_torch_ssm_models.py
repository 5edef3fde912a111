"""The port's recurrent backbones (repro_torch.models.{rwkv,ssm} and the
ssm / hybrid branches of the decoder stack) held against the JAX
package's ``repro.models``, at rwkv6-3b-smoke (2 layers, d 64, one
64-wide head, d_ff 128, chunk 16) and zamba2-1.2b-smoke (2 mamba layers
each followed by the shared attention block, d 64, inner 128 = 2 heads
× 64, state 8, chunk 32), S = 64 (several chunks on both).

  * configs field for field against the reference's (full and
    ``-smoke``), with untied embeddings in the schema;
  * the rwkv time-mix and channel-mix, the mamba block, and whole
    ``Model.features`` of both archs on the reference's ``Model.init``
    weights through ``convert.model_params``.  The zero- and
    one-initialised leaves (``mu_*``, ``u``, ``w0``, ``ln_bias``,
    ``A_log``, ``dt_bias``, ``D``, ``conv_b``) are replaced by random
    values on both sides, so token shift, the bonus term, the decay path
    (``w0`` reaches the MAX_LOG_DECAY clamp) and the skip go tested;
  * ``features`` also in bf16 compute;
  * ``convert.model_params`` on both schemas, and its refusal of a wrong
    shape; the port's own init for both schemas.

Tolerances: fp32 compute rtol 1e-5 with atol 1e-5·max|x| (fp32 sums in
another order).  bf16 compute: 3e-2·max|feature|, the slice-2 rule —
every product's output is rounded to bf16 in both packages, at
different points, and such one-step differences carry through the
layers into the pooled features.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import ParallelConfig as JParallelConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.config import ParallelConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import rwkv, ssm  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

_RWKV, _ZAMBA = "rwkv6-3b-smoke", "zamba2-1.2b-smoke"
_S = 64

# leaf name -> numpy draw replacing the reference's zeros / ones init
_RANDOM_LEAVES = {
    "mu_r": lambda r, s: r.uniform(0, 1, s),
    "mu_k": lambda r, s: r.uniform(0, 1, s),
    "mu_v": lambda r, s: r.uniform(0, 1, s),
    "mu_g": lambda r, s: r.uniform(0, 1, s),
    "mu_w": lambda r, s: r.uniform(0, 1, s),
    "u": lambda r, s: r.standard_normal(s),
    "w0": lambda r, s: r.uniform(-2.5, 2.0, s),   # rates past the clamp
    "ln_bias": lambda r, s: 0.1 * r.standard_normal(s),
    "A_log": lambda r, s: 0.5 * r.standard_normal(s),
    "dt_bias": lambda r, s: 0.5 * r.standard_normal(s),
    "D": lambda r, s: 1.0 + 0.3 * r.standard_normal(s),
    "conv_b": lambda r, s: 0.1 * r.standard_normal(s),
}


def _by_name(cfg):
    """asdict with every dtype replaced by its name."""
    def norm(v):
        if isinstance(v, torch.dtype):
            return str(v).replace("torch.", "")
        if v is jnp.float32 or v is jnp.bfloat16:
            return jnp.dtype(v).name
        return v
    return {k: norm(v) for k, v in dataclasses.asdict(cfg).items()}


def _close(got, want, tol=1e-5, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30), err_msg=msg)


def _randomize(tree, seed):
    """The reference's tree with the zero/one leaves drawn at random."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in _RANDOM_LEAVES:
                out[k] = _RANDOM_LEAVES[k](rng, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return walk(tree)


@pytest.fixture(scope="module", params=[_RWKV, _ZAMBA])
def weights(request):
    """(arch, reference model, its params with random leaves, the numpy
    tree, tokens)."""
    arch = request.param
    model = build_model(jget_config(arch),
                        JParallelConfig(use_flash_attention=True))
    tree = _randomize(jax.tree_util.tree_map(np.asarray,
                                             model.init(jax.random.PRNGKey(0))),
                      seed=5)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    tokens = np.random.default_rng(3).integers(0, 256, (3, _S)).astype(np.int32)
    return arch, model, params, tree, tokens


def _port_model(cfg, tree):
    m = Model(cfg, ParallelConfig(use_flash_attention=True), device="cpu")
    m.load_state_dict(convert.model_params(cfg, tree, device="cpu"))
    return m


def _layer0(tree, *path):
    node = tree
    for p in path:
        node = node[p]
    return jax.tree_util.tree_map(lambda a: np.array(a[0]), node)


def _tt(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


@pytest.mark.parametrize("arch", ["rwkv6-3b", _RWKV, "zamba2-1.2b", _ZAMBA])
def test_config_matches_reference(arch):
    t, j = get_config(arch), jget_config(arch)
    assert _by_name(t) == _by_name(j)
    assert t.param_count() == j.param_count()
    assert Model.schema_of(t)["embed"].keys() == {"embedding", "unembed"}


def test_block_parts_match_reference(weights):
    arch, _, _, tree, _ = weights
    cfg_t, cfg_j = get_config(arch), jget_config(arch)
    x = np.random.default_rng(4).standard_normal((2, _S, 64)).astype(np.float32)
    if arch == _RWKV:
        tm = _layer0(tree, "stack", "layers", "tm")
        cm = _layer0(tree, "stack", "layers", "cm")
        got = rwkv.time_mix_train(_tt(tm), cfg_t, torch.from_numpy(x),
                                  chunk=cfg_t.ssm_chunk)
        want = jrwkv.time_mix_train(tm, cfg_j, jnp.asarray(x),
                                    chunk=cfg_j.ssm_chunk)
        _close(got.numpy(), np.asarray(want), msg="time-mix")
        got = rwkv.channel_mix_train(_tt(cm), cfg_t, torch.from_numpy(x))
        want = jrwkv.channel_mix_train(cm, cfg_j, jnp.asarray(x))
        _close(got.numpy(), np.asarray(want), msg="channel-mix")
        # the decay reaches the clamp for some channels
        w = rwkv._decay(_tt(tm), torch.from_numpy(x))
        assert float(w.min()) == pytest.approx(np.exp(-3.49), rel=1e-6)
    else:
        mb = _layer0(tree, "stack", "mamba_layers", "mamba")
        got = ssm.mamba_train(_tt(mb), cfg_t, torch.from_numpy(x))
        want = jssm.mamba_train(mb, cfg_j, jnp.asarray(x))
        _close(got.numpy(), np.asarray(want), msg="mamba block")


def test_features_match_reference(weights):
    arch, jmodel, params, tree, tokens = weights
    want = jmodel.features(params, {"tokens": jnp.asarray(tokens)})
    got = _port_model(get_config(arch), tree).features(
        torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 64)
    _close(got.numpy(), np.asarray(want))


def test_features_bf16_compute_match_reference(weights):
    arch, _, params, tree, tokens = weights
    cfg_j = dataclasses.replace(jget_config(arch), compute_dtype=jnp.bfloat16)
    cfg_t = dataclasses.replace(get_config(arch), compute_dtype=torch.bfloat16)
    jmodel = build_model(cfg_j, JParallelConfig(use_flash_attention=True))
    want = jmodel.features(params, {"tokens": jnp.asarray(tokens)})
    got = _port_model(cfg_t, tree).features(torch.from_numpy(tokens))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=3e-2 * float(np.abs(want).max()))


def test_model_params_schema_and_refusal(weights):
    arch, _, _, tree, _ = weights
    cfg = get_config(arch)
    sd = convert.model_params(cfg, tree, device="cpu")
    own = Model(cfg, ParallelConfig(use_flash_attention=True), device="cpu",
                seed=1).state_dict()
    assert sorted(sd) == sorted(own)
    assert all(sd[k].shape == own[k].shape for k in sd)
    leaf = ("stack.layers.tm.u" if arch == _RWKV
            else "stack.mamba_layers.mamba.A_log")
    head, name = leaf.rsplit(".", 1)
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    node = bad
    for p in head.split("."):
        node = node[p]
    node[name] = np.zeros(node[name].shape[:-1] + (node[name].shape[-1] + 1,),
                          np.float32)
    with pytest.raises(ValueError, match=leaf.replace(".", r"\.")):
        convert.model_params(cfg, bad, device="cpu")


def test_init_follows_reference_rule():
    cfg = get_config(_RWKV)
    sd = Model(cfg, device="cpu", seed=7).state_dict()
    # stacked "scaled" leaves: std scale/sqrt(num_layers) (fan-in after
    # stacking, as the reference); zeros / ones leaves as declared
    assert torch.equal(sd["stack.layers.tm.u"], torch.zeros(2, 64))
    assert torch.equal(sd["stack.layers.tm.w0"], torch.ones(2, 64))
    assert abs(float(sd["stack.layers.tm.wr"].std()) - 2 ** -0.5) < 0.05
    assert abs(float(sd["stack.layers.tm.w_b"].std()) - 0.1 * 2 ** -0.5) < 0.01
    zc = get_config(_ZAMBA)
    zd = Model(zc, ParallelConfig(use_flash_attention=True), device="cpu",
               seed=7).state_dict()
    assert torch.equal(zd["stack.mamba_layers.mamba.D"], torch.ones(2, 2))
    assert zd["stack.mamba_layers.mamba.in_proj"].shape == (2, 64, 2 * 128 + 16 + 2)
    assert zd["stack.shared_attn.attn.wq"].shape == (64, 4, 16)


def test_hybrid_groups_and_flash_flag():
    from repro_torch.models.transformer import DecoderStack
    full = DecoderStack(get_config("zamba2-1.2b"), ParallelConfig())
    assert full._groups() == [6, 6, 6, 6, 6, 6, 2]
    assert DecoderStack(get_config(_ZAMBA), ParallelConfig())._groups() == [1, 1]
    # zamba2's shared block is attention: off the CPU it needs the flash
    # flag (checked before anything is allocated; rwkv6 needs none, which
    # tests/test_torch_cuda.py checks on the card)
    with pytest.raises(NotImplementedError, match="use_flash_attention"):
        Model(get_config(_ZAMBA), device="meta")
