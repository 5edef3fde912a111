"""The port's LM backbone (repro_torch.models) held against the JAX
package's ``repro.models``, at granite-3-2b-smoke (2 layers, d 64,
4 heads, 2 KV heads, head_dim 16, vocab 256) and S = 32.

  * ``ModelConfig`` / ``ParallelConfig`` field for field against the
    reference's (dtypes compared by name), ``param_count``, and the
    registry's ``-smoke`` suffix and refusals;
  * ``rmsnorm``, ``apply_rope`` (NeoX and interleaved, full and partial
    rotation), ``mlp_apply`` (SwiGLU and GELU), ``gqa_train`` and
    ``Model.features`` on the reference's weights (through
    ``convert.model_params``), with ``use_flash_attention=True`` on both
    sides; ``features`` also in bf16 compute; ``gqa_train`` refuses
    partial RoPE, and dense attention refuses tensors off the CPU;
  * the port's own init: schema order and shapes, and the reference's
    std rule including its fan-in quirk (stacked "scaled" weights have
    std 1/sqrt(num_layers)).

Tolerances: fp32 compute rtol 1e-5 with atol 1e-5·max|x| (fp32 sums in
another order); the bf16-compute features 3e-2·max|feature| — every
product's output is rounded to bf16 (2^-8 relative steps) in both
packages, but at different points (the two frameworks' bf16 matmuls
round their fp32 sums independently), and such one-step differences
carry through the two layers into the pooled features.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import ModelConfig as JModelConfig  # noqa: E402
from repro.config import ParallelConfig as JParallelConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.config import ModelConfig, ParallelConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention, layers  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.params import init_std  # noqa: E402

_ARCH = "granite-3-2b-smoke"
_S = 32


def _close(got, want, tol=1e-5, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30), err_msg=msg)


def _by_name(d):
    """asdict with every dtype replaced by its name."""
    def norm(v):
        if isinstance(v, torch.dtype):
            return str(v).replace("torch.", "")
        try:
            return jnp.dtype(v).name if v in (jnp.float32, jnp.bfloat16) \
                else v
        except TypeError:
            return v
    return {k: norm(v) for k, v in dataclasses.asdict(d).items()}


@pytest.mark.parametrize("arch", ["granite-3-2b", _ARCH])
def test_model_config_matches_reference(arch):
    t, j = get_config(arch), jget_config(arch)
    assert [f.name for f in dataclasses.fields(ModelConfig)] == \
        [f.name for f in dataclasses.fields(JModelConfig)]
    assert _by_name(t) == _by_name(j)
    assert t.padded_vocab == j.padded_vocab and t.q_dim == j.q_dim
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()


@pytest.mark.parametrize("over", [{}, dict(use_flash_attention=True,
                                           attention_impl="chunked",
                                           microbatch=4)])
def test_parallel_config_matches_reference(over):
    assert [f.name for f in dataclasses.fields(ParallelConfig)] == \
        [f.name for f in dataclasses.fields(JParallelConfig)]
    assert _by_name(ParallelConfig(**over)) == _by_name(JParallelConfig(**over))


def test_registry_refusals():
    assert get_config("granite-3-2b").num_layers == 40
    assert get_config("arctic-480b-smoke").num_experts == 4
    assert get_config("pixtral-12b-smoke").family == "vlm"
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    sc = rng.standard_normal(64).astype(np.float32)
    got = layers.rmsnorm({"scale": torch.from_numpy(sc)}, torch.from_numpy(x))
    want = jlayers.rmsnorm({"scale": jnp.asarray(sc)}, jnp.asarray(x))
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("interleaved,fraction", [(False, 1.0), (True, 1.0),
                                                  (False, 0.5), (True, 0.5)])
def test_rope_matches_reference(interleaved, fraction):
    cfg_t = dataclasses.replace(get_config(_ARCH), rope_fraction=fraction)
    cfg_j = dataclasses.replace(jget_config(_ARCH), rope_fraction=fraction)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9) + 3, (2, 9))
    st, ct = layers.rope_frequencies(cfg_t, torch.from_numpy(pos.copy()))
    sj, cj = jlayers.rope_frequencies(cfg_j, jnp.asarray(pos))
    _close(st.numpy(), np.asarray(sj))
    got = layers.apply_rope(torch.from_numpy(x), st, ct, interleaved)
    want = jlayers.apply_rope(jnp.asarray(x), sj, cj, interleaved)
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mlp", ["swiglu", "gelu"])
def test_mlp_matches_reference(mlp):
    cfg_t = dataclasses.replace(get_config(_ARCH), mlp=mlp)
    cfg_j = dataclasses.replace(jget_config(_ARCH), mlp=mlp)
    rng = np.random.default_rng(2)
    names = ["wi_gate", "wi_up", "wo"] if mlp == "swiglu" else ["wi", "wo"]
    p = {n: (rng.standard_normal((128, 64) if n == "wo" else (64, 128))
             .astype(np.float32) * 0.1) for n in names}
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    got = layers.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                           cfg_t, torch.from_numpy(x))
    want = jlayers.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                             cfg_j, jnp.asarray(x))
    _close(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def weights():
    """The reference's smoke model, its weights, and tokens."""
    cfg_j = jget_config(_ARCH)
    model = build_model(cfg_j, JParallelConfig(use_flash_attention=True))
    params = model.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg_j.vocab_size, (4, _S)).astype(np.int32)
    return model, params, tree, tokens


def test_gqa_train_matches_reference(weights):
    _, params, tree, _ = weights
    cfg_t, cfg_j = get_config(_ARCH), jget_config(_ARCH)
    lp_np = {k: np.array(v[0])
             for k, v in tree["stack"]["layers"]["attn"].items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, _S, 64)).astype(np.float32)
    for causal in (True, False):
        got = attention.gqa_train(
            {k: torch.from_numpy(v) for k, v in lp_np.items()}, cfg_t,
            torch.from_numpy(x), ParallelConfig(use_flash_attention=True),
            causal=causal)
        want = jattn.gqa_train(
            {k: jnp.asarray(v) for k, v in lp_np.items()}, cfg_j,
            jnp.asarray(x), parallel=JParallelConfig(use_flash_attention=True),
            causal=causal)
        _close(got.numpy(), np.asarray(want), msg=f"causal={causal}")
        # the dense path computes the same function in fp32
        dense = attention.gqa_train(
            {k: torch.from_numpy(v) for k, v in lp_np.items()}, cfg_t,
            torch.from_numpy(x), ParallelConfig(), causal=causal)
        _close(dense.numpy(), np.asarray(want), msg=f"dense causal={causal}")


def test_gqa_refuses_partial_rope_and_dense_off_cpu(weights):
    """Partial RoPE, once refused, now runs as the reference's (NeoX
    halves over the rotated half here: the name is not chatglm's); dense
    attention still refuses tensors off the CPU."""
    _, _, tree, _ = weights
    lp = {k: np.array(v[0])
          for k, v in tree["stack"]["layers"]["attn"].items()}
    x = np.random.default_rng(5).standard_normal((1, 8, 64)).astype(
        np.float32)
    partial = dataclasses.replace(get_config(_ARCH), rope_fraction=0.5)
    got = attention.gqa_train({k: torch.from_numpy(v) for k, v in lp.items()},
                              partial, torch.from_numpy(x),
                              ParallelConfig(use_flash_attention=True))
    want = jattn.gqa_train({k: jnp.asarray(v) for k, v in lp.items()},
                           dataclasses.replace(jget_config(_ARCH),
                                               rope_fraction=0.5),
                           jnp.asarray(x), parallel=JParallelConfig(
                               use_flash_attention=True))
    _close(got.numpy(), np.asarray(want), msg="partial RoPE")
    # off the CPU the dense path refuses: only the kernel runs there
    q = torch.empty((1, 8, 4, 16), device="meta")
    kv = torch.empty((1, 8, 2, 16), device="meta")
    with pytest.raises(NotImplementedError, match="use_flash_attention"):
        attention._maybe_flash(get_config(_ARCH), ParallelConfig(), q, kv, kv,
                               causal=True)


def _port_model(cfg, tree, flash=True):
    m = Model(cfg, ParallelConfig(use_flash_attention=flash), device="cpu")
    m.load_state_dict(convert.model_params(cfg, tree, device="cpu"))
    return m


def test_features_match_reference(weights):
    jmodel, params, tree, tokens = weights
    want = jmodel.features(params, {"tokens": jnp.asarray(tokens)})
    got = _port_model(get_config(_ARCH), tree).features(
        torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, 64)
    _close(got.numpy(), np.asarray(want))


def test_features_bf16_compute_match_reference(weights):
    _, params, tree, tokens = weights
    cfg_j = dataclasses.replace(jget_config(_ARCH),
                                compute_dtype=jnp.bfloat16)
    cfg_t = dataclasses.replace(get_config(_ARCH),
                                compute_dtype=torch.bfloat16)
    jmodel = build_model(cfg_j, JParallelConfig(use_flash_attention=True))
    want = jmodel.features(params, {"tokens": jnp.asarray(tokens)})
    got = _port_model(cfg_t, tree).features(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=3e-2 * float(np.abs(want).max()))


def test_model_params_refuses_other_schemas(weights):
    _, _, tree, _ = weights
    bad = dict(tree, ln_f={"scale": np.ones(65, np.float32)})
    with pytest.raises(ValueError, match="ln_f.scale"):
        convert.model_params(get_config(_ARCH), bad, device="cpu")
    with pytest.raises(ValueError, match="missing"):
        convert.model_params(get_config(_ARCH), {"embed": tree["embed"]},
                             device="cpu")


def test_init_follows_reference_rule(weights):
    _, _, tree, _ = weights
    cfg = dataclasses.replace(get_config(_ARCH), num_layers=6, d_model=256,
                              d_ff=512)
    m = Model(cfg, device="cpu", seed=7)
    sd = m.state_dict()
    ref_names = list(convert.model_params(get_config(_ARCH), tree,
                                          device="cpu"))
    assert sorted(_port_model(get_config(_ARCH), tree).state_dict()) == \
        sorted(ref_names)
    # the fan-in quirk: stacked "scaled" weights have std 1/sqrt(L)
    for name in ("stack.layers.attn.wq", "stack.layers.attn.wo",
                 "stack.layers.mlp.wi_gate", "stack.layers.mlp.wo"):
        assert sd[name].shape[0] == 6
        assert abs(float(sd[name].std()) - 6 ** -0.5) < 0.01 * 6 ** -0.5 * 5
    assert abs(float(sd["embed.embedding"].std()) - 0.02) < 0.02 * 0.02
    assert torch.equal(sd["ln_f.scale"], torch.ones(256))
    assert torch.equal(sd["stack.layers.ln1.scale"], torch.ones(6, 256))
    # the reference's init draws under the same rule
    wq = tree["stack"]["layers"]["attn"]["wq"]
    assert abs(float(wq.std()) - 2 ** -0.5) < 0.05 * 2 ** -0.5
    # one generator, one seed: the same weights again; another seed not
    again = Model(cfg, device="cpu", seed=7).state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    other = Model(cfg, device="cpu", seed=8).state_dict()
    assert not torch.equal(sd["stack.layers.attn.wq"],
                           other["stack.layers.attn.wq"])
    from repro_torch.models.params import ParamDef
    assert init_std(ParamDef((40, 2048, 32, 64), init="scaled")) == 40 ** -0.5
