"""The port's MoE (``repro_torch.models.moe``) held against the JAX
package's ``repro.models.moe``, at arctic-480b-smoke (4 experts, top-2,
softmax router, a dense residual MLP) and deepseek-v3-671b-smoke (4
experts, top-2, sigmoid router, one shared expert).

  * ``moe_schema`` names and shapes;
  * ``router_scores`` (softmax and sigmoid): gates, picks and probs;
  * ``_capacity`` across its rounding to 8 and to 128;
  * the dispatch slots against the reference's ``_row_dispatch``;
  * ``moe_apply`` at ``expert_capacity_factor=1.0``, where picks DO drop
    (the test asserts some do): the same dropped (row, token, expert)
    set as the reference, the output and the aux loss; and at the smoke
    factor (8.0, nothing dropped) in bf16 compute.

The same numpy-seeded weights and inputs go to both packages.
Tolerances: fp32 compute rtol 1e-5 with atol 1e-5·max|x| — fp32 sums in
another order (the router logits, the expert products); bf16 compute
3e-2·max|x| — every product is rounded to bf16 in both packages, at
points of their own, and the gated sum adds one more rounding.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import smoke_variant as jsmoke  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.config import smoke_variant  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.params import map_schema  # noqa: E402

_ARCHS = ["arctic-480b", "deepseek-v3-671b"]


def _close(got, want, tol=1e-5, msg=""):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30), err_msg=msg)


def _cfgs(arch, **over):
    return (smoke_variant(get_config(arch), **over),
            jsmoke(jget_config(arch), **over))


def _params(cfg, seed):
    """numpy weights of ``moe_schema(cfg)``, std 1/sqrt(fan-in)."""
    rng = np.random.default_rng(seed)

    def draw(_, d):
        return (rng.standard_normal(d.shape) / np.sqrt(d.shape[-2])
                ).astype(np.float32)
    return map_schema(draw, moe.moe_schema(cfg))


def _tree(params, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in params.items()}


@pytest.mark.parametrize("arch", _ARCHS)
def test_moe_schema_matches_reference(arch):
    cfg, jcfg = _cfgs(arch)
    got = {}
    map_schema(lambda p, d: got.__setitem__(p, tuple(d.shape)),
               moe.moe_schema(cfg))
    want = {}
    for path, d in jax.tree_util.tree_flatten_with_path(
            jmoe.moe_schema(jcfg), is_leaf=lambda x: hasattr(x, "axes"))[0]:
        want[".".join(k.key for k in path)] = tuple(d.shape)
    assert got == want
    assert ("shared.wo" in got) == (arch == "deepseek-v3-671b")
    assert ("dense.wo" in got) == (arch == "arctic-480b")


@pytest.mark.parametrize("arch", _ARCHS)
def test_router_scores_match_reference(arch):
    """softmax (arctic) and sigmoid (deepseek-v3, no bias term)."""
    cfg, jcfg = _cfgs(arch, num_experts=16, experts_per_token=4)
    assert cfg.router_score == jcfg.router_score == \
        ("sigmoid" if arch.startswith("deepseek") else "softmax")
    p = _params(cfg, 0)
    x = np.random.default_rng(1).standard_normal((40, 64)).astype(np.float32)
    g, i, pr = moe.router_scores(_tree(p, torch.from_numpy), cfg,
                                 torch.from_numpy(x))
    jg, ji, jpr = jmoe.router_scores(_tree(p, jnp.asarray), jcfg,
                                     jnp.asarray(x))
    assert np.array_equal(i.numpy(), np.asarray(ji))
    _close(g, jg, msg="gates")
    _close(pr, jpr, msg="probs")
    _close(g.sum(-1), np.ones(40, np.float32), msg="renormalised")


@pytest.mark.parametrize("tokens,k,cf,E", [
    (1, 2, 1.25, 128),      # decode: 1 -> 8
    (13, 2, 1.0, 4),        # 7 -> 8
    (16, 2, 1.0, 4),        # 9 -> 16
    (128, 8, 1.25, 256),    # deepseek prefill: 6 -> 8
    (4096, 2, 1.25, 128),   # 81 -> 88
    (8192, 2, 1.25, 128),   # 161 -> 256
    (6000, 4, 1.0, 4),      # 6001 -> 6016
])
def test_capacity_matches_reference(tokens, k, cf, E):
    cfg, jcfg = _cfgs("arctic-480b", num_experts=E, experts_per_token=k,
                      expert_capacity_factor=cf)
    c = moe._capacity(cfg, tokens)
    assert c == jmoe._capacity(jcfg, tokens)
    assert c % (128 if c >= 128 else 8) == 0
    assert c >= int(tokens * k * cf / E) + 1


def test_dispatch_slots_match_reference():
    """Each pick's slot, as the reference's sorted dispatch assigns it."""
    rng = np.random.default_rng(2)
    B, S, k, E = 3, 24, 2, 4
    idx = np.stack([np.stack([rng.choice(E, k, replace=False)
                              for _ in range(S)]) for _ in range(B)])
    slot = moe.dispatch_slots(torch.from_numpy(idx), E).numpy()
    for b in range(B):
        _, se, st, _, jslot = jmoe._row_dispatch(
            jnp.zeros((S, 8)), jnp.ones((S, k)), jnp.asarray(idx[b]), E, 64,
            jnp.float32)
        for e, t, s in zip(np.asarray(se), np.asarray(st), np.asarray(jslot)):
            j = int(np.flatnonzero(idx[b, t] == e)[0])
            assert slot[b, t, j] == s


def _dropped_reference(params, jcfg, x):
    """{(row, token, expert)} the reference's dispatch drops."""
    B, S, d = x.shape
    flat = jnp.asarray(x.reshape(B * S, d))
    _, idx, _ = jmoe.router_scores(params, jcfg, flat)
    idx = idx.reshape(B, S, -1)
    C = jmoe._capacity(jcfg, S)
    out = set()
    for b in range(B):
        _, se, st, _, slot = jmoe._row_dispatch(
            jnp.asarray(x[b]), jnp.ones(idx.shape[1:]), idx[b],
            jcfg.num_experts, C, jnp.float32)
        out |= {(b, int(t), int(e)) for e, t, s in
                zip(np.asarray(se), np.asarray(st), np.asarray(slot))
                if s >= C}
    return out


@pytest.mark.parametrize("arch", _ARCHS)
def test_moe_apply_drops_as_reference(arch):
    """At capacity factor 1.0 picks drop: the same ones as in the
    reference, and the same output and aux loss."""
    cfg, jcfg = _cfgs(arch, expert_capacity_factor=1.0)
    p = _params(cfg, 3)
    x = np.random.default_rng(4).standard_normal((4, 14, 64)).astype(
        np.float32)
    stats = {}
    out, aux = moe.moe_apply(_tree(p, torch.from_numpy), cfg,
                             torch.from_numpy(x), stats)
    jp = _tree(p, jnp.asarray)
    jout, jaux = jmoe.moe_apply(jp, jcfg, jnp.asarray(x))
    kept, idx = stats["kept"].numpy(), stats["idx"].numpy()
    dropped = {(b, t, int(idx[b, t, j])) for b, t, j in
               zip(*np.nonzero(~kept))}
    assert dropped, "capacity 1.0 must drop picks at this size"
    assert dropped == _dropped_reference(jp, jcfg, x)
    _close(out, jout, msg="out")
    _close(aux, jaux, msg="aux")
    assert out.dtype == torch.float32 and aux.dtype == torch.float32


@pytest.mark.parametrize("arch", _ARCHS)
def test_moe_apply_bf16_matches_reference(arch):
    cfg, jcfg = _cfgs(arch, compute_dtype=torch.bfloat16)
    jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.bfloat16)
    p = _params(cfg, 5)
    x = np.random.default_rng(6).standard_normal((2, 12, 64)).astype(
        np.float32)
    out, aux = moe.moe_apply(_tree(p, torch.from_numpy), cfg,
                             torch.from_numpy(x).to(torch.bfloat16))
    jout, jaux = jmoe.moe_apply(_tree(p, jnp.asarray), jcfg,
                                jnp.asarray(x, jnp.bfloat16))
    assert out.dtype == torch.bfloat16
    got = np.asarray(out.float(), np.float64)
    want = np.asarray(jnp.asarray(jout, jnp.float32), np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=3e-2 * float(np.abs(want).max()))
    _close(aux, jaux, msg="aux")
