"""The port's AdamW (repro_torch.optim.adamw) and TrainConfig held
against the JAX package's on the same gradients.

  * ``adamw_update`` over several steps of the same numpy gradients —
    some clipped, some not — from the same parameters: parameters and
    both moments within rtol 1e-6 plus atol 1e-7 (fp32 arithmetic in
    the same order; the bias corrections' powers are rounded once from
    fp64 in the port);
  * ``global_norm`` / ``clip_by_global_norm`` against the reference;
  * the traps: ``b2`` is 0.95, the weight decay enters ``delta`` on the
    pre-step parameter, in the reference's rounding order;
  * a batch of models: one norm per model over its own leaves — a model
    with a huge gradient does not scale its neighbours — and each model
    of the batch bitwise the same model stepped alone; one learning rate
    per model.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.config import TrainConfig  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

_TOL = dict(rtol=1e-6, atol=1e-7)


def _params(rng, lead=()):
    return {"w0": rng.standard_normal(lead + (5, 3)).astype(np.float32),
            "b0": rng.standard_normal(lead + (3,)).astype(np.float32),
            "w1": rng.standard_normal(lead + (3, 1)).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def test_train_config_mirrors_reference():
    assert [f.name for f in dataclasses.fields(TrainConfig)] == \
        [f.name for f in dataclasses.fields(JTrainConfig)]
    assert dataclasses.asdict(TrainConfig()) == \
        dataclasses.asdict(JTrainConfig())
    assert TrainConfig().b2 == 0.95


@pytest.mark.parametrize("wd,lr", [(0.1, 1e-2), (0.0, 3e-3), (1e-4, 1e-3)])
def test_steps_match_reference(wd, lr):
    rng = np.random.default_rng(0)
    p = _params(rng)
    jp, tp = _j(p), _t(p)
    jcfg = JTrainConfig(weight_decay=wd, grad_clip=1.0)
    tcfg = TrainConfig(weight_decay=wd, grad_clip=1.0)
    js, ts = jadamw.adamw_init(jp), adamw.adamw_init(tp)
    for i in range(6):
        # alternate gradients under and over the clip norm
        g = {k: (rng.standard_normal(v.shape) * (4.0 if i % 2 else 0.05)
                 ).astype(np.float32) for k, v in p.items()}
        jp, js, jm = jadamw.adamw_update(_j(g), js, jp, jnp.float32(lr), jcfg)
        tp, ts, tm = adamw.adamw_update(_t(g), ts, tp, lr, tcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert int(ts["step"]) == int(js.step) == 6
    for k in p:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   err_msg=k, **_TOL)
        np.testing.assert_allclose(ts["m"][k].numpy(), np.asarray(js.m[k]),
                                   err_msg=k, **_TOL)
        np.testing.assert_allclose(ts["v"][k].numpy(), np.asarray(js.v[k]),
                                   err_msg=k, **_TOL)


def test_norm_and_clip_match_reference():
    rng = np.random.default_rng(1)
    g = _params(rng)
    np.testing.assert_allclose(float(adamw.global_norm(_t(g))),
                               float(jadamw.global_norm(_j(g))), rtol=1e-6)
    for max_norm in (0.5, 100.0):
        tc, tn = adamw.clip_by_global_norm(_t(g), max_norm)
        jc, jn = jadamw.clip_by_global_norm(_j(g), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for k in g:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       err_msg=k, **_TOL)


def test_decoupled_decay_is_in_delta():
    """The first step, in fp32, is exactly ``p - lr·(m̂/(√v̂ + 1e-8) +
    wd·p)`` with m̂ = g and v̂ = g² (the reference's rounding order), not
    torch.optim.AdamW's ``p·(1 - lr·wd)`` then the Adam step."""
    p = {"w": torch.tensor([1.0, -2.0, 0.5])}
    cfg = TrainConfig(weight_decay=0.1)
    for g in (torch.zeros(3), torch.tensor([0.3, -0.1, 0.2])):
        new = adamw.adamw_update({"w": g}, adamw.adamw_init(p), p, 0.01,
                                 cfg)[0]["w"]
        m = (1 - 0.9) * g / torch.tensor(1 - 0.9)
        v = (1 - 0.95) * g * g / torch.tensor(1 - 0.95)
        want = p["w"] - 0.01 * (m / (torch.sqrt(v) + 1e-8) + 0.1 * p["w"])
        assert torch.equal(new, want)


def test_batch_has_one_norm_per_model_and_matches_each_alone():
    rng = np.random.default_rng(2)
    p = _params(rng, (3,))
    g = _params(rng, (3,))
    g["w0"][1] *= 1e4                       # model 1's gradient is huge
    tp, tg = _t(p), _t(g)
    norms = adamw.global_norm(tg, batch_dims=1)
    assert tuple(norms.shape) == (3,)
    lrs = torch.tensor([1e-3, 1e-2, 3e-3])
    cfg = TrainConfig()
    st = adamw.adamw_init(tp, batch_dims=1)
    assert tuple(st["step"].shape) == (3,)
    bp, bs = tp, st
    for _ in range(3):
        bp, bs, _ = adamw.adamw_update(tg, bs, bp, lrs, cfg, batch_dims=1)
    for b in range(3):
        one = {k: v[b] for k, v in tp.items()}
        gb = {k: v[b] for k, v in tg.items()}
        np.testing.assert_allclose(float(adamw.global_norm(gb)),
                                   float(norms[b]), rtol=1e-6)
        s1 = adamw.adamw_init(one)
        for _ in range(3):
            one, s1, _ = adamw.adamw_update(gb, s1, one, lrs[b], cfg)
        for k in one:
            assert torch.equal(bp[k][b], one[k]), (b, k)
    # each model is clipped by its own norm: the huge gradient of model 1
    # does not scale models 0 and 2
    c, _ = adamw.clip_by_global_norm(tg, 1.0, batch_dims=1)
    for b in (0, 2):
        alone, _ = adamw.clip_by_global_norm({k: v[b] for k, v in tg.items()},
                                             1.0)
        for k in alone:
            assert torch.equal(c[k][b], alone[k]), (b, k)


def test_bf16_moments():
    p = {"w": torch.ones(4)}
    st = adamw.adamw_init(p, moment_dtype=torch.bfloat16)
    assert st["m"]["w"].dtype == torch.bfloat16
    new, st, _ = adamw.adamw_update({"w": torch.full((4,), 0.5)}, st, p,
                                    1e-2, TrainConfig(),
                                    moment_dtype=torch.bfloat16)
    assert new["w"].dtype == torch.float32
    assert st["v"]["w"].dtype == torch.bfloat16
