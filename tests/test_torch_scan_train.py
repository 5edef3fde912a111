"""The scans under autograd (``ssm_scan.ops``'s ``_GLAScan`` / ``_SSDScan``
and their plain backward ``gla_bwd_chunks`` / ``ssd_bwd_chunks``) held
on the CPU against ``jax.vjp`` of the reference's chunked scans
(``repro.kernels.ssm_scan.ref.gla_chunked_ref`` in post and bonus modes,
``ssd_chunked_ref``), which ``jax.grad`` differentiates when the
reference trains rwkv6 and zamba2:

  * with a cotangent on the final state and without one (training drops
    the state: ``ds_final`` None);
  * fp32 inputs, and GLA's bf16 q, k, v beside fp32 w and u;
  * a T that is not a multiple of the chunk asked for (``ops`` halves
    it, as the reference's ``ops`` does);
  * ``torch.autograd.gradcheck`` of both Functions in fp64 at tiny
    sizes, and the Functions against autograd through the port's own
    plain chunked scans.

Inputs are drawn by numpy from a seed and handed to both.  Tolerances,
per gradient, relative to its max|g|: 1e-4 against the reference (fp32
sums in another order: the backward walks the chunk recurrence where
JAX transposes its ``lax.scan``); 1e-5 against autograd of the port's
plain scan (the same sums, the recurrence walked in another order).
bf16: the fp32 gradients before the cast are held at 1e-4 against
``jax.vjp`` at the same values in fp32; the bf16 gradients of the
Function against the reference's bf16 ones at one bf16 step (2^-7 of
the element, where two fp32 values a hair apart round to neighbours)
plus 1e-4·max.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssm_scan import ops as jops  # noqa: E402
from repro_torch.kernels.ssm_scan import ops, ref  # noqa: E402

REF_TOL, PLAIN_TOL, BF16_STEP = 1e-4, 1e-5, 2.0 ** -7


def _rel(got, want):
    got = np.asarray(got.detach().float().numpy() if torch.is_tensor(got)
                     else np.asarray(got, np.float32), np.float64)
    want = np.asarray(want.detach().float().numpy() if torch.is_tensor(want)
                      else np.asarray(want, np.float32), np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


def _gla_inputs(B, H, T, D, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, T, D)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(np.exp(-3.49), 1.0, (B, H, T, D)).astype(np.float32)
    u = rng.standard_normal((H, D)).astype(np.float32)
    do = rng.standard_normal((B, H, T, D)).astype(np.float32)
    ds = rng.standard_normal((B, H, D, D)).astype(np.float32)
    return (q, k, v, w, u), do, ds


def _ssd_inputs(B, H, T, N, P, seed):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((B, T, N)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, H, T, P)).astype(np.float32)
    a = rng.uniform(1e-3, 1.0, (B, H, T)).astype(np.float32)
    do = rng.standard_normal((B, H, T, P)).astype(np.float32)
    ds = rng.standard_normal((B, H, N, P)).astype(np.float32)
    return (q, k, v, a), do, ds


def _jax_vjp(fn, xs, do, ds):
    """The reference's cotangents of ``fn(*xs)`` = (o, s) at (do, ds),
    ds None for zero."""
    (o, s), vjp = jax.vjp(fn, *xs)
    ct_s = jnp.zeros_like(s) if ds is None else jnp.asarray(ds)
    return vjp((jnp.asarray(do, o.dtype), ct_s))


def _fn_grads(fn, xs, do, ds):
    """Leaves' grads through ``fn`` (a port scan) with only o's
    cotangent when ds is None, as a training loss that drops the state."""
    leaves = [x.clone().requires_grad_() for x in xs]
    o, s = fn(*leaves)
    outs, cots = [o], [do.to(o.dtype)]
    if ds is not None:
        outs.append(s)
        cots.append(ds)
    torch.autograd.backward(outs, cots)
    return [x.grad for x in leaves], o


GLA_CASES = [      # mode, T, chunk asked, with the state's cotangent
    ("bonus", 64, 16, True), ("bonus", 64, 16, False),
    ("post", 64, 16, True), ("post", 64, 16, False),
    ("bonus", 48, 32, True),                   # chunk 32 -> 16
    ("post", 40, 16, False)]                   # chunk 16 -> 8


@pytest.mark.parametrize("mode,T,chunk,with_ds", GLA_CASES,
                         ids=[f"{m}-T{t}-c{c}-{'ds' if d else 'nods'}"
                              for m, t, c, d in GLA_CASES])
def test_gla_backward_matches_reference_vjp(mode, T, chunk, with_ds):
    xs, do, ds = _gla_inputs(2, 3, T, 16, seed=T + chunk)
    if mode == "post":
        xs = xs[:4]
    ds = ds if with_ds else None
    want = _jax_vjp(lambda *a: jops.gla(*a, chunk=chunk),
                    [jnp.asarray(x) for x in xs], do, ds)
    t = [torch.from_numpy(x) for x in xs]
    u = t[4] if mode == "bonus" else None
    tdo = torch.from_numpy(do)
    tds = None if ds is None else torch.from_numpy(ds)
    direct = ops.gla_bwd_chunks(*t[:4], u, tdo, tds,
                                ops._fit_chunk(chunk, T))
    got, _ = _fn_grads(lambda *a: ops.gla(*a, chunk=chunk), t, tdo, tds)
    for name, d, g, w in zip("qkvwu", direct, got, want):
        assert _rel(d, w) <= REF_TOL, (name, _rel(d, w))
        assert _rel(g, w) <= REF_TOL, (name, _rel(g, w))
    if mode == "post":
        assert direct[4] is None


@pytest.mark.parametrize("mode", ["bonus", "post"])
def test_gla_bf16_backward_matches_reference_vjp(mode):
    """bf16 q, k, v (rwkv6's compute dtype) beside fp32 w and u."""
    xs, do, _ = _gla_inputs(2, 3, 64, 16, seed=5)
    bf = [jnp.asarray(x, jnp.bfloat16) for x in xs[:3]]
    up = [np.asarray(x, np.float32) for x in bf]     # the same values
    extra = list(xs[3:] if mode == "bonus" else xs[3:4])
    jdo = jnp.asarray(do, jnp.bfloat16)
    f = functools.partial(jops.gla, chunk=16)
    want_bf = _jax_vjp(f, bf + [jnp.asarray(x) for x in extra], jdo, None)
    want32 = _jax_vjp(f, [jnp.asarray(x) for x in up + extra],
                      np.asarray(jdo, np.float32), None)
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in up]
    te = [torch.from_numpy(x) for x in extra]
    tdo = torch.from_numpy(np.asarray(jdo, np.float32)).to(torch.bfloat16)
    u = te[1] if mode == "bonus" else None
    direct = ops.gla_bwd_chunks(*tb, te[0], u, tdo, None, 16)
    got, o = _fn_grads(lambda *a: ops.gla(*a, chunk=16), tb + te, tdo, None)
    assert o.dtype == torch.bfloat16
    for name, d, w in zip("qkvwu", direct, want32):
        assert d.dtype == torch.float32
        assert _rel(d, w) <= REF_TOL, (name, _rel(d, w))
    for name, g, w, x in zip("qkvwu", got, want_bf, tb + te):
        assert g.dtype == x.dtype, name
        g64 = g.double().numpy()
        w64 = np.asarray(w, np.float64) if w.dtype != jnp.bfloat16 else \
            np.asarray(w.astype(jnp.float32), np.float64)
        lim = BF16_STEP * np.abs(w64) + REF_TOL * np.abs(w64).max()
        assert (np.abs(g64 - w64) <= lim).all(), name


SSD_CASES = [      # T, chunk asked, with the state's cotangent
    (64, 32, True), (64, 32, False), (48, 32, True)]     # 48: 32 -> 16


@pytest.mark.parametrize("T,chunk,with_ds", SSD_CASES,
                         ids=[f"T{t}-c{c}-{'ds' if d else 'nods'}"
                              for t, c, d in SSD_CASES])
def test_ssd_backward_matches_reference_vjp(T, chunk, with_ds):
    xs, do, ds = _ssd_inputs(2, 3, T, 16, 8, seed=T)
    ds = ds if with_ds else None
    want = _jax_vjp(lambda *a: jops.ssd(*a, chunk=chunk),
                    [jnp.asarray(x) for x in xs], do, ds)
    t = [torch.from_numpy(x) for x in xs]
    tds = None if ds is None else torch.from_numpy(ds)
    direct = ops.ssd_bwd_chunks(*t, torch.from_numpy(do), tds,
                                ops._fit_chunk(chunk, T))
    got, _ = _fn_grads(lambda *a: ops.ssd(*a, chunk=chunk), t,
                       torch.from_numpy(do), tds)
    for name, d, g, w in zip("qkva", direct, got, want):
        assert _rel(d, w) <= REF_TOL, (name, _rel(d, w))
        assert _rel(g, w) <= REF_TOL, (name, _rel(g, w))


def test_functions_pass_gradcheck_in_fp64():
    """Both Functions (o and the final state) at tiny sizes, fp64."""
    g = torch.Generator().manual_seed(0)
    f64 = torch.float64

    def rn(*s):
        return torch.randn(s, generator=g, dtype=f64).requires_grad_()

    def decay(*s):
        return (torch.rand(s, generator=g, dtype=f64) * 0.9
                + 0.05).requires_grad_()

    B, H, T, D = 1, 2, 8, 3
    for u in (rn(H, D), None):
        args = (rn(B, H, T, D), rn(B, H, T, D), rn(B, H, T, D),
                decay(B, H, T, D), u)
        assert torch.autograd.gradcheck(
            lambda *a: ops.gla(*a, chunk=4), args, eps=1e-6, atol=1e-6)
    args = (rn(B, T, D), rn(B, T, D), rn(B, H, T, 2), decay(B, H, T))
    assert torch.autograd.gradcheck(lambda *a: ops.ssd(*a, chunk=4), args,
                                    eps=1e-6, atol=1e-6)


@pytest.mark.parametrize("scan", ["gla-bonus", "gla-post", "ssd"])
def test_functions_match_autograd_of_the_plain_scan(scan):
    """The Function's grads against autograd through ``ref``'s chunked
    scan on the same inputs, o's and the state's cotangents both."""
    if scan == "ssd":
        xs, do, ds = _ssd_inputs(2, 4, 96, 8, 8, seed=3)
        fn = functools.partial(ops.ssd, chunk=32)
        plain = functools.partial(ref.ssd_chunked_ref, chunk=32)
    else:
        xs, do, ds = _gla_inputs(2, 4, 96, 8, seed=3)
        xs = xs if scan == "gla-bonus" else xs[:4]
        fn = functools.partial(ops.gla, chunk=16)
        plain = functools.partial(ref.gla_chunked_ref, chunk=16)
    t = [torch.from_numpy(x) for x in xs]
    tdo, tds = torch.from_numpy(do), torch.from_numpy(ds)
    got, o = _fn_grads(fn, t, tdo, tds)
    assert o.grad_fn is not None and "Scan" in type(o.grad_fn).__name__
    leaves = [x.clone().requires_grad_() for x in t]
    po, ps = plain(*leaves)
    want = torch.autograd.grad((po, ps), leaves, (tdo, tds))
    assert torch.equal(o.detach(), po.detach())
    for name, g, w in zip("qkvwu", got, want):
        assert _rel(g, w) <= PLAIN_TOL, (name, _rel(g, w))


def test_no_grad_calls_are_the_plain_route():
    """Without grad (or with no input requiring it) ``ops`` returns the
    plain scan's tensors, with no Function in between."""
    xs, _, _ = _gla_inputs(1, 2, 32, 8, seed=9)
    t = [torch.from_numpy(x) for x in xs]
    o, s = ops.gla(*t, chunk=16)
    po, ps = ref.gla_chunked_ref(*t, chunk=16)
    assert o.grad_fn is None and torch.equal(o, po) and torch.equal(s, ps)
    with torch.no_grad():
        leaves = [x.clone().requires_grad_() for x in t]
        assert ops.gla(*leaves, chunk=16)[0].grad_fn is None
