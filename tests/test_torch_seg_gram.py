"""The port's segmented-Gram family (repro_torch.kernels.seg_gram) held
against the JAX package's.

  * every builder against ``repro.kernels.seg_gram.ref``;
  * the plain ``seg_reduce`` against the Pallas kernel run in interpret
    mode, for the four main-path builders, one and three segments, with
    and without row weights, at a row count that does not divide the
    block;
  * the plain versions of the four inference builders (fold_weighted,
    residual_direct, iv, iv_meat) — one segment and three, with row
    weights, and with a leading batch of per-replicate columns, weights
    and theta — against ``seg_gram_ref``, row by row of the batch;
  * ``residual_gram`` against the JAX entry point (interpret);
  * the argument layout the ops layer hands the CUDA kernel, through an
    emulation of the kernel's documented contract (the one-segment
    splits, and the segment walk over ``kernel.walk_plan``'s unit table
    for S > 1), for every builder;
  * inside torch, bitwise: a padded tail is a no-op, w=0 equals zeroed
    rows, an empty segment is exactly 0, power-of-two weights scale
    exactly, and a batch of one equals the same row of a batch of k;
  * the segment walk's plan cache (``kernel.cached_walk_plan``): a hit
    is the same plan, an in-place write to the ids or another S or rows
    per unit plans again, dropped ids drop their plans, the cache is
    bounded, and a cached plan is ``walk_plan``'s;
  * the large-tile template's tile schedule (``kernel.tile_schedule``,
    which csrc/seg_gram.cu mirrors) with the kernel's write rules: one
    triangle of a symmetric Gram and its mirror write every element
    exactly once, from the accumulator of its upper twin, and
    gram_and_vec's appended row in full.

Tolerance port vs reference: rtol 1e-5 plus atol 1e-5·max|G| — fp32
Grams reassociate differently in the two frameworks (about 1e-5
relative on cross-moments, ROADMAP §C).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.residual_gram import ops as jrg_ops  # noqa: E402
from repro.kernels.seg_gram import kernel as jsg_kernel  # noqa: E402
from repro.kernels.seg_gram import ref as jref  # noqa: E402
from repro_torch.kernels.residual_gram import ops as rg_ops  # noqa: E402
from repro_torch.kernels.seg_gram import ops, ref  # noqa: E402

_N, _P, _S, _RB = 1100, 3, 3, 512          # 1100 does not divide 512


def _close(got, want, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = 1e-5 * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def arrs():
    rng = np.random.default_rng(7)
    f32 = np.float32
    return dict(
        y=rng.standard_normal((_N, 1)).astype(f32),
        t=(rng.random((_N, 1)) < 0.5).astype(f32),
        my=(0.1 * rng.standard_normal((_N, 1))).astype(f32),
        mt=rng.uniform(0.1, 0.9, (_N, 1)).astype(f32),
        rz=rng.standard_normal((_N, 1)).astype(f32),
        phi=rng.standard_normal((_N, _P)).astype(f32),
        D=rng.standard_normal((_N, 6)).astype(f32),
        w=rng.exponential(size=(_N, 1)).astype(f32),
        W=rng.exponential(size=(4, _N)).astype(f32),
        seg=rng.integers(0, _S, _N).astype(np.int32),
        theta=np.arange(1.0, _P + 1, dtype=f32)[None],
    )


def _builder_cases(a):
    """(torch builder, jax builder, numpy inputs) for every builder."""
    return {
        "pair": (ref.build_pair, jref.build_pair, [a["phi"], a["D"]]),
        "design": (ref.build_design, jref.build_design, [a["D"]]),
        "residual": (ref.build_residual, jref.build_residual,
                     [a["y"], a["t"], a["my"], a["mt"], a["phi"]]),
        "residual_direct": (ref.build_residual_direct,
                            jref.build_residual_direct,
                            [a["y"], a["t"], a["phi"]]),
        "iv": (ref.build_iv, jref.build_iv,
               [a["y"], a["t"], a["rz"], a["phi"]]),
        "fold_weighted": (ref.build_fold_weighted, jref.build_fold_weighted,
                          [a["W"].T.copy(), a["D"]]),
        "gram_and_vec": (ref.build_gram_and_vec, jref.build_gram_and_vec,
                         [a["D"], a["w"], a["y"]]),
        "residual_meat": (ref.build_residual_meat, jref.build_residual_meat,
                          [a["y"], a["t"], a["my"], a["mt"], a["phi"],
                           a["theta"], a["w"]]),
        "iv_meat": (ref.build_iv_meat, jref.build_iv_meat,
                    [a["y"], a["t"], a["rz"], a["phi"], a["theta"],
                     a["w"]]),
    }


_BUILDERS = ["pair", "design", "residual", "residual_direct", "iv",
             "fold_weighted", "gram_and_vec", "residual_meat", "iv_meat"]
_MAIN = ["design", "gram_and_vec", "residual", "residual_meat"]
_INFERENCE = ["fold_weighted", "residual_direct", "iv", "iv_meat"]


@pytest.mark.parametrize("name", _BUILDERS)
def test_builder_matches_reference(arrs, name):
    """Elementwise builders: the same fp32 operations in both packages
    (the meat's 3-term row sum may round once differently: rtol 1e-6)."""
    tb, jb, inputs = _builder_cases(arrs)[name]
    L, R = tb(*[torch.from_numpy(x) for x in inputs])
    jL, jR = jb(*[jnp.asarray(x) for x in inputs])
    np.testing.assert_allclose(L.numpy(), np.asarray(jL), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("S", [1, _S])
@pytest.mark.parametrize("name", _MAIN)
def test_plain_matches_pallas_interpret(arrs, name, S, weighted):
    tb, jb, inputs = _builder_cases(arrs)[name]
    if name == "residual_meat":
        inputs = inputs[:-1]
    w = arrs["w"] if weighted else None
    seg = arrs["seg"] if S > 1 else None
    want = jsg_kernel.seg_gram_pallas(
        jb, [jnp.asarray(x) for x in inputs],
        seg=None if seg is None else jnp.asarray(seg)[:, None],
        w=None if w is None else jnp.asarray(w), n_segments=S,
        block_n=_RB, interpret=True)
    got = ops.seg_reduce(
        tb, [torch.from_numpy(x) for x in inputs],
        seg=None if seg is None else torch.from_numpy(seg).long(),
        w=None if w is None else torch.from_numpy(w[:, 0]),
        n_segments=S)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got.numpy(), np.asarray(want), f"{name} S={S} w={weighted}")


def _batched_inputs(a, name, R=3):
    """(torch inputs with a leading replicate axis, per-replicate numpy
    inputs) for an inference builder: columns (R, n, 1), theta
    (R, 1, p); fold_weighted's batch is its Wt columns instead."""
    if name == "fold_weighted":
        return None, None
    _, _, inputs = _builder_cases(a)[name]
    if name == "iv_meat":
        inputs = inputs[:-1]
    scale = [np.float32(1 + 0.25 * b) for b in range(R)]
    per = [[x * sc if x.shape[1] == 1 or x is a["theta"] else x
            for x in inputs] for sc in scale]
    batched = [torch.from_numpy(np.stack([p[i] for p in per]))
               if (x.shape[1] == 1 or x is a["theta"])
               else torch.from_numpy(x) for i, x in enumerate(inputs)]
    return batched, per


@pytest.mark.parametrize("case", ["plain", "weighted", "segmented",
                                  "batched"])
@pytest.mark.parametrize("name", _INFERENCE)
def test_inference_builders_plain_match_reference(arrs, name, case):
    """``seg_reduce`` (the plain version the CPU takes and the card's
    kernel is held against) against ``seg_gram_ref``."""
    tb, jb, inputs = _builder_cases(arrs)[name]
    if name == "iv_meat":
        inputs = inputs[:-1]
    if name == "fold_weighted" and case in ("weighted", "segmented"):
        with pytest.raises(ValueError, match="Wt"):
            ops.seg_reduce(tb, [torch.from_numpy(x) for x in inputs],
                           w=torch.ones(_N))
        return
    W = arrs["W"]
    if case == "batched" and name != "fold_weighted":
        batched, per = _batched_inputs(arrs, name)
        got = ops.seg_reduce(tb, batched, w=torch.from_numpy(W[:3]))
        for b in range(3):
            want = jref.seg_gram_ref(jb, [jnp.asarray(x) for x in per[b]],
                                     w=jnp.asarray(W[b])[:, None])
            _close(got[b].numpy(), np.asarray(want), f"{name} row {b}")
        return
    w = arrs["w"] if case == "weighted" else None
    S = _S if case == "segmented" else 1
    seg = arrs["seg"] if S > 1 else None
    want = jref.seg_gram_ref(
        jb, [jnp.asarray(x) for x in inputs],
        seg=None if seg is None else jnp.asarray(seg)[:, None],
        w=None if w is None else jnp.asarray(w), n_segments=S)
    got = ops.seg_reduce(
        tb, [torch.from_numpy(x) for x in inputs],
        seg=None if seg is None else torch.from_numpy(seg).long(),
        w=None if w is None else torch.from_numpy(w[:, 0]), n_segments=S)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got.numpy(), np.asarray(want), f"{name} {case}")


def test_residual_gram_matches_reference(arrs):
    a = arrs
    cols = [a[k][:, 0] for k in ("y", "t", "my", "mt")]
    G, b = rg_ops.residual_gram(*[torch.from_numpy(c) for c in cols],
                                torch.from_numpy(a["phi"]))
    jG, jb = jrg_ops.residual_gram(*[jnp.asarray(c) for c in cols],
                                   jnp.asarray(a["phi"]),
                                   backend="interpret")
    _close(G.numpy(), np.asarray(jG), "G")
    _close(b.numpy(), np.asarray(jb), "b")


def _emulate_kernel(builder, X, *, scalars=(), theta=None, w=None,
                    seg=None, n_segments=1, count_as=None):
    """csrc/seg_gram.cu's contract in plain torch: L = [c1L·X | c2L·X? |
    eL?] with the row weight and segment mask, R alike; every scalar,
    w and theta (n,)/(dX,) or batched; (B, S·qL, qR)."""
    batched = [x.shape[0] for x in list(scalars) + [w, theta]
               if x is not None and x.dim() == 2]
    B = max(batched or [1])
    outs = []
    for b in range(B):
        sc = [x[b] if x.dim() == 2 else x for x in scalars]
        th = None if theta is None else (theta[b] if theta.dim() == 2
                                         else theta)

        def meat_e(ry, rt, w2):
            e = ry - ((rt[:, None] * X) * th).sum(1)
            return w2 * e if w2 is not None else e

        if builder == "design":
            L = R = X
        elif builder == "gram_and_vec":
            L, R = torch.cat([sc[0][:, None] * X, sc[1][:, None]], 1), X
        elif builder in ("residual", "residual_direct"):
            ry, rt = ((sc[0] - sc[2], sc[1] - sc[3]) if builder == "residual"
                      else (sc[0], sc[1]))
            L = R = torch.cat([rt[:, None] * X, ry[:, None]], 1)
        elif builder == "iv":
            ry, rt, rz = sc
            L = R = torch.cat([rz[:, None] * X, rt[:, None] * X,
                               ry[:, None]], 1)
        elif builder == "iv_meat":
            e = meat_e(sc[0], sc[1], sc[3] if len(sc) == 4 else None)
            L = R = (e * sc[2])[:, None] * X
        else:
            rt = sc[1] - sc[3]
            e = meat_e(sc[0] - sc[2], rt, sc[4] if len(sc) == 5 else None)
            L = R = (e * rt)[:, None] * X
        wb = torch.ones(X.shape[0]) if w is None else (w[b] if w.dim() == 2
                                                       else w)
        outs.append(torch.cat([
            (L * (wb * (seg == s if seg is not None else 1))[:, None]).T @ R
            for s in range(n_segments)]))
    return torch.stack(outs)


def _emulate_walk(builder, X, *, Y=None, scalars=(), theta=None, w=None,
                  seg, n_segments, init=None, rows_per_unit=64):
    """csrc/seg_gram.cu's segment walk in plain torch, over the unit
    table of ``kernel.walk_plan``: each unit's rows read through the
    permutation, each segment's units summed in order (or, with init,
    one unit per segment seeded from init); (S, qL, qR)."""
    from repro_torch.kernels.seg_gram import kernel as kern

    if builder == "pair":
        L, R = X, Y
    else:
        L = R = _rows_of(builder, X, scalars)
    if w is not None:
        L = L * w[:, None]
    plan = kern.walk_plan(seg, n_segments, None if init is not None
                          else rows_per_unit)
    W = plan.useg.shape[0]
    parts = torch.zeros((W, L.shape[1], R.shape[1]))
    for u in range(W):
        if int(plan.useg[u]) >= n_segments:
            continue
        rows = plan.perm[int(plan.lo[u]):int(plan.hi[u])]
        parts[u] = L[rows].T @ R[rows]
        if init is not None:
            parts[u] += init[int(plan.useg[u])]
    first = plan.first.tolist()
    return torch.stack([parts[first[s]:first[s + 1]].sum(0)
                        for s in range(n_segments)])


def _rows_of(builder, X, scalars):
    """The L = R rows of a symmetric builder, as the kernel forms them."""
    sc = list(scalars)
    if builder == "design":
        return X
    if builder in ("residual", "residual_direct"):
        ry, rt = ((sc[0] - sc[2], sc[1] - sc[3]) if builder == "residual"
                  else (sc[0], sc[1]))
        return torch.cat([rt[:, None] * X, ry[:, None]], 1)
    if builder == "iv":
        ry, rt, rz = sc
        return torch.cat([rz[:, None] * X, rt[:, None] * X, ry[:, None]], 1)
    raise AssertionError(f"no segmented layout case for {builder}")


def _layout_case(a, name):
    """(ops inputs, seg_reduce keywords) exercising batch strides."""
    W = a["W"]
    Rb = W.shape[0]

    def rep(x):               # (n, 1) column -> (R, n, 1), per-replicate
        return torch.stack([x * (1 + 0.25 * b) for b in range(Rb)])

    col = {"design": [a["D"]],
           "fold_weighted": [W.T.contiguous(), a["D"]],
           "gram_and_vec": [a["D"], W[..., None], (0.5 * W)[..., None]],
           "residual": [a["y"], a["t"], a["my"], a["mt"], a["phi"]],
           "residual_meat": [a["y"], a["t"], a["my"], a["mt"], a["phi"],
                             a["theta"], a["w"]],
           "residual_direct": [rep(a["y"]), rep(a["t"]), a["phi"]],
           "iv": [a["y"], a["t"], a["rz"], a["phi"]],
           "iv_meat": [rep(a["y"]), rep(a["t"]), rep(a["rz"]), a["phi"],
                       torch.stack([a["theta"] * (1 + 0.5 * b)
                                    for b in range(Rb)]), rep(a["w"])]}[name]
    kw = {"design": dict(w=W), "residual": dict(seg=a["seg"].long(),
                                                n_segments=_S),
          "residual_direct": dict(w=W), "iv": dict(seg=a["seg"].long(),
                                                   n_segments=_S),
          "iv_meat": dict(w=W)}.get(name, {})
    return col, kw


@pytest.mark.parametrize("name", _MAIN + _INFERENCE)
def test_kernel_argument_layout(arrs, name, monkeypatch):
    """The columns, batch strides and output reshapes the ops layer
    hands the CUDA wrapper reproduce the plain result (the kernel's
    contract emulated on the CPU)."""
    from repro_torch.kernels.seg_gram import kernel as kern

    a = {k: torch.from_numpy(v) for k, v in arrs.items()}
    col, kw = _layout_case(a, name)
    builder = getattr(ref, f"build_{name}")
    want = ops.seg_reduce(builder, col, **kw)

    kname, X, scalars, theta, w, count = ops._kernel_args(builder, col,
                                                          kw.get("w"))
    assert count == ("fold_weighted" if name == "fold_weighted" else None)
    S = kw.get("n_segments", 1)
    if S > 1:
        # segmented calls take the segment walk (unbatched)
        monkeypatch.setattr(kern, "seg_walk_cuda", _emulate_walk)
        got = kern.seg_walk_cuda(kname, X, scalars=scalars, theta=theta,
                                 w=w, seg=kw["seg"], n_segments=S)
    else:
        monkeypatch.setattr(kern, "seg_gram_cuda", _emulate_kernel)
        G = kern.seg_gram_cuda(kname, X, scalars=scalars, theta=theta, w=w)
        if name == "fold_weighted":
            got = G.reshape(-1, G.shape[2])
        else:
            batched = any(c.dim() == 3 for c in col) or "w" in kw and \
                kw["w"].dim() == 2
            got = G if batched else G[0]
    assert got.shape == want.shape
    _close(got.numpy(), want.numpy(), name)


@pytest.mark.parametrize("name", ["residual_direct", "iv", "fold_weighted",
                                  "iv_meat", "pair"])
def test_later_builders_have_no_cuda_kernel_yet(arrs, name):
    """Every builder now maps to a kernel form: the inference builders
    (and fold_weighted, on the design form) since slice 4, build_pair —
    the last one — on the segment walk."""
    tb, _, inputs = _builder_cases(arrs)[name]
    arrays = [torch.from_numpy(x) for x in inputs]
    if name == "iv_meat":
        arrays = arrays[:-1]
    kname = ops._kernel_args(tb, arrays)[0]
    assert kname == ("design" if name == "fold_weighted" else name)
    assert kname in ops._kernel.BUILDERS


def test_only_cuda_or_cpu(arrs):
    D = torch.empty((8, 3), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.design_gram(D)


# ---------------------------------------------------------------------------
# Bitwise invariants inside torch (plain version).
# ---------------------------------------------------------------------------

def test_padded_tail_exact_noop(arrs):
    """Rows of zeros with seg = -1 and w = 0 change nothing, bitwise, on
    the blocked path (each block keeps its shape).  The whole-array
    plain product retiles with n, so there it holds to tolerance only,
    as for the reference's one-hot oracle."""
    from repro_torch.core import moments

    a = {k: torch.from_numpy(v) for k, v in arrs.items()}
    pad = 56                                  # 1156 still spans 3 blocks
    D, seg, w = a["D"], a["seg"].long(), a["w"][:, 0]
    Dp = torch.cat([D, torch.zeros((pad, D.shape[1]))])
    segp = torch.cat([seg, torch.full((pad,), -1)])
    wp = torch.cat([w, torch.zeros(pad)])
    kw = dict(row_block=_RB, strategy="chunked")
    g = moments.weighted_gram(D, w, intercept=False, **kw)
    gp = moments.weighted_gram(Dp, wp, intercept=False, **kw)
    assert torch.equal(g[0], gp[0]) and torch.equal(g[1], gp[1])
    g = moments.fold_gram(D, seg, _S, **kw)
    gp = moments.fold_gram(Dp, segp, _S, **kw)
    assert torch.equal(g[0], gp[0]) and torch.equal(g[1], gp[1])
    g = ops.seg_reduce(ref.build_design, [D], seg=seg, w=w, n_segments=_S)
    gp = ops.seg_reduce(ref.build_design, [Dp], seg=segp, w=wp,
                        n_segments=_S)
    _close(gp.numpy(), g.numpy(), "whole-array plain")


def test_zero_weight_equals_zero_data(arrs):
    a = {k: torch.from_numpy(v)[:, 0] if v.ndim == 2 and v.shape[1] == 1
         else torch.from_numpy(v) for k, v in arrs.items()}
    mask = (torch.arange(_N) % 3 != 0).float()
    g_w = ops.residual_gram(a["y"], a["t"], a["my"], a["mt"], a["phi"],
                            w=mask)
    g_z = ops.residual_gram(a["y"] * mask, a["t"] * mask, a["my"] * mask,
                            a["mt"] * mask, a["phi"] * mask[:, None])
    assert torch.equal(g_w[0], g_z[0]) and torch.equal(g_w[1], g_z[1])


def test_empty_segment_exact_zero(arrs):
    D = torch.from_numpy(arrs["D"])
    seg = torch.from_numpy(arrs["seg"]).long()
    seg = torch.where(seg == 2, torch.ones_like(seg), seg)
    G, counts = ops.fold_design_gram(D, seg, _S)
    assert bool((G[2] == 0).all())
    assert float(counts[2]) == 0.0


def test_power_of_two_weights_exact(arrs):
    D = torch.from_numpy(arrs["D"])
    seg = torch.from_numpy(arrs["seg"]).long()
    g1 = ops.seg_reduce(ref.build_design, [D], seg=seg, n_segments=_S)
    g2 = ops.seg_reduce(ref.build_design, [D], seg=seg, n_segments=_S,
                        w=torch.full((_N,), 2.0))
    assert torch.equal(2.0 * g1, g2)


def test_batch_of_one_equals_row_of_batch(arrs):
    """The fold batch: row b of a (k, n)-weighted call equals the
    unbatched call with weights w[b]."""
    D = torch.from_numpy(arrs["D"])
    W = torch.from_numpy(arrs["W"])
    Gk = ops.design_gram(D, w=W)
    Gv, uv = ops.gram_and_vec(D, W, 0.5 * W)
    for b in range(W.shape[0]):
        assert torch.equal(Gk[b], ops.design_gram(D, w=W[b]))
        G1, u1 = ops.gram_and_vec(D, W[b], 0.5 * W[b])
        assert torch.equal(Gv[b], G1) and torch.equal(uv[b], u1)


# ---------------------------------------------------------------------------
# segment_outer (build_pair) and the segment walk's unit table.
# ---------------------------------------------------------------------------

def _outer_case(a, case):
    """(U, V, seg, w, init) numpy inputs of one segment_outer case."""
    U, V = a["phi"], np.concatenate([a["D"], a["y"]], axis=1)
    seg, w, init = a["seg"], None, None
    rng = np.random.default_rng(11)
    if case == "weighted":
        w = a["w"][:, 0]
    elif case == "init":
        init = rng.standard_normal((_S, U.shape[1], V.shape[1])).astype(
            np.float32)
    elif case == "padded":
        seg = np.where(np.arange(_N) % 7 == 0, -1, seg).astype(np.int32)
    elif case == "empty":
        seg = np.where(seg == 2, 1, seg).astype(np.int32)
    elif case == "vector":
        U = a["y"][:, 0]
    return U, V, seg, w, init


_OUTER = ["plain", "weighted", "init", "padded", "empty", "vector"]


@pytest.mark.parametrize("backend", ["ref", "interpret"])
@pytest.mark.parametrize("case", _OUTER)
def test_segment_outer_matches_reference(arrs, case, backend):
    """The port's plain segment_outer against the reference's one-hot
    oracle and its Pallas kernel in interpret mode: row weights, a
    seeded accumulator (the reference adds init to its result), seg = -1
    padding, an empty segment, a vector U."""
    from repro.kernels.seg_gram import ops as jsg_ops

    U, V, seg, w, init = _outer_case(arrs, case)
    want = jsg_ops.segment_outer(
        jnp.asarray(U), jnp.asarray(V), jnp.asarray(seg), _S,
        w=None if w is None else jnp.asarray(w), row_block=_RB,
        backend=backend, init=None if init is None else jnp.asarray(init))
    got = ops.segment_outer(
        torch.from_numpy(U), torch.from_numpy(V), torch.from_numpy(seg), _S,
        w=None if w is None else torch.from_numpy(w),
        init=None if init is None else torch.from_numpy(init))
    assert tuple(got.shape) == tuple(want.shape)
    _close(got.numpy(), np.asarray(want), f"{case} vs {backend}")
    if case == "empty":
        assert bool((got[2] == 0).all())


def test_segment_outer_bitwise_contracts(arrs):
    """Inside torch, bitwise: rows with seg = -1 change nothing; init is
    added to the walk's result and not written; an empty segment is 0."""
    a = {k: torch.from_numpy(v) for k, v in arrs.items()}
    U, V, seg = a["phi"], a["D"], a["seg"].long()
    G = ops.segment_outer(U, V, seg, _S)
    pad = 40
    Up = torch.cat([U, torch.randn((pad, U.shape[1]))])
    Vp = torch.cat([V, torch.randn((pad, V.shape[1]))])
    segp = torch.cat([seg, torch.full((pad,), -1)])
    assert torch.equal(G, ops.segment_outer(Up, Vp, segp, _S))
    init = torch.randn(G.shape)
    keep = init.clone()
    assert torch.equal(ops.segment_outer(U, V, seg, _S, init=init), init + G)
    assert torch.equal(init, keep)
    seg_e = torch.where(seg == 2, torch.zeros_like(seg), seg)
    assert bool((ops.segment_outer(U, V, seg_e, _S)[2] == 0).all())


@pytest.mark.parametrize("rows", [None, 1, 64, 5000])
def test_walk_plan_covers_every_row_once(arrs, rows):
    """The unit table: every row of [0, S) in exactly one unit of its
    segment, in arrival order; units of at most ``rows`` rows; every
    segment at least one unit (an empty one too); ceil(n / rows) + S
    entries with an unused tail; and the kernel's contract emulated over
    it equals the plain segmented Gram."""
    from repro_torch.kernels.seg_gram import kernel as kern

    seg = torch.from_numpy(arrs["seg"]).long()
    seg = torch.where(seg == 1, torch.full_like(seg, -1), seg)   # 1 empty
    plan = kern.walk_plan(seg, _S, rows)
    W = plan.useg.shape[0]
    assert W == (_S if rows is None else -(-_N // rows) + _S)
    first = plan.first.tolist()
    assert first[0] == 0 and all(b > a for a, b in zip(first, first[1:]))
    for s in range(_S):
        units = range(first[s], first[s + 1])
        got = torch.cat([plan.perm[int(plan.lo[u]):int(plan.hi[u])]
                         for u in units])
        assert torch.equal(got, torch.nonzero(seg == s).squeeze(1))
        assert all(int(plan.useg[u]) == s for u in units)
        if rows is not None:
            assert all(int(plan.hi[u] - plan.lo[u]) <= rows for u in units)
    assert bool((plan.useg[first[-1]:] == _S).all())
    U, V = (torch.from_numpy(arrs[k]) for k in ("phi", "D"))
    got = _emulate_walk("pair", U, Y=V, seg=seg, n_segments=_S,
                        rows_per_unit=rows or 64)
    _close(got.numpy(), ops.segment_outer(U, V, seg, _S).numpy(), "walk")


def _same_plan(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _plan_seg(arrs):
    return torch.from_numpy(arrs["seg"]).long().clone()


def test_walk_plan_cache_hit_returns_the_same_plan(arrs):
    """A second walk of the same ids tensor (same S, rows per unit)
    reuses the plan: no sort, no new count in PLANS."""
    from repro_torch.kernels.seg_gram import kernel as kern

    kern.clear_plan_cache()
    seg = _plan_seg(arrs)
    before = kern.PLANS[(_S, 64)]
    plan = kern.cached_walk_plan(seg, _S, 64)
    assert kern.cached_walk_plan(seg, _S, 64) is plan
    assert kern.PLANS[(_S, 64)] == before + 1


def test_walk_plan_cache_replans_after_an_in_place_write(arrs):
    """An in-place write to the ids bumps their version: the next walk
    plans again, and its plan is the new ids' plan."""
    from repro_torch.kernels.seg_gram import kernel as kern

    seg = _plan_seg(arrs)
    plan = kern.cached_walk_plan(seg, _S, 64)
    seg[0] = (seg[0] + 1) % _S
    again = kern.cached_walk_plan(seg, _S, 64)
    assert again is not plan
    assert _same_plan(again, kern.walk_plan(seg, _S, 64))
    assert not _same_plan(again, plan)


@pytest.mark.parametrize("S,rows", [(_S + 1, 64), (_S, 128), (_S, None)])
def test_walk_plan_cache_keys_on_segments_and_rows(arrs, S, rows):
    """Another S or another rows per unit (None: unsplit, the seeded
    walk) is another plan."""
    from repro_torch.kernels.seg_gram import kernel as kern

    seg = _plan_seg(arrs)
    plan = kern.cached_walk_plan(seg, _S, 64)
    other = kern.cached_walk_plan(seg, S, rows)
    assert other is not plan
    assert _same_plan(other, kern.walk_plan(seg, S, rows))
    assert kern.cached_walk_plan(seg, _S, 64) is plan


def test_walk_plan_cache_drops_a_dropped_seg(arrs):
    """The cache holds ids tensors by weak reference: dropping the ids
    drops their plans."""
    import gc

    from repro_torch.kernels.seg_gram import kernel as kern

    kern.clear_plan_cache()
    seg = _plan_seg(arrs)
    kern.cached_walk_plan(seg, _S, 64)
    kern.cached_walk_plan(seg, _S, None)
    assert len(kern._PLAN_CACHE) == 2
    del seg
    gc.collect()
    assert len(kern._PLAN_CACHE) == 0


def test_walk_plan_cache_is_bounded(arrs):
    """At most PLAN_CACHE_SIZE plans are kept; the least recently used
    goes first."""
    from repro_torch.kernels.seg_gram import kernel as kern

    kern.clear_plan_cache()
    segs = [_plan_seg(arrs) for _ in range(kern.PLAN_CACHE_SIZE + 2)]
    plans = [kern.cached_walk_plan(s, _S, 64) for s in segs]
    assert len(kern._PLAN_CACHE) == kern.PLAN_CACHE_SIZE
    assert kern.cached_walk_plan(segs[-1], _S, 64) is plans[-1]
    assert kern.cached_walk_plan(segs[0], _S, 64) is not plans[0]


@pytest.mark.parametrize("rows", [None, 1, 64, 5000])
def test_cached_walk_plan_equals_uncached(arrs, rows):
    """A cached plan, on its first use and on a hit, is the plan
    ``walk_plan`` makes."""
    from repro_torch.kernels.seg_gram import kernel as kern

    seg = _plan_seg(arrs)
    want = kern.walk_plan(seg, _S, rows)
    assert _same_plan(kern.cached_walk_plan(seg, _S, rows), want)
    assert _same_plan(kern.cached_walk_plan(seg, _S, rows), want)


def test_stage_restores_the_launch_parts():
    """``kernel.stage`` picks the part a launch runs for timing and puts
    back both parts on leaving, also on an error."""
    from repro_torch.kernels.seg_gram import kernel as kern

    assert kern._parts == 3
    with kern.stage("main"):
        assert kern._parts == 1
    with pytest.raises(RuntimeError):
        with kern.stage("reduce"):
            assert kern._parts == 2
            raise RuntimeError("in a timed call")
    assert kern._parts == 3


def _tile_writes(qL, qR, sym, tile):
    """csrc/seg_gram.cu's epilogue over ``kernel.tile_schedule``: how many
    times each output element is written, and the (row, col) of the
    accumulator each last came from.  A launched tile writes its element
    (I, J) when the output is not symmetric, or I >= qR (gram_and_vec's
    v row), or I <= J; a tile on or above the diagonal also writes, for
    I < J < qR, the mirror (J, I) from the same accumulator."""
    from repro_torch.kernels.seg_gram import kernel as kern

    count = np.zeros((qL, qR), np.int64)
    src = np.full((qL, qR, 2), -1, np.int64)
    for ti, tj in kern.tile_schedule(qL, qR, sym, tile):
        I = np.arange(ti * tile, min((ti + 1) * tile, qL))[:, None]
        J = np.arange(tj * tile, min((tj + 1) * tile, qR))[None, :]
        I, J = np.broadcast_arrays(I, J)
        direct = ~np.asarray(sym) | (I >= qR) | (I <= J)
        np.add.at(count, (I[direct], J[direct]), 1)
        src[I[direct], J[direct]] = np.stack([I[direct], J[direct]], -1)
        if sym and ti <= tj:
            mir = (I < J) & (J < qR)
            np.add.at(count, (J[mir], I[mir]), 1)
            src[J[mir], I[mir]] = np.stack([I[mir], J[mir]], -1)
    return count, src


@pytest.mark.parametrize("tile", [8, 128])
@pytest.mark.parametrize("qL,qR,sym", [
    (37, 37, True), (40, 40, True), (38, 37, True), (41, 40, True),
    (37, 37, False), (5, 37, False), (502, 502, True), (503, 502, True),
    (1006, 1006, True), (2050, 2049, True), (130, 130, True),
    (131, 130, True), (256, 256, True), (257, 256, True)])
def test_tile_schedule_covers_the_output(qL, qR, sym, tile):
    """Every element of the (qL, qR) output is written exactly once; in a
    symmetric one, (i, j) and (j, i) come from one accumulator (the upper
    one, i <= j), so the result is bitwise symmetric; the tiles are
    distinct and in range, one triangle plus gram_and_vec's v tile row
    (all of it) — about half the full grid."""
    from repro_torch.kernels.seg_gram import kernel as kern

    tiles = kern.tile_schedule(qL, qR, sym, tile)
    TL, TR = -(-qL // tile), -(-qR // tile)
    assert len(set(tiles)) == len(tiles)
    assert all(0 <= i < TL and 0 <= j < TR for i, j in tiles)
    count, src = _tile_writes(qL, qR, sym, tile)
    assert (count == 1).all()
    i, j = np.meshgrid(np.arange(qL), np.arange(qR), indexing="ij")
    if not sym:
        assert len(tiles) == TL * TR
        assert (src[..., 0] == i).all() and (src[..., 1] == j).all()
        return
    assert len(tiles) == TR * (TR + 1) // 2 + (qR // tile if qL > qR else 0)
    lo = np.minimum(i, j)
    hi = np.maximum(i, j)
    body = i < qR
    assert (src[..., 0][body] == lo[body]).all()
    assert (src[..., 1][body] == hi[body]).all()
    if qL > qR:                          # gram_and_vec: row qR in full
        assert (src[qR:, :, 0] == qR).all()
        assert (src[qR:, :, 1] == np.arange(qR)).all()
        assert {(qR // tile, c) for c in range(TR)} <= set(tiles)
