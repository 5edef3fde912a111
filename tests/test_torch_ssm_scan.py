"""The port's chunked scans (repro_torch.kernels.ssm_scan) held against
the JAX package's ``repro.kernels.ssm_scan``: the plain GLA scan in
"post" and "bonus" (RWKV-6) modes and the plain SSD scan, through
``ops.gla`` / ``ops.ssd`` on CPU tensors (the plain chunked versions),
against

  * ``gla_pallas`` / ``ssd_pallas`` in interpret mode (the TPU kernels'
    bodies run on the CPU, as the reference's own kernel tests run them),
  * the reference's ``*_chunked_ref`` and ``*_naive``,
  * the port's own ``*_naive`` in float64;

plus the strong-decay cases at the clamp (GLA at w = exp(-MAX_LOG_DECAY),
SSD at a = 1e-20; mirroring ``tests/test_kernels_ssm.py``), the chunk
halving of ``ops`` on a ragged T, bf16 inputs, the initial state, the
single-token steps, and the wrappers' refusals off the card.  Inputs are
drawn by numpy from a seed.

The wrappers' launch plan (``kernel.gla_plan`` / ``kernel.ssd_plan``,
plain Python, so it runs here): the form, grid, block, head group and
shared memory chosen for rwkv6-3b's and zamba2-1.2b's scans, their smoke
configs and the chunks a ragged T halves to, every plan within a block's
232,448 bytes, and a clear ``ValueError`` for a shape no form takes.

Tolerance: 1e-5 relative with atol 1e-5·max|x| on fp32 outputs and
states (fp32 sums in another order); the float64 naive oracle is held
to the same bound.  bf16 inputs: o is rounded to bf16 by both, 8e-3·max
(one bf16 step, 2^-8, where the fp32 sums straddle a rounding boundary).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssm_scan import kernel as jkernel  # noqa: E402
from repro.kernels.ssm_scan import ops as jops  # noqa: E402
from repro.kernels.ssm_scan import ref as jref  # noqa: E402
from repro_torch.kernels.ssm_scan import kernel, ops, ref  # noqa: E402


def _close(got, want, tol=1e-5, msg=""):
    got = np.asarray(got.numpy() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want.numpy() if torch.is_tensor(want) else want,
                      np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-30), err_msg=msg)


def _gla_inputs(B, H, T, Dk, Dv, seed=0, wmin=0.05):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((B, H, T, Dk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, H, T, Dv)).astype(np.float32)
    w = rng.uniform(wmin, 1.0, (B, H, T, Dk)).astype(np.float32)
    u = rng.standard_normal((H, Dk)).astype(np.float32)
    return q, k, v, w, u


def _ssd_inputs(B, H, T, N, P, seed=0):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((B, T, N)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, H, T, P)).astype(np.float32)
    a = rng.uniform(0.05, 1.0, (B, H, T)).astype(np.float32)
    return q, k, v, a


def _t(*xs):
    return [None if x is None else torch.from_numpy(x) for x in xs]


def _j(*xs):
    return [None if x is None else jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("mode", ["post", "bonus"])
@pytest.mark.parametrize("shape", [(2, 3, 64, 16, 16, 16),
                                   (1, 2, 128, 64, 64, 16),
                                   (2, 1, 96, 8, 32, 32)])
def test_gla_matches_reference(shape, mode):
    B, H, T, Dk, Dv, chunk = shape
    q, k, v, w, u = _gla_inputs(B, H, T, Dk, Dv)
    uu = None if mode == "post" else u
    o, s = ops.gla(*_t(q, k, v, w, uu), chunk=chunk)
    assert o.dtype == torch.float32 and s.shape == (B, H, Dk, Dv)
    o_pal, s_pal = jkernel.gla_pallas(*_j(q, k, v, w, uu), chunk=chunk,
                                      interpret=True)
    _close(o, o_pal, msg="o vs gla_pallas (interpret)")
    _close(s, s_pal, msg="state vs gla_pallas (interpret)")
    o_ref, s_ref = jref.gla_chunked_ref(*_j(q, k, v, w, uu), chunk=chunk)
    _close(o, o_ref, msg="o vs gla_chunked_ref")
    _close(s, s_ref, msg="state vs gla_chunked_ref")
    o_jn, s_jn = jref.gla_naive(*_j(q, k, v, w, uu))
    _close(o, o_jn, msg="o vs the reference's gla_naive")
    o64, s64 = ref.gla_naive(*(None if x is None else x.double()
                               for x in _t(q, k, v, w, uu)))
    _close(o, o64, msg="o vs fp64 naive")
    _close(s, s64, msg="state vs fp64 naive")


@pytest.mark.parametrize("shape", [(2, 3, 64, 16, 16, 32),
                                   (1, 4, 128, 64, 64, 32),
                                   (2, 1, 96, 8, 8, 32)])
def test_ssd_matches_reference(shape):
    B, H, T, N, P, chunk = shape
    q, k, v, a = _ssd_inputs(B, H, T, N, P)
    o, s = ops.ssd(*_t(q, k, v, a), chunk=chunk)
    assert o.dtype == torch.float32 and s.shape == (B, H, N, P)
    o_pal, s_pal = jkernel.ssd_pallas(*_j(q, k, v, a), chunk=chunk,
                                      interpret=True)
    _close(o, o_pal, msg="o vs ssd_pallas (interpret)")
    _close(s, s_pal, msg="state vs ssd_pallas (interpret)")
    o_ref, s_ref = jref.ssd_chunked_ref(*_j(q, k, v, a), chunk=chunk)
    _close(o, o_ref, msg="o vs ssd_chunked_ref")
    _close(s, s_ref, msg="state vs ssd_chunked_ref")
    o_jn, _ = jref.ssd_naive(*_j(q, k, v, a))
    _close(o, o_jn, msg="o vs the reference's ssd_naive")
    o64, s64 = ref.ssd_naive(*(x.double() for x in _t(q, k, v, a)))
    _close(o, o64, msg="o vs fp64 naive")
    _close(s, s64, msg="state vs fp64 naive")


@pytest.mark.parametrize("mode", ["post", "bonus"])
def test_gla_strong_decay_at_the_clamp(mode):
    """w = exp(-MAX_LOG_DECAY) everywhere: exp(-cum) reaches ~1e24 at
    chunk 16 and the chunked form stays finite and exact."""
    assert ref.MAX_LOG_DECAY == jref.MAX_LOG_DECAY
    q, k, v, w, u = _gla_inputs(1, 2, 64, 16, 16, seed=1)
    w = np.full_like(w, np.exp(-ref.MAX_LOG_DECAY))
    uu = None if mode == "post" else u
    o, s = ops.gla(*_t(q, k, v, w, uu), chunk=16)
    assert bool(torch.isfinite(o).all() and torch.isfinite(s).all())
    o_pal, s_pal = jkernel.gla_pallas(*_j(q, k, v, w, uu), chunk=16,
                                      interpret=True)
    _close(o, o_pal)
    _close(s, s_pal)
    o64, _ = ref.gla_naive(*(None if x is None else x.double()
                             for x in _t(q, k, v, w, uu)))
    _close(o, o64)


def test_ssd_strong_decay_any_magnitude():
    q, k, v, a = _ssd_inputs(1, 2, 64, 16, 16, seed=2)
    a = np.full_like(a, 1e-20)
    o, s = ops.ssd(*_t(q, k, v, a), chunk=32)
    assert bool(torch.isfinite(o).all() and torch.isfinite(s).all())
    o_pal, s_pal = jkernel.ssd_pallas(*_j(q, k, v, a), chunk=32,
                                      interpret=True)
    _close(o, o_pal)
    _close(s, s_pal)


@pytest.mark.parametrize("which", ["gla-post", "gla-bonus", "ssd"])
def test_ops_halve_the_chunk_like_the_reference(which):
    """T = 48 does not divide 32: both ops halve the chunk to 16."""
    if which == "ssd":
        xs = _ssd_inputs(2, 3, 48, 8, 16, seed=3)
        got = ops.ssd(*_t(*xs), chunk=32)
        want = jops.ssd(*_j(*xs), chunk=32)
        direct = ref.ssd_chunked_ref(*_t(*xs), chunk=16)
    else:
        q, k, v, w, u = _gla_inputs(2, 3, 48, 8, 16, seed=3)
        xs = (q, k, v, w, u if which == "gla-bonus" else None)
        got = ops.gla(*_t(*xs), chunk=32)
        want = jops.gla(*_j(*xs), chunk=32)
        direct = ref.gla_chunked_ref(*_t(*xs), chunk=16)
    for g, wnt, d in zip(got, want, direct):
        _close(g, wnt)
        assert torch.equal(g, d)


@pytest.mark.parametrize("mode", ["post", "bonus"])
def test_gla_bf16_inputs(mode):
    q, k, v, w, u = _gla_inputs(2, 2, 64, 64, 64, seed=4)
    uu = None if mode == "post" else u
    bf = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    o, s = ops.gla(*bf, torch.from_numpy(w), None if uu is None
                   else torch.from_numpy(uu), chunk=16)
    assert o.dtype == torch.bfloat16 and s.dtype == torch.float32
    jbf = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    o_pal, s_pal = jkernel.gla_pallas(*jbf, jnp.asarray(w), None if uu is None
                                      else jnp.asarray(uu), chunk=16,
                                      interpret=True)
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(o_pal.astype(jnp.float32)), rtol=0,
                               atol=8e-3 * float(np.abs(o_pal).max()))
    _close(s, s_pal)


def test_initial_state_and_steps_match_reference():
    q, k, v, w, u = _gla_inputs(1, 2, 32, 8, 8, seed=5)
    s0 = np.random.default_rng(6).standard_normal((1, 2, 8, 8)).astype(np.float32)
    o1, s1 = ref.gla_chunked_ref(*_t(q, k, v, w, u), chunk=16,
                                 initial_state=torch.from_numpy(s0))
    o2, s2 = jref.gla_chunked_ref(*_j(q, k, v, w, u), chunk=16,
                                  initial_state=jnp.asarray(s0))
    _close(o1, o2)
    _close(s1, s2)
    # T single-token steps give the scan's outputs and final state
    for uu in (None, torch.from_numpy(u)):
        st = torch.zeros((1, 2, 8, 8))
        outs = []
        for t in range(32):
            st, o = ref.gla_step(st, *(torch.from_numpy(x)[:, :, t]
                                       for x in (q, k, v, w)), uu)
            outs.append(o)
        o_scan, s_scan = ref.gla_chunked_ref(*_t(q, k, v, w), uu, chunk=16)
        _close(torch.stack(outs, 2), o_scan)
        _close(st, s_scan)
    qs, ks, vs, a = _ssd_inputs(2, 3, 1, 8, 4, seed=7)
    s0 = np.random.default_rng(8).standard_normal((2, 3, 8, 4)).astype(np.float32)
    got = ref.ssd_step(torch.from_numpy(s0), *_t(qs[:, 0], ks[:, 0],
                                                  vs[:, :, 0], a[:, :, 0]))
    want = jops.ssd_decode_step(jnp.asarray(s0), *_j(qs[:, 0], ks[:, 0],
                                                      vs[:, :, 0], a[:, :, 0]))
    for g, wnt in zip(got, want):
        _close(g, wnt)


def test_wrappers_refuse_off_the_card():
    q, k, v, w, u = _t(*_gla_inputs(1, 1, 16, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.gla_cuda(q, k, v, w, u, chunk=16)
    qs, ks, vs, a = _t(*_ssd_inputs(1, 1, 32, 8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.ssd_cuda(qs, ks, vs, a, chunk=32)
    meta = torch.empty((1, 1, 16, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.gla(meta, meta, meta, meta)


def _scan_shape(arch):
    """(family, heads, head dim, state width, chunk, itemsize) of the
    scan that ``arch``'s recurrent layers run."""
    from repro_torch.configs import get_config
    from repro_torch.models import rwkv, ssm

    cfg = get_config(arch)
    item = torch.empty((), dtype=cfg.compute_dtype).element_size()
    if cfg.family == "ssm":
        h, hd = rwkv._heads(cfg)
        return "gla", h, hd, hd, cfg.ssm_chunk, item
    _, h, hd = ssm._dims(cfg)
    return "ssd", h, hd, cfg.ssm_state, max(cfg.ssm_chunk, 32), 4


# arch, T, (form, chunk, grid, threads, group, shared-memory bytes) at
# B = 256; T = 200 halves the chunk to 8
_PLANS = [
    ("rwkv6-3b", 256, ("tiled", 16, 256 * 40, 128, 1, 52480)),
    ("rwkv6-3b", 200, ("tiled", 8, 256 * 40, 128, 1, 34304)),
    ("rwkv6-3b-smoke", 256, ("tiled", 16, 256, 128, 1, 58624)),
    ("zamba2-1.2b", 256, ("tiled", 32, 256 * 32, 256, 2, 108608)),
    ("zamba2-1.2b", 200, ("tiled", 8, 256 * 32, 256, 2, 50240)),
    ("zamba2-1.2b-smoke", 256, ("generic", 32, 256 * 2, 256, 1, 17024)),
]


@pytest.mark.parametrize("arch,T,want", _PLANS)
def test_launch_plan_of_each_backbone(arch, T, want):
    scan, H, hd, n, chunk, item = _scan_shape(arch)
    chunk = ops._fit_chunk(chunk, T)
    if scan == "gla":
        plan = kernel.gla_plan(256, H, T, hd, hd, chunk, item, True)
        assert plan == kernel.gla_plan(256, H, T, hd, hd, chunk, item, True,
                                       aligned=True, form=None)
    else:
        plan = kernel.ssd_plan(256, H, T, n, hd, chunk)
    assert (plan.form, plan.chunk, plan.grid, plan.threads, plan.group,
            plan.smem) == want
    assert plan.key == f"{scan}:{plan.form}"
    assert plan.smem <= kernel.SMEM_MAX == 232448


@pytest.mark.parametrize("chunk", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("itemsize,bonus", [(2, True), (2, False),
                                            (4, True), (4, False)])
def test_every_tiled_chunk_fits(chunk, itemsize, bonus):
    """Every chunk the tiled forms take, in every dtype and mode, and the
    SSD at G = 1 and 2, fits a block; the generic form takes the same
    shape when asked or when the rows are not 16-byte aligned."""
    g = kernel.gla_plan(2, 3, 64, 64, 64, chunk, itemsize, bonus)
    assert (g.form, g.threads, g.grid) == ("tiled", 128, 6)
    assert g.smem <= kernel.SMEM_MAX
    gen = kernel.gla_plan(2, 3, 64, 64, 64, chunk, itemsize, bonus,
                          form="generic")
    assert (gen.form, gen.threads) == ("generic", 256)
    assert kernel.gla_plan(2, 3, 64, 64, 64, chunk, itemsize, bonus,
                           aligned=False) == gen
    for H, G in ((3, 1), (4, 2)):
        s = kernel.ssd_plan(2, H, 64, 64, 64, chunk)
        assert (s.form, s.group, s.threads, s.grid) == ("tiled", G, 128 * G,
                                                         2 * H // G)
        assert s.smem <= kernel.SMEM_MAX


def test_generic_form_takes_the_other_shapes():
    for Dk, Dv, chunk in ((64, 32, 16), (128, 128, 16), (8, 8, 8),
                          (64, 64, 64), (64, 64, 48)):
        p = kernel.gla_plan(1, 2, 192, Dk, Dv, chunk, 4, False)
        assert p.form == "generic" and p.smem <= kernel.SMEM_MAX
    for N, P in ((8, 64), (16, 32), (64, 128)):
        p = kernel.ssd_plan(1, 2, 64, N, P, 32)
        assert (p.form, p.group) == ("generic", 1)


def test_plans_refuse_what_no_form_takes():
    with pytest.raises(ValueError, match="shared memory"):
        kernel.gla_plan(1, 1, 64, 256, 256, 64, 4, False)
    with pytest.raises(ValueError, match="shared memory"):
        kernel.ssd_plan(1, 1, 128, 256, 256, 128)
    with pytest.raises(ValueError, match="does not take"):
        kernel.gla_plan(1, 1, 64, 32, 32, 16, 2, True, form="tiled")
    with pytest.raises(ValueError, match="does not take"):
        kernel.ssd_plan(1, 2, 64, 64, 64, 64, form="tiled")
    with pytest.raises(ValueError, match="does not take"):
        kernel.gla_plan(1, 1, 64, 64, 64, 16, 2, True, aligned=False,
                        form="tiled")
    with pytest.raises(ValueError, match="multiple"):
        kernel.gla_plan(1, 1, 48, 64, 64, 32, 2, True)
    with pytest.raises(ValueError, match="forms are"):
        kernel.ssd_plan(1, 2, 64, 64, 64, 32, form="fast")
