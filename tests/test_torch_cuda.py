"""Tests of the port that need the CUDA card (marked ``cuda``; they skip
without one).  This file imports neither jax nor the JAX package, so it
runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

The CUDA kernel against its plain version for the four main-path
builders (one segment, k-fold batch, three segments), and the DML fit on
the card against the same fit on the CPU.  Tolerance: 1e-5·max|G| on
Grams (fp32 row sums in another order), 1e-4 relative on theta.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.seg_gram import ops, ref  # noqa: E402

_N, _P, _S = 3001, 7, 3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(dev):
    g = torch.Generator().manual_seed(0)
    r = {k: torch.randn((_N, 1), generator=g) for k in ("y", "t", "my", "mt")}
    r["phi"] = torch.randn((_N, _P), generator=g)
    r["D"] = torch.randn((_N, _P), generator=g)
    r["W"] = torch.rand((4, _N), generator=g)
    r["w"] = torch.rand((_N, 1), generator=g)
    r["theta"] = torch.randn((1, _P), generator=g)
    r["seg"] = torch.randint(-1, _S, (_N,), generator=g)
    return {k: v.to(dev) for k, v in r.items()}


def _close(got, want):
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["design", "gram_and_vec", "residual",
                                  "residual_meat"])
def test_kernel_matches_plain(card, name):
    a = _inputs(card)
    col = {"design": [a["D"]],
           "gram_and_vec": [a["D"], a["W"][..., None],
                            (0.5 * a["W"])[..., None]],
           "residual": [a["y"], a["t"], a["my"], a["mt"], a["phi"]],
           "residual_meat": [a["y"], a["t"], a["my"], a["mt"], a["phi"],
                             a["theta"], a["w"]]}[name]
    builder = getattr(ref, f"build_{name}")
    cases = [{}, dict(seg=a["seg"], n_segments=_S)]
    if name != "gram_and_vec":
        cases.append(dict(w=a["W"]))
    for kw in cases:
        got = ops.seg_reduce(builder, col, **kw)
        want = ops.seg_reduce(builder, [c.cpu() for c in col],
                              **{k: v.cpu() if torch.is_tensor(v) else v
                                 for k, v in kw.items()})
        assert got.shape == want.shape
        _close(got, want)


@pytest.mark.cuda
def test_fit_on_card_matches_cpu(card):
    from repro_torch.config import CausalConfig
    from repro_torch.core.dml import DML
    from repro_torch.data.causal_dgp import paper_demo_data

    d = paper_demo_data(n=4000, p=10, seed=2, device="cpu")
    cfg = CausalConfig(cate_features=2, inference="jackknife", row_block=512,
                       row_block_strategy="pallas")
    out = [DML(cfg, device=dev).fit(d.y, d.t, d.X,
                                    gen=torch.Generator().manual_seed(1))
           for dev in ("cpu", card)]
    np.testing.assert_allclose(out[1].theta.cpu().numpy(),
                               out[0].theta.numpy(), rtol=1e-4)
