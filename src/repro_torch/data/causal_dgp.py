"""Synthetic causal data — the paper's §5.3 setup, drawn on a
``torch.Generator``.

Partially-linear DGPs with known ground truth, so estimator runs can
assert ATE/CATE recovery.  torch cannot replay the JAX package's
random streams: the port's draws agree with the reference in
distribution, not value (parity tests hand the reference's data over
through ``repro_torch.convert``).  Draws are made on the generator's
device — a CUDA generator makes the data on the card, in bulk.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.device import DeviceLike, resolve_device

Tensor = torch.Tensor
_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class CausalData:
    """One synthetic observational study with known ground truth."""

    X: Tensor             # (n, p) confounders
    t: Tensor             # (n,) treatment
    y: Tensor             # (n,) outcome
    true_ate: float
    true_cate: Tensor     # (n,) theta(x_i)
    propensity: Tensor    # (n,) P(T=1|X)

    @property
    def n(self) -> int:
        """Rows."""
        return self.X.shape[0]

    @property
    def p(self) -> int:
        """Covariates."""
        return self.X.shape[1]


def _generator(gen: Optional[torch.Generator], seed: int,
               device: torch.device) -> torch.Generator:
    if gen is not None:
        return gen
    return torch.Generator(device=device).manual_seed(seed)


def make_causal_data(n: int, p: int, *, seed: int = 0,
                     gen: Optional[torch.Generator] = None,
                     device: DeviceLike = None,
                     discrete_treatment: bool = True,
                     heterogeneous: bool = False, effect: float = 1.0,
                     confounding_strength: float = 1.0, noise: float = 1.0,
                     n_effect_modifiers: int = 1) -> CausalData:
    """X ~ N(0, I_p); T ~ Bern(sigmoid(c·<a, X>)) (or continuous);
    theta(x) = effect (· (1 + 0.5·Σ x_modifiers)); Y = theta·T + <b, X> +
    eps.  The first min(p, 10) covariates confound."""
    dev = resolve_device(device)
    g = _generator(gen, seed, dev)
    X = torch.randn((n, p), generator=g, device=dev, dtype=_F32)
    live = min(p, 10)
    a = torch.zeros(p, device=dev, dtype=_F32)
    a[:live] = torch.randn(live, generator=g, device=dev) / live ** 0.5
    b = torch.zeros(p, device=dev, dtype=_F32)
    b[:live] = torch.randn(live, generator=g, device=dev)
    logits = confounding_strength * (X @ a)
    prop = torch.sigmoid(logits)
    if discrete_treatment:
        t = torch.bernoulli(prop, generator=g)
    else:
        t = logits + torch.randn(n, generator=g, device=dev)
    if heterogeneous:
        cate = effect * (1.0 + 0.5 * X[:, :n_effect_modifiers].sum(-1))
    else:
        cate = torch.full((n,), effect, device=dev, dtype=_F32)
    y = cate * t + X @ b + noise * torch.randn(n, generator=g, device=dev)
    true_ate = float(effect) if not heterogeneous else float(cate.mean())
    return CausalData(X=X, t=t, y=y, true_ate=true_ate, true_cate=cate,
                      propensity=prop)


def make_sharded_causal_data(n: int, p: int, n_shards: int, shard: int, *,
                             seed: int = 0, device: DeviceLike = None,
                             **kw) -> CausalData:
    """Rows of one shard: ``make_causal_data(n // n_shards, p)`` on a
    generator seeded from (seed, shard) alone (splitmix64, the port's
    stand-in for the reference's ``fold_in``), so each host makes its
    rows without the others' and the union over shards is one
    deterministic data set.  As in the reference, each shard also draws
    its own confounding coefficients."""
    from repro_torch.inference.bootstrap import derive_seed

    if n % n_shards:
        raise ValueError(f"{n} rows do not split into {n_shards} shards")
    if not 0 <= shard < n_shards:
        raise ValueError(f"shard {shard} is not in [0, {n_shards})")
    return make_causal_data(n // n_shards, p, seed=derive_seed(seed, shard),
                            device=device, **kw)


def paper_demo_data(n: int = 100_000, p: int = 500, *, seed: int = 0,
                    gen: Optional[torch.Generator] = None,
                    device: DeviceLike = None) -> CausalData:
    """The §5.1 listing: y = (1 + .5·x0)·T + x0 + N(0,1),
    T ~ Bern(expit(x0)), X ~ N(0, I_p)."""
    dev = resolve_device(device)
    g = _generator(gen, seed, dev)
    X = torch.randn((n, p), generator=g, device=dev, dtype=_F32)
    prop = torch.sigmoid(X[:, 0])
    t = torch.bernoulli(prop, generator=g)
    cate = 1.0 + 0.5 * X[:, 0]
    y = cate * t + X[:, 0] + torch.randn(n, generator=g, device=dev)
    return CausalData(X=X, t=t, y=y, true_ate=1.0, true_cate=cate,
                      propensity=prop)


@dataclasses.dataclass(frozen=True)
class IVData:
    """One synthetic IV study with known LATE (core/iv.py's target).

    Binary-instrument design: Z ~ Bern(sigmoid(c·<a, X>)); complier
    status C ~ Bern(compliance), independent of X and of the unobserved
    confounder U, so LATE = E[θ(X)]; compliers take T = Z, the others
    T = Bern(sigmoid(γ·U)) — driven by the confounder, which biases the
    naive estimate.  Y = θ(X)·T + <b, X> + γ·U + ε."""

    X: Tensor             # (n, p) observed covariates
    z: Tensor             # (n,) instrument
    t: Tensor             # (n,) treatment
    y: Tensor             # (n,) outcome
    true_late: float
    true_cate: Tensor     # (n,) θ(x_i)
    complier: Tensor      # (n,) complier indicator
    instrument_propensity: Tensor   # (n,) P(Z=1|X)

    @property
    def n(self) -> int:
        """Rows."""
        return self.X.shape[0]

    @property
    def p(self) -> int:
        """Covariates."""
        return self.X.shape[1]


def make_iv_data(n: int, p: int, *, seed: int = 0,
                 gen: Optional[torch.Generator] = None,
                 device: DeviceLike = None, effect: float = 1.0,
                 compliance: float = 0.7, heterogeneous: bool = False,
                 confounding_strength: float = 1.0,
                 instrument_strength: float = 1.0, noise: float = 1.0,
                 discrete_instrument: bool = True,
                 n_effect_modifiers: int = 1) -> IVData:
    """The reference's compliance IV design, drawn on a generator: the
    same distribution, other numbers.

    discrete_instrument=True   binary Z and T as documented on IVData;
    discrete_instrument=False  Z = <a, X> + N(0, 1), continuous
                               T = compliance·Z + γ·U + ν, whose 2SLS
                               estimand is E[θ(X)].
    """
    dev = resolve_device(device)
    g = _generator(gen, seed, dev)
    X = torch.randn((n, p), generator=g, device=dev, dtype=_F32)
    live = min(p, 10)
    a = torch.zeros(p, device=dev, dtype=_F32)
    a[:live] = torch.randn(live, generator=g, device=dev) / live ** 0.5
    b = torch.zeros(p, device=dev, dtype=_F32)
    b[:live] = torch.randn(live, generator=g, device=dev)
    U = torch.randn(n, generator=g, device=dev)            # unobserved
    if heterogeneous:
        cate = effect * (1.0 + 0.5 * X[:, :n_effect_modifiers].sum(-1))
    else:
        cate = torch.full((n,), effect, device=dev, dtype=_F32)
    if discrete_instrument:
        prop_z = torch.sigmoid(instrument_strength * (X @ a))
        z = torch.bernoulli(prop_z, generator=g)
        complier = torch.bernoulli(torch.full((n,), compliance, device=dev),
                                   generator=g)
        d_nc = torch.bernoulli(torch.sigmoid(confounding_strength * U),
                               generator=g)
        t = complier * z + (1.0 - complier) * d_nc
    else:
        z = X @ a + torch.randn(n, generator=g, device=dev)
        prop_z = torch.zeros(n, device=dev, dtype=_F32)
        complier = torch.ones(n, device=dev, dtype=_F32)
        t = (compliance * z + confounding_strength * U
             + torch.randn(n, generator=g, device=dev))
    # C independent of (X, U): LATE = E[θ(X) | C=1] = E[θ(X)]
    true_late = float(effect) if not heterogeneous else float(cate.mean())
    eps = noise * torch.randn(n, generator=g, device=dev)
    y = cate * t + X @ b + confounding_strength * U + eps
    return IVData(X=X, z=z, t=t, y=y, true_late=true_late, true_cate=cate,
                  complier=complier, instrument_propensity=prop_z)
