"""ServingPanel: the immutable scoring artifact of one panel version.

A server never scores against a live ``EffectPanel``: it scores against
a prepared snapshot of one estimator column — the per-segment effect
coefficients, their standard errors and the per-segment validity mask,
on the device that scores, stamped with the version they came from.
Preparing it once keeps the hot path free of panel plumbing, and making
it immutable makes a hot-swap atomic: installing a new version is one
reference assignment, and every wave keeps the reference it captured.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.device import DeviceLike

Tensor = torch.Tensor
_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ServingPanel:
    """One servable panel version: column ``column`` of an EffectPanel.

    thetas / ses are (E, pf) per-segment effect coefficients and their
    standard errors; ``ok`` is the (E,) per-segment validity mask
    (zero-row or non-finite cells serve flagged responses, never NaN).
    ``aligned`` carries the store column's ingest regime (None for sweep
    panels); ``version`` is the store / checkpoint version the estimates
    came from.
    """

    thetas: Tensor  # (E, pf)
    ses: Tensor  # (E, pf)
    ok: Tensor  # (E,) bool
    n_features: int  # expected request feature width p
    cate_features: int  # pf of phi(x) (1 => constant effect)
    version: int = 0
    column: str = ""  # estimator name, provenance only
    aligned: Optional[bool] = None

    @property
    def n_segments(self) -> int:
        """Number of segments E this panel serves."""
        return int(self.thetas.shape[0])

    @property
    def device(self) -> torch.device:
        """Where the panel's tensors live (and its waves are scored)."""
        return self.thetas.device

    @classmethod
    def from_effect_panel(cls, panel, *, n_features: int, column: int = 0,
                          version: int = 0,
                          device: DeviceLike = None) -> "ServingPanel":
        """Prepare column ``column`` of ``panel`` for serving, on
        ``device`` (default: where the column's thetas are).  Fails
        loudly on a failed column: a server must not serve a column that
        carries no estimates."""
        col = panel.columns[column]
        if col.failed or col.thetas is None:
            raise ValueError(
                f"serve: column {column} ({col.estimator!r}) failed and "
                f"carries no estimates: {col.error}")
        dev = torch.device(device) if device is not None \
            else col.thetas.device
        thetas = col.thetas.to(device=dev, dtype=_F32).contiguous()
        ses = (col.ses.to(device=dev, dtype=_F32).contiguous()
               if col.ses is not None else torch.zeros_like(thetas))
        return cls(thetas=thetas, ses=ses,
                   ok=col.ok(panel.counts).to(dev),
                   n_features=int(n_features),
                   cate_features=int(thetas.shape[1]), version=int(version),
                   column=col.estimator, aligned=col.aligned)


def panel_from_checkpoint(manager, spec, n_features: int, *, seed: int = 0,
                          column: int = 0, step: Optional[int] = None,
                          store=None, tracer=None,
                          device: DeviceLike = None) -> ServingPanel:
    """Load a servable panel version from a ``MomentStore`` snapshot.

    Builds a store shell for ``spec`` (or reuses ``store``), restores
    snapshot ``step`` (latest if None) through the port's
    ``CheckpointManager`` — with the store's provenance checks, so a
    snapshot of another column set or feature width fails loudly — then
    refreshes and prepares column ``column``.  This is the ingest →
    refresh → serve edge of the daily-refresh workload.
    """
    from repro_torch.store import MomentStore

    if store is None:
        store = MomentStore(spec, n_features, seed=seed, tracer=tracer,
                            device=device)
    store.restore(manager, step=step)
    return ServingPanel.from_effect_panel(store.refresh(),
                                          n_features=n_features,
                                          column=column,
                                          version=store.version)
