"""Nuisance models for Double-ML (m_y = E[Y|X], m_t = E[T|X]).

Each model is a triple of plain functions (init / fit / predict) with a
sample-weight argument.  The weight may carry a leading batch axis: with
``w`` of shape (k, n) — fold-complement masks — one ``fit`` call trains
all k fold models at once, the state gaining a leading k, and every
Gram of the fit is one fold-batched kernel launch.  This is how the
"parallel" cross-fit engine writes out the fold axis the JAX package
vmaps.

Closed-form ridge and Newton logistic are the main path.  The ``mlp``
kind trains a GELU MLP by full-batch AdamW for a fixed step count; with
a batched state it trains every model of the batch in one loop, each
model's forward and backward on its own (so a model's numbers do not
depend on the batch it sits in).  The ``backbone`` kind puts the linear
heads over features pooled by a frozen LM backbone
(``backbone_features``: the Dream11 scenario, paper §4).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import CausalConfig, TrainConfig
from repro_torch.core import moments
from repro_torch.distributed.sharding import matmul, per_shard, row_sum
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.pytree import tree_map

Tensor = torch.Tensor
_F32 = torch.float32


@dataclasses.dataclass(frozen=True, eq=False)
class Nuisance:
    """Plain-function model bundle.

    init(gen, p, device)    -> state   (gen: torch.Generator or None)
    fit(state, X, y, w)     -> state   (w: (n,) or fold-batched (k, n))
    predict(state, X)       -> (n,) or (k, n)

    ``hyper`` exposes the scalar hyper-parameters baked into the
    closures."""

    name: str
    task: str  # "reg" | "clf"
    init: Callable[..., Dict[str, Tensor]]
    fit: Callable[[Dict[str, Tensor], Tensor, Tensor, Tensor], Dict[str, Tensor]]
    predict: Callable[[Dict[str, Tensor], Tensor], Tensor]
    hyper: Optional[Dict[str, Any]] = None


def _aug(X: Tensor) -> Tensor:
    """Append the intercept column (laid out as X's rows)."""
    return torch.cat([X, torch.ones_like(X[:, :1])], dim=1)


def _linear(state: Dict[str, Tensor], X: Tensor) -> Tensor:
    """``[X | 1] @ beta``: (n,) for beta (q,), (k, n) for beta (k, q)."""
    beta = state["beta"]
    Xa = _aug(X.to(_F32))
    return Xa @ beta if beta.dim() == 1 else matmul(Xa, beta.T).T


def _eye(q: int, like: Tensor) -> Tensor:
    return torch.eye(q, dtype=_F32, device=like.device)


def _init_linear(lam: float):
    def init(gen: Optional[torch.Generator], p: int, device=None):
        return {"beta": torch.zeros((p + 1,), dtype=_F32, device=device),
                "lam": torch.tensor(lam, dtype=_F32, device=device)}
    return init


# ---------------------------------------------------------------------------
# Ridge regression (closed form — one Gram + solve)
# ---------------------------------------------------------------------------

def make_ridge(lam: float = 1e-3, row_block: int = 0,
               strategy: Optional[str] = None) -> Nuisance:
    """Weighted ridge: one augmented Gram ``[X | 1 | y]`` and a solve."""

    def fit(state, X, y, w):
        q = X.shape[1] + 1
        Gaug, n_eff = moments.weighted_gram(X, w, intercept=True, append=y,
                                            row_block=row_block,
                                            strategy=strategy)
        n_eff = torch.clamp(n_eff, min=1.0)
        lam_ = state["lam"]
        A = Gaug[..., :q, :q] / n_eff[..., None, None] \
            + lam_[..., None, None] * _eye(q, Gaug)
        rhs = Gaug[..., :q, q] / n_eff[..., None]
        beta = torch.linalg.solve(A, rhs[..., None])[..., 0]
        return {**state, "beta": beta}

    return Nuisance("ridge", "reg", _init_linear(lam), fit, _linear,
                    hyper={"lam": lam, "row_block": row_block,
                           "strategy": strategy})


# ---------------------------------------------------------------------------
# Logistic regression via Newton/IRLS (fixed iteration count)
# ---------------------------------------------------------------------------

def make_logistic(lam: float = 1e-3, iters: int = 16, row_block: int = 0,
                  strategy: Optional[str] = None) -> Nuisance:
    """Weighted ridge-penalized logistic regression, ``iters`` Newton
    steps from zero; each step is ONE Gram-and-vector pass over X."""

    def fit(state, X, y, w):
        Xf = X.to(_F32)
        ws = w.to(_F32)
        yt = y.to(_F32)
        q = X.shape[1] + 1
        n_eff = torch.clamp(row_sum(lambda v: v.sum(-1), ws), min=1.0)
        lam_ = state["lam"]
        lam_eye = lam_[..., None, None] * _eye(q, Xf)
        beta = state["beta"]
        for _ in range(iters):
            mu = torch.sigmoid(_linear({"beta": beta}, Xf))
            s = torch.clamp(mu * (1 - mu), min=1e-6) * ws
            # Hessian + gradient in ONE weighted-moments pass over X
            H, g_raw, _ = moments.weighted_gram_and_vec(
                Xf, s, ws * (mu - yt), intercept=True,
                row_block=row_block, strategy=strategy)
            g = g_raw / n_eff[..., None] + lam_[..., None] * beta
            A = H / n_eff[..., None, None] + lam_eye
            beta = beta - torch.linalg.solve(A, g[..., None])[..., 0]
        return {**state, "beta": beta}

    def predict(state, X):
        return torch.sigmoid(_linear(state, X))

    return Nuisance("logistic", "clf", _init_linear(lam), fit, predict,
                    hyper={"lam": lam, "iters": iters,
                           "row_block": row_block, "strategy": strategy})


# ---------------------------------------------------------------------------
# MLP (full-batch AdamW for a fixed step count)
# ---------------------------------------------------------------------------

def _mlp_init(gen: Optional[torch.Generator], sizes, device=None
              ) -> Dict[str, Tensor]:
    """N(0, 1/fan_in) weights drawn on ``gen`` (default: a CPU generator
    seeded 0), zero biases."""
    gen = gen if gen is not None else torch.Generator().manual_seed(0)
    params = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        w = torch.randn((a, b), generator=gen, device=gen.device, dtype=_F32)
        params[f"w{i}"] = (w / math.sqrt(a)).to(device)
        params[f"b{i}"] = torch.zeros((b,), dtype=_F32, device=device)
    return params


def _mlp_forward(params: Dict[str, Tensor], X: Tensor, n_layers: int
                 ) -> Tensor:
    """One model's (n,) output; GELU is the tanh form, as ``jax.nn.gelu``."""
    h = X
    for i in range(n_layers):
        h = h @ params[f"w{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            h = F.gelu(h, approximate="tanh")
    return h[..., 0]


def make_mlp(task: str, hidden: Tuple[int, ...] = (256, 256),
             steps: int = 200, lr: float = 1e-3, wd: float = 1e-4
             ) -> Nuisance:
    """A GELU MLP trained by ``steps`` full-batch AdamW steps
    (``TrainConfig``'s b1 / b2, clip 1.0) on the weighted mean loss —
    squared error for "reg", log-loss on the logit for "clf" — from the
    state ``init`` draws.  An ``"lr"`` state leaf overrides the rate
    (scalar, or one per model of a batch), so tuning sweeps it as data.

    ``fit`` takes w (n,), or (…, n) with a state of the same leading
    axes (an unbatched state is copied to each); y may carry the same
    leading axes.  The gradients are taken by ``torch.autograd.grad``
    over the batched parameters, each model's loss built from its own
    slice of them."""
    tcfg = TrainConfig(learning_rate=lr, weight_decay=wd, grad_clip=1.0)
    n_layers = len(hidden) + 1

    def init(gen, p, device=None):
        params = _mlp_init(gen, (p,) + tuple(hidden) + (1,), device)
        return {"params": params, "opt": adamw_init(params)}

    def loss_fn(params, X, y, w):
        out = _mlp_forward(params, X, n_layers)
        if task == "clf":
            per = (torch.clamp(out, min=0) - out * y
                   + torch.log1p(torch.exp(-torch.abs(out))))
        else:
            per = 0.5 * torch.square(out - y)
        return torch.sum(per * w) / torch.clamp(w.sum(), min=1.0)

    def grads(params, X, y, w):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        models = {k: v.unbind(0) for k, v in leaves.items()}
        total = None
        for b in range(w.shape[0]):
            loss = loss_fn({k: v[b] for k, v in models.items()}, X, y[b],
                           w[b])
            total = loss if total is None else total + loss
        g = torch.autograd.grad(total, list(leaves.values()))
        return dict(zip(leaves, g))

    def fit(state, X, y, w):
        Xf, yf, wf = X.to(_F32), y.to(_F32), w.to(_F32)
        lead = tuple(wf.shape[:-1])
        params, opt = state["params"], state["opt"]
        lr_t = torch.as_tensor(state.get("lr", lr), dtype=_F32,
                               device=Xf.device)
        if params["w0"].dim() == 2:        # one init for every model
            params, opt = tree_map(
                lambda x: x.expand(lead + tuple(x.shape)).clone(),
                (params, opt))
        # one leading model axis (a single model is a batch of one)
        params, opt = tree_map(
            lambda x: x.reshape((-1,) + tuple(x.shape[len(lead):])),
            (params, opt))
        if lr_t.dim():
            lr_t = lr_t.reshape(-1)
        W = wf.reshape(-1, wf.shape[-1])
        Y = yf.expand(lead + (yf.shape[-1],)).reshape(W.shape)
        with torch.enable_grad():
            for _ in range(steps):
                g = grads(params, Xf, Y, W)
                params, opt, _ = adamw_update(g, opt, params, lr_t, tcfg,
                                              batch_dims=1)
        return tree_map(lambda x: x.reshape(lead + tuple(x.shape[1:])),
                        {"params": params, "opt": opt})

    def predict(state, X):
        params = state["params"]
        Xf = X.to(_F32)
        lead = tuple(params["w0"].shape[:-2])
        flat = {k: v.reshape((-1,) + tuple(v.shape[len(lead):]))
                for k, v in params.items()}
        rows = []
        for b in range(flat["w0"].shape[0]):
            out = _mlp_forward({k: v[b] for k, v in flat.items()}, Xf,
                               n_layers)
            rows.append(torch.sigmoid(out) if task == "clf" else out)
        preds = torch.stack(rows)
        return preds.reshape(lead + (Xf.shape[0],))

    return Nuisance(f"mlp_{task}", task, init, fit, predict,
                    hyper={"hidden": hidden, "steps": steps, "lr": lr})


def make_nuisance(kind: str, task: str, cfg: CausalConfig) -> Nuisance:
    """Nuisance factory from a CausalConfig."""
    rb, st = cfg.row_block, cfg.row_block_strategy
    if kind == "ridge":
        return make_ridge(cfg.ridge_lambda, row_block=rb, strategy=st)
    if kind == "logistic":
        return make_logistic(cfg.ridge_lambda, cfg.newton_iters,
                             row_block=rb, strategy=st)
    if kind == "mlp":
        return make_mlp(task, cfg.mlp_hidden, cfg.mlp_steps, cfg.mlp_lr)
    if kind == "backbone":
        # heads over precomputed backbone features; the same linear math
        if task == "clf":
            return make_logistic(cfg.ridge_lambda, cfg.newton_iters,
                                 row_block=rb, strategy=st)
        return make_ridge(cfg.ridge_lambda, row_block=rb, strategy=st)
    raise ValueError(f"unknown nuisance kind {kind!r}")


# ---------------------------------------------------------------------------
# LM-backbone features (the Dream11 scenario: event-sequence confounders)
# ---------------------------------------------------------------------------

def backbone_features(model, tokens: Tensor, batch_size: int = 0,
                      extras: Optional[Dict[str, Tensor]] = None) -> Tensor:
    """Pooled (n, d_model) fp32 features of ``model``
    (``repro_torch.models.model.Model``) over (n, S) user event
    sequences, ``batch_size`` sequences per forward (0: all at once).
    ``extras`` (whisper's ``frames``, pixtral's ``patch_embeds``, n rows
    each) are sliced with the tokens.  The backbone is frozen; nuisance
    heads (ridge / logistic) are cross-fit on top."""
    extras = extras or {}
    if not batch_size or tokens.shape[0] <= batch_size:
        return model.features(tokens, **extras)
    return torch.cat([
        model.features(tokens[i:i + batch_size],
                       **{k: v[i:i + batch_size] for k, v in extras.items()})
        for i in range(0, tokens.shape[0], batch_size)], dim=0)


# ---------------------------------------------------------------------------
# Fold-batched fast paths: the leave-one-out Gram identity
#
#       Xᵀ diag(w_k) X  =  G_total - G_heldout_k
#
# turns the k complement-weighted Grams of cross-fitting into ONE
# fold-segmented pass over X.  Ridge stays exact; logistic takes the
# Böhning-Lindsay fixed majorizer H0 = XᵀX/4 + λI, factored once.
# ---------------------------------------------------------------------------

def _fold_grams(Xa: Tensor, folds: Tensor, k: int, row_block: int = 0,
                strategy: Optional[str] = None):
    """(G_heldout (k, q, q), G_total (q, q)) from one segmented pass."""
    Gh, _ = moments.fold_gram(Xa, folds, k, row_block=row_block,
                              strategy=strategy)
    return Gh, Gh.sum(0)


def ridge_fit_folds(lam: float, X: Tensor, y: Tensor, folds: Tensor, k: int,
                    row_block: int = 0, strategy: Optional[str] = None):
    """Exact per-fold ridge via the LOO identity; one pass over X."""
    n, p = X.shape[0], X.shape[1] + 1
    Gh_aug, counts = moments.fold_gram(X, folds, k, intercept=True, append=y,
                                       row_block=row_block,
                                       strategy=strategy)
    G_aug = Gh_aug.sum(0)
    Gh, G = Gh_aug[:, :p, :p], G_aug[:p, :p]
    bh, b_tot = Gh_aug[:, :p, p], G_aug[:p, p]
    n_eff = torch.clamp(n - counts, min=1.0)[:, None, None]
    A = (G[None] - Gh) / n_eff + lam * _eye(p, G)[None]
    rhs = (b_tot[None] - bh) / n_eff[..., 0]
    beta = torch.linalg.solve(A, rhs[..., None])[..., 0]        # (k, p)
    return {"beta": beta, "lam": torch.full((k,), lam, dtype=_F32,
                                            device=X.device)}


def logistic_fit_folds(lam: float, iters: int, X: Tensor, t: Tensor,
                       folds: Tensor, k: int, row_block: int = 0,
                       strategy: Optional[str] = None):
    """Per-fold logistic by fixed-Hessian majorization: H0_k factored
    once, then ``iters`` MM steps of two mat-vecs each."""
    Xa = _aug(X.to(_F32))
    n, p = Xa.shape
    Gh, G = _fold_grams(Xa, folds, k, row_block=row_block, strategy=strategy)
    ids = torch.arange(k, device=folds.device, dtype=folds.dtype)
    onehot = per_shard(lambda f: (f[:, None] == ids[None, :]).to(_F32),
                       folds, out_dim=0)                        # (n, k)
    w = 1.0 - onehot                                            # train weights
    n_eff = torch.clamp(n - row_sum(lambda o: o.sum(0), onehot), min=1.0)
    H0 = (G[None] - Gh) / (4.0 * n_eff[:, None, None]) \
        + lam * _eye(p, G)[None]
    LU, piv = torch.linalg.lu_factor(H0)
    tt = t.to(_F32)
    beta = torch.zeros((k, p), dtype=_F32, device=X.device)
    for _ in range(iters):
        mu = torch.sigmoid(matmul(Xa, beta.T))                 # (n, k)
        r = w * (mu - tt[:, None])
        g = row_sum(lambda r, Xa: r.T @ Xa, r, Xa) / n_eff[:, None] \
            + lam * beta                                        # (k, p)
        beta = beta - torch.linalg.lu_solve(LU, piv, g[..., None])[..., 0]
    return {"beta": beta, "lam": torch.full((k,), lam, dtype=_F32,
                                            device=X.device)}
