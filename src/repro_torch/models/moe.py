"""Mixture-of-Experts: a top-k router and capacity-bounded dispatch per
batch row.

The counterpart of the reference's ``models/moe.py``, in plain PyTorch:
the reference computes the router, the dispatch, the experts' SwiGLU
(``einsum`` over the stacked (E, d, ff) weights) and the combine outside
any Pallas kernel, so there is no kernel here either; the expert
products are ``torch.bmm`` over the expert axis (``sharding.bmm``: the
same call on plain tensors).

The reference's semantics, kept exactly:

  * capacity per batch row (a row is one dispatch group):
    C = int(S·k·cf / E) + 1, rounded up to a multiple of 128 when it is
    at least 128 and to a multiple of 8 otherwise (``_capacity``);
  * the router in fp32: softmax, or deepseek-v3's sigmoid (without its
    bias-correction term, as in the reference); the top-k gates
    renormalised with a 1e-9 floor; ``probs`` for the aux loss;
  * dispatch: the row's picks sorted stably by expert; a pick's slot is
    its place among that row's picks of its expert; a pick whose slot is
    C or more is dropped (it adds nothing to its token), as the
    reference's ``mode="drop"`` scatter drops it;
  * combine: each expert output times its gate in the compute dtype,
    summed in the compute dtype per token in the order the sorted picks
    reach it (ascending expert), from 0 — the reference's scatter-add;
    the shared experts and arctic's dense residual MLP added after;
  * the Switch-style load-balance aux loss.

Torch has no ``vmap`` here: the rows are a batch axis of every tensor
and every index stays row-local, so the capacity is per row.  A dropped
pick is written to, and read back from, one spare slot C per (row,
expert) that the experts never see and that reads as zeros, so the
dispatch has no data-dependent shapes (no host sync).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.distributed.sharding import (bmm, constrain, matmul,
                                              rowwise)
from repro_torch.models.params import ParamDef

Tensor = torch.Tensor
_F32 = torch.float32


def moe_schema(cfg: ModelConfig):
    """router (d, E), the experts' wi_gate / wi_up (E, d, ff) and wo
    (E, ff, d); ``shared`` (num_shared_experts x ff wide) and ``dense``
    (arctic's parallel residual MLP) where the config has them."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    ex_in = ("experts", "expert_embed", "expert_ff")
    sch = {"router": ParamDef((d, E), ("embed", "experts"), init="scaled"),
           "wi_gate": ParamDef((E, d, ff), ex_in, init="scaled"),
           "wi_up": ParamDef((E, d, ff), ex_in, init="scaled"),
           "wo": ParamDef((E, ff, d), ("experts", "expert_ff", "expert_embed"),
                          init="scaled")}
    if cfg.num_shared_experts:
        sf = ff * cfg.num_shared_experts
        sch["shared"] = {"wi_gate": ParamDef((d, sf), ("embed", "ff"),
                                             init="scaled"),
                         "wi_up": ParamDef((d, sf), ("embed", "ff"),
                                           init="scaled"),
                         "wo": ParamDef((sf, d), ("ff", "embed"),
                                        init="scaled")}
    if cfg.dense_residual:
        sch["dense"] = {"wi_gate": ParamDef((d, ff), ("embed", "ff"),
                                            init="scaled"),
                        "wi_up": ParamDef((d, ff), ("embed", "ff"),
                                          init="scaled"),
                        "wo": ParamDef((ff, d), ("ff", "embed"),
                                       init="scaled")}
    return sch


def _capacity(cfg: ModelConfig, tokens: int) -> int:
    """Expert capacity of one dispatch group (one batch row) of
    ``tokens`` tokens."""
    c = int(tokens * cfg.experts_per_token * cfg.expert_capacity_factor
            / cfg.num_experts) + 1
    if c >= 128:
        return -(-c // 128) * 128
    return -(-c // 8) * 8


def _dense_swiglu(x: Tensor, p, ct) -> Tensor:
    """A SwiGLU MLP over (..., d) in the compute dtype."""
    g = matmul(x, p["wi_gate"].to(ct))
    u = matmul(x, p["wi_up"].to(ct))
    return matmul(F.silu(g) * u, p["wo"].to(ct))


def router_scores(params, cfg: ModelConfig, x_flat: Tensor
                  ) -> Tuple[Tensor, Tensor, Tensor]:
    """x_flat (T, d) -> (gates (T, k) fp32, idx (T, k), probs (T, E)
    fp32 for the aux loss)."""
    logits = matmul(x_flat.to(_F32), params["router"].to(_F32))
    k = cfg.experts_per_token
    if cfg.router_score == "sigmoid":              # deepseek-v3
        scores = torch.sigmoid(logits)
        gates, idx = torch.topk(scores, k, dim=-1)
        probs = scores / scores.sum(-1, keepdim=True).clamp_min(1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, idx, probs


def dispatch_slots(idx: Tensor, E: int) -> Tensor:
    """idx (B, S, k) expert picks -> slot (B, S, k): each pick's place
    among its row's picks of its expert, in the order a stable sort by
    expert puts them (token order).  A slot of C or more is a drop."""
    B, S, k = idx.shape
    e_flat = idx.reshape(B, S * k)
    order = torch.sort(e_flat, dim=-1, stable=True).indices
    se = e_flat.gather(1, order)
    counts = torch.zeros((B, E), dtype=torch.long, device=idx.device)
    counts.scatter_add_(1, e_flat, torch.ones_like(e_flat))
    start = counts.cumsum(1) - counts
    pos = torch.arange(S * k, device=idx.device).expand(B, S * k)
    slot_sorted = pos - start.gather(1, se)
    return torch.empty_like(e_flat).scatter_(1, order, slot_sorted) \
        .reshape(B, S, k)


def _experts(x: Tensor, params, ct) -> Tensor:
    """The experts' SwiGLU on their slots: x (B, E, C, d) -> (B, E, C,
    d), one ``bmm`` over the expert axis per product; each stacked
    weight cast to the compute dtype per call, as the reference's."""
    B, E, C, d = x.shape
    xe = x.permute(1, 0, 2, 3).reshape(E, B * C, d)
    g = bmm(xe, params["wi_gate"].to(ct))
    u = bmm(xe, params["wi_up"].to(ct))
    h = F.silu(g) * u
    del g, u
    out = bmm(h, params["wo"].to(ct))
    return out.reshape(E, B, C, d).permute(1, 0, 2, 3)


def moe_apply(params, cfg: ModelConfig, x: Tensor,
              stats: Optional[dict] = None, rules=None
              ) -> Tuple[Tensor, Tensor]:
    """x (B, S, d) in the compute dtype -> (out (B, S, d), aux loss
    fp32).  With ``stats``, ``stats["idx"]`` gets the picks (B, S, k) and
    ``stats["kept"]`` whether each was kept (slot < C)."""
    ct = cfg.compute_dtype
    B, S, d = x.shape
    k, E = cfg.experts_per_token, cfg.num_experts
    C = _capacity(cfg, S)
    # the seq dim whole before the row-local dispatch (the reference's
    # one all-gather of (S, d) per layer under sequence parallelism)
    x = constrain(x, ("batch", None, "embed_act"), rules)
    gates, idx, probs = router_scores(params, cfg, x.reshape(B * S, d))
    gates, idx = gates.reshape(B, S, k), idx.reshape(B, S, k)
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return _moe_rowwise(params, cfg, x, gates, idx, probs, rules)
    slot = dispatch_slots(idx, E).clamp_max(C)      # C: the spare slot
    if stats is not None:
        stats["idx"], stats["kept"] = idx, slot < C

    expert_in = constrain(_dispatch(x, idx, slot, E, C, ct),
                          ("batch", "experts", None, "embed_act"), rules)
    out_e = constrain(_experts(expert_in, params, ct),
                      ("batch", "experts", None, "embed_act"), rules)
    del expert_in
    back = torch.cat([out_e, out_e.new_zeros((B, E, 1, d))], 2)
    del out_e

    # per token, its picks in ascending expert order (the order the
    # sorted scatter-add reaches them), each output times its gate in ct
    rows = torch.arange(B, device=x.device)[:, None, None].expand(B, S, k)
    e_tok, perm = torch.sort(idx, dim=-1)
    s_tok = slot.gather(2, perm)
    g_tok = gates.to(ct).gather(2, perm)
    contrib = back[rows, e_tok, s_tok] * g_tok[..., None]
    del back
    out = torch.zeros((B, S, d), dtype=ct, device=x.device)
    for j in range(k):
        out = out + contrib[:, :, j]

    if cfg.num_shared_experts:
        out = out + _dense_swiglu(x, params["shared"], ct)
    if cfg.dense_residual:
        out = out + _dense_swiglu(x, params["dense"], ct)

    frac = torch.zeros(E, dtype=_F32, device=x.device).index_add_(
        0, idx.reshape(-1), torch.full((B * S * k,), 1.0 / (B * S * k),
                                       dtype=_F32, device=x.device))
    aux = E * torch.sum(frac * probs.mean(0)) * cfg.router_aux_loss
    return constrain(out, ("batch", "seq", "embed_act"), rules), aux


def _dispatch(x: Tensor, idx: Tensor, slot: Tensor, E: int, C: int,
              ct) -> Tensor:
    """Rows' tokens into their experts' slots: (B, E, C, d)."""
    B, S, k = idx.shape
    d = x.shape[-1]
    rows = torch.arange(B, device=x.device)[:, None, None].expand(B, S, k)
    buf = x.new_zeros((B, E, C + 1, d), dtype=ct)
    buf[rows, idx, slot] = x.to(ct)[:, :, None, :].expand(B, S, k, d)
    return buf[:, :, :C]


def _combine(out_e: Tensor, idx: Tensor, slot: Tensor, gates: Tensor,
             ct) -> Tensor:
    """The experts' slots back to their rows' tokens, gate-weighted."""
    B, E, _, d = out_e.shape
    S, k = idx.shape[1:]
    back = torch.cat([out_e, out_e.new_zeros((B, E, 1, d))], 2)
    rows = torch.arange(B, device=out_e.device)[:, None, None].expand(B, S,
                                                                      k)
    e_tok, perm = torch.sort(idx, dim=-1)
    contrib = back[rows, e_tok, slot.gather(2, perm)] * \
        gates.to(ct).gather(2, perm)[..., None]
    out = torch.zeros((B, S, d), dtype=ct, device=out_e.device)
    for j in range(k):
        out = out + contrib[:, :, j]
    return out


def _picks(idx: Tensor, E: int) -> Tensor:
    """Per row, each expert's share of all the batch's picks (B, E)."""
    B, S, k = idx.shape
    return torch.zeros((B, E), dtype=_F32, device=idx.device).scatter_add_(
        1, idx.reshape(B, S * k), torch.ones((B, S * k), dtype=_F32,
                                             device=idx.device))


def _moe_rowwise(params, cfg: ModelConfig, x: Tensor, gates: Tensor,
                 idx: Tensor, probs: Tensor, rules) -> Tuple[Tensor, Tensor]:
    """``moe_apply`` on DTensors (a mesh's dry run): the dispatch, the
    combine and the aux loss's pick counts run on each rank's rows
    (``rowwise``), as the reference's row-local dispatch shards; the
    experts' products are DTensor ops."""
    ct = cfg.compute_dtype
    B, S, d = x.shape
    k, E = cfg.experts_per_token, cfg.num_experts
    C = _capacity(cfg, S)
    slot = rowwise(lambda i: dispatch_slots(i, E).clamp_max(C), idx)
    expert_in = constrain(
        rowwise(lambda a, i, sl: _dispatch(a, i, sl, E, C, ct), x, idx, slot),
        ("batch", "experts", None, "embed_act"), rules)
    out_e = constrain(_experts(expert_in, params, ct),
                      ("batch", "experts", None, "embed_act"), rules)
    out = rowwise(lambda o, i, sl, g: _combine(o, i, sl, g, ct), out_e, idx,
                  slot, gates)
    if cfg.num_shared_experts:
        out = out + _dense_swiglu(x, params["shared"], ct)
    if cfg.dense_residual:
        out = out + _dense_swiglu(x, params["dense"], ct)
    frac = rowwise(lambda i: _picks(i, E), idx).sum(0) / (B * S * k)
    aux = E * torch.sum(frac * probs.mean(0)) * cfg.router_aux_loss
    return constrain(out, ("batch", "seq", "embed_act"), rules), aux
