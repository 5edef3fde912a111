"""Gradient compression for data-parallel reductions, with error
feedback (the reference's ``optim/compression.py``).

Gradients are quantized to bf16 or int8 (one absmax scale a tensor)
before the reduction and dequantized after, halving or quartering the
bytes on the wire; the residual g - dequant(quant(g)) is carried as
error feedback, so the compression's bias vanishes over steps
(Karimireddy et al., 2019).  ``compress_decompress`` is the round trip a
receiver reconstructs (``launch/train.py`` applies it to every gradient
when ``gradient_compression`` is set); ``compressed_psum_mean`` is the
mean over a ``torch.distributed`` group, the data mesh's, which takes
the place of the reference's ``axis_name``.  Trees are nested dicts of
tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.pytree import tree_map

Tensor = torch.Tensor
_F32 = torch.float32
METHODS = ("none", "bf16", "int8")


@dataclasses.dataclass
class ErrorFeedback:
    residual: Any  # a tree like the gradients, fp32


def ef_init(grads_like) -> ErrorFeedback:
    """Zero residuals shaped like ``grads_like``."""
    return ErrorFeedback(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=_F32, device=g.device),
        grads_like))


def _quant_one(g: Tensor, method: str) -> Tuple[Tensor, Tensor]:
    """(payload, scale): the payload is what crosses the wire."""
    g32 = g.to(_F32)
    if method == "bf16":
        return g32.to(torch.bfloat16), torch.ones((), dtype=_F32,
                                                   device=g.device)
    if method == "int8":
        absmax = torch.clamp(g32.abs().max(), min=1e-12)
        scale = absmax / 127.0
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        return q, scale
    raise ValueError(f"gradient compression {method!r} not in {METHODS}")


def _dequant_one(q: Tensor, scale: Tensor) -> Tensor:
    return q.to(_F32) * scale


def compress_decompress(g: Tensor, method: str) -> Tensor:
    """``g`` through the compressed representation and back, in fp32;
    only the cast for ``method == "none"``."""
    if method == "none":
        return g.to(_F32)
    return _dequant_one(*_quant_one(g, method))


def compressed_psum_mean(grads, group=None, method: str = "none",
                         ef: Optional[ErrorFeedback] = None
                         ) -> Tuple[Any, Optional[ErrorFeedback]]:
    """The mean of ``grads`` over the ranks of ``group`` (the default
    group if None), each rank's payload quantized by ``method``.  With
    ``ef``, the rank's residual is added before quantizing and the new
    residual (staying on the rank) returned; else (mean, None).  int8's
    scale is per tensor and rank, so the dequantized payloads are
    summed."""
    n = dist.get_world_size(group)

    def one(g, r):
        g32 = g.to(_F32) / n
        if ef is not None:
            g32 = g32 + r
        if method == "none":
            out = g32.clone()
            dist.all_reduce(out, group=group)
            return out, torch.zeros_like(g32)
        sent = _dequant_one(*_quant_one(g32, method))
        new_r = g32 - sent
        dist.all_reduce(sent, group=group)
        return sent, new_r

    res = ef.residual if ef is not None else tree_map(
        lambda g: torch.zeros(g.shape, dtype=_F32, device=g.device), grads)
    pairs = tree_map(one, grads, res)
    return _pick(pairs, 0), (ErrorFeedback(residual=_pick(pairs, 1))
                             if ef is not None else None)


def _pick(tree, i: int):
    """Element ``i`` of every (out, residual) leaf pair of ``tree``."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
