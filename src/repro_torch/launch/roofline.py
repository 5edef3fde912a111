"""Roofline of a step from its per-device cost (the reference's
``launch/roofline.py``).

Three terms, all PER DEVICE (``launch/op_cost.count`` counts the local
ops of each rank):

    compute    = flops / peak_flops            [s]
    memory     = hbm_bytes / hbm_bw            [s]
    collective = wire_bytes / link_bw          [s]

``wire_bytes(op, size, group)`` is the ring algorithm's bytes on a
device's links for one collective (G = group size, S = the payload):

    all-reduce          2·S·(G-1)/G      (reduce-scatter + all-gather)
    all-gather          S_out·(G-1)/G
    reduce-scatter      S_out·(G-1)      (input = S_out·G)
    all-to-all          S·(G-1)/G
    collective-permute  S

Hardware model: the NVIDIA H100 SXM — 989 TFLOP/s dense bf16 and
3.35 TB/s of HBM3 (``obs/audit.py``, the data sheet), NVLink 4 at
450 GB/s a direction per GPU (the data sheet's 900 GB/s in total).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.obs.audit import HBM_BW, PEAK_FLOPS_BF16

PEAK_FLOPS = PEAK_FLOPS_BF16   # FLOP / s, dense bf16 tensor cores
LINK_BW = 450e9                # bytes / s, NVLink 4, one direction

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def wire_bytes(op: str, size: float, group: int) -> float:
    """Bytes one device puts on its links for collective ``op`` of
    payload ``size`` bytes (the output for all-gather / reduce-scatter)
    over a group of ``group`` devices."""
    g = max(int(group), 1)
    ring = (g - 1) / g
    if op == "all-reduce":
        return 2 * size * ring
    if op == "reduce-scatter":
        return size * (g - 1)
    if op == "collective-permute":
        return float(size)
    if op in ("all-gather", "all-to-all"):
        return size * ring
    raise ValueError(f"unknown collective {op!r}; known: {COLLECTIVES}")


@dataclasses.dataclass
class Roofline:
    flops: float            # per device
    hbm_bytes: float        # per device
    wire_bytes: float       # per device
    model_flops: float      # analytic 6ND/2ND (global)
    chips: int
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    link_bw: float = LINK_BW

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.wire_bytes / self.link_bw

    @property
    def bottleneck(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def step_time(self) -> float:
        """Lower bound assuming perfect overlap: max of the three."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_frac(self) -> float:
        """MODEL_FLOPS / (chips · counted flops): how much counted
        compute is 'useful' (catches remat/redundancy waste)."""
        tot = self.flops * self.chips
        return self.model_flops / tot if tot else 0.0

    @property
    def mfu_bound(self) -> float:
        """Useful model FLOPs per chip-second at the step-time lower
        bound, vs peak."""
        t = self.step_time
        if t <= 0:
            return 0.0
        return self.model_flops / (self.chips * t) / self.peak_flops

    def row(self) -> Dict[str, float]:
        return {
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck, "step_time": self.step_time,
            "useful_frac": self.useful_flops_frac,
            "mfu_bound": self.mfu_bound,
        }


def model_flops_for(cfg, shape) -> float:
    """Analytic MODEL_FLOPS for the cell (global, per step):
    train 6·N_active·D; prefill 2·N_active·D; decode 2·N_active·B."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: one token
