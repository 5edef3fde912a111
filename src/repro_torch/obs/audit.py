"""The predicted-vs-measured cost audit: each traced chunk joined to the
predictions made for it.

  peak_ratio   predicted peak bytes at the chunk's size against the
               peak measured for it (1.0 = perfect);
  time_ratio   measured seconds (a span synchronized with the card)
               against the roofline lower bound
               max(FLOPs / peak FLOP rate, bytes / memory rate).

The hardware constants are the NVIDIA H100 SXM's data-sheet figures
(the same ones ``chip_smoke.py`` and PERF.md bound every kernel with):
3.35 TB/s of HBM3, 67 TFLOP/s fp32 outside the tensor cores (the
default peak: the port's Gram kernels are fp32 FMA) and 989 TFLOP/s
dense bf16 on the tensor cores.  Pass other numbers for another device;
the ratios stay comparable across runs with the same constants.

The rows come from the task runtime (``repro_torch.runtime``): one per
chunk of a traced map that the memory model sized, its measured peak
the CUDA allocator's and its work counted from the chunk's seg_gram
launches.  A chunk whose work was not counted (no launch: the plain
versions on the CPU) carries None there, and so do its roofline and
time ratio.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

# NVIDIA H100 SXM data sheet
HBM_BW = 3.35e12              # bytes / s
PEAK_FLOPS_FP32 = 67e12       # FLOP / s, fp32 outside the tensor cores
PEAK_FLOPS_BF16 = 989e12      # FLOP / s, dense bf16 tensor cores
PEAK_FLOPS = PEAK_FLOPS_FP32

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class ChunkAudit:
    """One traced chunk joined to its cost predictions."""

    label: str
    chunk_index: int
    chunk_size: int
    predicted_peak_bytes: float  # the memory model at chunk_size
    probed_peak_bytes: float  # the peak measured at chunk_size
    flops: Optional[float]  # operations of one execution of the chunk
    hbm_bytes: Optional[float]  # bytes it must move
    measured_s: float  # span duration (synchronized)

    @property
    def peak_ratio(self) -> float:
        """Predicted / measured peak bytes (finite, > 0)."""
        return max(self.predicted_peak_bytes, _EPS) / max(
            self.probed_peak_bytes, _EPS)

    def roofline_s(self, peak_flops: float = PEAK_FLOPS,
                   hbm_bw: float = HBM_BW) -> Optional[float]:
        """Roofline lower bound for one execution of the chunk (None
        when its work was not counted)."""
        if self.flops is None or self.hbm_bytes is None:
            return None
        return max(self.flops / peak_flops, self.hbm_bytes / hbm_bw)

    def time_ratio(self, peak_flops: float = PEAK_FLOPS,
                   hbm_bw: float = HBM_BW) -> Optional[float]:
        """Measured / roofline seconds (>= ~1 when the model is sane)."""
        bound = self.roofline_s(peak_flops, hbm_bw)
        if bound is None:
            return None
        return max(self.measured_s, _EPS) / max(bound, _EPS)


class CostAudit:
    """Accumulates :class:`ChunkAudit` rows across a traced run and
    renders them as a table or a JSON-friendly summary."""

    def __init__(self, peak_flops: float = PEAK_FLOPS,
                 hbm_bw: float = HBM_BW):
        self.peak_flops = float(peak_flops)
        self.hbm_bw = float(hbm_bw)
        self.rows: List[ChunkAudit] = []

    def record(self, row: ChunkAudit) -> None:
        """Append one chunk's row."""
        self.rows.append(row)

    def __len__(self) -> int:
        return len(self.rows)

    def as_dicts(self) -> List[Dict]:
        """One plain dict per row, ratios included."""
        return [{
            "label": r.label,
            "chunk_index": r.chunk_index,
            "chunk_size": r.chunk_size,
            "predicted_peak_bytes": r.predicted_peak_bytes,
            "probed_peak_bytes": r.probed_peak_bytes,
            "peak_ratio": r.peak_ratio,
            "flops": r.flops,
            "hbm_bytes": r.hbm_bytes,
            "measured_s": r.measured_s,
            "roofline_s": r.roofline_s(self.peak_flops, self.hbm_bw),
            "time_ratio": r.time_ratio(self.peak_flops, self.hbm_bw),
        } for r in self.rows]

    def summary(self) -> Dict:
        """Min / max / mean of the ratios over the rows."""
        if not self.rows:
            return {"n_chunks": 0}
        pr = [r.peak_ratio for r in self.rows]
        tr = [x for x in (r.time_ratio(self.peak_flops, self.hbm_bw)
                          for r in self.rows) if x is not None]
        return {
            "n_chunks": len(self.rows),
            "labels": sorted({r.label for r in self.rows}),
            "peak_ratio_min": min(pr),
            "peak_ratio_max": max(pr),
            "peak_ratio_mean": sum(pr) / len(pr),
            "time_ratio_min": min(tr) if tr else None,
            "time_ratio_max": max(tr) if tr else None,
        }

    def table(self) -> str:
        """Human-readable audit: one line per chunk."""
        head = (f"{'label':<24} {'#':>3} {'size':>5} {'pred_peak':>10} "
                f"{'meas_peak':>10} {'ratio':>6} {'meas_ms':>8} "
                f"{'time_x':>9}")
        lines = [head, "-" * len(head)]
        for r in self.rows:
            tr = r.time_ratio(self.peak_flops, self.hbm_bw)
            lines.append(
                f"{r.label[:24]:<24} {r.chunk_index:>3} {r.chunk_size:>5} "
                f"{r.predicted_peak_bytes:>10.0f} "
                f"{r.probed_peak_bytes:>10.0f} {r.peak_ratio:>6.2f} "
                f"{r.measured_s * 1e3:>8.2f} "
                + (f"{tr:>9.1f}" if tr is not None else f"{'-':>9}"))
        return "\n".join(lines)
