"""What the per-layer metric files compute, from a traced run's records.
Each returns None where the run gave nothing to read, and the harness then
leaves the metric out."""

from __future__ import annotations

import statistics
from typing import Optional

from harness.kernel_bytes import bound_s, launch_cost
from harness.peaks import FP32_FLOPS_PER_S


def median_ms(records, key: str, sub: Optional[str] = None) -> Optional[float]:
    values = records.get(key)
    if values is not None and sub is not None:
        values = values.get(sub)
    return statistics.median(values) if values else None


def idle_share(records) -> Optional[float]:
    """Percent of the traced window in which no device operation ran."""
    t = records.get("trace")
    if t is None or t.window_s <= 0:
        return None
    return (1.0 - t.busy_s() / t.window_s) * 100.0


def conv_ms_per_unit(records) -> Optional[float]:
    """Device ms per traced unit (iteration or batch) in convolutions."""
    t = records.get("trace")
    if t is None or not records.get("units"):
        return None
    ms = t.category_s("convolution") * 1e3
    return ms / records["units"] if ms > 0 else None


def kernel_roofline(records) -> Optional[float]:
    """Percent: the summed least times of the port's kernel launches (their
    bytes at the HBM bandwidth, or operations at the float32 peak) over
    their summed device times."""
    t = records.get("trace")
    if t is None:
        return None
    bound, took = 0.0, 0.0
    for op, ev in t.port_launches():
        cost = launch_cost(op, ev["op_args"])
        if cost is None:
            return None
        bound += bound_s(*cost)
        took += ev["dur"] / 1e6
    return bound / took * 100.0 if took > 0 else None


def launches_per_unit(records) -> Optional[float]:
    """Device kernels per traced unit (request)."""
    t = records.get("trace")
    if t is None or not records.get("units"):
        return None
    n = len(t.kernels())
    return n / records["units"] if n else None


def train_mfu(records) -> Optional[float]:
    """Percent of the float32 peak: the model operations of the timed
    iterations over their wall time."""
    if not records.get("flops") or not records.get("window_s"):
        return None
    return records["flops"] / (records["window_s"] * FP32_FLOPS_PER_S) * 100.0


def edit_mfu(records) -> Optional[float]:
    if not records.get("flops_per_image") or not records.get("window_s"):
        return None
    return (records["flops_per_image"] * records["window_images"]
            / (records["window_s"] * FP32_FLOPS_PER_S) * 100.0)
