"""Bytes each launch of the port's five kernels must move, and its operations, from the shapes
of the operator that launched it: each input byte read once, each output
byte written once (FIR taps are host constants).  The arithmetic behind
``chip_smoke.py``'s ``bound()`` calls and the kernel table's shapes, copied
here so that it stays fixed.

An operator's record in the trace gives ``Input Dims`` (one list per
argument), ``Input type`` and ``Concrete Inputs`` (the scalar arguments as
strings).  The schemas (``fm3dgan_torch/ops``):

    blur(Tensor x, float[] taps, int kh, int kw, int p0, int p1)
    upsample2x(Tensor x, float[] taps, int p0, int p1)
    downsample2x(Tensor x, float[] taps, int p0, int p1)
    fused_leaky_relu(Tensor x, Tensor? bias, float negative_slope, float scale)
    fused_leaky_relu_bwd(Tensor grad, Tensor out, float negative_slope, float scale)
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from harness.peaks import FP32_FLOPS_PER_S, HBM_BYTES_PER_S

OPS = ("blur", "upsample2x", "downsample2x", "fused_leaky_relu", "fused_leaky_relu_bwd")
ELEMENT_BYTES = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "double": 8}


def _numel(dims: List[int]) -> int:
    n = 1
    for d in dims:
        n *= int(d)
    return n


def _ints(concrete: List[str], idx: List[int]) -> Optional[List[int]]:
    try:
        return [int(float(concrete[i])) for i in idx]
    except (IndexError, ValueError):
        return None


def _taps(concrete: List[str]) -> Optional[int]:
    try:
        return len(json.loads(concrete[1]))
    except (IndexError, ValueError, TypeError):
        return None


def launch_cost(op: str, args: Dict) -> Optional[Tuple[int, int]]:
    """(bytes read and written, floating-point operations) of one launch of
    ``op`` (a key of ``OPS``) from its trace record's ``args``; None where
    the record lacks what the count needs.  Operations: a multiply and an add
    per FIR tap of each output (2 x 2 taps per output of the 2x upsample's
    polyphase), 4 per element of the activation, 2 of its gradient."""
    dims = args.get("Input Dims") or []
    types = args.get("Input type") or []
    concrete = args.get("Concrete Inputs") or []
    if not dims or not dims[0] or (op in OPS[:3] and len(dims[0]) != 4):
        return None
    es = ELEMENT_BYTES.get(types[0] if types else "")
    if es is None:
        return None
    x = dims[0]
    if op == "blur":
        p = _ints(concrete, [2, 3, 4, 5])
        if p is None:
            return None
        kh, kw, p0, p1 = p
        out = x[0] * x[1] * (x[2] + p0 + p1 - kh + 1) * (x[3] + p0 + p1 - kw + 1)
        return (_numel(x) + out) * es, out * kh * kw * 2
    if op == "upsample2x":
        return 5 * _numel(x) * es, 4 * _numel(x) * 4 * 2
    if op == "downsample2x":
        p, k = _ints(concrete, [2, 3]), _taps(concrete)
        if p is None or k is None:
            return None
        p0, p1 = p
        out = x[0] * x[1] * ((x[2] + p0 + p1 - k) // 2 + 1) * ((x[3] + p0 + p1 - k) // 2 + 1)
        return (_numel(x) + out) * es, out * k * k * 2
    if op == "fused_leaky_relu":
        bias = _numel(dims[1]) if len(dims) > 1 and dims[1] else 0
        return (2 * _numel(x) + bias) * es, 4 * _numel(x)
    if op == "fused_leaky_relu_bwd":
        return 3 * _numel(x) * es, 2 * _numel(x)
    raise KeyError(op)


def bound_s(n_bytes: int, flops: int = 0) -> float:
    """The least time the card could take: the larger of bytes over HBM
    bandwidth and operations over the float32 peak."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)
