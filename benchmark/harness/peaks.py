"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit): HBM bandwidth and float32 outside the tensor cores, the
precision every configuration here states (TF32 off).  The same figures as
``HBM_BYTES_PER_S`` and ``FP32_FLOPS_PER_S`` in ``chip_smoke.py``."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
