"""Device ms per training iteration launched inside the lazy regularisers' steps (R1 and PPL)."""

from harness import spans


def read(records):
    return spans.device_ms(records, ("fm3d.train.d_reg_step", "fm3d.train.g_reg_step"))
