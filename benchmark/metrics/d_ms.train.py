"""Device ms per training iteration launched inside the D step (``fm3d.train.d_step``)."""

from harness import spans


def read(records):
    return spans.device_ms(records, ("fm3d.train.d_step",))
