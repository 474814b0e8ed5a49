"""Device ms per training iteration launched inside the G step (``fm3d.train.g_step``: G, LPIPS,
ArcFace, D's forward, the backward, Adam and EMA)."""

from harness import spans


def read(records):
    return spans.device_ms(records, ("fm3d.train.g_step",))
