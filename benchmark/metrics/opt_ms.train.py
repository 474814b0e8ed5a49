"""Device ms per training iteration launched inside the optimizer's updates and the EMA."""

from harness import spans


def read(records):
    return spans.device_ms(records, ("fm3d.train.apply", "fm3d.train.ema"))
