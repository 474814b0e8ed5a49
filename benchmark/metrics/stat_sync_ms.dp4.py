"""Device ms per training iteration launched inside the gathers of the
global BatchNorm and the minibatch stddev (``fm3d.parallel.stats``), rank 0's."""

from harness import spans


def read(records):
    return spans.device_ms(records, ("fm3d.parallel.stats",))
