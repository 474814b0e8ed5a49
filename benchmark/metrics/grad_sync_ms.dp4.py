"""Device ms per training iteration launched inside the gradient all-reduce
of every optimizer update (``fm3d.parallel.grads``), rank 0's."""

from harness import spans


def read(records):
    return spans.device_ms(records, ("fm3d.parallel.grads",))
