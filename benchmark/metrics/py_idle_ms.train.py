"""Device-idle ms per training iteration with the host in the port's own Python."""

from harness import spans


def read(records):
    return spans.python_idle_ms(records)
