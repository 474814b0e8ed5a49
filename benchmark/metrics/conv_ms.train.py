"""Device ms per training iteration in convolutions (cuDNN), over the traced iterations."""

from harness import readers


def read(records):
    return readers.conv_ms_per_unit(records)
