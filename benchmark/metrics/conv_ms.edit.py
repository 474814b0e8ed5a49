"""Device ms per edit batch in convolutions (cuDNN), over the traced batches."""

from harness import readers


def read(records):
    return readers.conv_ms_per_unit(records)
