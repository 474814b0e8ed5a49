"""Percent of the float32 peak: model operations of the timed edit batches over their wall time."""

from harness import readers


def read(records):
    return readers.edit_mfu(records)
