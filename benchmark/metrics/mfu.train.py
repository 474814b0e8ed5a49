"""Percent of the float32 peak: model operations of the timed training iterations over their wall time."""

from harness import readers


def read(records):
    return readers.train_mfu(records)
