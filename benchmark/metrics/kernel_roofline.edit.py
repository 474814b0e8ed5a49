"""Percent of their roofline the port's kernels reach over the traced edit batches."""

from harness import readers


def read(records):
    return readers.kernel_roofline(records)
