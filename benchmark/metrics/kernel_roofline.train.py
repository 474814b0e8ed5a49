"""Percent of their roofline the port's five kernels reach over the traced training iterations."""

from harness import readers


def read(records):
    return readers.kernel_roofline(records)
