"""Device kernels per interactive edit request in the traced window."""

from harness import readers


def read(records):
    return readers.launches_per_unit(records)
