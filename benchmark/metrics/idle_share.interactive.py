"""Percent of the traced interactive-edit window in which the device ran nothing."""

from harness import readers


def read(records):
    return readers.idle_share(records)
