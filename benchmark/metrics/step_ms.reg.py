"""Median host ms of a training iteration that runs R1 or PPL, with a synchronize around it."""

from harness import readers


def read(records):
    return readers.median_ms(records, "step_ms", "reg")
