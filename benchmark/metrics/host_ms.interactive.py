"""Median host ms to issue one interactive edit request (the call, before its images are copied back)."""

from harness import readers


def read(records):
    return readers.median_ms(records, "host_ms")
