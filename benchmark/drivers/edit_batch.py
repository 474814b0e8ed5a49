"""Offline edit cells: batches of distinct (photo, render) pairs, each
batch sent when the previous one is on the host (``harness/edit_loop.py``)."""

from harness.edit_loop import run

__all__ = ["run"]
