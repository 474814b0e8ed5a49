"""Interactive edit cells: one client, one photo with k renders a request,
each sent when the previous one is on the host (``harness/edit_loop.py``)."""

from harness.edit_loop import run

__all__ = ["run"]
