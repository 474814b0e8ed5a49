"""Graceful preemption for the training CLI.

Counterpart of ``fm3dgan/train/preempt.py``.  A preemptible machine gets
SIGTERM a short grace window before it goes away; ``GracefulShutdown`` turns
the first SIGTERM/SIGINT into a flag the training loop polls between
iterations, and the loop then flushes its log, saves a final checkpoint and
exits 0, so a supervisor can restart it with ``--resume_dir/--resume_step``.
A second signal restores the previous handler and re-raises, so a shutdown
stuck in a device sync can still be interrupted.  ``restore()`` puts the
previous handlers back when the loop ends.

Under data parallelism a signal may reach one rank only: ``agreed()``
all-reduces the flag (max) every iteration over the host's gloo group (no
wait for the card), so every rank leaves the loop after the same
iteration, and the final checkpoint is rank 0's, which the others wait for.  Without the agreement one rank would leave while the
others wait for it in a collective.
"""

from __future__ import annotations

import json
import os
import signal
import sys

from fm3dgan_torch import parallel


class GracefulShutdown:
    """Installs handlers on construction; poll ``requested`` in the loop."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self.signum = None
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:
                # Not in the main thread: preemption handling is best-effort.
                pass

    def _handler(self, signum, frame):
        self.requested = True
        self.signum = signum
        print(f"[preempt] received signal {signum}; will checkpoint and exit after the "
              "current iteration", file=sys.stderr, flush=True)
        signal.signal(signum, self._prev.get(signum, signal.SIG_DFL))

    def agreed(self) -> bool:
        """Whether a signal reached this or any other rank."""
        return parallel.any_rank(self.requested)

    def restore(self) -> None:
        """Reinstall the handlers that were in place before this object."""
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev = {}

    def checkpoint_and_exit(self, trainer, ckpt_dir: str, step: int, logf=None) -> None:
        """Save a final checkpoint (unless the periodic save just wrote this
        step) and say how to resume.  Returns normally; the caller leaves its
        loop and exits 0.  Under data parallelism every rank calls it and
        rank 0 decides whether the checkpoint exists."""
        if not parallel.broadcast_flag(os.path.exists(os.path.join(ckpt_dir, f"{step:06d}.pt"))):
            trainer.save_checkpoint(ckpt_dir, step)
        if logf is not None:
            logf.write(json.dumps({"preempted_at": step, "signal": self.signum}) + "\n")
            logf.flush()
        if parallel.is_main():
            print(f"[preempt] checkpoint saved at iter {step}; resume with --resume_dir "
                  f"{os.path.abspath(ckpt_dir)} --resume_step {step}", flush=True)
