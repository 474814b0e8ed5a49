"""Experiment directory setup and status printing.

Counterpart of ``fm3dgan/utils/experiment.py``: timestamped experiment dirs
with sample/ and ckpt/ subfolders and a full config dump at start.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
from typing import Optional, TextIO, Tuple


def setup_experiment_dir(base_dir: str, timestamp: Optional[str] = None) -> Tuple[str, str, str]:
    """Create Exp_<ts>/{sample,ckpt}; returns (exp_dir, sample_dir, ckpt_dir)."""
    ts = timestamp or datetime.datetime.now().strftime("%Y-%m-%d_%H:%M:%S")
    exp_dir = os.path.join(base_dir, f"Exp_{ts}")
    sample_dir = os.path.join(exp_dir, "sample")
    ckpt_dir = os.path.join(exp_dir, "ckpt")
    os.makedirs(sample_dir, exist_ok=True)
    os.makedirs(ckpt_dir, exist_ok=True)
    return exp_dir, sample_dir, ckpt_dir


def print_experiment_status(config, file: Optional[TextIO] = None) -> str:
    """Dump the full hyperparameter set (a dataclass) as JSON; returns the
    string."""
    d = dataclasses.asdict(config)
    s = json.dumps(d, indent=2, default=str)
    header = "=" * 30 + " Experiment Config " + "=" * 30
    text = f"{header}\n{s}\n" + "=" * len(header)
    print(text, file=file)
    return text
