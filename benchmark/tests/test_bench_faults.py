"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run (the driver's set-up, window and comparison) on the CPU at a tiny
width, with the cell's own limits, once sound and once for each fault the
cell can have: a step that leaves the state unchanged, half of each batch
left out, an answer altered where it is produced, and for training R1 or
the path-length step skipped.  (One card: no exchange
between cards to leave out.)"""

import contextlib
import copy

import pytest
import torch

from conftest import tiny_3enc
from harness import models, spec

SEED = 7
calibrate = spec.load_module(f"{spec.BENCH_DIR}/calibrate.py", "bench_calibrate")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def _cell(name, **traffic):
    cell = copy.deepcopy(spec.find_cell(name))
    cell.config = tiny_3enc(cell.config)
    cell.traffic.update(traffic)
    return cell


def _run(cell, tmp_path):
    driver = spec.load_module(spec.driver_path(cell.driver), f"driver_{cell.driver}")
    ctx = spec.Context(cell=cell, seed=SEED, seconds=0.5, trace=False,
                       build_dir=str(tmp_path), device="cpu")
    out = driver.run(ctx)
    return all(c.ok for c in out.checks), {c.name: c.value for c in out.checks}


class Altered:
    """Adds 0.01 to G's first ToRGB bias (every pixel of the image) after
    every iteration."""

    def __init__(self, system):
        self._system = system

    def __getattr__(self, name):
        return getattr(self._system, name)

    def train_iteration(self, i, *batch):
        out = self._system.train_iteration(i, *batch)
        with torch.no_grad():
            self._system.trainer.state.models.generator.to_rgb1.bias += 0.01
        return out


TRAIN_FAULTS = {
    None: (lambda s: s, contextlib.nullcontext),
    "state_unchanged": (calibrate.frozen_steps, contextlib.nullcontext),
    "altered_update": (Altered, contextlib.nullcontext),
    **calibrate.FAULTS,
}


@pytest.mark.parametrize("fault", list(TRAIN_FAULTS), ids=lambda f: f or "sound")
def test_training_faults(fault, monkeypatch, tmp_path):
    build = models.program_trainer
    wrap, around = TRAIN_FAULTS[fault]
    monkeypatch.setattr(models, "program_trainer", lambda *a, **k: wrap(build(*a, **k)))
    with around():
        ok, numbers = _run(_cell("train.3enc.b16", batch=4, pool=12), tmp_path)
    assert ok == (fault is None), numbers


def _half_batch(fn):
    """Half of each batch left out (its rows get the mean of the rest); at
    batch 1, every second request left out (it gets the previous answer)."""
    last = []

    def forward(models_, photo, render, **kw):
        if photo.shape[0] == 1:
            if last:
                return last.pop()
            out = fn(models_, photo, render, **kw)
            last.append(out.clone())
            return out
        n = photo.shape[0] // 2
        out = fn(models_, photo[:n], render[:n], **kw)
        return torch.cat([out, out.mean(0, keepdim=True).expand(photo.shape[0] - n, *out.shape[1:])])
    return forward


def _altered(fn):
    calls = [0]

    def forward(models_, photo, render, **kw):
        out = fn(models_, photo, render, **kw).clone()
        calls[0] += 1
        out[0, 0, 0, 0] += 0.5
        return out
    return forward


EDIT_FAULTS = {None: lambda f: f, "half_batch": _half_batch, "altered_image": _altered}


@pytest.mark.parametrize("cell", ["edit.3enc.b16", "edit.3enc.interactive"])
@pytest.mark.parametrize("fault", list(EDIT_FAULTS), ids=lambda f: f or "sound")
def test_edit_faults(cell, fault, monkeypatch, tmp_path):
    import fm3dgan_torch.pipeline.forward as fwd

    monkeypatch.setattr(fwd, "forward_3_encoder", EDIT_FAULTS[fault](fwd.forward_3_encoder))
    extra = {"batch": 4} if cell == "edit.3enc.b16" else {}
    c = _cell(cell, pool=8, distinct_requests=6, checked_requests=40, **extra)
    ok, numbers = _run(c, tmp_path)
    assert ok == (fault is None), numbers
