"""``torch.profiler`` trace of the 3-encoder training iteration, the
counterpart of ``tools/profile_train.py``.

Builds the JAX tool's ``Trainer(TrainConfig(size, rec_batch=batch,
ds_batch=batch, compute_dtype, ...))`` with LPIPS and ArcFace unless
``--no_frozen``, on seeded uniform photo and render batches (the photo is
the reference too).  It warms iterations 0 and 1, then times the D, R1, G
and PPL steps (``train/steps.py`` ``d_step``, ``d_reg_step``, ``g_step``,
``g_reg_step`` on the first ``max(1, batch // 2)`` rows), each dispatched
and synchronised, as the wall seconds of the second of two calls.  It
traces iterations 16 to 16 + iters - 1 (16 runs R1 and PPL) under
``torch.profiler`` (CPU, and CUDA on a card; ``record_shapes``) and writes
one Chrome-trace JSON under ``--out_dir``, which ``analyze_trace`` reads.

    python -m fm3dgan_torch.tools.profile_train --batch 8 --size 256 --dtype bfloat16 \\
        --out_dir /tmp/fm3dgan_trace [--no_frozen] [--share_noise 0|1] [--device cpu]

Prints ``{"step_seconds": {...}, "trace_dir": ...}`` as its last line; on a
card also ``"profile"``: the window's device busy ms per iteration, idle
share and top ops (:func:`profile_summary`).  The JAX tool's TPU knobs
``--remat_frozen``, ``--remat_reg`` and ``--fused`` have no counterpart in
eager PyTorch (ROADMAP §1, "Not queued"), and ``--upfirdn_backend`` none
either: the port has no backend switch, a CUDA tensor always takes the
hand-written kernels.  TF32 is left as the process has it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np
import torch

from fm3dgan_torch.pipeline.forward import resolve_device
from fm3dgan_torch.train import TrainConfig, Trainer, steps

TRACE_START = 16  # the first traced iteration: R1 (every 16) and PPL (every 4)


def profile_summary(prof, wall_s: float, iterations: int, top: int = 15) -> dict:
    """Device busy time per iteration (the summed time of the events that
    ran on the device: kernels, copies, sets; a host op's device time is
    theirs counted again) against the window's wall time, the device events
    with the most time and the host ops with the most self time."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    on_device = [e for e in events if e.device_type != DeviceType.CPU]
    on_host = [e for e in events if e.device_type == DeviceType.CPU]

    def rows(evs, key):
        ranked = sorted(evs, key=lambda e: getattr(e, key), reverse=True)[:top]
        return [dict(name=e.key[:120], calls=e.count, self_device_ms=e.self_device_time_total / 1e3,
                     self_cpu_ms=e.self_cpu_time_total / 1e3) for e in ranked]

    busy_ms = sum(e.self_device_time_total for e in on_device) / 1e3
    wall_ms = wall_s * 1e3
    return dict(iterations=iterations, wall_ms_per_iteration=wall_ms / iterations,
                device_busy_ms_per_iteration=busy_ms / iterations,
                device_idle_share=1.0 - busy_ms / wall_ms,
                top_device=rows(on_device, "self_device_time_total"),
                top_cpu=rows(on_host, "self_cpu_time_total"))


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--no_frozen", action="store_true")
    p.add_argument("--out_dir", default=os.path.join(tempfile.gettempdir(), "fm3dgan_trace"))
    p.add_argument("--share_noise", type=int, default=None,
                   help="override config.share_dg_noise (0/1)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default cuda; cpu to run on the CPU)")
    return p


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_arg_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg_kwargs = {}
    if args.share_noise is not None:
        cfg_kwargs["share_dg_noise"] = bool(args.share_noise)
    cfg = TrainConfig(
        size=args.size,
        rec_batch=args.batch,
        ds_batch=args.batch,
        compute_dtype=args.dtype,
        lpips_loss_lambda=0.0 if args.no_frozen else 3.0,
        face_id_loss_lambda=0.0 if args.no_frozen else 30.0,
        **cfg_kwargs,
    )
    trainer = Trainer(cfg, seed=0, use_lpips=not args.no_frozen,
                      use_arcface=not args.no_frozen, device=device)
    rng = np.random.RandomState(0)
    s = args.size
    photo_np = rng.uniform(-1, 1, (args.batch, s, s, 3)).astype(np.float32)
    render_np = rng.uniform(-1, 1, (args.batch, s, s, 3)).astype(np.float32)

    # Outside the trace: iteration 0 runs R1 and PPL, iteration 1 is DS.
    for i in range(2):
        trainer.train_iteration(i, photo_np, render_np, photo_np)
    _sync(device)
    print("# warmed; tracing", file=sys.stderr)

    # Each step dispatched and synchronised, the second of two calls timed;
    # every call draws its noise from a generator seeded 9, as the JAX tool
    # passes PRNGKey(9) to each.  The steps update the state in place.
    photo, render = (steps.prepare_batch(a, device) for a in (photo_np, render_np))
    st, half = trainer.state, max(1, args.batch // 2)

    def gen():
        return torch.Generator(device=device).manual_seed(9)

    breakdown = {}
    for name, fn in (
        ("d_step", lambda: steps.d_step(st, cfg, photo, render, photo, False, gen())),
        ("d_reg_step", lambda: steps.d_reg_step(st, cfg, photo, False)),
        ("g_step", lambda: steps.g_step(st, cfg, photo, render, photo, False, False, False,
                                        gen(), apply_ema=True, apply_hmap=False)),
        ("g_reg_step", lambda: steps.g_reg_step(st, cfg, photo[:half], render[:half], gen(),
                                                apply_ema=True)),
    ):
        for timed in (False, True):
            t0 = time.perf_counter()
            fn()
            _sync(device)
            if timed:
                breakdown[name] = round(time.perf_counter() - t0, 4)

    os.makedirs(args.out_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities, record_shapes=True) as prof:
        t0 = time.perf_counter()
        for i in range(args.iters):
            trainer.train_iteration(TRACE_START + i, photo_np, render_np, photo_np)
        _sync(device)
        wall = time.perf_counter() - t0
    path = os.path.join(args.out_dir, f"profile_train_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    result = {"step_seconds": breakdown, "trace_dir": args.out_dir}
    if device.type == "cuda":
        result["profile"] = profile_summary(prof, wall, args.iters)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
