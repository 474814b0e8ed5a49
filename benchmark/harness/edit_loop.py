"""The edit cells' loop: one client sends ``forward_3_encoder`` requests,
each the next as soon as the previous one's images are on the host.

Set-up builds the port's 3-encoder bundle with the benchmark's weights,
cuts the traffic's distinct requests from seeded pools (float32 NHWC on
the host) and runs each request shape twice.  Each request is timed from
the call until its images are on the host (``.cpu()``); the host time to
issue it is the call alone.  A traced run profiles the first
``traced_requests`` of the window; its timed numbers come from the rest.
After the window the program is freed and the reference edits a sample of
the finished requests, drawn from the seed, the last one among them.
"""

from __future__ import annotations

import time
from unittest import mock
from typing import Dict, List

import numpy as np
import torch

from harness import compare, flops, models, spec, trace
from harness.device import free, memory_peak, sync
from harness.feed import EditFeed
from reference.fm3dref import forward as ref_forward


def forward_kwargs(cfg) -> Dict:
    tc = cfg["train_config"]
    sliced = tc.get("w_plus_sliced_layer")
    return dict(tsr_encode=tc["tsr_encode"], use_tanh=tc["use_tanh"],
                sliced_layer=None if sliced is None else tuple(sliced))


def _loop(models_, reqs, kw, seconds, first: int, device, count: int = 0):
    """Requests from ``first``: ``count`` of them, or until ``seconds`` have
    passed; returns (outputs, latency s, host s, wall s)."""
    from fm3dgan_torch.pipeline.forward import forward_3_encoder

    outs, lat, host = [], [], []
    sync(device)
    start = time.perf_counter()
    j = first
    while True:
        photo, render = reqs[j % len(reqs)]
        t0 = time.perf_counter()
        img = forward_3_encoder(models_, photo, render, **kw)
        t1 = time.perf_counter()
        outs.append(img.cpu())
        t2 = time.perf_counter()
        lat.append(t2 - t0)
        host.append(t1 - t0)
        j += 1
        if (count and len(outs) == count) or (not count and t2 - start >= seconds):
            break
    return outs, lat, host, time.perf_counter() - start


def run(ctx: spec.Context) -> spec.Outcome:
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    kw = forward_kwargs(cfg)
    t0 = time.perf_counter()
    weights = models.make_weights(cfg, ctx.seed, ctx.device, training=False)
    models_ = models.program_manipulator(cfg, ctx.seed, weights, device=ctx.device)
    del weights
    feed = EditFeed(ctx.seed, tr["pool"], cfg["input_size"], tr["distinct_requests"],
                    batch=tr.get("batch"), renders_per_request=tr.get("renders_per_request"))
    reqs = [(torch.from_numpy(p), torch.from_numpy(r)) for p, r in feed.requests]
    from fm3dgan_torch.pipeline.forward import forward_3_encoder

    shapes = {}
    for p, r in reqs:
        shapes.setdefault(p.shape[0], (p, r))
    for p, r in shapes.values():
        for _ in range(2):
            forward_3_encoder(models_, p, r, **kw).cpu()
    sync(ctx.device)
    setup_s = time.perf_counter() - t0

    records, busy_s, window_s, breakdown, first = {}, None, None, None, 0
    outs: List[torch.Tensor] = []
    if ctx.trace:
        first = tr["traced_requests"]
        with trace.traced(ctx.build_dir, ctx.device) as traced:
            outs, _, _, _ = _loop(models_, reqs, kw, 0, 0, ctx.device, count=first)
        t = traced["trace"]
        busy_s, window_s = t.busy_s(), t.window_s
        breakdown = {"device_ops": t.top_device_ops(), "idle_gaps": t.idle_gaps()}
        records.update(trace=t, units=first)
    rest, lat, host, wall = _loop(models_, reqs, kw, ctx.seconds, first, ctx.device)
    outs += rest
    images = sum(o.shape[0] for o in rest)
    if ctx.trace:
        records.update(host_ms=[h * 1e3 for h in host], window_s=wall, window_images=images)
        end_to_end = {}
    else:
        end_to_end = {"edit_img_per_s": images / wall,
                      "edit_p95_ms": float(np.percentile(np.asarray(lat) * 1e3, 95))}
    end_to_end["setup_s"] = setup_s
    failed = sum(not bool(torch.isfinite(o).all()) for o in outs)
    peak = memory_peak(ctx.device)
    del models_
    free(ctx.device)

    picked = compare.sample(ctx.seed, len(outs), tr["checked_requests"], must=[len(outs) - 1])
    gap = image_gaps(cfg, ctx.seed, reqs, outs, picked, ctx.device)
    checks = [spec.Check("image_gap", gap, ctx.cell.limits["image_gap"])]
    if ctx.trace:
        records["flops_per_image"] = image_flops(cfg, kw, reqs[0][0].shape[1:])
    return spec.Outcome(end_to_end=end_to_end, records=records, checks=checks,
                        attempted=len(outs), failed=failed, memory_peak_bytes=peak,
                        busy_s=busy_s, window_s=window_s, breakdown=breakdown)


def reference_images(cfg, seed, reqs, picked, device, bundle=None) -> Dict[int, np.ndarray]:
    """The reference's edits of requests ``picked`` (by window position)."""
    kw = forward_kwargs(cfg)
    if bundle is None:
        weights = models.make_weights(cfg, seed, device, training=False)
        bundle = models.reference_manipulator(cfg, weights, device)
    return {j: ref_forward.forward_3_encoder(bundle, *reqs[j % len(reqs)], **kw).cpu().numpy()
            for j in picked}


def image_gaps(cfg, seed, reqs, outs, picked, device) -> float:
    ref = reference_images(cfg, seed, reqs, picked, device)
    return max(compare.image_gap(outs[j].numpy(), ref[j]) for j in picked)


def image_flops(cfg, kw, image_shape) -> float:
    """Model operations of one edited image (a batch of 16 on the meta
    device, over 16).  The forward runs under ``no_grad`` in place of
    ``inference_mode``, which hides the operations from a dispatch mode;
    the operations are the same."""
    bundle = models.reference_manipulator(cfg, None, device="meta")
    x = torch.empty((16, *image_shape), device="meta")
    with mock.patch.object(torch, "inference_mode", torch.no_grad):
        return flops.count(lambda: ref_forward.forward_3_encoder(bundle, x, x.clone(), **kw)) / 16
