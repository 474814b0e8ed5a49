"""Host time per launch of each kernel wrapper, and a batch-1 generator step,
on one CUDA card.

    python fm3dgan_torch/tools/launch_overhead.py [--label NAME] [--out results.json]

Imports ``fm3dgan_torch`` from the Python path, so with
``PYTHONPATH=<another checkout>`` the same script times that checkout's
wrappers (it uses only ``ops.{blur, upsample2x, downsample2x,
fused_leaky_relu, fused_leaky_relu_bwd, build_all, reset_launches,
launch_counts}`` and ``models.Generator``).  Run two checkouts in turns in
one call (A, B, B, A) to compare their host paths on one card.

* per kernel, at the batch-1 shapes of a projector step where the host
  bounds every launch: ``host_us``, the host clock over ``--calls`` eager
  calls without a synchronize, and ``eager_us``, CUDA events around the same
  calls (the two agree when the launches are host-bound);
* ``g_step_ms``: a full-width 256 px generator's forward and backward to its
  W+ latent at batch 1 (a projector step without LPIPS, 50 launches), host
  clock around steps ending in a synchronize.

Prints one JSON object; exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch


def _timed(fn, calls: int):
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return host / calls * 1e6, start.elapsed_time(end) / calls * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default=None, help="also append the object to this JSON-lines file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("launch_overhead: no CUDA device", file=sys.stderr)
        return 1
    import fm3dgan_torch
    from fm3dgan_torch import ops
    from fm3dgan_torch.models import Generator

    ops.build_all()
    g = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *shape: torch.randn(*shape, device="cuda", generator=g)  # noqa: E731
    k2d = ops.make_kernel([1, 3, 3, 1]) * 4.0
    k1d = [0.25, 0.75, 0.75, 0.25]
    x_blur, x_up, x_down = rnd(1, 512, 9, 9), rnd(1, 3, 8, 8), rnd(1, 3, 16, 16)
    x_act, bias, grad = rnd(1, 512, 8, 8), rnd(512), rnd(1, 512, 8, 8)
    out = ops.fused_leaky_relu(x_act, bias)
    cases = {
        "blur": lambda: ops.blur(x_blur, k2d, (1, 1)),
        "upsample2x": lambda: ops.upsample2x(x_up, k1d, (2, 1)),
        "downsample2x": lambda: ops.downsample2x(x_down, k1d, (1, 1)),
        "fused_leaky_relu": lambda: ops.fused_leaky_relu(x_act, bias),
        "fused_leaky_relu_bwd": lambda: ops.fused_leaky_relu_bwd(grad, out),
    }
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = dict(label=args.label, package=os.path.dirname(os.path.abspath(fm3dgan_torch.__file__)),
               device=torch.cuda.get_device_name(0), calls=args.calls, kernels={})
    for name, fn in cases.items():
        ops.reset_launches()
        host_us, eager_us = _timed(fn, args.calls)
        launches = ops.launch_counts()[name]
        rec["kernels"][name] = dict(host_us=host_us, eager_us=eager_us,
                                    launches_per_call=launches / (args.calls + 20))

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        gen = Generator(size=256).cuda().eval().requires_grad_(False)
    w = torch.randn(1, gen.n_latent, gen.style_dim, device="cuda", requires_grad=True)

    def step():
        img = gen(input_is_latent=True, latent_styles=[w], randomize_noise=False)
        (grad_w,) = torch.autograd.grad(img.square().mean(), w)
        return grad_w

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        step()
    torch.cuda.synchronize()
    rec["g_step_ms"] = (time.perf_counter() - t0) / args.steps * 1e3
    rec["g_step_launches"] = {k: v // args.steps for k, v in ops.launch_counts().items()}
    print(json.dumps(rec), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
