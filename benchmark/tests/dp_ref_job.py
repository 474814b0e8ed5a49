"""The reference's collectives as ``harness/ref_parallel.py`` installs them,
run alike in one process on a whole batch and in each rank of a CPU gloo
group on its rows (``test_bench_dp.py``).

    python benchmark/tests/dp_ref_job.py --rank R --world W --port P --out DIR

joins a gloo group at ``tcp://127.0.0.1:P`` (60 s timeout), runs ``job()``
in float64 with the reference's helpers replaced and writes what it
returns to ``DIR/rank{R}.pt``; the test calls ``job()`` without a group for
the one process.  Row-wise results are the rank's rows; a parameter's
gradient is the rank's share (their sum over the ranks is the one
process's); a sum over the ranks and an average of gradients are W times
and the mean of the ranks' values.
"""

import argparse
import datetime
import os
import sys

import numpy as np
import torch

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _path in (BENCH_DIR, os.path.dirname(BENCH_DIR)):
    if _path not in sys.path:
        sys.path.insert(0, _path)

from harness import ref_parallel  # noqa: E402
from reference.fm3dref import common, layers, parallel  # noqa: E402

D = torch.float64


def _rows(a: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(a[parallel.local_rows(a.shape[0])], dtype=D)


def job() -> dict:
    """BatchNorm (forward, first and second derivatives, running
    statistics), the minibatch stddev under an R1-style double backward,
    noise rows, the differentiable sum, and gradient averaging."""
    rng = np.random.RandomState(0)
    out = {}
    x_np = rng.randn(8, 6, 5, 5) * rng.uniform(0.5, 2, (1, 6, 1, 1)) + rng.uniform(-1, 1, (1, 6, 1, 1))
    proj_np, v_np = rng.randn(8, 6, 5, 5), rng.randn(8, 6, 5, 5)
    m = torch.nn.BatchNorm2d(6).to(D)
    with torch.no_grad():
        m.weight.copy_(torch.as_tensor(rng.uniform(0.5, 1.5, 6)))
        m.bias.copy_(torch.as_tensor(rng.uniform(-0.5, 0.5, 6)))
    x = _rows(x_np).requires_grad_(True)
    y = common.bn(m, x, train=True)
    gx, gw = torch.autograd.grad((y * _rows(proj_np)).sum(), (x, m.weight), create_graph=True)
    g2x, g2w = torch.autograd.grad((gx * _rows(v_np)).sum(), (x, m.weight))
    out.update(bn_y=y, bn_gx=gx, bn_gw=gw, bn_g2x=g2x, bn_g2w=g2w,
               bn_running_mean=m.running_mean, bn_running_var=m.running_var)

    s_np, sp_np = rng.randn(8, 4, 4, 4), rng.randn(8, 5, 4, 4)
    scale = torch.nn.Parameter(torch.as_tensor(rng.uniform(0.5, 1.5, (1, 4, 1, 1)), dtype=D))
    s = _rows(s_np).requires_grad_(True)
    o = layers.minibatch_stddev(s * scale)
    (gs,) = torch.autograd.grad((o.square() * _rows(sp_np)).sum(), s, create_graph=True)
    (g_scale,) = torch.autograd.grad(gs.square().sum(), scale)
    out.update(stddev=o, stddev_gs=gs, stddev_g_scale=g_scale)

    gen = torch.Generator().manual_seed(5)
    out["noise"] = parallel.randn_rows((4 // parallel.world_size(), 1, 4, 4), generator=gen,
                                       dtype=D)

    t = torch.nn.Parameter(torch.as_tensor(rng.randn(3), dtype=D))
    total = parallel.all_reduce_sum(t.sum())
    (g_t,) = torch.autograd.grad(total, t)
    out.update(sum=total, sum_gt=g_t)

    local = {"a": {"w": torch.full((2, 2), float(parallel.local_rows(8).start), dtype=D)}}
    out["averaged"] = parallel.average_gradients(local)["a"]["w"]
    return {k: v.detach().clone() for k, v in out.items()}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args()
    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{args.port}",
                                         rank=args.rank, world_size=args.world,
                                         timeout=datetime.timedelta(seconds=60))
    with ref_parallel.installed():
        result = job()
    torch.save(result, os.path.join(args.out, f"rank{args.rank}.pt"))
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
