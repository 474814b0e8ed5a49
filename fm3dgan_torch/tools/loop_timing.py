"""Wall-clock period of the 3-encoder training CLI's loop on image folders,
as one process and as an NCCL world of one under ``--data_parallel``.

    python -m fm3dgan_torch.tools.loop_timing [--work_dir build/loop_timing]
        [--image_size 1024] [--iters 12] [--runs one,ddp,ddp,one] [--label NAME]
        [--profile A:B] [--out results.json] [-- extra train_3_encoder flags]

Writes an FFHQ-style reconstruction layout (``img/`` + ``render_img/``) and
a synthetic pair layout (``id_XXXXX/g_K.png, r_K.png``) of procedural PNGs
(``make_dataset_layouts``) under ``--work_dir`` unless they are there, then
runs ``fm3dgan_torch.tools.train_3_encoder`` on them once per entry of
``--runs``: ``one`` as one process, ``ddp`` under ``torchrun
--nproc_per_node 1 ... --data_parallel``.  The runs decode every image they
read (``--cache_decoded false``), write no checkpoint and no sample, and
keep the default ``--log_every``.  Each run records, in its own process, the
host clock at the entry of every ``train_iteration``, with no synchronize, and
once more when the CLI returns: the gap between two entries is one period of
the loop (the iteration on the card, the next batch's load, the log line, as
far as they do not overlap), and ``ms_per_iteration`` is the time from the
entry of iteration 1 to the CLI's return over the iterations after the first.
``load_s`` is the log's time of each ``load_batch``, ``enqueue_ms`` the host
time inside each ``train_iteration`` call, ``allocator_after_first`` the
caching allocator's cudaMalloc / cudaFree calls and retries after the first
iteration.  ``--profile A:B`` traces iterations A to B - 1 of every run with
``torch.profiler``: the device's busy time per iteration (the summed time
of the kernels and copies), its idle share of the window, the kernels with
the most device time and the host ops with the most host time.

Run it from the repo root with ``python -m fm3dgan_torch.tools.loop_timing``.
The runs import the ``fm3dgan_torch`` that this process imported, so with
``PYTHONPATH=<another checkout>`` they use that checkout's package; run two
checkouts in one call to compare them on one card.  Prints one JSON
object; exits non-zero if a run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import time

MODULE = "fm3dgan_torch.tools.train_3_encoder"


ALLOCATOR_COUNTS = ("num_device_alloc", "num_device_free", "num_alloc_retries")


def child_main(stats_path: str, argv) -> int:
    """``python -m MODULE argv`` in this process, recording the host clock
    at the entry and the return of every ``Trainer.train_iteration``, the
    caching allocator's counts at each entry, and the clock at the end.
    With ``--profile A:B`` ahead of the CLI's flags, iterations A to B - 1
    run under ``torch.profiler`` (CPU and CUDA), with a synchronize at
    both ends of the window."""
    import runpy

    import torch

    from fm3dgan_torch.tools.profile_train import profile_summary
    from fm3dgan_torch.train.loop import Trainer

    window = None
    if argv[:1] == ["--profile"]:
        window = tuple(int(x) for x in argv[1].split(":"))
        argv = argv[2:]
    rec = dict(starts=[], returns=[], allocator=[])
    state = {}
    original = Trainer.train_iteration

    def train_iteration(self, i, *a, **kw):
        if window is not None and i in window:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                torch.cuda.synchronize()
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            if i == window[0]:
                state["prof"] = torch.profiler.profile(activities=activities)
                state["prof"].__enter__()
                state["t0"] = time.perf_counter()
            else:
                wall = time.perf_counter() - state["t0"]
                state["prof"].__exit__(None, None, None)
                rec["profile"] = profile_summary(state["prof"], wall, window[1] - window[0])
        rec["starts"].append(time.perf_counter())
        if torch.cuda.is_available():
            stats = torch.cuda.memory_stats()
            rec["allocator"].append({k: stats.get(k, 0) for k in ALLOCATOR_COUNTS})
        out = original(self, i, *a, **kw)
        rec["returns"].append(time.perf_counter())
        return out

    Trainer.train_iteration = train_iteration
    sys.argv = [MODULE, *argv]
    try:
        runpy.run_module(MODULE, run_name="__main__", alter_sys=True)
        code = 0
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
    rec.update(end=time.perf_counter(), code=code)
    with open(stats_path, "w") as f:
        json.dump(rec, f)
    return code


def make_layouts(work_dir: str, image_size: int, n_photos: int, n_ids: int, n_var: int):
    from fm3dgan_torch.tools import make_dataset_layouts

    rec, ds = os.path.join(work_dir, "rec"), os.path.join(work_dir, "ds")
    if not os.path.isdir(os.path.join(rec, "render_img")):
        make_dataset_layouts.main(["ffhq", rec, "--n_ids", str(n_photos), "--n_edits", "0",
                                   "--size", str(image_size)])
    if not os.path.isdir(os.path.join(ds, f"id_{n_ids - 1:05d}")):
        make_dataset_layouts.main(["synthetic", ds, "--n_ids", str(n_ids), "--n_var", str(n_var),
                                   "--size", str(image_size)])
    return rec, ds


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_once(kind: str, index: int, args, rec: str, ds: str, extra) -> dict:
    import fm3dgan_torch

    name = f"{args.label or 'run'}{index}_{kind}"
    exp, stats = os.path.join(args.work_dir, name), os.path.join(args.work_dir, name + ".json")
    shutil.rmtree(exp, ignore_errors=True)
    cli = ["--rec_data_dir", rec, "--ds_data_dir", ds, "--exp_dir", exp, "--device", args.device,
           "--training_iters", str(args.iters), "--model_save_freq", str(10 ** 6),
           "--val_sample_freq", str(10 ** 6), "--cache_decoded", "false", *extra]
    profile = ["--profile", args.profile] if args.profile else []
    me = [os.path.abspath(__file__), "--child", stats, "--", *profile, *cli]
    if kind == "ddp":
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1",
               "--master_port", str(_free_port()), *me, "--data_parallel"]
    elif kind == "one":
        cmd = [sys.executable, *me]
    else:
        raise ValueError(f"unknown run {kind!r}: one or ddp")
    # The children import the package this process imported.
    root = os.path.dirname(os.path.dirname(os.path.abspath(fm3dgan_torch.__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [x for x in os.environ.get("PYTHONPATH", "").split(os.pathsep) if x]))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=args.timeout, env=env)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-6000:])
        raise SystemExit(f"run {index} ({kind}) exited {proc.returncode}")
    with open(stats) as f:
        st = json.load(f)
    with open(os.path.join(exp, "training_log.jsonl")) as f:
        log = [x for x in map(json.loads, f) if "iter" in x]
    starts = st["starts"] + [st["end"]]
    periods = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]
    allocator = st["allocator"]
    return dict(run=index, kind=kind, iterations=len(st["starts"]), periods_ms=periods,
                ms_per_iteration=(st["end"] - st["starts"][1]) * 1e3 / (len(st["starts"]) - 1),
                median_period_ms=statistics.median(periods[1:]),
                enqueue_ms=[(b - a) * 1e3 for a, b in zip(st["starts"], st["returns"])],
                allocator_after_first={k: allocator[-1][k] - allocator[1][k] for k in allocator[-1]}
                if allocator else None,
                profile=st.get("profile"),
                load_s=[x["load_s"] for x in log], median_load_s=statistics.median(
                    x["load_s"] for x in log[1:]), process_s=time.perf_counter() - t0)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--child"]:  # --child STATS -- cli args
        return child_main(argv[1], argv[3:])
    extra = []
    if "--" in argv:
        extra = argv[argv.index("--") + 1:]
        argv = argv[:argv.index("--")]
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--work_dir", default=os.path.join("build", "loop_timing"))
    p.add_argument("--image_size", type=int, default=1024, help="the PNGs' size (FFHQ's 1024)")
    p.add_argument("--n_photos", type=int, default=32, help="reconstruction photos")
    p.add_argument("--n_ids", type=int, default=8, help="identities of the pair layout")
    p.add_argument("--n_var", type=int, default=4, help="pairs per identity")
    p.add_argument("--iters", type=int, default=12)
    p.add_argument("--runs", default="one,ddp,ddp,one")
    p.add_argument("--device", default="cuda")
    p.add_argument("--label", default="")
    p.add_argument("--timeout", type=float, default=900.0, help="seconds per run")
    p.add_argument("--profile", default=None, metavar="A:B",
                   help="profile iterations A to B - 1 of every run (torch.profiler; the "
                        "window's periods are not the loop's)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    os.makedirs(args.work_dir, exist_ok=True)
    t0 = time.perf_counter()
    rec, ds = make_layouts(args.work_dir, args.image_size, args.n_photos, args.n_ids, args.n_var)
    result = dict(label=args.label, image_size=args.image_size, iters=args.iters,
                  layouts_s=time.perf_counter() - t0, extra=extra, runs=[])
    if args.device.startswith("cuda"):
        result["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    for i, kind in enumerate(args.runs.split(",")):
        result["runs"].append(run_once(kind, i, args, rec, ds, extra))
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
