"""Training cells: the port's ``train_iteration`` at the configuration's
batch, fed as the training CLIs feed it.

Set-up builds the trainer with the benchmark's weights and runs the
traffic's warm-up iterations (``warmup_order``: every branch of the
schedule, R1 and PPL included, a plain reconstruction first) through the
window's own call and feed; after the first it reads the losses, each
optimizer's first gradient and each parameter's change (the start).
The window then starts at ``window_start`` (a multiple of the schedule's
period, so every run sees the same mix) and ends at the first iteration
boundary past ``--seconds`` at which the count of iterations is a multiple
of ``window_multiple`` (whole PPL periods).
Each batch is staged (``stage_batch``: pinned memory, a side stream) right
after the previous iteration is enqueued, as the CLIs do.

A traced run profiles the first ``traced_iterations`` of the window and
times the rest one by one, with a synchronize around each.  After the
window the program's state is copied (``TrainSystem.snapshot``) and the
program runs one iteration of each branch of the schedule (``BRANCHES``,
the first such index past the window) from that state, set back to it
before each.  The program is then freed; the reference follows the start
from the weights made again from the seed, and each branch from the same
snapshot, with the same batches and noise (``harness/compare.py``).
"""

from __future__ import annotations

import math
import time

from harness import compare, flops, models, spec, trace
from harness.device import free, memory_peak, sync
from harness.feed import TrainFeed


# One iteration of each branch is compared: (name, whether index i is one).
BRANCHES = {
    "3enc": (("rec", lambda c, i: not c.is_ds_iter(i) and not _reg(c, i)),
             ("ds", lambda c, i: c.is_ds_iter(i) and not c.is_extreme_ds_iter(i)),
             ("extreme_ds", lambda c, i: c.is_extreme_ds_iter(i)),
             ("r1_ppl", lambda c, i: _r1(c, i) and _ppl(c, i))),
    "2enc": (("rec", lambda c, i: not c.is_ds_iter(i) and not _reg(c, i)),
             ("ffhq_ds", lambda c, i: c.is_ds_iter(i)),
             ("r1_ppl", lambda c, i: _r1(c, i) and _ppl(c, i))),
}


def _r1(schedule, i: int) -> bool:
    return i % schedule.d_reg_every == 0


def _ppl(schedule, i: int) -> bool:
    return bool(schedule.use_g_reg and i % schedule.g_reg_every == 0)


def _reg(schedule, i: int) -> bool:
    """Whether iteration ``i`` runs R1 or PPL."""
    return _r1(schedule, i) or _ppl(schedule, i)


def branch_indices(cfg, schedule, end: int) -> dict:
    """{branch: the first index from ``end`` on that runs it}."""
    return {name: next(i for i in range(end, end + 10 * schedule.d_reg_every * schedule.ds_freq
                                        * schedule.ex_ds_freq) if is_it(schedule, i))
            for name, is_it in BRANCHES[cfg["model"]]}


def start_readings(system, i: int, metrics, start_weights):
    """(losses, first gradients, change norms) after the first iteration,
    ``i``, from ``start_weights``."""
    sched = system.trainer.config
    return (compare.losses(metrics, _r1(sched, i), _ppl(sched, i)), compare.grad_norms(system),
            compare.change_norms(system, start_weights))


def _warm_up(system, feed, tr, start_weights):
    """The warm-up iterations through the window's call and feed; returns
    the start readings and the window's first batch, staged."""
    order = tr["warmup_order"]
    start = None
    staged = system.stage(*feed.batch(order[0]))
    for k, i in enumerate(order):
        metrics = system.train_iteration(i, *staged)
        staged = system.stage(*feed.batch(order[k + 1] if k + 1 < len(order)
                                          else tr["window_start"]))
        if k == 0:
            start = start_readings(system, i, metrics, start_weights)
    return start, staged


def branch_readings(system, feed, indices: dict, snap) -> dict:
    """{branch: (losses, optimizer moves, change norms)} of one iteration
    of each branch, ``system`` set back to ``snap`` before each."""
    sched = system.trainer.config
    out = {}
    for name, i in indices.items():
        system.restore(snap)
        metrics = system.train_iteration(i, *system.stage(*feed.batch(i)))
        out[name] = (compare.losses(metrics, _r1(sched, i), _ppl(sched, i)),
                     compare.optimizer_moves(system, snap),
                     compare.change_norms(system, snap["modules"]))
    return out


def _window(system, feed, tr, seconds, staged, device, sync_each: bool = False, first: int = 0,
            count: int = 0):
    """Iterations from ``window_start + first``: ``count`` of them, or until
    ``seconds`` have passed at a multiple of ``window_multiple``; returns
    (metrics per iteration, wall seconds, host seconds per iteration when
    ``sync_each``, the next staged batch)."""
    i = tr["window_start"] + first
    out, step_s = [], []
    sync(device)
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        out.append(system.train_iteration(i, *staged))
        staged = system.stage(*feed.batch(i + 1))
        if sync_each:
            sync(device)
            step_s.append(time.perf_counter() - t0)
        i += 1
        if count:
            if len(out) == count:
                break
        elif time.perf_counter() - start >= seconds and len(out) % tr["window_multiple"] == 0:
            break
    sync(device)
    return out, time.perf_counter() - start, step_s, staged


def _finite(metrics) -> bool:
    return all(math.isfinite(v) for v in compare.losses(metrics).values())


def _iteration_flops(cfg, seed, feed, indices):
    """Model operations of each iteration in ``indices``, counted on the
    reference on the meta device, once per kind of iteration."""
    ref = models.reference_trainer(cfg, seed, None, device="meta", noise=False)
    sched = ref.trainer.config
    by_kind, out = {}, []
    for i in indices:
        kind = (sched.is_ds_iter(i), sched.is_extreme_ds_iter(i), i % sched.d_reg_every == 0,
                sched.use_g_reg and i % sched.g_reg_every == 0)
        if kind not in by_kind:
            batch = feed.batch(i)
            by_kind[kind] = flops.count(lambda: ref.train_iteration(i, *batch))
        out.append(by_kind[kind])
    return out


def run(ctx: spec.Context) -> spec.Outcome:
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    t0 = time.perf_counter()
    schedule = models.train_config(cfg)
    weights = models.make_weights(cfg, ctx.seed, ctx.device, training=True)
    system = models.program_trainer(cfg, ctx.seed, weights, device=ctx.device)
    feed = TrainFeed(ctx.seed, tr["pool"], tr["batch"], cfg["input_size"], cfg["size"], schedule,
                     ffhq=cfg.get("ds_dataset_type") == "FFHQ")
    start, staged = _warm_up(system, feed, tr, weights)
    del weights
    sync(ctx.device)
    setup_s = time.perf_counter() - t0

    records, busy_s, window_s, breakdown = {}, None, None, None
    if ctx.trace:
        n_traced = tr["traced_iterations"]
        with trace.traced(ctx.build_dir, ctx.device) as traced:
            first_part, _, _, staged = _window(system, feed, tr, 0, staged, ctx.device,
                                               count=n_traced)
        tr_ = traced["trace"]
        rest, wall, step_s, staged = _window(system, feed, tr, ctx.seconds, staged, ctx.device,
                                             sync_each=True, first=n_traced)
        done = first_part + rest
        idx = [tr["window_start"] + n_traced + k for k in range(len(rest))]
        records.update(
            trace=tr_, units=n_traced,
            step_ms={"plain": [s * 1e3 for i, s in zip(idx, step_s) if not _reg(schedule, i)],
                     "reg": [s * 1e3 for i, s in zip(idx, step_s) if _reg(schedule, i)]},
            window_s=wall, indices=idx)
        busy_s, window_s = tr_.busy_s(), tr_.window_s
        breakdown = {"device_ops": tr_.top_device_ops(), "idle_gaps": tr_.idle_gaps()}
        end_to_end = {}
    else:
        done, wall, _, staged = _window(system, feed, tr, ctx.seconds, staged, ctx.device)
        end_to_end = {"train_ms_per_iter": wall / len(done) * 1e3}
    end_to_end["setup_s"] = setup_s
    attempted, failed = len(done), sum(not _finite(m) for m in done)
    peak = memory_peak(ctx.device)
    indices = branch_indices(cfg, schedule, tr["window_start"] + len(done))
    del done, staged
    snap = system.snapshot()
    prog = (start, branch_readings(system, feed, indices, snap))
    del system
    free(ctx.device)

    ref = reference_readings(cfg, tr, ctx.seed, feed, indices, snap, ctx.device)
    del snap
    got = numbers(prog, ref)
    checks = [spec.Check(k, got[k], limit) for k, limit in ctx.cell.limits.items()]
    if ctx.trace:
        records["flops"] = sum(_iteration_flops(cfg, ctx.seed, feed, records["indices"]))
    return spec.Outcome(end_to_end=end_to_end, records=records, checks=checks,
                        attempted=attempted, failed=failed, memory_peak_bytes=peak,
                        busy_s=busy_s, window_s=window_s, breakdown=breakdown)


def reference_readings(cfg, tr, seed, feed, indices, snap, device):
    """The reference's start, from weights made again from the seed, and
    its branches from ``snap``."""
    weights = models.make_weights(cfg, seed, device, training=True)
    ref = models.reference_trainer(cfg, seed, weights, device)
    i = tr["warmup_order"][0]
    start = start_readings(ref, i, ref.train_iteration(i, *ref.stage(*feed.batch(i))), weights)
    del weights
    return start, branch_readings(ref, feed, indices, snap)


def numbers(prog, ref) -> dict:
    """The numbers compared, from (start readings, branch readings) of the
    program and of the reference; each branch number is the worst branch's."""
    (p_loss, p_grad, p_change), p_branches = prog
    (r_loss, r_grad, r_change), r_branches = ref
    out = {"start_loss_gap": compare.loss_gap([p_loss], [r_loss]),
           "start_grad_gap": compare.grad_gap([p_grad], [r_grad]),
           "start_change_gap": compare.change_gap(p_change, r_change, r_grad)}
    per = [compare.branch_numbers(p_branches[b], r_branches[b]) for b in r_branches]
    out.update({k: max(n[k] for n in per) for k in per[0]})
    return out
