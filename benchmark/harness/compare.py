"""The numbers that decide ``correct``, each from the program's output and
the reference's.

Training compares two things.  The start: the first warm-up iteration,
which both sides run from the weights made from the seed, the same batch
and the same noise:

- ``start_loss_gap``: the largest relative gap between a loss the
  program reported and the reference's;
- ``start_grad_gap``: each optimizer's first gradient, read from its state
  after its first step (Adam's first moment, which with beta1 = 0 is the
  gradient itself): the gap between the program's norm of a leaf and the
  reference's over the larger of the reference's norm of that leaf and of
  the optimizer's median leaf, for the worst leaf;
- ``start_change_gap``: the same for the norm of each parameter's change
  (g_ema's included).

And one iteration of each branch of the schedule (``BRANCHES``), run by
both sides from the same state: the program's, as the window left it
(``TrainSystem.snapshot``), so that the variation of cuDNN's float32
algorithms that earlier iterations carried forward is not compared:

- ``loss_gap``: the largest relative gap of a loss that the iteration
  computed (R1's and the path length's only where it ran them);
- ``grad_gap``: each optimizer's last gradient of the iteration (its first
  moment), as ``start_grad_gap``; a leaf that took another number of steps
  than the reference's reads infinity;
- ``moment_gap``: the same for the change of each leaf's second moment,
  which every gradient of the iteration enters (an optimizer that steps
  twice, as D's does under R1 and G's under PPL or FFHQ dual supervision);
- ``change_gap``: the same for each parameter's change (g_ema's included).

Every change leaves out the leaves whose last gradient is nought to
rounding in the reference (under a thousandth of its optimizer's median
leaf), which Adam moves by its round-off; the leaves of an optimizer that
did not step are kept, and have to stay where they were.  Each branch
number is the worst over the branches.  A run compares the numbers that
``checks/<cell>.json`` lists; ``calibrate.py`` records them all.

Editing: ``image_gap``, the largest absolute difference between an edited
image of the program and the reference's over the largest magnitude of the
reference's, for the worst request of a sample drawn from the seed.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from harness.weights import derive_seed

LOSS_KEYS = ("d", "r1", "g", "lpips", "l1", "face_id", "hmap", "face_reg", "g_reg",
             "path_length", "d_ffhq", "r1_ffhq", "g_ffhq", "face_id_ffhq")
NOUGHT = 1e-3
Norms = Dict[str, float]


def losses(metrics: Dict, do_r1: bool = True, do_ppl: bool = True) -> Dict[str, float]:
    """The losses in ``metrics``; R1's and the path length's (which the
    trainers carry over from the last iteration that ran them) only where
    the flags say that this one did."""
    skip = set(() if do_r1 else ("r1",)) | set(() if do_ppl else ("g_reg", "path_length"))
    return {k: float(metrics[k]) for k in LOSS_KEYS if k in metrics and k not in skip}


def _norms(keys, tensors) -> Norms:
    if not keys:
        return {}
    return dict(zip(keys, torch.stack(torch._foreach_norm(tensors)).cpu().tolist()))


def grad_norms(system) -> Dict[str, Norms]:
    """{optimizer: {leaf: norm of its Adam first moment}} of the optimizers
    that have taken exactly one step: their first gradient."""
    out = {}
    for name, (opt, params) in system.optimizers().items():
        held = [(k, opt.state[p]) for k, p in params if p in opt.state]
        if held and all(int(st["step"]) == 1 for _, st in held):
            out[name] = _norms([k for k, _ in held], [st["exp_avg"] for _, st in held])
    return out


def change_norms(system, start: Dict[str, Dict[str, torch.Tensor]]) -> Norms:
    """{leaf: norm of (parameter now - its value in ``start``)}; ``start``
    holds state dicts by group, and a g_ema leaf starts from G's where
    ``start`` has no g_ema."""
    keys, now, first = [], [], []
    for key, p in system.tracked().items():
        group, name = key.split(".", 1)
        keys.append(key)
        now.append(p.detach())
        first.append(start[group if group in start else "g"][name])
    return _norms(keys, torch._foreach_sub(now, first))


def optimizer_moves(system, snap) -> Dict[str, Dict[str, Tuple[float, float, float]]]:
    """{optimizer: {leaf: (steps taken since ``snap``, norm of the first
    moment, norm of the second moment's change)}}."""
    out = {}
    for name, (opt, params) in system.optimizers().items():
        held = snap["optim"][name]
        keys, steps, firsts, seconds = [], [], [], []
        for k, p in params:
            st = opt.state.get(p)
            if not st:
                continue
            before = held.get(k)
            keys.append(k)
            steps.append(float(st["step"]) - (float(before["step"]) if before else 0.0))
            firsts.append(st["exp_avg"])
            seconds.append(st["exp_avg_sq"] - before["exp_avg_sq"] if before else st["exp_avg_sq"])
        m, v = _norms(keys, firsts), _norms(keys, seconds)
        out[name] = {k: (n, m[k], v[k]) for k, n in zip(keys, steps)}
    return out


def loss_gap(prog: List[Dict[str, float]], ref: List[Dict[str, float]]) -> float:
    worst = 0.0
    for p, r in zip(prog, ref, strict=True):
        for k, b in r.items():
            a = p.get(k, math.nan)
            if a == b:
                continue
            gap = abs(a - b) / abs(b) if b != 0 else math.inf
            worst = max(worst, gap if gap == gap else math.inf)
    return worst


def _median(values) -> float:
    values = list(values)
    return float(np.median(values)) if values else 0.0


def norm_gap(prog: Norms, ref: Norms, keep=None) -> float:
    """The worst leaf's |prog - ref| / max(ref, median ref)."""
    keys = [k for k in ref if keep is None or keep(k)]
    med = _median(ref[k] for k in keys)
    worst = 0.0
    for k in keys:
        a = prog.get(k, math.nan)
        denom = max(ref[k], med)
        gap = abs(a - ref[k]) / denom if denom > 0 else (0.0 if a == ref[k] else math.inf)
        worst = max(worst, gap if gap == gap else math.inf)
    return worst


def grad_gap(prog: List[Dict[str, Norms]], ref: List[Dict[str, Norms]]) -> float:
    """Each optimizer's first gradient, from the iteration after which it
    had taken one step."""
    worst = 0.0
    for p, r in zip(prog, ref, strict=True):
        for opt, leaves in r.items():
            worst = max(worst, norm_gap(p.get(opt, {}), leaves))
    return worst


def nought_leaves(ref_grads: Dict[str, Norms]) -> set:
    """Leaves whose reference gradient is under a thousandth of their
    optimizer's median leaf, with the g_ema leaves of such G leaves."""
    out = set()
    for leaves in ref_grads.values():
        med = _median(leaves.values())
        out.update(k for k, v in leaves.items() if v < NOUGHT * med)
    return out | {"g_ema." + k[2:] for k in out if k.startswith("g.")}


def change_gap(prog: Norms, ref: Norms, ref_grads: Dict[str, Norms]) -> float:
    """The worst group's ``norm_gap`` of the changes, leaving out the nought
    leaves of ``ref_grads``."""
    nought = nought_leaves(ref_grads)
    groups = {k.split(".", 1)[0] for k in ref}
    return max(norm_gap(prog, ref, lambda k, g=g: k.split(".", 1)[0] == g and k not in nought)
               for g in groups)


def branch_numbers(prog, ref) -> Dict[str, float]:
    """The four numbers of one branch from (losses, optimizer moves, change
    norms) of the program and of the reference, both from one state."""
    p_loss, p_opt, p_change = prog
    r_loss, r_opt, r_change = ref
    steps = math.inf if any({k: v[0] for k, v in p_opt.get(o, {}).items()}
                            != {k: v[0] for k, v in leaves.items()}
                            for o, leaves in r_opt.items()) else 0.0
    stepped = {o: leaves for o, leaves in r_opt.items() if any(v[0] for v in leaves.values())}
    grads = {o: {k: v[1] for k, v in leaves.items()} for o, leaves in stepped.items()}

    def gap(j):
        return max([norm_gap({k: v[j] for k, v in p_opt.get(o, {}).items()},
                             {k: v[j] for k, v in leaves.items()})
                    for o, leaves in stepped.items()] or [0.0])

    return {"loss_gap": loss_gap([p_loss], [r_loss]), "grad_gap": max(steps, gap(1)),
            "moment_gap": max(steps, gap(2)), "change_gap": change_gap(p_change, r_change, grads)}


def image_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    scale = float(np.abs(ref).max())
    return float(np.abs(prog.astype(np.float64) - ref).max() / scale) if scale > 0 else math.inf


def sample(seed: int, n_done: int, k: int, must: Optional[List[int]] = None) -> List[int]:
    """``k`` of the ``n_done`` finished units, drawn from the seed, with
    ``must`` among them."""
    rng = np.random.default_rng(derive_seed(seed, 301))
    picked = set(must or [])
    rest = [j for j in rng.permutation(n_done).tolist() if j not in picked]
    return sorted(picked | set(rest[:max(0, k - len(picked))]))
