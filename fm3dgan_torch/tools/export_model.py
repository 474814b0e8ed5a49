"""Ahead-of-time export of the serving forward: the counterpart of
``tools/export_model.py``.

``torch.export`` traces the 3-encoder forward of a training checkpoint
(``forward_3_encoder`` with the checkpoint's options, as the edit CLI runs
it) at a static batch into a ``.pt2`` program.  The hand-written kernels
appear in it as the ``torch.ops.fm3dgan_torch`` operators, so loading and
running the program needs ``import fm3dgan_torch.ops`` (which registers
them and builds the kernels at their first CUDA launch) and no model code.
As in the JAX tool, the weights are call arguments, not part of the
program: one program serves every checkpoint of the same architecture.

    # Export (on cuda unless --device cpu; the program runs on the device of
    # its trace):
    python -m fm3dgan_torch.tools.export_model --ckpt_dir Exp/ckpt --step 420000 \\
        --out model.pt2 --batch 32 --dtype bfloat16

    # Round trip: reload the program and compare it with the live forward
    # (both under cuDNN's deterministic algorithms).
    python -m fm3dgan_torch.tools.export_model --ckpt_dir Exp/ckpt --step 420000 \\
        --out model.pt2 --verify

Serving from the file:

    import torch, fm3dgan_torch.ops
    program = torch.export.load("model.pt2").module()
    image = program(weights, photo, render)   # NHWC float32 in [-1, 1]

where ``weights`` is :func:`program_weights` of the checkpoint's
``ServingForward`` (its parameters and buffers by name).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from fm3dgan_torch.pipeline.forward import forward_3_encoder

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
VERIFY_TOL = {"float32": 2e-5, "bfloat16": 5e-2}


class ServingForward(nn.Module):
    """``forward_3_encoder`` of ``models`` with a checkpoint's options:
    (photo, render) NHWC in [-1, 1] -> the edited image NHWC."""

    def __init__(self, models: nn.Module, meta: Dict):
        super().__init__()
        self.models = models
        self.options = dict(
            tsr_encode=meta.get("tsr_encode", "Render Image"),
            sliced_layer=tuple(meta["sliced_layer"]) if meta.get("sliced_layer") else None,
            use_tanh=bool(meta.get("use_tanh", False)),
        )

    def forward(self, photo, render):
        return forward_3_encoder(self.models, photo, render, **self.options)


class WeightsAsInputs(nn.Module):
    """(weights, photo, render) -> ``serving(photo, render)`` with
    ``weights`` in place of its parameters and buffers
    (``torch.func.functional_call``).  ``serving`` is held outside the
    module tree, so an exported program of this module holds no weight."""

    def __init__(self, serving: ServingForward):
        super().__init__()
        self._serving = (serving,)

    def forward(self, weights: Dict[str, torch.Tensor], photo, render):
        return torch.func.functional_call(self._serving[0], weights, (photo, render))


def program_weights(serving: ServingForward) -> Dict[str, torch.Tensor]:
    """The program's first argument: every parameter and buffer by name."""
    return {**dict(serving.named_parameters()), **dict(serving.named_buffers())}


def export_forward(serving: ServingForward, batch: int, in_size: int):
    """The ``torch.export`` program of ``serving`` with its weights as
    inputs, traced on ``serving``'s device at NHWC float32 inputs of
    ``batch`` x ``in_size``², without the example inputs (which would hold a
    copy of the weights).  The example photo and render are two tensors: one
    tensor passed twice would make them one input of the program."""
    photo, render = (torch.zeros(batch, in_size, in_size, 3, device=serving.models.device)
                     for _ in range(2))
    with torch.no_grad():
        program = torch.export.export(WeightsAsInputs(serving),
                                      (program_weights(serving), photo, render), strict=False)
    program.example_inputs = None
    return program


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms: its default ones are not run-to-run
    deterministic, and two eager forwards of a trained 256 px checkpoint
    differ by more than the float32 bar that the program is held to."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def seeded_inputs(batch: int, in_size: int, seed: int = 0):
    """The verification's (photo, render): uniform in [-1, 1] from
    ``np.random.RandomState(seed)``, as the JAX tool draws them."""
    rng = np.random.RandomState(seed)
    shape = (batch, in_size, in_size, 3)
    return (torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)),
            torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)))


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ckpt_dir", type=str, required=True)
    p.add_argument("--step", type=int, required=True)
    p.add_argument("--no_ema", action="store_true")
    p.add_argument("--out", type=str, required=True, help="output program path (.pt2)")
    p.add_argument("--batch", type=int, default=32, help="static serving batch size")
    p.add_argument("--input_size", type=int, default=None)
    p.add_argument("--dtype", default="float32", choices=tuple(DTYPES))
    p.add_argument("--device", type=str, default=None,
                   help="torch device to trace on (default cuda; cpu to run on the CPU); the "
                        "program runs on the device of its trace")
    p.add_argument("--verify", action="store_true",
                   help="after writing, load the program and check its output against the "
                        "live forward")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_arg_parser().parse_args(argv)

    from fm3dgan_torch.utils.analysis import build_manipulator_from_checkpoint

    models, meta = build_manipulator_from_checkpoint(args.ckpt_dir, args.step,
                                                     use_ema=not args.no_ema,
                                                     device=args.device, dtype=DTYPES[args.dtype])
    serving = ServingForward(models, meta)
    in_size = args.input_size or meta.get("input_size") or meta["size"]
    program = export_forward(serving, args.batch, in_size)
    torch.export.save(program, args.out)
    print(f"exported {args.out}: {os.path.getsize(args.out) / 1e6:.2f} MB, "
          f"device={models.device.type}, batch={args.batch}, {in_size}px, {args.dtype}")

    if args.verify:
        reloaded = torch.export.load(args.out).module()
        photo, render = (x.to(models.device) for x in seeded_inputs(args.batch, in_size))
        weights = program_weights(serving)
        with deterministic_cudnn(), torch.no_grad():
            got = reloaded(weights, photo, render).float().cpu().numpy()
            want = serving(photo, render).float().cpu().numpy()
        # bfloat16 outputs carry about 2^-8 relative precision, which the
        # JAX tool's bar allows for.
        tol = VERIFY_TOL[args.dtype]
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
        print(f"verify OK: program output matches live forward "
              f"(max |delta| = {np.max(np.abs(got - want)):.2e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
