"""Named spans at the port's layer boundaries, on the profiler's clock.

``span(name, **attrs)`` marks a block of host code.  While a
``torch.profiler`` runs, the block becomes one host event named ``name``
(``cat`` ``cpu_op`` in the Chrome trace, ``attrs`` among its ``args`` when
the profiler records shapes), kept in memory by the profiler and written
with the device events, so spans and kernels share one clock.  With no
profiler running a span records nothing and costs an enter and an exit of a
native context manager (about half a microsecond on the host).  There is no
switch of its own: tracing is on exactly when the profiler is.

A span launches nothing, synchronizes nothing and reads no device value; it
dispatches no operator, so ``torch.export`` sees none.  Names start with
``fm3d.``; none contains ``conv`` or starts with ``fm3dgan_torch::``, which
the trace's readers take for convolutions and for the port's kernels.

    fm3d.train.iteration (iter)   Trainer / Trainer2.train_iteration
    fm3d.train.stage_batch        TrainerBase.stage_batch
    fm3d.train.<step>             each step of train/steps.py and steps_2encoder.py
    fm3d.train.apply              gradient averaging, Adam's step, zero_grad
    fm3d.train.ema                the g_ema update
    fm3d.model.<module>           e_tsr, e_w, e_w_plus, e_tensor, e_mod, generator
    fm3d.model.g_level.<res>      one synthesis level of Generator.forward (res 4 ... 1024):
                                  its StyledConvs and its ToRGB with the skip's up2
    fm3d.model.psp_body           GradualStyleEncoder's input layer and IR-SE units
    fm3d.model.psp_styles         its lateral fusion and GradualStyleBlocks
    fm3d.parallel.grads           the gradient all-reduce of parallel.average_gradients
    fm3d.parallel.stats           parallel.gather_stats: the global BatchNorm's and the
                                  minibatch stddev's gathers
                                  (both only while a process group is active)
    fm3d.loss.lpips / .arcface    the frozen loss networks' calls
    fm3d.edit.forward             forward_3_encoder / forward_2_encoder
    fm3d.edit.to_device           their inputs' copies to the device (through pinned
                                  buffers for host inputs) and permutes
    fm3d.edit.to_host             the image's and the latent's copy out to the host, for
                                  host inputs: chunks through pinned buffers
    fm3d.edit.capture             forward_3_encoder's warm-up and capture of a CUDA graph
    fm3d.edit.replay              its copies in, the graph's replay and the outputs' clones
                                  or copy out
"""

from __future__ import annotations

from torch._C._profiler import _RecordFunctionFast


def span(name: str, **attrs) -> _RecordFunctionFast:
    """A context manager recording ``name`` with ``attrs`` while a
    ``torch.profiler`` runs, and nothing otherwise."""
    return _RecordFunctionFast(name, (), attrs)
