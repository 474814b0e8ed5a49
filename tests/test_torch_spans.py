"""The port's ``fm3d.`` spans on the CPU, under ``torch.profiler`` with
shapes recorded as the benchmark's traced runs record them:

* a 3-encoder iteration with R1 and PPL emits its step, optimizer, EMA,
  model and loss spans, each inside the span it belongs to;
* a 2-encoder FFHQ dual-supervision iteration emits the three FFHQ spans;
* ``forward_3_encoder`` and ``forward_2_encoder`` emit ``fm3d.edit.forward``
  with their children in order;
* every span is a ``cpu_op`` whose name the trace's readers take for
  neither a convolution nor one of the port's kernels, and the iteration
  span carries its index;
* the same iteration without a profiler gives the same numbers to the bit
  and leaves nothing behind, and the exported serving program holds no
  profiler node."""

import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fm3dgan_torch.models import LPIPS, Discriminator, ResNetFace18
from fm3dgan_torch.pipeline import FaceManipulator, TwoEncoderModels
from fm3dgan_torch.pipeline.forward import forward_2_encoder, forward_3_encoder
from fm3dgan_torch.tools import export_model
from fm3dgan_torch.train import TrainConfig, Trainer, Trainer2, TrainState2

TINY = dict(size=16, latent=32, width_mult=1 / 16, rec_face_reg_loss_lambda=0.0,
            ds_face_reg_loss_lambda=0.0, ep_face_reg_loss_lambda=0.0)
STEPS = ("fm3d.train.d_step", "fm3d.train.d_reg_step", "fm3d.train.g_step",
         "fm3d.train.g_reg_step")
ENCODERS = ("fm3d.model.e_tsr", "fm3d.model.e_w", "fm3d.model.e_w_plus")
FFHQ = ("fm3d.train.d_ffhq_step", "fm3d.train.d_ffhq_reg_step", "fm3d.train.g_ffhq_ds_step")


def _spans(fn, tmp_path, name="trace.json"):
    """(fn's result, the trace's ``fm3d.`` events by start) under a CPU
    profiler with shapes recorded."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        out = fn()
    path = os.path.join(tmp_path, name)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return out, sorted((ev for ev in events if ev.get("name", "").startswith("fm3d.")),
                       key=lambda ev: (ev["ts"], -ev["dur"]))


def _parents(spans):
    """[(name, innermost enclosing span's name or None)] in start order."""
    out, stack = [], []
    for ev in spans:
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= ev["ts"]:
            stack.pop()
        out.append((ev["name"], stack[-1]["name"] if stack else None))
        stack.append(ev)
    return out


def _batch(seed, n=2):
    rng = np.random.RandomState(seed)
    photo, render = (rng.randint(0, 256, (n, 128, 128, 3)).astype(np.uint8) for _ in range(2))
    return photo, render, rng.randint(0, 256, (n, 16, 16, 3)).astype(np.uint8)


def _tensors(trainer):
    st = trainer.state
    out = {f"{k}.{n}": t for k, m in trainer._modules().items()
           for n, t in m.state_dict().items()}
    for k in trainer.OPTIMIZERS:
        for i, s in getattr(st, k).state_dict()["state"].items():
            out.update({f"{k}.{i}.{n}": t for n, t in s.items()})
    out["mean_path_length"] = st.mean_path_length
    return out


@pytest.fixture(scope="module")
def three_encoder(tmp_path_factory):
    """Iteration 0 (R1 and PPL; not DS) of two tiny trainers from one seed,
    the first under the profiler with its batch staged, the second without."""
    batch = _batch(0)

    def run(trainer):
        return trainer.train_iteration(0, *trainer.stage_batch(*batch))

    traced, plain = (Trainer(TrainConfig(**TINY), seed=0, device="cpu", input_size=128)
                     for _ in range(2))
    metrics, spans = _spans(lambda: run(traced), tmp_path_factory.mktemp("spans"))
    return dict(spans=spans, metrics=metrics, traced=traced, plain_metrics=run(plain),
                plain=plain)


def _inside_models(names):
    """(span, parent) of each model span's own spans, after it: pSp's body
    and style blocks inside an encoder that is a GradualStyleEncoder, and
    G's synthesis levels (4, 8 and 16 px at size 16) inside G."""
    out = []
    for m in names:
        out.append(m)
        if m in ("fm3d.model.e_w_plus", "fm3d.model.e_mod"):
            out += [("fm3d.model.psp_body", m), ("fm3d.model.psp_styles", m)]
        if m == "fm3d.model.generator":
            out += [(f"fm3d.model.g_level.{r}", m) for r in (4, 8, 16)]
    return out


def test_three_encoder_iteration_spans_nest(three_encoder):
    got = _parents(three_encoder["spans"])
    model = ENCODERS + ("fm3d.model.generator",)

    def models_in(step):
        return [p if isinstance(p, tuple) else (p, step) for p in _inside_models(model)]

    want = [("fm3d.train.stage_batch", None), ("fm3d.train.iteration", None),
            ("fm3d.train.d_step", "fm3d.train.iteration"),
            *models_in("fm3d.train.d_step"),
            ("fm3d.train.apply", "fm3d.train.d_step"),
            ("fm3d.train.d_reg_step", "fm3d.train.iteration"),
            ("fm3d.train.apply", "fm3d.train.d_reg_step"),
            ("fm3d.train.g_step", "fm3d.train.iteration"),
            *models_in("fm3d.train.g_step"),
            ("fm3d.loss.lpips", "fm3d.train.g_step"), ("fm3d.loss.arcface", "fm3d.train.g_step"),
            ("fm3d.train.apply", "fm3d.train.g_step"),
            ("fm3d.train.g_reg_step", "fm3d.train.iteration"),
            *models_in("fm3d.train.g_reg_step"),
            ("fm3d.train.apply", "fm3d.train.g_reg_step"),
            ("fm3d.train.ema", "fm3d.train.g_reg_step")]
    assert got == want


def test_every_span_is_a_host_op_the_readers_keep_apart(three_encoder, tmp_path):
    models = FaceManipulator.create(size=16, style_dim=32, width_mult=1 / 16, input_size=128,
                                    device="cpu", seed=1)
    x = torch.zeros(1, 128, 128, 3)
    _, edit = _spans(lambda: forward_3_encoder(models, x, x.clone()), tmp_path)
    for ev in three_encoder["spans"] + edit:
        name = ev["name"]
        assert ev["cat"] == "cpu_op" and ev["ph"] == "X", ev
        assert "conv" not in name.lower() and not name.startswith("fm3dgan_torch::"), name
    iteration = [ev for ev in three_encoder["spans"] if ev["name"] == "fm3d.train.iteration"]
    assert [ev["args"]["iter"] for ev in iteration] == [0]


def test_spans_change_no_number(three_encoder):
    got, want = three_encoder["metrics"], three_encoder["plain_metrics"]
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], torch.Tensor):
            assert torch.equal(got[k], want[k]), k
        else:
            assert got[k] == want[k], k
    a, b = _tensors(three_encoder["traced"]), _tensors(three_encoder["plain"])
    assert sorted(a) == sorted(b)
    for k in b:
        assert torch.equal(a[k], b[k]), k


def test_no_span_is_recorded_without_a_profiler(three_encoder, tmp_path):
    """The iteration run without a profiler left nothing that a profiler
    started afterwards writes out."""
    assert not torch.autograd.profiler._is_profiler_enabled
    _, spans = _spans(lambda: None, tmp_path)
    assert spans == []


def _ffhq_trainer():
    """A 2-encoder FFHQ trainer on a small Tensor Transform state at 128 px
    in and out (stem width 4), R1 and PPL every iteration."""
    cfg = TrainConfig(size=16, d_reg_every=1, g_reg_every=1, rec_face_reg_loss_lambda=0.0,
                      ds_face_reg_loss_lambda=0.0, ep_face_reg_loss_lambda=0.0)
    trainer = Trainer2(cfg, device="cpu", input_size=128, ds_dataset_type="FFHQ",
                       use_lpips=False, use_arcface=False)
    torch.manual_seed(5)
    models = TwoEncoderModels.create(size=128, co_modulation="Tensor Transform", latent=32,
                                     input_size=128, width_mult=1 / 16, device="cpu", seed=5)
    d, d_ffhq = (Discriminator(size=128, width_mult=1 / 16) for _ in range(2))
    trainer.state = TrainState2.create(
        cfg, models, d, d_ffhq, lpips=LPIPS().requires_grad_(False).eval(),
        arcface=ResNetFace18(64).requires_grad_(False).eval())
    return trainer


def test_ffhq_iteration_emits_the_ffhq_spans(tmp_path):
    trainer = _ffhq_trainer()
    rng = np.random.RandomState(7)
    photo, render, ffhq = (rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
                           for _ in range(3))
    _, spans = _spans(lambda: trainer.train_iteration(1, photo, render, photo, ffhq_ref=ffhq),
                      tmp_path)
    parents = _parents(spans)
    steps = [(n, p) for n, p in parents if p == "fm3d.train.iteration"]
    assert steps == [(n, "fm3d.train.iteration") for n in FFHQ + STEPS]
    inside = {n: [c for c, p in parents if p == n] for n in FFHQ}
    model = ["fm3d.model.e_tensor", "fm3d.model.e_mod", "fm3d.model.generator"]
    assert inside["fm3d.train.d_ffhq_step"] == model + ["fm3d.train.apply"]
    assert inside["fm3d.train.d_ffhq_reg_step"] == ["fm3d.train.apply"]
    assert inside["fm3d.train.g_ffhq_ds_step"] == model + ["fm3d.loss.arcface",
                                                           "fm3d.train.apply"]


def test_edit_forwards_emit_their_children(tmp_path):
    m3 = FaceManipulator.create(size=16, style_dim=32, width_mult=1 / 16, input_size=128,
                                device="cpu", seed=1)
    m2 = TwoEncoderModels.create(size=16, co_modulation="Tensor Transform", latent=32,
                                 input_size=128, width_mult=1 / 16, device="cpu", seed=2)
    photo, render = torch.zeros(1, 128, 128, 3), torch.ones(1, 128, 128, 3) * 0.5
    for fwd, models, middle in ((forward_3_encoder, m3, list(ENCODERS)),
                                (forward_2_encoder, m2, ["fm3d.model.e_tensor",
                                                         "fm3d.model.e_mod"])):
        want = fwd(models, photo, render)
        got, spans = _spans(lambda: fwd(models, photo, render), tmp_path)
        assert torch.equal(got, want)
        assert _parents(spans) == [("fm3d.edit.forward", None)] + [
            p if isinstance(p, tuple) else (p, "fm3d.edit.forward")
            for p in _inside_models(["fm3d.edit.to_device", *middle, "fm3d.model.generator"])]


def test_exported_program_holds_no_profiler_node():
    models = FaceManipulator.create(size=16, style_dim=32, width_mult=1 / 16, input_size=128,
                                    device="cpu", seed=3)
    program = export_model.export_forward(export_model.ServingForward(models, {}), 1, 128)
    targets = [str(node.target) for node in program.graph.nodes if node.op == "call_function"]
    assert any("fm3dgan_torch" in t for t in targets)  # the forward was traced
    assert not [t for t in targets if "profiler" in t or "record_function" in t]
