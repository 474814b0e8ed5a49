"""The 3-encoder edit forward replayed from CUDA graphs (``pipeline/graphs.py``).

On the CPU the graph path never engages: the forward runs eagerly as before
and is counted under ``cpu``; the signature, the address fingerprint and the
cache's bookkeeping (with a stand-in for the capture) are checked here.  The
``gpu`` tests capture and replay on the card at the small configuration.
"""

import copy
import json
import os

import pytest
import torch

from fm3dgan_torch import ops
from fm3dgan_torch.models.psp_encoder import _align_corners_weights
from fm3dgan_torch.pipeline import STATS, FaceManipulator, forward_3_encoder, graphs
from fm3dgan_torch.pipeline.forward import _combine_w_wplus, _edit, _latent_mask

SMALL = dict(size=16, input_size=128, width_mult=1 / 16, style_dim=32)


@pytest.fixture(scope="module")
def cpu_models():
    return FaceManipulator.create(**SMALL, device="cpu", seed=5)


def _pair(seed, n=1, size=128):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n, size, size, 3, generator=g) * 2 - 1,
            torch.rand(n, size, size, 3, generator=g) * 2 - 1)


def _state_dicts(models):
    return {"g": models.generator.state_dict(), "e_tsr": models.e_tsr.state_dict(),
            "e_w": models.e_w.state_dict(), "e_w_plus": models.e_w_plus.state_dict()}


# ---------------- the CPU: eager, as before ----------------------------------


def test_cpu_forward_is_eager_and_unchanged(cpu_models):
    """The modules composed by hand give the same bits; every call is counted
    eager under ``cpu`` and nothing is captured or remembered."""
    m = cpu_models
    photo, render = _pair(1, n=2)
    with torch.inference_mode():
        p, r = (x.permute(0, 3, 1, 2).contiguous() for x in (photo, render))
        latent = _combine_w_wplus(m.e_w(r), m.e_w_plus(p), (0, 2))
        img, lat = m.generator(input_is_latent=True, latent_styles=[latent],
                               external_input_tensor=m.e_tsr(r), randomize_noise=False,
                               return_latent=True)
        want = torch.tanh(img).permute(0, 2, 3, 1)
    before = copy.deepcopy(STATS)
    for _ in range(2):
        got, got_latent = forward_3_encoder(m, photo, render, sliced_layer=(0, 2), use_tanh=True,
                                            return_latent=True)
        assert torch.equal(got, want) and torch.equal(got_latent, lat)
    assert STATS["eager"].get("cpu", 0) == before["eager"].get("cpu", 0) + 2
    assert {k: STATS[k] for k in ("captures", "replays", "invalidations", "branches")} == {
        k: before[k] for k in ("captures", "replays", "invalidations", "branches")}
    assert not m.graphs.graphs and not m.graphs.seen


def _flip(flag):
    mod, name = flag

    def change():
        setattr(mod, name, not getattr(mod, name))
        return lambda: setattr(mod, name, not getattr(mod, name))
    return change


BASE = dict(tsr_encode="Render Image", sliced_layer=None, use_tanh=False, return_latent=False)
VARIANTS = {
    "photo_shape": dict(photo=(2, 64, 64, 3)),
    "render_shape": dict(render=(1, 32, 32, 3)),
    "photo_dtype": dict(photo_dtype=torch.float64),
    "render_dtype": dict(render_dtype=torch.bfloat16),
    "tsr_encode": dict(tsr_encode="Photo Image"),
    "sliced_layer": dict(sliced_layer=(0, 1)),
    "sliced_layer_empty": dict(sliced_layer=()),
    "use_tanh": dict(use_tanh=True),
    "return_latent": dict(return_latent=True),
    "cudnn_allow_tf32": dict(flip=(torch.backends.cudnn, "allow_tf32")),
    "matmul_allow_tf32": dict(flip=(torch.backends.cuda.matmul, "allow_tf32")),
    "cudnn_deterministic": dict(flip=(torch.backends.cudnn, "deterministic")),
}


def _signature(photo=(1, 64, 64, 3), render=(1, 64, 64, 3), photo_dtype=torch.float32,
               render_dtype=torch.float32, **options):
    return graphs.signature(torch.zeros(photo, dtype=photo_dtype),
                            torch.zeros(render, dtype=render_dtype), **{**BASE, **options})


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_signature_changes_with_each_part(variant):
    base = _signature()
    assert _signature() == base  # other tensors of the same shape and dtype
    spec = dict(VARIANTS[variant])
    flip = spec.pop("flip", None)
    if flip is not None:
        undo = _flip(flip)()
        try:
            changed = _signature(**spec)
        finally:
            undo()
    else:
        changed = _signature(**spec)
    assert changed != base
    assert _signature() == base
    hash(changed)


class _Probe(torch.nn.Module):
    """Holds the bundle so that ``functional_call`` can swap its tensors, and
    reads the fingerprint of a layout taken before the call."""

    def __init__(self, models, layout):
        super().__init__()
        self.models = models
        self.layout = layout

    def forward(self):
        return self.layout.addresses()


def _fresh_bundle():
    return FaceManipulator.create(**SMALL, device="cpu", seed=7)


@pytest.mark.parametrize("move", ["to", "load_state_dict_assign", "functional_call"])
def test_fingerprint_changes_when_tensors_move(move):
    m = _fresh_bundle()
    before = graphs.Layout(m).addresses()
    assert len(before) == len(list(m.parameters())) + len(list(m.buffers()))
    if move == "to":
        m.to(torch.float64)
        after = graphs.Layout(m).addresses()
    elif move == "load_state_dict_assign":
        m.generator.load_state_dict({k: v.clone() for k, v in m.generator.state_dict().items()},
                                    assign=True)
        after = graphs.Layout(m).addresses()
    else:
        layout = graphs.Layout(m)
        probe = _Probe(m, layout)
        swapped = {k: v.clone() for k, v in [*probe.named_parameters(), *probe.named_buffers()]}
        after = torch.func.functional_call(probe, swapped, ())
        assert layout.addresses() == before  # restored after the call
    assert after != before


def test_fingerprint_kept_by_load_variables():
    m = _fresh_bundle()
    layout = graphs.Layout(m)
    before = layout.addresses()
    new = _state_dicts(FaceManipulator.create(**SMALL, device="cpu", seed=8))
    m.load_variables(new)
    assert layout.current(m) and layout.addresses() == before
    assert torch.equal(m.generator.input.input, new["g"]["input.input"])


def test_fingerprint_sees_a_replaced_submodule():
    m = _fresh_bundle()
    layout = graphs.Layout(m)
    m.e_w = copy.deepcopy(m.e_w)
    assert not layout.current(m)
    assert graphs.Layout(m).addresses() != layout.addresses()


def test_host_made_constants_are_made_once():
    """pSp's interpolation matrices and the latent mask are made from host
    data once per shape, dtype and device (a capture cannot copy from the
    host), and never as inference tensors, so that a training forward can
    save them for its backward."""
    with torch.inference_mode():
        a = _align_corners_weights(4, 8, torch.float32, torch.device("cpu"))
    assert not a.is_inference() and not a.requires_grad
    assert _align_corners_weights(4, 8, torch.float32, torch.device("cpu")) is a
    assert _align_corners_weights(4, 8, torch.float64, torch.device("cpu")) is not a
    assert a.shape == (8, 4) and torch.allclose(a.sum(1), torch.ones(8))
    assert _latent_mask(5, frozenset({1, 3}), torch.device("cpu")) is _latent_mask(
        5, frozenset({3, 1}), torch.device("cpu"))
    w, wp = torch.randn(2, 4), torch.randn(2, 5, 4)
    got = _combine_w_wplus(w, wp, [1, 3])
    assert torch.equal(got, _combine_w_wplus(w, wp, [3, 1]))
    assert torch.equal(got[:, 1], w * wp[:, 1]) and torch.equal(got[:, 0], w)
    assert torch.equal(_combine_w_wplus(w, wp, None), w[:, None] * wp)


def test_training_forward_through_the_cached_constants():
    """A pSp forward with gradients after an inference call made the
    constants: the backward runs and reaches the encoder's input."""
    m = _fresh_bundle()
    photo, _ = _pair(8)
    with torch.inference_mode():
        m.e_w_plus(photo.permute(0, 3, 1, 2).contiguous())
    x = photo.permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    m.e_w_plus(x).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


# ---------------- the cache's bookkeeping, with a stand-in capture -----------


class _FakeGraph:
    """Replays by running the region eagerly: the bookkeeping without a card."""

    def __init__(self, region):
        self.region = region

    def replay(self, photo, render, return_latent):
        image, latent = self.region(photo, render)
        return image.clone(), latent.clone() if return_latent else None


@pytest.fixture
def fake_capture(monkeypatch):
    captured = []

    def capture(device, photo, render, region):
        captured.append(tuple(photo.shape))
        return _FakeGraph(region)
    monkeypatch.setattr(graphs, "capture", capture)
    return captured


def _run(m, photo, render, **options):
    """``forward_3_encoder``'s graph route as a card would take it."""
    opts = {**BASE, **options}

    def region(p, r):
        return _edit(m, p, r, opts["tsr_encode"], opts["sliced_layer"], opts["use_tanh"], None)
    with torch.inference_mode():
        key = graphs.signature(photo, render, **opts)
        return m.graphs.run(m, photo, render, key, opts["return_latent"], region), region


def test_first_sighting_eager_second_captures_then_replays(fake_capture):
    m = _fresh_bundle()
    photo, render = _pair(2)
    before = copy.deepcopy(STATS)
    out, region = _run(m, photo, render)
    assert out is None and STATS["eager"]["first"] == before["eager"].get("first", 0) + 1
    with torch.inference_mode():
        want = region(photo, render)[0]
    for i in range(3):
        out, _ = _run(m, photo, render)
        assert torch.equal(out[0], want) and out[1] is None
    assert fake_capture == [(1, 128, 128, 3)]
    assert STATS["captures"] == before["captures"] + 1
    assert STATS["replays"] == before["replays"] + 3
    out, _ = _run(m, photo, render, return_latent=True)  # another signature: eager
    assert out is None and len(fake_capture) == 1


def test_at_most_max_graphs_least_recently_used_out(fake_capture):
    m = _fresh_bundle()
    keys = []
    for n in range(1, graphs.MAX_GRAPHS + 3):
        photo, render = _pair(n, n=n)
        for _ in range(2):
            _run(m, photo, render)
        keys.append(graphs.signature(photo, render, **BASE))
        # Using the first again keeps it from being the least recently used.
        _run(m, *_pair(1, n=1))
    assert len(m.graphs.graphs) == graphs.MAX_GRAPHS
    assert keys[0] in m.graphs.graphs and keys[1] not in m.graphs.graphs
    assert len(fake_capture) == graphs.MAX_GRAPHS + 2


def test_moved_tensors_drop_the_graphs_and_sightings(fake_capture):
    m = _fresh_bundle()
    photo, render = _pair(3)
    for _ in range(2):
        _run(m, photo, render)
    assert len(m.graphs.graphs) == 1
    before = STATS["invalidations"]
    m.e_w_plus.load_state_dict({k: v.clone() for k, v in m.e_w_plus.state_dict().items()},
                               assign=True)
    out, _ = _run(m, photo, render)
    assert out is None and not m.graphs.graphs and STATS["invalidations"] == before + 1
    out, _ = _run(m, photo, render)
    assert out is not None and len(fake_capture) == 2


def test_in_place_updates_keep_the_graph(fake_capture):
    m = _fresh_bundle()
    photo, render = _pair(4)
    for _ in range(2):
        first, region = _run(m, photo, render)
    m.load_variables(_state_dicts(FaceManipulator.create(**SMALL, device="cpu", seed=9)))
    out, _ = _run(m, photo, render)
    with torch.inference_mode():
        want = region(photo, render)[0]
    assert len(fake_capture) == 1 and torch.equal(out[0], want)
    assert not torch.equal(out[0], first[0])


def test_training_mode_runs_eagerly(fake_capture):
    m = _fresh_bundle()
    photo, render = _pair(5)
    for _ in range(2):
        _run(m, photo, render)
    before = STATS["eager"].get("train", 0)
    m.e_tsr.train()
    out, _ = _run(m, photo, render)
    assert out is None and STATS["eager"]["train"] == before + 1
    m.eval()
    out, _ = _run(m, photo, render)
    assert out is not None and len(fake_capture) == 1


def test_a_copy_of_the_bundle_starts_without_graphs(fake_capture):
    m = _fresh_bundle()
    photo, render = _pair(6)
    for _ in range(2):
        _run(m, photo, render)
    dup = copy.deepcopy(m)
    assert dup.graphs is not m.graphs and not dup.graphs.graphs and len(m.graphs.graphs) == 1


def test_eager_reasons_before_the_cache():
    m = _fresh_bundle()
    photo, render = _pair(7)
    assert graphs.eager_reason(m, photo, render, None) == "cpu"
    meta = FaceManipulator.create(**SMALL, device="meta")
    assert graphs.eager_reason(meta, photo, render, None) == "meta"


CARD_CALLS = {
    None: dict(),
    "noise": dict(noise=True),
    "grad": dict(grad=True),
    "plain": dict(context=ops.plain_versions),
    "batch": dict(n=graphs.MAX_BATCH + 1),
}


@pytest.mark.parametrize("reason", list(CARD_CALLS), ids=str)
def test_eager_reasons_of_a_card_bundle(monkeypatch, reason):
    """The reasons a call on a card runs eagerly, judged before the cache;
    None for a call that may replay, at the largest graphed batch."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    bundle = type("CardBundle", (), {"device": torch.device("cuda")})()
    spec = CARD_CALLS[reason]
    photo, render = _pair(9, n=spec.get("n", graphs.MAX_BATCH), size=8)
    if spec.get("grad"):
        render.requires_grad_(True)
    noise = torch.Generator() if spec.get("noise") else None
    context = spec.get("context")
    if context is not None:
        with context():
            assert graphs.eager_reason(bundle, photo, render, noise) == reason
        assert graphs.eager_reason(bundle, photo, render, noise) is None
    else:
        assert graphs.eager_reason(bundle, photo, render, noise) == reason


# ---------------- the card -----------------------------------------------------


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never while the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _eager(m, photo, render, **options):
    opts = {**BASE, **options}
    with torch.inference_mode():
        return _edit(m, photo, render, opts["tsr_encode"], opts["sliced_layer"],
                     opts["use_tanh"], None)


def _gap(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 2])
def test_replay_matches_eager_on_card(cuda_device, batch):
    """8 distinct pairs after the eager call and the capture: each replay
    against the eager forward of the same pair; request k's image is left
    as it was by request k+1."""
    m = FaceManipulator.create(**SMALL, device=cuda_device, seed=5)
    opts = dict(sliced_layer=(0, 3, 5), use_tanh=True)
    before = copy.deepcopy(STATS)
    outs, gaps = [], []
    for k in range(10):
        photo, render = _pair(100 + k, n=batch)
        got, latent = forward_3_encoder(m, photo, render, return_latent=True, **opts)
        want, want_latent = _eager(m, photo, render, **opts)
        gaps.append(max(_gap(got.cpu(), want.cpu()), _gap(latent.cpu(), want_latent.cpu())))
        outs.append((got, got.clone()))
    assert STATS["captures"] == before["captures"] + 1
    assert STATS["replays"] == before["replays"] + 9
    print(f"batch {batch}: largest replay - eager gap {max(gaps[1:]):.3e}, "
          f"bitwise equal in {sum(g == 0 for g in gaps[1:])} of 9")
    assert max(gaps) <= 1e-5
    for got, kept in outs:
        assert torch.equal(got, kept)


@pytest.mark.gpu
def test_load_variables_replays_the_new_weights(cuda_device):
    m = FaceManipulator.create(**SMALL, device=cuda_device, seed=5)
    other = FaceManipulator.create(**SMALL, device=cuda_device, seed=11)
    photo, render = _pair(3)
    for _ in range(2):
        old = forward_3_encoder(m, photo, render)
    m.load_variables(_state_dicts(other))
    captures = STATS["captures"]
    got = forward_3_encoder(m, photo, render)
    assert STATS["captures"] == captures
    assert _gap(got, _eager(other, photo, render)[0]) <= 1e-5 < _gap(got, old)


@pytest.mark.gpu
def test_moves_and_flags_recapture(cuda_device):
    m = FaceManipulator.create(**SMALL, device=cuda_device, seed=5)
    photo, render = _pair(4)

    def twice():
        for _ in range(2):
            out = forward_3_encoder(m, photo, render)
        return out
    twice()
    inv, caps = STATS["invalidations"], STATS["captures"]
    m.to("cpu").to(cuda_device)
    twice()
    assert (STATS["invalidations"], STATS["captures"]) == (inv + 1, caps + 1)
    owner = next(mod for mod in m.e_w.modules() if mod._parameters)
    name, p = next(iter(owner.named_parameters(recurse=False)))
    setattr(owner, name, torch.nn.Parameter(p.detach().clone()))
    got = twice()
    assert (STATS["invalidations"], STATS["captures"]) == (inv + 2, caps + 2)
    assert _gap(got, _eager(m, photo, render)[0]) <= 1e-5
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = not prev
    try:
        twice()
    finally:
        torch.backends.cudnn.deterministic = prev
    assert STATS["captures"] == caps + 3 and len(m.graphs.graphs) == 2


@pytest.mark.gpu
def test_noise_plain_and_training_run_eagerly(cuda_device):
    m = FaceManipulator.create(**SMALL, device=cuda_device, seed=5)
    photo, render = _pair(5)
    before = copy.deepcopy(STATS)
    for _ in range(3):
        forward_3_encoder(m, photo, render,
                          noise_generator=torch.Generator(device=cuda_device).manual_seed(1))
    ops.reset_launches()
    with ops.plain_versions():
        for _ in range(3):
            forward_3_encoder(m, photo, render)
    assert not any(ops.launch_counts().values())
    m.generator.train()
    for _ in range(3):
        forward_3_encoder(m, photo, render)
    m.eval()
    eager = STATS["eager"]
    for reason in ("noise", "plain", "train"):
        assert eager.get(reason, 0) == before["eager"].get(reason, 0) + 3, reason
    assert STATS["captures"] == before["captures"] and not m.graphs.graphs


@pytest.mark.gpu
def test_at_most_max_graphs_on_card(cuda_device):
    m = FaceManipulator.create(**SMALL, device=cuda_device, seed=5)
    options = [dict(use_tanh=t, sliced_layer=s) for t in (False, True) for s in (None, (0,), (1, 2))]
    assert len(options) == graphs.MAX_GRAPHS + 2
    for n, opts in enumerate(options):
        photo, render = _pair(n, n=1 + n % graphs.MAX_BATCH)
        for _ in range(3):
            got = forward_3_encoder(m, photo, render, **opts)
        assert _gap(got, _eager(m, photo, render, **opts)[0]) <= 1e-5
    assert len(m.graphs.graphs) == graphs.MAX_GRAPHS


@pytest.mark.gpu
def test_batches_above_the_limit_run_eagerly(cuda_device):
    """A batch of more than ``MAX_BATCH`` pairs is never graphed: every call
    launches the kernels as the eager path does."""
    m = FaceManipulator.create(**SMALL, device=cuda_device, seed=5)
    photo, render = _pair(12, n=graphs.MAX_BATCH + 1)
    before = copy.deepcopy(STATS)
    ops.reset_launches()
    first = forward_3_encoder(m, photo, render)
    counts = ops.launch_counts()
    for _ in range(2):
        ops.reset_launches()
        got = forward_3_encoder(m, photo, render)
        assert ops.launch_counts() == counts and _gap(got, first) <= 1e-5
    assert STATS["eager"]["batch"] == before["eager"].get("batch", 0) + 3
    assert STATS["captures"] == before["captures"] and not m.graphs.graphs


@pytest.mark.gpu
def test_profiled_replay_nests_in_the_forward(cuda_device, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    m = FaceManipulator.create(**SMALL, device=cuda_device, seed=5)
    photo, render = _pair(6)
    for _ in range(2):
        forward_3_encoder(m, photo, render)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            forward_3_encoder(m, photo, render).cpu()
        torch.cuda.synchronize()
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = {name: [ev for ev in events if ev.get("name") == name]
             for name in ("fm3d.edit.forward", "fm3d.edit.replay", "fm3d.model.generator")}
    assert len(spans["fm3d.edit.forward"]) == len(spans["fm3d.edit.replay"]) == 3
    assert not spans["fm3d.model.generator"]
    for fwd, rep in zip(*(sorted(spans[n], key=lambda ev: ev["ts"])
                          for n in ("fm3d.edit.forward", "fm3d.edit.replay"))):
        assert fwd["ts"] <= rep["ts"] and rep["ts"] + rep["dur"] <= fwd["ts"] + fwd["dur"]
    kernels = [ev for ev in events if ev.get("cat") == "kernel"]
    print(f"kernels traced in 3 replays: {len(kernels)}")
