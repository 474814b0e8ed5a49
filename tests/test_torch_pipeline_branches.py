"""Independent sub-networks as parallel branches of the edit forward's CUDA
graph (``utils/streams.py``, its two call sites in ``pipeline/forward.py``
and ``models/psp_encoder.py``).

On the CPU: ``fork`` outside a capture is a plain sequence of calls; the
branched forwards give the bits of the serial formulation; and under a
stand-in for CUDA's streams and capture every branch is forked from the
capturing stream and joined back before its consumer.  The ``gpu`` tests
replay branched graphs on the card against serial ones and the eager forward.
"""

import contextlib
import copy

import pytest
import torch

from fm3dgan_torch import ops
from fm3dgan_torch.models.psp_encoder import GradualStyleEncoder, _upsample_align_corners
from fm3dgan_torch.models._common import bn, conv, prelu
from fm3dgan_torch.pipeline import STATS, FaceManipulator, forward_3_encoder, graphs
from fm3dgan_torch.pipeline.forward import _combine_w_wplus, _edit
from fm3dgan_torch.utils import streams

# 14 W+ codes as at 256 px (2 encoder branches + 14 style blocks = 16), at a
# width the CPU runs in moments; 128 px inputs give E_Tsr G's 4x4 input.
STYLES14 = dict(size=256, input_size=128, width_mult=1 / 16, style_dim=32)
BRANCHES = 16
CPU = torch.device("cpu")


def _pair(seed, n=1, size=128):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n, size, size, 3, generator=g) * 2 - 1,
            torch.rand(n, size, size, 3, generator=g) * 2 - 1)


def _serial_psp(enc, x, train=False):
    """``GradualStyleEncoder.forward`` as it was written before the branches:
    every style block in turn."""
    il = enc.input_layer
    x = prelu(il[2], bn(il[1], conv(il[0], x, enc.dtype), train))
    feats = {}
    for i, unit in enumerate(enc.body):
        x = unit(x, train)
        if i in enc.taps:
            feats[i] = x
    c1, c2, c3 = (feats[t] for t in enc.taps)
    latents = [enc.styles[j](c3) for j in range(enc.coarse_ind)]
    lat1 = conv(enc.latlayer1, c2, enc.dtype)
    p2 = _upsample_align_corners(c3, lat1) + lat1
    latents += [enc.styles[j](p2) for j in range(enc.coarse_ind, enc.middle_ind)]
    lat2 = conv(enc.latlayer2, c1, enc.dtype)
    p1 = _upsample_align_corners(p2, lat2) + lat2
    latents += [enc.styles[j](p1) for j in range(enc.middle_ind, len(enc.styles))]
    return torch.stack(latents, dim=1)


def _serial_edit(m, photo, render, sliced_layer=None, use_tanh=False, tsr_encode="Render Image"):
    """``_edit`` as it was written before the branches: E_Tsr, E_W, E_W+, G."""
    p, r = (x.permute(0, 3, 1, 2).contiguous() for x in (photo, render))
    tensor, w = m.e_tsr(p if tsr_encode == "Photo Image" else r), m.e_w(r)
    latent = _combine_w_wplus(w, _serial_psp(m.e_w_plus, p), sliced_layer)
    img, lat = m.generator(input_is_latent=True, latent_styles=[latent],
                           external_input_tensor=tensor, randomize_noise=False,
                           return_latent=True)
    if use_tanh:
        img = torch.tanh(img)
    return img.permute(0, 2, 3, 1).contiguous(), lat


# ---------------- a stand-in for CUDA's streams and capture -------------------


class _Stream:
    def __init__(self, log, name):
        self.log, self.name, self.device = log, name, CPU

    def wait_stream(self, other):
        self.log.append(("wait", self, other))

    def __repr__(self):
        return self.name


class _Card:
    """torch.cuda's streams, stream context and graph capture on the CPU:
    logs each wait, each stream entered and each hooked module's call with
    the stream current at the time.  Side streams start afresh."""

    def __init__(self, monkeypatch):
        self.log, self.made, self.capturing = [], [], False
        self.current = self.default = _Stream(self.log, "default")
        for name, value in (("is_initialized", lambda: True),
                            ("is_current_stream_capturing", lambda: self.capturing),
                            ("current_stream", lambda device=None: self.current),
                            ("Stream", self.new_stream), ("stream", self.use),
                            ("graph", self.graph), ("CUDAGraph", lambda: None),
                            ("Event", lambda: None)):
            monkeypatch.setattr(torch.cuda, name, value)
        monkeypatch.setattr(streams, "_SIDE", {})
        monkeypatch.setattr(streams, "_HELD", {})

    def new_stream(self, device=None):
        self.made.append(_Stream(self.log, f"stream{len(self.made)}"))
        return self.made[-1]

    @contextlib.contextmanager
    def use(self, stream):
        before, self.current = self.current, stream
        self.log.append(("enter", stream))
        try:
            yield
        finally:
            self.current = before

    @contextlib.contextmanager
    def graph(self, graph):
        self.capture_stream = _Stream(self.log, "capture")
        with self.use(self.capture_stream):
            self.capturing = True
            try:
                yield
            finally:
                self.capturing = False

    @contextlib.contextmanager
    def capture(self):
        """A bare capture on the current stream."""
        with self.graph(None):
            yield self.capture_stream

    def hook(self, name, module, done=False):
        module.register_forward_pre_hook(
            lambda mod, args: self.log.append(("call", name, self.current)))
        if done:
            module.register_forward_hook(
                lambda mod, args, out: self.log.append(("done", name, self.current)))

    def at(self, *entry):
        return next(i for i, e in enumerate(self.log) if e[:len(entry)] == entry)

    def calls(self):
        return {e[1]: e[2] for e in self.log if e[0] == "call"}


@pytest.fixture
def card(monkeypatch):
    return _Card(monkeypatch)


# ---------------- fork outside and inside a capture ----------------------------


def _recording(order, results):
    def make(i):
        def call():
            order.append(i)
            return results[i]
        return call
    return make


@pytest.mark.parametrize("state", ["no_cuda", "not_capturing", "exporting"])
def test_fork_is_inline_outside_a_capture(monkeypatch, state):
    """Each callable once, in order, the trunk last, on the current stream;
    the results as they were returned; no stream made, nothing counted."""
    if state != "no_cuda":
        monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: state == "exporting")
        monkeypatch.setattr(torch.compiler, "is_exporting", lambda: state == "exporting")

    def no_streams(*args, **kwargs):
        raise AssertionError("a stream was touched outside a capture")
    for name in ("Stream", "stream", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, no_streams)
    order, results = [], [object() for _ in range(4)]
    make = _recording(order, results)
    forked = streams.forked
    out, got = streams.fork([make(0), make(1), make(2)], make(3))
    assert order == [0, 1, 2, 3] and out is results[3]
    assert len(got) == 3 and all(a is b for a, b in zip(got, results))
    assert streams.fork([make(0)]) == (None, [results[0]])
    assert streams.fork([], make(3)) == (results[3], [])
    assert streams.forked == forked


def test_fork_in_a_capture_forks_and_joins(card):
    order, results = [], [object() for _ in range(4)]
    make = _recording(order, results)
    forked = streams.forked
    with card.capture() as cap:
        out, got = streams.fork([make(0), make(1), make(2)], make(3))
        assert card.current is cap
    assert order == [0, 1, 2, 3] and out is results[3] and got == results[:3]
    assert streams.forked == forked + 3
    sides = streams._SIDE[CPU]
    assert len(sides) == 3 and len(set(map(id, sides))) == 3 and cap not in sides
    for side in sides:
        assert card.at("wait", side, cap) < card.at("enter", side) < card.at("wait", cap, side)
    # Forked before the trunk ran, joined after it: the trunk runs beside them.
    assert card.log.index(("wait", sides[2], cap)) < card.at("wait", cap)
    assert streams._HELD[CPU] == 0


def test_fork_joins_what_it_forked_when_a_call_raises(card):
    def fail():
        raise RuntimeError("in the branch")
    with card.capture() as cap:
        with pytest.raises(RuntimeError, match="in the branch"):
            streams.fork([lambda: 1, fail, lambda: 3], lambda: 4)
    first, second, third = streams._SIDE[CPU]
    joined = [e[2] for e in card.log if e[0] == "wait" and e[1] is cap]
    assert joined == [first, second] and streams._HELD[CPU] == 0


def test_nested_forks_take_free_streams_and_keep_them(card):
    """A fork inside a trunk takes side streams the outer fork does not
    hold; the streams are made once and reused by later forks."""
    def inner():
        return streams.fork([lambda: "b", lambda: "c"])[1]
    with card.capture():
        out, got = streams.fork([lambda: "a"], inner)
        assert (out, got) == (["b", "c"], ["a"])
        assert len(card.made) == 3
        streams.fork([lambda: "d", lambda: "e", lambda: "f"])
    assert len(card.made) == 3 and streams._SIDE[CPU] == card.made


# ---------------- the branched forwards against the serial ones ----------------


@pytest.mark.parametrize("num_layers", [18, 50])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_psp_matches_the_serial_formulation(num_layers, train):
    """Bit for bit, with the IR-SE-18 and IR-SE-50 tap sets, and in training
    (batch statistics, running ones updated alike)."""
    torch.manual_seed(num_layers)
    enc = GradualStyleEncoder(num_layers=num_layers, n_styles=14, input_size=64, width=4,
                              style_dim=32)
    twin = copy.deepcopy(enc)
    x = torch.randn(2, 3, 64, 64)
    with torch.inference_mode(not train):
        got, want = enc(x, train), _serial_psp(twin, x, train)
    assert got.shape == (2, 14, 32) and torch.equal(got, want)
    for a, b in zip(enc.buffers(), twin.buffers()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("w_plus_layers", [18, 50])
def test_forward_3_encoder_matches_the_serial_formulation(w_plus_layers):
    m = FaceManipulator.create(**STYLES14, w_plus_layers=w_plus_layers, device="cpu", seed=3)
    photo, render = _pair(21, n=2)
    with torch.inference_mode():
        want, want_latent = _serial_edit(m, photo, render, (0, 5, 9), True)
    got, latent = forward_3_encoder(m, photo, render, sliced_layer=(0, 5, 9), use_tanh=True,
                                    return_latent=True)
    assert torch.equal(got, want) and torch.equal(latent, want_latent)


@pytest.mark.parametrize("tsr_encode", ["Render Image", "Photo Image"])
def test_a_mocked_capture_branches_every_encoder_and_style_block(card, tsr_encode):
    """``graphs.capture`` on the CPU under the stand-in: the warm-up forks
    nothing; the capture forks 16 branches, E_Tsr and E_W and each style
    block on a side stream of its own, each forked from the capturing stream
    and joined back before its consumer (pSp's stack, G); its outputs are
    the serial formulation's bits."""
    m = FaceManipulator.create(**STYLES14, device="cpu", seed=4)
    photo, render = _pair(22)
    region_opts = (tsr_encode, (1, 2), False, None)
    with torch.inference_mode():
        plain = _edit(m, photo, render, *region_opts)
        serial = _serial_edit(m, photo, render, (1, 2), tsr_encode=tsr_encode)
    assert torch.equal(plain[0], serial[0]) and torch.equal(plain[1], serial[1])
    del card.log[:]
    for name in ("e_tsr", "e_w", "generator"):
        card.hook(name, getattr(m, name))
    card.hook("e_w_plus", m.e_w_plus, done=True)
    styles = [f"style{j}" for j in range(len(m.e_w_plus.styles))]
    for name, block in zip(styles, m.e_w_plus.styles):
        card.hook(name, block)
    assert len(styles) == 14

    before, forked = STATS["branches"], streams.forked
    with torch.inference_mode():
        graph = graphs.capture(CPU, photo, render,
                               lambda p, r: _edit(m, p, r, *region_opts))
    assert STATS["branches"] == before + BRANCHES and streams.forked == forked + BRANCHES
    assert torch.equal(graph.outputs[0], plain[0]) and torch.equal(graph.outputs[1], plain[1])

    cap = card.capture_stream
    captured = card.log[card.at("enter", cap):]
    card.log[:] = captured
    calls = card.calls()
    sides = streams._SIDE[CPU]
    assert len(sides) == BRANCHES
    branch = {name: calls[name] for name in ("e_tsr", "e_w", *styles)}
    assert sorted(map(id, branch.values())) == sorted(map(id, sides))
    assert calls["e_w_plus"] is cap and calls["generator"] is cap
    g_at, stack_at = card.at("call", "generator"), card.at("done", "e_w_plus")
    for name, side in branch.items():
        call_at = card.at("call", name)
        assert card.at("wait", side, cap) < call_at < card.at("wait", cap, side) < g_at, name
        if name.startswith("style"):
            assert card.at("wait", cap, side) < stack_at, name
    # The coarse blocks stay forked while the middle and fine ones run, the
    # middle ones while the fine ones run: each overlaps the fusion after it.
    coarse, middle, fine = styles[:3], styles[3:7], styles[7:]
    last_fine = max(card.at("call", name) for name in fine)
    for name in coarse + middle:
        assert card.at("wait", cap, branch[name]) > last_fine, name
    first_middle = min(card.at("call", name) for name in middle)
    for name in coarse:
        assert card.at("call", name) < first_middle
    assert len({id(card.made[0]), *map(id, sides)}) == BRANCHES + 1  # warm-up stream apart


# ---------------- the card ---------------------------------------------------------


@pytest.fixture
def cuda_device(monkeypatch):
    """The card under cuDNN's deterministic algorithms, or a skip: decided
    here, never while the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    return torch.device("cuda")


def _eager(m, photo, render, **opts):
    with torch.inference_mode():
        return _edit(m, photo, render, opts.get("tsr_encode", "Render Image"),
                     opts.get("sliced_layer"), opts.get("use_tanh", False), None)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 2, 4])
def test_branched_replay_equals_serial_replay_and_eager(cuda_device, monkeypatch, batch):
    """Under cuDNN's deterministic algorithms, over 8 distinct requests in a
    row after the captures: the branched replay, a replay captured with the
    branches inline, and the eager forward agree bit for bit, and no
    request's image changes after it was returned."""
    opts = dict(sliced_layer=(0, 3, 5), use_tanh=True, return_latent=True)
    branched = FaceManipulator.create(**STYLES14, device=cuda_device, seed=5)
    serial = FaceManipulator.create(**STYLES14, device=cuda_device, seed=5)
    first = _pair(200, n=batch)
    counts = lambda: (STATS["captures"], STATS["branches"])  # noqa: E731
    start = counts()
    with monkeypatch.context() as inline:
        inline.setattr(streams, "_capturing", lambda: False)
        for _ in range(2):
            forward_3_encoder(serial, *first, **opts)
    assert counts() == (start[0] + 1, start[1])
    for _ in range(2):
        forward_3_encoder(branched, *first, **opts)
    assert counts() == (start[0] + 2, start[1] + BRANCHES)
    kept = []
    for k in range(8):
        photo, render = _pair(300 + k, n=batch)
        got, latent = forward_3_encoder(branched, photo, render, **opts)
        ser, ser_latent = forward_3_encoder(serial, photo, render, **opts)
        want, want_latent = _eager(branched, photo, render, **opts)
        assert torch.equal(got, ser) and torch.equal(latent, ser_latent), k
        assert torch.equal(got, want) and torch.equal(latent, want_latent), k
        kept.append((got, got.clone()))
    assert counts() == (start[0] + 2, start[1] + BRANCHES)
    for got, copy_ in kept:
        assert torch.equal(got, copy_)


class _Calls(torch.nn.Module):
    """Two edits of one pair inside ``functional_call``."""

    def __init__(self, models):
        super().__init__()
        self.models = models

    def forward(self, photo, render):
        return [forward_3_encoder(self.models, photo, render) for _ in range(2)]


def _to(m, device):
    m.to("cpu").to(device)


def _load_assign(m, device):
    m.e_w_plus.load_state_dict({k: v.clone() for k, v in m.e_w_plus.state_dict().items()},
                               assign=True)


def _replace(m, device):
    m.e_w = copy.deepcopy(m.e_w)


MOVES = {"to": _to, "load_state_dict_assign": _load_assign, "replaced_submodule": _replace,
         "functional_call": None}


@pytest.mark.gpu
@pytest.mark.parametrize("move", list(MOVES))
def test_moved_tensors_drop_the_branched_graphs(cuda_device, move):
    """Each move of the bundle's tensors drops its branched graphs; the
    next capture branches again and its replay is the eager forward's bits."""
    m = FaceManipulator.create(**STYLES14, device=cuda_device, seed=5)
    photo, render = _pair(4)
    for _ in range(2):
        forward_3_encoder(m, photo, render)
    assert len(m.graphs.graphs) == 1
    inv, caps, branches = STATS["invalidations"], STATS["captures"], STATS["branches"]
    if move == "functional_call":
        probe = _Calls(m)
        swapped = {k: v.detach().clone()
                   for k, v in [*probe.named_parameters(), *probe.named_buffers()]}
        got = torch.func.functional_call(probe, swapped, (photo, render))[1]
    else:
        MOVES[move](m, cuda_device)
        assert forward_3_encoder(m, photo, render) is not None and not m.graphs.graphs
        got = forward_3_encoder(m, photo, render)
    assert STATS["invalidations"] == inv + 1
    assert (STATS["captures"], STATS["branches"]) == (caps + 1, branches + BRANCHES)
    assert torch.equal(got, _eager(m, photo, render)[0])


@pytest.mark.gpu
def test_eager_paths_fork_nothing_on_card(cuda_device):
    """Batches above the graph limit, a noise generator, the plain kernels
    and pSp with gradients in training mode run the branches inline."""
    m = FaceManipulator.create(**STYLES14, device=cuda_device, seed=5)
    photo, render = _pair(12, n=graphs.MAX_BATCH + 1)
    forked, branches = streams.forked, STATS["branches"]
    for _ in range(2):
        forward_3_encoder(m, photo, render)
        forward_3_encoder(m, photo[:1], render[:1],
                          noise_generator=torch.Generator(device=cuda_device).manual_seed(1))
        with ops.plain_versions():
            forward_3_encoder(m, photo[:1], render[:1])
    enc = m.e_w_plus.train()
    x = photo.permute(0, 3, 1, 2).contiguous().to(cuda_device).requires_grad_(True)
    enc(x, True).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert (streams.forked, STATS["branches"]) == (forked, branches) and not m.graphs.graphs
