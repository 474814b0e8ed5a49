"""The edit forwards' host transfers through pinned buffers
(``pipeline/staging.py``).

On the CPU: the chunked copy's arithmetic and order, driven with host
tensors; the route each call takes; a CPU bundle is never staged.  The
``gpu`` tests hold the staged calls against the card route's ``.cpu()`` bit
for bit, on the eager route and on the graph route.
"""

import copy
import json
import os
import sys
import threading

import pytest
import torch

from fm3dgan_torch.pipeline import STATS, FaceManipulator, TwoEncoderModels, forward_2_encoder
from fm3dgan_torch.pipeline import forward_3_encoder, graphs, staging

SMALL = dict(size=16, input_size=128, width_mult=1 / 16, style_dim=32)
SMALL2 = dict(size=16, co_modulation="Multiplication", latent=32, input_size=128,
              width_mult=1 / 16)


def _pair(seed, n=1, size=128):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n, size, size, 3, generator=g) * 2 - 1,
            torch.rand(n, size, size, 3, generator=g) * 2 - 1)


# ---------------- the chunked copy, on the host --------------------------------


@pytest.mark.parametrize("nbytes, size, want", [
    (10, 4, [(0, 4), (4, 8), (8, 10)]),
    (1, 4, [(0, 1)]),
    (8, 4, [(0, 4), (4, 8)]),
    (4, 4, [(0, 4)]),
    (0, 4, []),
], ids=["not_a_multiple", "one_byte", "exactly_two", "exactly_one", "empty"])
def test_chunks_cover_the_bytes_in_order(nbytes, size, want):
    assert staging.chunks(nbytes, size) == want


class _Event:
    """Stands in for a CUDA event: logs when the copy out waits on it."""

    def __init__(self, log, chunk):
        self.log, self.chunk = log, chunk

    def synchronize(self):
        self.log.append(("wait", self.chunk))


SIZES = {"not_a_multiple": [13], "one_element": [1], "exactly_two_chunks": [16],
         "several_tensors": [13, 1, 40, 8], "with_an_empty_one": [0, 5]}


@pytest.mark.parametrize("case", list(SIZES))
def test_copy_chunked_through_two_buffers(case):
    """Host tensors through two 8-byte buffers: every byte lands at its
    place; chunks 0 and 1 go out before the fault-in, and chunk i + 2 only
    after chunk i was waited on and read out of the buffer they share."""
    size = 8
    g = torch.Generator().manual_seed(len(case))
    srcs = [torch.randint(0, 256, (n,), dtype=torch.uint8, generator=g) for n in SIZES[case]]
    dsts = [torch.full_like(s, 7) for s in srcs]
    buffers = (torch.empty(size, dtype=torch.uint8), torch.empty(size, dtype=torch.uint8))
    log = []

    def record():
        sent = sum(e[0] == "send" for e in log)
        log.append(("send", sent))
        return _Event(log, sent)

    staging.copy_chunked(srcs, dsts, buffers, size, record, lambda: log.append(("before",)))
    for src, dst in zip(srcs, dsts):
        assert torch.equal(src, dst)
    n = sum(len(staging.chunks(s.numel(), size)) for s in srcs)
    assert [e for e in log if e[0] == "send"] == [("send", i) for i in range(n)]
    assert [e for e in log if e[0] == "wait"] == [("wait", i) for i in range(n)]
    assert log.index(("before",)) == min(2, n)
    for i in range(n - 2):
        assert log.index(("wait", i)) < log.index(("send", i + 2))


class _CudaEvent:
    """Stands in for ``torch.cuda.Event``: recorded and waited on, nothing more."""

    def record(self, stream=None):
        pass

    def synchronize(self):
        pass


@pytest.fixture
def host_only(monkeypatch):
    """A :class:`staging.Staging` driven on the host: plain memory for the
    pinned buffers, stand-ins for the events and the stream."""
    monkeypatch.setattr(staging, "_pinned", lambda n: torch.empty(n, dtype=torch.uint8))
    monkeypatch.setattr(torch.cuda, "Event", _CudaEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)


@pytest.mark.parametrize("threads", ["calling", "intra_op"])
@pytest.mark.parametrize("chunk", [None, 1000], ids=["chunk_default", "chunk_1000"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_staging_round_trip_on_the_host(host_only, monkeypatch, dtype, chunk, threads):
    """Inputs come out of the input buffer equal, at aligned offsets; image
    and latent come back as new contiguous tensors outside inference mode,
    equal to the bit, aliasing no buffer; the counters count the bytes.
    The host's copies on the calling thread (these sizes) or on torch's
    threads (``PARALLEL_BYTES`` 0)."""
    if chunk is not None:
        monkeypatch.setattr(staging, "CHUNK_BYTES", chunk)
    if threads == "intra_op":
        monkeypatch.setattr(staging, "PARALLEL_BYTES", 0)
    stage = staging.Staging()
    photo, render = (x.to(dtype) for x in _pair(16, n=3, size=9))
    image = torch.randn(3, 17, 17, 3).to(dtype)
    latent = torch.randn(3, 5, 7, dtype=dtype)
    before = copy.deepcopy(STATS)
    with torch.inference_mode():
        sent = stage.to_device(torch.device("cpu"), photo, render.permute(0, 2, 1, 3))
        got, got_latent = stage.to_host(image, latent)
        image_only, none = stage.to_host(image)
    assert torch.equal(sent[0], photo) and torch.equal(sent[1], render.permute(0, 2, 1, 3))
    held = stage.inputs.untyped_storage().data_ptr()
    assert [x.untyped_storage().data_ptr() for x in sent] == [held, held]
    assert [x.storage_offset() * x.element_size() % 64 for x in sent] == [0, 0]
    for out, want in ((got, image), (got_latent, latent), (image_only, image)):
        assert torch.equal(out, want) and out.dtype == dtype and out.is_contiguous()
        assert not out.is_inference()
        assert all(out.untyped_storage().data_ptr() != b.untyped_storage().data_ptr()
                   for b in stage.outputs)
    assert none is None
    assert STATS["staged"] == before["staged"] + 1
    assert STATS["staged_bytes"] == before["staged_bytes"] + (
        photo.nbytes + render.nbytes + 2 * image.nbytes + latent.nbytes)
    assert stage.pinned_bytes == stage.inputs.numel() + 2 * min(staging.CHUNK_BYTES, image.nbytes)


# ---------------- the route ------------------------------------------------------


class _Bundle:
    def __init__(self, kind):
        self.device = torch.device(kind)


ROUTES = {
    "host_inputs_card_bundle": (True, "cuda", "cpu", "cpu", None),
    "card_photo": (False, "cuda", "meta", "cpu", None),
    "card_render": (False, "cuda", "cpu", "meta", None),
    "cpu_bundle": (False, "cpu", "cpu", "cpu", None),
    "exporting": (False, "cuda", "cpu", "cpu", "is_exporting"),
    "compiling": (False, "cuda", "cpu", "cpu", "is_compiling"),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_staged_only_for_host_inputs_to_a_card(monkeypatch, route):
    want, bundle, photo_on, render_on, tracer = ROUTES[route]
    if tracer is not None:
        monkeypatch.setattr(torch.compiler, tracer, lambda: True)
    photo = torch.empty(1, 8, 8, 3, device=photo_on)
    render = torch.empty(1, 8, 8, 3, device=render_on)
    assert staging.engaged(_Bundle(bundle), photo, render) is want


@pytest.mark.parametrize("scheme", ["3_encoder", "2_encoder"])
def test_cpu_bundle_returns_host_tensors_unstaged(scheme):
    photo, render = _pair(3, n=2)
    before = copy.deepcopy(STATS)
    if scheme == "3_encoder":
        m = FaceManipulator.create(**SMALL, device="cpu", seed=5)
        image, latent = forward_3_encoder(m, photo, render, return_latent=True)
        assert latent.device.type == "cpu"
    else:
        m = TwoEncoderModels.create(**SMALL2, device="cpu", seed=5)
        image = forward_2_encoder(m, photo, render)
    assert image.device.type == "cpu" and image.shape == (2, 16, 16, 3)
    assert (STATS["staged"], STATS["staged_bytes"]) == (before["staged"], before["staged_bytes"])
    assert m.staging.inputs is None and not m.staging.outputs


def test_a_copy_of_the_bundle_stages_through_buffers_of_its_own():
    m = FaceManipulator.create(**SMALL, device="cpu", seed=5)
    dup = copy.deepcopy(m)
    assert dup.staging is not m.staging and dup.staging.lock is not m.staging.lock
    assert dup.staging.pinned_bytes == 0


# ---------------- the card -------------------------------------------------------


@pytest.fixture
def cuda_device(monkeypatch):
    """The card under cuDNN's deterministic algorithms (two eager forwards
    agree bit for bit), or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    return torch.device("cuda")


def _on(device, pair):
    return tuple(x.to(device) for x in pair)


def _host_result(t):
    return (t.device.type == "cpu" and not t.is_pinned() and not t.is_inference()
            and t.is_contiguous())


# Eager: 16 pairs, above the graph limit; graph: 1 pair, replayed.  A chunk
# of 1000 bytes splits the small image into many chunks, none a multiple of
# an element's 4 bytes.
ROUTES_ON_CARD = {"eager_b16": 16, "graph_b1": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [None, 1000], ids=["chunk_default", "chunk_1000"])
@pytest.mark.parametrize("route", list(ROUTES_ON_CARD))
def test_host_inputs_return_the_card_routes_bits_on_the_host(cuda_device, monkeypatch, route,
                                                             chunk):
    if chunk is not None:
        monkeypatch.setattr(staging, "CHUNK_BYTES", chunk)
    n = ROUTES_ON_CARD[route]
    m = FaceManipulator.create(**SMALL, device=cuda_device, seed=5)
    opts = dict(sliced_layer=(0, 2), use_tanh=True, return_latent=True)
    first, second = _pair(11, n=n), _pair(12, n=n)
    for _ in range(2):  # the graph route's eager first call and its capture
        forward_3_encoder(m, *_on(cuda_device, first), **opts)
    want, want_latent = forward_3_encoder(m, *_on(cuda_device, first), **opts)
    assert want.device.type == "cuda" and want_latent.device.type == "cuda"
    before = copy.deepcopy(STATS)
    got, latent = forward_3_encoder(m, *first, **opts)
    assert _host_result(got) and _host_result(latent)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want.cpu()) and torch.equal(latent, want_latent.cpu())
    kept = got.clone()
    other, _ = forward_3_encoder(m, *second, **opts)
    assert torch.equal(got, kept) and not torch.equal(other, got)
    moved = sum(x.nbytes for x in first) + got.nbytes + latent.nbytes
    assert STATS["staged"] == before["staged"] + 2
    assert STATS["staged_bytes"] == before["staged_bytes"] + 2 * moved
    if route == "graph_b1":
        assert STATS["replays"] == before["replays"] + 2
    else:
        assert STATS["eager"]["batch"] == before["eager"]["batch"] + 2
    image_only = forward_3_encoder(m, *first, sliced_layer=(0, 2), use_tanh=True)
    assert _host_result(image_only) and torch.equal(image_only, want.cpu())
    size = min(staging.CHUNK_BYTES, max(got.nbytes, latent.nbytes))
    assert m.staging.pinned_bytes == 2 * size + sum(-(-x.nbytes // 64) * 64 for x in first)


@pytest.mark.gpu
def test_card_inputs_stay_on_the_card(cuda_device):
    m = FaceManipulator.create(**SMALL, device=cuda_device, seed=5)
    before = STATS["staged"]
    for n in (1, 1, 1, 16):
        image, latent = forward_3_encoder(m, *_on(cuda_device, _pair(n, n=n)), return_latent=True)
        assert image.device.type == "cuda" and latent.device.type == "cuda"
    assert STATS["staged"] == before and m.staging.pinned_bytes == 0


@pytest.mark.gpu
def test_pinned_inputs_go_straight_to_the_card(cuda_device):
    m = FaceManipulator.create(**SMALL, device=cuda_device, seed=5)
    photo, render = (x.pin_memory() for x in _pair(13, n=16))
    want = forward_3_encoder(m, *_on(cuda_device, (photo, render))).cpu()
    got = forward_3_encoder(m, photo, render)
    assert _host_result(got) and torch.equal(got, want)
    assert m.staging.inputs is None


@pytest.mark.gpu
def test_threads_sharing_a_bundle_each_get_their_own_image(cuda_device):
    """12 threads, more than the card machine's 8 cores, share one bundle and
    its staging, with a short switch interval; each call returns its own
    pair's image, as the same call alone does."""
    m = FaceManipulator.create(**SMALL, device=cuda_device, seed=5)
    pairs = [_pair(100 + k, n=1 + k % 2) for k in range(12)]
    want = [forward_3_encoder(m, *p) for p in pairs for _ in range(2)][1::2]
    got = [None] * len(pairs)

    def work(k):
        for _ in range(4):
            got[k] = forward_3_encoder(m, *pairs[k])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(len(pairs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g is not None and torch.equal(g, w), k


@pytest.mark.gpu
def test_forward_2_encoder_follows_the_contract(cuda_device):
    m = TwoEncoderModels.create(**SMALL2, device=cuda_device, seed=5)
    photo, render = _pair(14, n=4)
    want = forward_2_encoder(m, *_on(cuda_device, (photo, render)))
    assert want.device.type == "cuda"
    before = copy.deepcopy(STATS)
    got = forward_2_encoder(m, photo, render)
    assert _host_result(got) and torch.equal(got, want.cpu())
    assert STATS["staged"] == before["staged"] + 1
    assert STATS["staged_bytes"] == before["staged_bytes"] + photo.nbytes + render.nbytes + got.nbytes


@pytest.mark.gpu
@pytest.mark.parametrize("route", list(ROUTES_ON_CARD))
def test_staged_calls_trace_pinned_copies_inside_the_forward(cuda_device, monkeypatch, tmp_path,
                                                             route):
    """Under the profiler: each staged call's ``fm3d.edit.to_host`` span lies
    inside its ``fm3d.edit.forward``; every copy between host and card is
    pinned, none pageable."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(staging, "CHUNK_BYTES", 1000)
    m = FaceManipulator.create(**SMALL, device=cuda_device, seed=5)
    photo, render = _pair(15, n=ROUTES_ON_CARD[route])
    for _ in range(2):
        forward_3_encoder(m, photo, render)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            forward_3_encoder(m, photo, render)
        torch.cuda.synchronize()
    path = os.path.join(tmp_path, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = {name: sorted((ev for ev in events if ev.get("name") == name), key=lambda e: e["ts"])
             for name in ("fm3d.edit.forward", "fm3d.edit.to_host")}
    assert len(spans["fm3d.edit.forward"]) == len(spans["fm3d.edit.to_host"]) == 3
    for fwd, out in zip(spans["fm3d.edit.forward"], spans["fm3d.edit.to_host"]):
        assert fwd["ts"] <= out["ts"] and out["ts"] + out["dur"] <= fwd["ts"] + fwd["dur"]
    copies = [ev["name"] for ev in events if str(ev.get("name", "")).startswith("Memcpy")]
    assert not [c for c in copies if "Pageable" in c], copies
    assert any("DtoH (Device -> Pinned)" in c for c in copies), copies
    assert any("HtoD (Pinned -> Device)" in c for c in copies), copies
    if route == "graph_b1":
        assert graphs.STATS["replays"] > 0


@pytest.mark.gpu
def test_quant_eval_scores_on_the_card(cuda_device, tmp_path, monkeypatch, capsys):
    """The quant_eval CLI on the card from host batches: its ``forward_fn``
    sends them to the card first, so the edited image, and the scorers that
    run on the output's device, stay there."""
    from fm3dgan_torch.eval import quant_eval as scores
    from fm3dgan_torch.tools import make_dataset_layouts, quant_eval
    from fm3dgan_torch.train import TrainConfig, Trainer

    trainer = Trainer(TrainConfig(size=16, latent=32, width_mult=1 / 16), device="cpu",
                      input_size=128, use_lpips=False, use_arcface=False)
    trainer.save_checkpoint(str(tmp_path / "ckpt"), 3)
    data = str(tmp_path / "layout")
    assert make_dataset_layouts.main(["ffhq", data, "--n_ids", "3", "--size", "128"]) == 0
    devices = []
    recon_score = scores.get_recon_score

    def spy(batches, forward_fn, *args, **kwargs):
        def forward(photo, render):
            image = forward_fn(photo, render)
            devices.append(image.device.type)
            return image
        return recon_score(batches, forward, *args, **kwargs)

    monkeypatch.setattr(scores, "get_recon_score", spy)
    assert quant_eval.main(["--ckpt_dir", str(tmp_path / "ckpt"), "--step", "3", "--recon_dir", data,
                            "--batch", "2", "--device", "cuda"]) == 0
    line = [x for x in capsys.readouterr().out.splitlines() if x.startswith("RECON")]
    assert devices == ["cuda"] and len(line) == 1 and "nan" not in line[0], (devices, line)
