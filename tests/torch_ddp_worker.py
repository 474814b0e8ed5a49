"""Jobs of the data-parallel tests (tests/test_torch_ddp_*.py), run alike in
one process on the whole batch and in each rank of a gloo group on its rows.

    python tests/torch_ddp_worker.py JOB --rank R --world W --port P --out DIR [--dtype D]

joins a CPU gloo group at ``tcp://127.0.0.1:P`` (60 s timeout), runs
``JOBS[JOB](dtype, out_dir)`` and writes what it returns to
``DIR/rank{R}.pt``.  The tests call the same job without a group for the
single-process reference.  Imports neither JAX nor the JAX package.
"""

import argparse
import datetime
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from fm3dgan_torch import parallel  # noqa: E402
from fm3dgan_torch.losses.path_reg import path_regularize  # noqa: E402
from fm3dgan_torch.models._common import bn  # noqa: E402
from fm3dgan_torch.nn.layers import minibatch_stddev  # noqa: E402

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _rows(a: np.ndarray, dtype) -> torch.Tensor:
    """This rank's rows of a global numpy batch, as a tensor."""
    return torch.as_tensor(a[parallel.local_rows(a.shape[0])], dtype=dtype)


def ops_job(dtype, _out):
    """BatchNorm (forward, first and second derivatives, running
    statistics), minibatch stddev under an R1-style double backward, the
    global noise rows and the PPL penalty.  Row-wise results are this rank's
    rows; parameter gradients are this rank's share (their sum over ranks is
    the one process's gradient)."""
    rng = np.random.RandomState(0)
    out = {}
    # BatchNorm over [8, 6, 5, 5], channels offset from zero as after a conv.
    x_np = rng.randn(8, 6, 5, 5) * rng.uniform(0.5, 2, (1, 6, 1, 1)) + rng.uniform(-1, 1, (1, 6, 1, 1))
    proj_np, v_np = rng.randn(8, 6, 5, 5), rng.randn(8, 6, 5, 5)
    m = torch.nn.BatchNorm2d(6).to(dtype)
    with torch.no_grad():
        m.weight.copy_(torch.as_tensor(rng.uniform(0.5, 1.5, 6)))
        m.bias.copy_(torch.as_tensor(rng.uniform(-0.5, 0.5, 6)))
        m.running_mean.copy_(torch.as_tensor(rng.randn(6)))
        m.running_var.copy_(torch.as_tensor(rng.uniform(0.5, 2, 6)))
    x = _rows(x_np, dtype).requires_grad_(True)
    y = bn(m, x, train=True)
    gx, gw, gb = torch.autograd.grad((y * _rows(proj_np, dtype)).sum(), (x, m.weight, m.bias),
                                     create_graph=True)
    g2x, g2w = torch.autograd.grad((gx * _rows(v_np, dtype)).sum(), (x, m.weight))
    out.update(bn_y=y, bn_gx=gx, bn_gw=gw, bn_gb=gb, bn_g2x=g2x, bn_g2w=g2w,
               bn_running_mean=m.running_mean, bn_running_var=m.running_var)

    # Minibatch stddev over [8, 4, 4, 4] (groups of 4 strided over the batch),
    # R1-style: the input gradient with create_graph, then its penalty.
    s_np, sp_np = rng.randn(8, 4, 4, 4), rng.randn(8, 5, 4, 4)
    scale = torch.nn.Parameter(torch.as_tensor(rng.uniform(0.5, 1.5, (1, 4, 1, 1)), dtype=dtype))
    s = _rows(s_np, dtype).requires_grad_(True)
    o = minibatch_stddev(s * scale)
    (gs,) = torch.autograd.grad((o.square() * _rows(sp_np, dtype)).sum(), s, create_graph=True)
    (g_scale,) = torch.autograd.grad(gs.square().sum(), scale)
    out.update(stddev=o, stddev_gs=gs, stddev_g_scale=g_scale)

    # Noise: a local draw is the rank's rows of the global draw.
    gen = torch.Generator().manual_seed(5)
    out["noise"] = parallel.randn_rows((4 // parallel.world_size(), 1, 4, 4), generator=gen,
                                       dtype=dtype)
    out["noise_next"] = torch.randn(3, generator=gen, dtype=dtype)  # the generator's state after

    # PPL: a differentiable "generator" latent [N, 3, 8] -> image [N, 2, 4, 4].
    lat_np, w_np = rng.randn(4, 3, 8), rng.randn(8, 32) / 3
    w = torch.nn.Parameter(torch.as_tensor(w_np, dtype=dtype))
    latent = _rows(lat_np, dtype).requires_grad_(True)

    def g_fn(lat):
        return torch.tanh(lat @ w).sum(1).reshape(lat.shape[0], 2, 4, 4)

    pen, new_mean, pl = path_regularize(g_fn, latent, torch.tensor(0.3, dtype=dtype),
                                        generator=torch.Generator().manual_seed(7))
    (g_w,) = torch.autograd.grad(pen, w)
    out.update(ppl_penalty=pen.detach(), ppl_mean=new_mean, ppl_lengths=pl.detach(), ppl_gw=g_w)
    return {k: v.detach().clone() for k, v in out.items()}


# ---- training: the whole iteration, its applied gradients recorded ---------

# The tiny 3-encoder configuration of the CPU tests (torch_port_utils.CFG);
# R1 and PPL at every iteration.
CFG = dict(size=16, latent=32, width_mult=1 / 16, rec_face_reg_loss_lambda=0.0,
           ds_face_reg_loss_lambda=0.0, ep_face_reg_loss_lambda=0.0, d_reg_every=1,
           g_reg_every=1)


def _record_gradients():
    """Record every gradient an optimizer step applies, after the average
    over the ranks: the list, and a function that stops the recording."""
    import fm3dgan_torch.parallel as package

    recorded, average = [], package.average_gradients

    def record(grads):
        grads = average(grads)
        recorded.append({k: {n: g.detach().clone() for n, g in part.items()}
                         for k, part in grads.items()})
        return grads

    package.average_gradients = record
    return recorded, lambda: setattr(package, "average_gradients", average)


def _float32_noise():
    """Draw the float64 run's noise (the generator's and PPL's) in float32
    and cast it up, so that it is the float32 run's noise and the float64
    run is that run's exact reference."""
    import fm3dgan_torch.parallel as package

    draw = package.randn_rows

    def randn_rows(shape, generator=None, device=None, dtype=None):
        if dtype == torch.float64:
            return draw(shape, generator=generator, device=device, dtype=torch.float32).double()
        return draw(shape, generator=generator, device=device, dtype=dtype)

    package.randn_rows = randn_rows


def _double(*modules):
    """The float64 run: parameters and buffers cast to float64 in place (the
    optimizers keep their parameter objects), so that no float32 rounding is
    left anywhere."""
    for m in modules:
        if m is not None:
            m.double()


def _batch(i: int, n: int = 4, size: int = 128, ref_size: int = 16):
    """Iteration i's global NHWC batches (photo, render, ref, FFHQ reals),
    seeded by i; the rank's rows of each."""
    rng = np.random.RandomState(100 + i)
    photo, render = (rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32) for _ in range(2))
    render[:, : size // 4] = -1.0
    ref, ffhq = (rng.uniform(-1, 1, (n, ref_size, ref_size, 3)).astype(np.float32)
                 for _ in range(2))
    rows = parallel.local_rows(n)
    return photo[rows], render[rows], ref[rows], ffhq[rows]


def _iterations(trainer, iters, record, **batch_kw):
    out = {}
    for i in iters:
        recorded, stop = _record_gradients()
        photo, render, ref, ffhq = _batch(i, **batch_kw)
        args = (photo, render, ref) + ((ffhq,) if record == "ffhq" else ())
        metrics = trainer.train_iteration(i, *args)
        stop()
        out[i] = {"grads": recorded,
                  "metrics": {k: v.detach().clone() for k, v in metrics.items()
                              if torch.is_tensor(v)}}
    return out


def train_job(dtype, _out):
    """``Trainer`` at lr 0 (every step's gradient at the same weights): the
    reconstruction iteration 0, the DS iteration 1 (D_edit) and the
    extreme-DS iteration 5, each with R1 and PPL, and the shared iteration;
    the gradients of every applied step and the metrics."""
    import dataclasses

    from fm3dgan_torch.train import TrainConfig, Trainer

    cfg = TrainConfig(**CFG, lr=0.0)
    out = {}
    for shared, iters in ((False, (0, 1, 5)), (True, (0,))):
        trainer = Trainer(dataclasses.replace(cfg, share_dg_noise=shared), device="cpu",
                          input_size=128)
        if dtype == torch.float64:
            _float32_noise()
            trainer.state = trainer.float64_state()
            st = trainer.state
            _double(st.models, st.d, st.d_edit, st.g_ema, st.lpips, st.arcface)
        out["shared" if shared else "unshared"] = _iterations(trainer, iters, "3enc")
    return out


def train_iters_job(dtype, _out):
    """Three float32 iterations of ``Trainer`` at its learning rate (R1 and
    PPL at iteration 0 and 2): every parameter and statistic after them,
    and the metrics."""
    from fm3dgan_torch.train import TrainConfig, Trainer

    cfg = TrainConfig(**dict(CFG, d_reg_every=2, g_reg_every=2))
    trainer = Trainer(cfg, device="cpu", input_size=128)
    out = {"initial": trainer.state.models.generator.state_dict()["convs.0.conv.weight"].clone()}
    out["iters"] = _iterations(trainer, (0, 1, 2), "3enc")
    out["state"] = {k: {n: t.clone() for n, t in m.state_dict().items()}
                    for k, m in trainer._modules().items()}
    out["mean_path_length"] = trainer.state.mean_path_length.clone()
    return out


def train2_ffhq_job(dtype, _out):
    """The FFHQ-DS iteration 1 of a ``Trainer2`` (no co-modulation, 128 px
    in and out, stem width 4) at lr 0, with R1, R1_ffhq and PPL: the
    gradients of its D_ffhq, R1_ffhq, G-vs-D_ffhq, D, R1, G and PPL steps."""
    from fm3dgan_torch.pipeline.forward import TwoEncoderModels
    from fm3dgan_torch.train import TrainConfig, TrainState2, Trainer2

    class SmallTrainer2(Trainer2):
        def _create_state(self, _dtype):
            cfg, dt = self.config, dtype
            models = TwoEncoderModels.create(size=cfg.size, latent=cfg.latent,
                                             input_size=self.input_size, width_mult=4 / 64,
                                             dtype=dt, device=self.device, seed=self._seed)
            d, d_ffhq = self._discriminators(dt, 2, width_mult=1 / 16)
            return TrainState2.create(cfg, models, d, d_ffhq,
                                      **self._frozen_nets(dt, True, True))

    cfg = TrainConfig(size=128, latent=32, width_mult=1 / 16, d_reg_every=1, g_reg_every=1,
                      lr=0.0)
    trainer = SmallTrainer2(cfg, ds_dataset_type="FFHQ", device="cpu", input_size=128)
    if dtype == torch.float64:
        _float32_noise()
        st = trainer.state
        _double(st.models, st.d, st.d_ffhq, st.g_ema, st.lpips, st.arcface)
    return _iterations(trainer, (1,), "ffhq", ref_size=128)


def jax_pair_job(dtype, out_dir):
    """The D, R1, G (DS, with LPIPS and ArcFace) and PPL step gradients of
    the 2-encoder Tensor Transform pair that ``out_dir/setup.pt`` holds
    (``test_torch_ddp_train.py`` writes the port's weights of
    ``torch_port_utils.make_train2_pair`` there), in float64, on this
    rank's rows, averaged over the ranks."""
    from fm3dgan_torch.models import LPIPS, Discriminator, ResNetFace18
    from fm3dgan_torch.pipeline.forward import TwoEncoderModels
    from fm3dgan_torch.train import TrainConfig, TrainState2
    from fm3dgan_torch.train import steps_2encoder as steps2

    setup = torch.load(os.path.join(out_dir, "setup.pt"), weights_only=False)
    cfg = TrainConfig(**setup["cfg"])
    models = TwoEncoderModels.create(size=cfg.size, co_modulation=setup["co_mod"],
                                     latent=cfg.latent, input_size=setup["input_size"],
                                     width_mult=cfg.width_mult, dtype=dtype, device="cpu")
    d, d_ffhq = (Discriminator(size=cfg.size, width_mult=cfg.width_mult, dtype=dtype)
                 for _ in range(2))
    lpips, arcface = LPIPS(dtype=dtype), ResNetFace18(input_size=cfg.size // 2, dtype=dtype)
    for name, m in (("models", models), ("d", d), ("d_ffhq", d_ffhq), ("lpips", lpips),
                    ("arcface", arcface)):
        m.load_state_dict(setup["state_dicts"][name])
    lpips.requires_grad_(False).eval()
    arcface.requires_grad_(False).eval()
    _double(models, d, d_ffhq, lpips, arcface)
    st = TrainState2.create(cfg, models, d, d_ffhq, lpips=lpips, arcface=arcface)
    st.mean_path_length = torch.tensor(setup["mean_path_length"], dtype=dtype)
    photo, render, ref, ppl_noise = (_rows(a, dtype) for a in setup["inputs"])
    enc, avg = "Render Image", parallel.average_gradients
    out = {"d": avg(steps2.d_step_grads(st, cfg, photo, render, ref, enc)[0]),
           "r1": avg(steps2.d_reg_step_grads(st, cfg, ref)[0]),
           "g": avg(steps2.g_step_grads(st, cfg, photo, render, ref, enc, ds_flag=True)[0])}
    # The PPL batch: the first rows of the global batch, split over the ranks.
    m = setup["inputs"][3].shape[0]
    p_sub, r_sub = (_rows(a[:m], dtype) for a in setup["inputs"][:2])
    grads, new_mean, _ = steps2.g_reg_step_grads(st, cfg, p_sub, r_sub, enc, ppl_noise=ppl_noise)
    out.update(ppl=avg(grads), ppl_mean=new_mean)
    return out


def replicas_job(dtype, _out):
    """``check_replicas_equal`` on equal tensors, and on tensors that differ
    on one rank: whether each raised; then the host flags (``any_rank`` of a
    flag that only rank 1 raises, ``broadcast_flag`` of one that only rank 0
    raises) and the backend of the group that carries them."""
    same = [torch.arange(6, dtype=dtype), torch.ones(2, 3, dtype=dtype)]
    other = [t.clone() for t in same]
    if parallel.rank() == 1:
        other[1][0, 2] += 1e-6
    out = {}
    for name, ts in (("same", same), ("other", other)):
        try:
            parallel.check_replicas_equal(ts)
            out[name] = torch.tensor(0)
        except RuntimeError:
            out[name] = torch.tensor(1)
    out["any_rank"] = torch.tensor(int(parallel.any_rank(parallel.rank() == 1)))
    out["broadcast_flag"] = torch.tensor(int(parallel.broadcast_flag(parallel.rank() == 0)))
    host = parallel.dist._host_group
    out["host_group"] = torch.tensor(int(host is not None and host != torch.distributed.group.WORLD
                                         and torch.distributed.get_backend(host) == "gloo"))
    return out


def bn_encoders_job(dtype, _out):
    """Train-mode forwards of the 2-encoder encoders (Tensor Transform,
    stem width 4) on 4 seeded 128 px photos: every BatchNorm input (this
    rank's rows, float32) and its normalisation by the global statistics
    (weight 1, bias 0), in call order."""
    import fm3dgan_torch.models._common as common
    from fm3dgan_torch.pipeline.forward import TwoEncoderModels

    calls, combine = [], common._global_batch_norm

    def record(xf, weight, bias, eps):
        normalised, _, _ = combine(xf, torch.ones_like(weight), torch.zeros_like(bias), eps)
        calls.append({"x": xf.detach().clone(), "y": normalised.detach().clone()})
        return combine(xf, weight, bias, eps)

    common._global_batch_norm = record
    models = TwoEncoderModels.create(size=16, co_modulation="Tensor Transform", latent=32,
                                     input_size=128, width_mult=4 / 64, device="cpu")
    photo = torch.as_tensor(np.random.RandomState(4).uniform(-1, 1, (4, 3, 128, 128)),
                            dtype=torch.float32)
    with torch.no_grad():
        models.tensor_encoder(photo[parallel.local_rows(4)], True)
        models.modulation_encoder(photo[parallel.local_rows(4)], True)
    common._global_batch_norm = combine
    return {"calls": calls}


def features_job(dtype, _out):
    """``eval.fid.make_mesh_feature_fn`` on 10 seeded 64 px images (padded to
    a multiple of the world size) with InceptionV3 at its random seed-0
    weights: every rank's [10, 2048] features."""
    from fm3dgan_torch.eval.fid import make_mesh_feature_fn
    from fm3dgan_torch.tools.nets import inception_net

    img = torch.as_tensor(np.random.RandomState(3).uniform(-1, 1, (10, 3, 64, 64)), dtype=dtype)
    with torch.no_grad():
        return {"features": make_mesh_feature_fn(inception_net("cpu"))(img)}


JOBS = {"ops": ops_job, "replicas": replicas_job, "bn_encoders": bn_encoders_job, "features": features_job, "train": train_job, "train_iters": train_iters_job,
        "train2_ffhq": train2_ffhq_job, "jax_pair": jax_pair_job}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(job: str, out_dir: str, world: int = 2, dtype: str = "float32",
              timeout: float = 180.0):
    """Run ``job`` in ``world`` gloo ranks (one process each); return each
    rank's result.  A rank that fails or outlives ``timeout`` fails the
    caller, with every rank's output."""
    import subprocess

    os.makedirs(out_dir, exist_ok=True)
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), job, "--rank", str(r),
                               "--world", str(world), "--port", str(port), "--out", out_dir,
                               "--dtype", dtype],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(world)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            proc.kill()
    for r, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, f"rank {r} exited {proc.returncode}:\n" + "\n".join(logs)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("job", choices=sorted(JOBS))
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    args = p.parse_args()
    torch.set_num_threads(1)
    parallel.init_distributed(f"127.0.0.1:{args.port}", args.world, args.rank, device="cpu",
                              timeout=datetime.timedelta(seconds=60))
    result = JOBS[args.job](DTYPES[args.dtype], args.out)
    torch.save(result, os.path.join(args.out, f"rank{args.rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
