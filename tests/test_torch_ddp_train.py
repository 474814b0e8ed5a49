"""Data-parallel training of the port: two gloo ranks on the CPU, 2 rows
each, against one process on the 4-row global batch, and against the JAX
package's mesh path.

The jobs are ``torch_ddp_worker``'s, run alike in the ranks and in this
process without a group.  The trainer jobs train at lr 0, so that every
step of an iteration takes its gradient at the same weights (after an Adam
step, a weight whose gradient is rounding residue moves by lr either way),
and record the gradient each optimizer step applies, after the average
over the ranks: D, R1, G and PPL of the reconstruction iteration, of the DS
iteration with D_edit and of the extreme-DS iteration, the shared iteration
(``share_dg_noise``), and ``Trainer2``'s FFHQ-DS iteration (D_ffhq, R1_ffhq,
G against D_ffhq, then D, R1, G and PPL on the edit).

Bars, per tensor relative to its largest reference gradient:

* float64: 1e-9.  A tensor whose reference gradient is zero in exact
  arithmetic (within 1e-6 of its partition's largest: a bias right ahead of
  a train-mode BatchNorm) is held at 1e-9 of the partition's largest.
* float32: ``torch_port_utils.assert_grads_held``'s rule, with the one
  process's float64 run as the exact reference: the ranks within 1e-3 of
  it, or no further than the one process's float32 run is, and within that
  bar of the one process's float32 run.
* The losses: in float64 at 1e-9 relative; D's mean scores and the R1
  values are float32 by construction (D's logits and the gradient with
  respect to a float32 input), so 1e-6.  In float32 by the rule above, at
  1e-5 relative to the float64 value (the PPL penalty, a variance of path
  lengths, and the face-ID loss on the FFHQ step's edit are the
  ill-conditioned ones).
  The float64 runs draw their noise in float32 (``_float32_noise``), so that
  they are the exact reference of the float32 runs.
* After three float32 iterations at the trainer's learning rate, every
  parameter and statistic is equal on both ranks to the bit.

The port against JAX: the 2-encoder Tensor Transform pair of
``make_train2_pair`` in float64, the ranks' D, R1, G (DS, with LPIPS and
ArcFace) and PPL gradients against the JAX package's own steps run on the
global batch through its mesh path (``create_mesh(1)``, ``replicate``,
``shard_batch``), with ``assert_grads_held``'s float64 bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm3dgan.losses.path_reg import path_regularize
from fm3dgan.parallel import create_mesh, replicate, shard_batch
from fm3dgan.pipeline.forward import encode_2_encoder as jax_encode_2_encoder
from torch_ddp_worker import JOBS, run_ranks
from torch_port_utils import (
    FLOAT64_BAR,
    G2,
    MEAN_PATH_LENGTH,
    adam_first_moment,
    as_float64,
    assert_grads_held,
    grads2_to_port_layout,
    jax_step_fns2,
    make_train2_pair,
)

DTYPES = {"float32": torch.float32, "float64": torch.float64}
# Float32 by construction: D's mean logits (``steps.d_loss_grads``) and the
# R1 values, squares of the gradient with respect to a float32 input.
FLOAT32_METRICS = ("ref_score", "out_score", "r1", "r1_ffhq")


def _run(job, dtype, tmp_path_factory):
    ranks = run_ranks(job, str(tmp_path_factory.mktemp(f"{job}_{dtype}")), 2, dtype)
    return ranks, JOBS[job](DTYPES[dtype], None)


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    return {dt: _run("train", dt, tmp_path_factory) for dt in DTYPES}


@pytest.fixture(scope="module")
def ffhq_runs(tmp_path_factory):
    return {dt: _run("train2_ffhq", dt, tmp_path_factory) for dt in DTYPES}


# The float32 bar of every step: D's gradients follow the generated batch,
# whose float32 rounding they amplify (the one process's float32 D step of the
# FFHQ iteration is 1.5e-4 from float64, the JAX package's own 2.5e-4:
# ROADMAP.md section 3), so D is held at G's bar.
FLOAT32_BAR = 1e-3


def _held_float64(got, want, what):
    n = 0
    for part, tensors in want.items():
        part_max = max(float(t.abs().max()) for t in tensors.values())
        for name, w in tensors.items():
            g = got[part][name]
            assert g.dtype == torch.float64 and g.shape == w.shape, (what, part, name)
            scale = float(w.abs().max())
            err = float((g - w).abs().max())
            floor = scale if scale > 1e-6 * part_max else part_max
            assert err <= 1e-9 * floor, (what, part, name, err, scale, part_max)
            n += 1
    assert n > 0
    return n


def _check_iteration(ranks, ref, key, dtype, runs64=None, what="", float32_steps=None):
    """The recorded gradients and the metrics of one iteration: both ranks
    the same, and the ranks against the one process (in float32 the steps
    ``float32_steps``, default all)."""
    got, got1, want = ranks[0][key], ranks[1][key], ref[key]
    assert len(got["grads"]) == len(want["grads"]) >= 3, what
    for a, b in zip(got["grads"], got1["grads"]):
        for part in a:
            for name in a[part]:
                assert torch.equal(a[part][name], b[part][name]), (what, part, name)
    for k, w in want["metrics"].items():
        assert torch.equal(got["metrics"][k], got1["metrics"][k]), (what, k)
        g, w = float(got["metrics"][k]), float(w)
        if dtype == "float64":
            bar = 1e-6 if k in FLOAT32_METRICS else 1e-9
            assert abs(g - w) <= bar * max(abs(w), 1e-12), (what, k, g, w)
            continue
        # assert_grads_held's rule on the float64 run's value.
        e = float(runs64[key]["metrics"][k])
        scale = max(abs(e), 1e-12)
        rel = {"ranks_vs_exact": abs(g - e) / scale, "one_vs_exact": abs(w - e) / scale,
               "ranks_vs_one": abs(g - w) / scale}
        assert rel["ranks_vs_exact"] <= max(1e-5, rel["one_vs_exact"]), (what, k, rel)
        assert rel["ranks_vs_one"] <= 1e-5 + rel["one_vs_exact"], (what, k, rel)
    for s, (g, w) in enumerate(zip(got["grads"], want["grads"])):
        if dtype == "float64":
            n = _held_float64(g, w, f"{what} step {s}")
            print(f"{what} step {s} ({sorted(g)}): {n} tensors within 1e-9")
        elif float32_steps is None or s in float32_steps:
            exact = runs64[key]["grads"][s]
            assert_grads_held(g, {p: {n: t.numpy() for n, t in ts.items()} for p, ts in w.items()},
                              exact, FLOAT32_BAR, what=f"{what} step {s} ({sorted(g)})")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("section,it", [("unshared", 0), ("unshared", 1), ("unshared", 5),
                                        ("shared", 0)],
                         ids=["reconstruction", "ds_d_edit", "extreme_ds", "shared"])
def test_trainer_iteration_gradients_match_one_process(train_runs, dtype, section, it):
    ranks, ref = train_runs[dtype]
    assert ranks[0][section][it]["metrics"]["r1"] > 0
    _check_iteration([r[section] for r in ranks], ref[section], it, dtype,
                     runs64=train_runs["float64"][1][section], what=f"{section} {it} {dtype}")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_trainer2_ffhq_ds_iteration_gradients_match_one_process(ffhq_runs, dtype):
    ranks, ref = ffhq_runs[dtype]
    steps = ref[1]["grads"]
    assert [sorted(g) for g in steps[:3]] == [["d"], ["d"], ["g", "modulation_encoder",
                                                              "tensor_encoder"]]
    assert len(steps) == 7  # D_ffhq, R1_ffhq, G_ffhq, D, R1, G, PPL
    # In float32 the G and PPL steps on the edit (5, 6) are beyond float32:
    # there the one process's own G noise-weight gradients are 3-4e-2 and its
    # PPL tensor-encoder gradients 0.32 from float64 (its float64 run holds
    # them at 1e-9 above).
    _check_iteration(ranks, ref, 1, dtype, runs64=ffhq_runs["float64"][1],
                     what=f"ffhq {dtype}", float32_steps=range(5))


def test_parameters_are_equal_on_the_ranks_after_training(tmp_path_factory):
    ranks, ref = _run("train_iters", "float32", tmp_path_factory)
    n = 0
    for k, sd in ranks[0]["state"].items():
        for name, t in sd.items():
            assert torch.equal(t, ranks[1]["state"][k][name]), (k, name)
            n += 1
    assert torch.equal(ranks[0]["mean_path_length"], ranks[1]["mean_path_length"])
    # The weights moved, and iteration 0 (before any update) is the one
    # process's.
    assert not torch.equal(ranks[0]["state"]["g"]["convs.0.conv.weight"], ranks[0]["initial"])
    # D's step comes before any update; what follows it is after Adam steps.
    for k in ("d", "ref_score", "out_score"):
        w = ref["iters"][0]["metrics"][k]
        got = float(ranks[0]["iters"][0]["metrics"][k])
        assert abs(got - float(w)) <= 1e-5 * max(abs(float(w)), 1e-12), (k, got, float(w))
    print(f"{n} parameters and statistics equal to the bit on both ranks after 3 iterations")


# ---- the port against the JAX package's mesh path ---------------------------


@pytest.fixture(scope="module")
def jax_pair(tmp_path_factory):
    pair = make_train2_pair("Tensor Transform", rec_face_reg_loss_lambda=0.0,
                            ds_face_reg_loss_lambda=0.0, ep_face_reg_loss_lambda=0.0)
    st = pair["state"]
    cfg = {k: getattr(pair["cfg"], k) for k in ("size", "latent", "width_mult",
                                                "rec_face_reg_loss_lambda",
                                                "ds_face_reg_loss_lambda",
                                                "ep_face_reg_loss_lambda")}
    out = tmp_path_factory.mktemp("jax_pair")
    torch.save({"cfg": cfg, "co_mod": pair["co_mod"], "input_size": pair["input_size"],
                "mean_path_length": MEAN_PATH_LENGTH,
                "state_dicts": {"models": st.models.state_dict(), "d": st.d.state_dict(),
                                "d_ffhq": st.d_ffhq.state_dict(),
                                "lpips": st.lpips.state_dict(),
                                "arcface": st.arcface.state_dict()},
                "inputs": [np.ascontiguousarray(a.transpose(0, 3, 1, 2))
                           for a in (pair["np_in"][:3] + pair["np_in"][4:])]},
               out / "setup.pt")
    ranks = run_ranks("jax_pair", str(out), 2, "float64")
    with jax.enable_x64(True):
        want = _jax_mesh_grads(pair)
    return pair, ranks, want


def _jax_mesh_grads(pair):
    """The JAX steps in float64 on the global batch, through the mesh path:
    the state replicated and the batches sharded over ``create_mesh(1)``."""
    mesh = create_mesh(1)
    fns, _ = jax_step_fns2(pair, jnp.float64, loss_nets=True)
    e_tsr, e_mod, gen = (m.clone(dtype=jnp.float64) for m in pair["modules"])
    photo, render, ref, _, y = as_float64(pair["np_in"])
    frozen = replicate(as_float64(pair["frozen"]), mesh)
    photo, render, ref, y = shard_batch((photo, render, ref, y), mesh)
    out = {}
    new, _ = fns["d_step"](replicate(as_float64(pair["jstate"]), mesh), photo, render, ref, None)
    out["d"] = {"d": adam_first_moment(new["d_opt"])}
    new, _ = fns["d_reg_step"](replicate(as_float64(pair["jstate"]), mesh), ref)
    out["r1"] = {"d": adam_first_moment(new["d_opt"])}
    new, _ = fns["g_step"](replicate(as_float64(pair["jstate"]), mesh), photo, render, ref, None,
                           frozen, ds_flag=True, extreme_ds_flag=False, apply_ema=True)
    out["g"] = adam_first_moment(new["g_opt"])
    js = replicate(as_float64(pair["jstate"]), mesh)
    n, cfg = y.shape[0], pair["cfg"]

    @jax.jit
    def ppl(enc_params, photo, render, y):
        def loss(p):
            variables = {k: {"params": p[k], **js["stats"][k]} for k in G2}
            latent, tensor, _ = jax_encode_2_encoder(
                e_tsr, e_mod, gen, variables, photo, render, mod_encode="Render Image",
                co_modulation=pair["co_mod"], train=True)
            pen, new_mean, _ = path_regularize(
                lambda lat: gen.apply(variables["g"], input_is_latent=True, latent_styles=[lat],
                                      randomize_noise=False, external_input_tensor=tensor),
                latent, jnp.float64(MEAN_PATH_LENGTH), None, noise=y)
            return cfg.path_reg_weight * cfg.g_reg_every * pen, new_mean

        return jax.grad(loss, has_aux=True)(enc_params)

    sub = shard_batch((np.asarray(photo)[:n], np.asarray(render)[:n]), mesh)
    out["ppl"], out["ppl_mean"] = ppl({k: js["params"][k] for k in G2}, *sub, y)
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("step", ["d", "r1", "g", "ppl"])
def test_two_ranks_match_the_jax_mesh_in_float64(jax_pair, step):
    pair, ranks, want = jax_pair
    stats = pair["jstate"]["stats"]
    exact = {k: {n: torch.from_numpy(np.asarray(v, np.float64)) for n, v in part.items()}
             for k, part in grads2_to_port_layout(want[step], stats).items()}
    for a, b in zip(ranks[0][step].values(), ranks[1][step].values()):
        assert all(torch.equal(a[n], b[n]) for n in a), step
    assert_grads_held(ranks[0][step], {k: {n: t.numpy() for n, t in p.items()}
                                       for k, p in exact.items()},
                      exact, FLOAT64_BAR, what=f"{step}: 2 ranks vs the JAX mesh, float64")
    if step == "ppl":
        assert abs(float(ranks[0]["ppl_mean"]) - float(want["ppl_mean"])) <= 1e-9
        assert torch.equal(ranks[0]["ppl_mean"], ranks[1]["ppl_mean"])
