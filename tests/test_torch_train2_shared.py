"""The port's 2-encoder shared iteration (``share_dg_noise``) vs the JAX
package's ``fused_shared_iteration_step`` under ``jax.jit``, fp32 on the
CPU: one DS iteration with R1, LPIPS and ArcFace, fixed noise, from the
same weights (``make_train2_pair``).  The encoders are the pair without
co-modulation, two ResNet-18s (tensor and W): under ``jax.jit`` on XLA:CPU
the JAX package's train-mode pSp gradients are wrong (``ROADMAP.md``
section 3).  The learning rate is 1e-7, so that the D update ahead of the G
loss leaves the same D on both sides (see ``test_torch_train2_ffhq.py``:
Adam's first update moves a weight whose gradient is within rounding of
zero by lr in either direction; at 1e-3 that moved G's gradients by 2.4e-3
here).

Bars: the losses at rtol 1e-4 (R1 at the JAX golden bar, 1e-3); the G and
encoder gradients, read from Adam's first moment (beta1 = 0, so it holds
the gradient), held at 1e-3 to the JAX package's fused step run in float64
(``assert_grads_held``: its float32 run is 8.2e-3 from it, the port's
3.1e-5), and the port's float64 shared iteration within ``FLOAT64_BAR`` of
it (1.4e-6); the encoders' running statistics after their one update at
1e-5; g_ema after it at 1e-6, absolute and relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fm3dgan_torch.train import steps_2encoder as steps2
from fm3dgan_torch.train.state import g2_modules, named_params
from torch_port_utils import (
    adam_first_moment,
    as_float64,
    assert_close,
    assert_grads_held,
    assert_running_stats,
    float64_state2,
    grads2_to_port_layout,
    jax_step_fns2,
    make_train2_pair,
)

ENC = "Render Image"


def test_shared_iteration_matches_jax_fused_shared_step():
    pair = make_train2_pair(None, rec_face_reg_loss_lambda=0.0, ds_face_reg_loss_lambda=0.0,
                            ep_face_reg_loss_lambda=0.0, lr=1e-7)
    photo, render, ref = pair["np_in"][:3]
    args = (pair["jstate"], photo, render, ref, None, None, np.arange(2), pair["frozen"])
    kw = dict(ds_flag=True, extreme_ds_flag=False, do_r1=True, do_g_reg=False)
    new, want = jax_step_fns2(pair, loss_nets=True)[0]["fused_shared_iteration_step"](*args, **kw)
    new = jax.tree_util.tree_map(np.asarray, new)
    with jax.enable_x64(True):
        new64, _ = jax_step_fns2(pair, jnp.float64, loss_nets=True)[0][
            "fused_shared_iteration_step"](*as_float64(args), **kw)
        exact = grads2_to_port_layout(adam_first_moment(new64["g_opt"]), new["stats"])
    st, cfg = pair["state"], pair["cfg"]
    s64 = float64_state2(pair)
    steps2.shared_iteration(s64, cfg, *(x.double() for x in pair["t_in"][:3]), ENC, ds_flag=True,
                            do_r1=True, apply_ema=True)
    got = steps2.shared_iteration(st, cfg, *pair["t_in"][:3], ENC, ds_flag=True, do_r1=True,
                                  apply_ema=True)
    for k in ("d", "ref_score", "out_score", "g", "lpips", "l1", "face_id"):
        assert float(want[k]) != 0.0, k
        assert_close(float(got[k]), float(want[k]), 0, 1e-4, k)
    assert_close(float(got["r1"]), float(want["r1"]), 0, 1e-3, "r1")

    grads, port64 = ({part: {name: s.g_opt.state[p]["exp_avg"] for q, name, p in
                             named_params(g2_modules(s.models)) if q == part}
                      for part in ("g", "tensor_encoder", "modulation_encoder")} for s in (st, s64))
    assert_grads_held(grads, grads2_to_port_layout(adam_first_moment(new["g_opt"]), new["stats"]),
                      exact, 1e-3, what="shared iteration G and encoder gradients",
                      port_exact=port64)
    assert_running_stats({"tensor_encoder": st.models.tensor_encoder,
                          "modulation_encoder": st.models.modulation_encoder},
                         pair["jstate"]["params"], new["stats"], "shared iteration")
    want_ema = grads2_to_port_layout({"g": new["g_ema"]}, {})["g"]
    for name, p in st.g_ema.named_parameters():
        torch.testing.assert_close(p.detach(), want_ema[name], rtol=1e-6, atol=1e-6, msg=name)
