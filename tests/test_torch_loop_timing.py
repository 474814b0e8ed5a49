"""``fm3dgan_torch/tools/loop_timing.py`` on the CPU: the 3-encoder CLI on
image folders as one process and under ``torchrun --nproc_per_node 1
--data_parallel`` (a gloo world of one), at a tiny configuration."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--size", "16", "--latent", "32", "--width_mult", "0.0625", "--input_size", "128",
        "--rec_batch", "2", "--ds_batch", "2", "--ds_face_reg_loss_lambda", "0",
        "--ep_face_reg_loss_lambda", "0"]


def test_loop_timing_runs_both_ways_on_image_folders(tmp_path):
    out = tmp_path / "timing.json"
    proc = subprocess.run(
        [sys.executable, "-m", "fm3dgan_torch.tools.loop_timing", "--work_dir", str(tmp_path),
         "--image_size", "64", "--n_photos", "8", "--n_ids", "4", "--n_var", "2", "--iters", "4",
         "--runs", "one,ddp", "--device", "cpu", "--profile", "1:3", "--out", str(out), "--",
         *TINY],
        cwd=REPO, capture_output=True, text=True, timeout=170,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    result = json.loads(out.read_text())
    assert [r["kind"] for r in result["runs"]] == ["one", "ddp"]
    for r in result["runs"]:
        assert r["iterations"] == 4 and len(r["periods_ms"]) == 4 and len(r["load_s"]) == 4
        assert all(p > 0 for p in r["periods_ms"]) and r["ms_per_iteration"] > 0
        assert all(x >= 0 for x in r["load_s"]) and len(r["enqueue_ms"]) == 4
        # Iterations 1 and 2 under the profiler: host ops only on the CPU.
        p = r["profile"]
        assert p["iterations"] == 2 and p["wall_ms_per_iteration"] > 0
        assert p["device_busy_ms_per_iteration"] == 0 and p["top_device"] == []
        assert p["top_cpu"][0]["self_cpu_ms"] > 0
    # The data-parallel route's own ops show in its profile alone.
    names = [{e["name"] for e in r["profile"]["top_cpu"]} for r in result["runs"]]
    assert not any(n.startswith("c10d::") for n in names[0])
    # Both runs read the same PNGs: the reconstruction photos of the layout.
    assert len(os.listdir(tmp_path / "rec" / "img")) == 8
