"""The operators' C++ CUDA kernels (``fm3dgan_torch/ops/csrc/ops.cpp``) on the
CPU: the registration unit compiled with g++ against torch's headers and
linked with stand-in entry points (``kernels.h``, each returning 0), loaded
into a process of its own, where ``redispatch`` to the CUDA key reaches
each kernel's checks with CPU tensors.  Its schemas must match the Python
definitions for the load to succeed; each case must raise the exception
type the card raises (``tests/test_torch_cuda.py::
test_kernels_raise_on_what_they_do_not_take``) before anything is launched.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from fm3dgan_torch.ops import _build

STUBS = r"""
#include "kernels.h"
int fm_blur(const void*, void*, const float*, int, int, int, int, int, int, int, int, void*) {
  return 0;
}
int fm_upsample2x(const void*, void*, const Up2Phases&, int, int, int, int, void*) { return 0; }
int fm_downsample2x(const void*, void*, const Down2Params&, int, int, int, int, void*) {
  return 0;
}
int fm_fused_leaky_relu(const void*, const void*, void*, int, long long, int, int, float, float,
                        void*) {
  return 0;
}
int fm_fused_leaky_relu_bwd(const void*, const void*, void*, int, long long, float, float, void*) {
  return 0;
}
"""

# Each case: the operator and its arguments (evaluated with x, a float32
# [1, 4, 9, 9] tensor, and K, 4 x 4 taps), and the exception it raises.
CASES = {
    "blur_half": ("blur", "x.half(), K, 4, 4, 1, 1", "TypeError"),
    "blur_not_contiguous": ("blur", "x.transpose(2, 3), K, 4, 4, 1, 1", "ValueError"),
    "blur_pad_ge_k": ("blur", "x, K, 4, 4, 4, 1", "ValueError"),
    "blur_over_8x8": ("blur", "x, [1.0] * 81, 9, 9, 1, 1", "ValueError"),
    "blur_taps_not_kh_kw": ("blur", "x, K[:15], 4, 4, 1, 1", "ValueError"),
    "blur_empty_output": ("blur", "x[:, :, :2].contiguous(), K, 4, 4, 0, 0", "ValueError"),
    "upsample2x_9_taps": ("upsample2x", "x, [0.1] * 9, 4, 4", "ValueError"),
    "upsample2x_not_nchw": ("upsample2x", "x[0], [0.25, 0.75, 0.75, 0.25], 2, 1", "ValueError"),
    "downsample2x_empty_output": ("downsample2x", "x, [0.25, 0.75, 0.75, 0.25], -6, 0",
                                  "ValueError"),
    "downsample2x_no_taps": ("downsample2x", "x, [], 0, 0", "ValueError"),
    "fused_leaky_relu_half": ("fused_leaky_relu", "x.half(), None, 0.2, 1.4", "TypeError"),
    "fused_leaky_relu_bias_shape": ("fused_leaky_relu", "x, torch.zeros(3), 0.2, 1.4",
                                    "ValueError"),
    "fused_leaky_relu_bias_dtype": ("fused_leaky_relu", "x, torch.zeros(4).bfloat16(), 0.2, 1.4",
                                    "ValueError"),
    "fused_leaky_relu_1d": ("fused_leaky_relu", "x.flatten(), None, 0.2, 1.4", "ValueError"),
    "fused_leaky_relu_bwd_shapes": ("fused_leaky_relu_bwd", "x, x[:, :2].contiguous(), 0.2, 1.4",
                                    "ValueError"),
    "fused_leaky_relu_bwd_dtypes": ("fused_leaky_relu_bwd", "x, x.bfloat16(), 0.2, 1.4",
                                    "ValueError"),
}

RUNNER = r"""
import json, sys
import torch
import fm3dgan_torch.ops
torch.ops.load_library(sys.argv[1])
cases = json.loads(sys.argv[2])
cuda = torch._C.DispatchKeySet(torch._C.DispatchKey.CUDA)
x, K = torch.randn(1, 4, 9, 9), [1 / 64] * 16
out = {"counts": list(torch.ops.fm3dgan_torch.launch_counts())}
for name, (op, args, _) in cases.items():
    try:
        getattr(torch.ops.fm3dgan_torch, op).default.redispatch(cuda, *eval(args))
        out[name] = ["none", ""]
    except Exception as e:
        out[name] = [type(e).__name__, str(e).splitlines()[0]]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def native_results(tmp_path_factory):
    root = tmp_path_factory.mktemp("native_ops")
    torch_dir = os.path.dirname(os.path.abspath(torch.__file__))
    (root / "stubs.cpp").write_text(STUBS)
    objs = []
    unit = [*_build.CXX_FLAGS, _build._abi_flag(), "-I", os.path.join(torch_dir, "include")]
    for src, flags in ((os.path.join(_build.CSRC, "ops.cpp"), unit),
                       (str(root / "stubs.cpp"), ["-std=c++17", "-fPIC", "-I", _build.CSRC])):
        objs.append(str(root / (os.path.basename(src) + ".o")))
        subprocess.run(["g++", *flags, "-c", "-o", objs[-1], src], check=True)
    lib = str(root / "libops_cpu.so")
    torch_lib = os.path.join(torch_dir, "lib")
    subprocess.run(["g++", "-shared", "-o", lib, *objs, "-L", torch_lib, "-lc10", "-ltorch_cpu",
                    f"-Wl,-rpath,{torch_lib}"], check=True)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", RUNNER, lib, json.dumps(CASES)], check=True,
                         capture_output=True, text=True, cwd=repo, timeout=180,
                         env={**os.environ, "PYTHONPATH": repo})
    return json.loads(run.stdout.strip().splitlines()[-1])


def test_native_library_loads_with_its_counters_at_zero(native_results):
    assert native_results["counts"] == [0] * 5


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_kernels_raise_on_what_they_do_not_take(native_results, case):
    kind, message = native_results[case]
    assert kind == CASES[case][2], (case, kind, message)
