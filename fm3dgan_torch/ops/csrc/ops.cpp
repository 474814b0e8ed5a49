// The CUDA kernels of the fm3dgan_torch operators (K1-K5), whose schemas,
// CPU kernels and shape functions ../_build.py defines.  Each checks what its
// kernel takes (TypeError for the dtype, ValueError for the rest), allocates
// the output, launches on the input's device and current stream, raises on a
// CUDA error and counts the launch.  c10's device-generic guard and stream
// keep CUDA's headers out of this unit, which g++ compiles.

#include <ATen/core/Tensor.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>
#include <torch/library.h>

#include <algorithm>
#include <atomic>
#include <vector>

#include "kernels.h"

namespace {

// Launches per operator, in the order of ops.launch_counts().
enum Kernel { kBlur, kUp2, kAct, kActBwd, kDown2, kKernels };
std::atomic<int64_t> launches[kKernels];

int dtype_code(const at::Tensor& x, const char* what) {
  const auto t = x.scalar_type();
  TORCH_CHECK_TYPE(t == at::kFloat || t == at::kBFloat16,
                   what, ": CUDA kernels take float32 or bfloat16, not ", t);
  TORCH_CHECK_VALUE(x.is_contiguous(), what, ": input must be a contiguous NCHW tensor");
  return t == at::kFloat ? 0 : 1;
}

// Runs `launch(stream)` on x's device and its current stream; raises on a
// CUDA error and counts the launch.
template <typename F>
void launch_on(const at::Tensor& x, Kernel k, const char* what, F launch) {
  const c10::DeviceGuard guard(x.device());
  void* stream = c10::impl::getDeviceGuardImpl(c10::DeviceType::CUDA)
                     ->getStream(x.device())
                     .native_handle();
  const int err = launch(stream);
  TORCH_CHECK(err == 0, what, ": CUDA error ", err, " at launch");
  launches[k].fetch_add(1, std::memory_order_relaxed);
}

at::Tensor blur(const at::Tensor& x, c10::ArrayRef<double> taps, int64_t kh, int64_t kw,
                int64_t p0, int64_t p1) {
  const int code = dtype_code(x, "blur");
  TORCH_CHECK_VALUE(x.dim() == 4 && (int64_t)taps.size() == kh * kw,
                    "blur takes an NCHW tensor and a 2-D kernel");
  TORCH_CHECK_VALUE(1 <= kh && kh <= kMaxTaps && 1 <= kw && kw <= kMaxTaps,
                    "blur kernel must be at most 8x8, got ", kh, "x", kw);
  TORCH_CHECK_VALUE(0 <= p0 && p0 < std::min(kh, kw) && 0 <= p1 && p1 < std::min(kh, kw),
                    "blur pads must satisfy 0 <= p < k, got (", p0, ", ", p1, ")");
  const int64_t n = x.size(0), c = x.size(1), h = x.size(2), w = x.size(3);
  const int64_t oh = h + p0 + p1 - kh + 1, ow = w + p0 + p1 - kw + 1;
  TORCH_CHECK_VALUE(oh > 0 && ow > 0, "blur output would be empty: (", oh, ", ", ow, ")");
  at::Tensor y = x.new_empty({n, c, oh, ow});
  float k[kMaxTaps * kMaxTaps];
  std::copy(taps.begin(), taps.end(), k);
  launch_on(x, kBlur, "fm_blur", [&](void* s) {
    return fm_blur(x.data_ptr(), y.data_ptr(), k, code, n * c, h, w, kh, kw, p0, p1, s);
  });
  return y;
}

at::Tensor upsample2x(const at::Tensor& x, c10::ArrayRef<double> taps, int64_t p0, int64_t p1) {
  const int code = dtype_code(x, "upsample2x");
  TORCH_CHECK_VALUE(x.dim() == 4, "upsample2x takes an NCHW tensor");
  Up2Phases ph;
  const char* bad = up2_phases(taps.data(), (int)taps.size(), (int)p0, ph);
  TORCH_CHECK_VALUE(bad == nullptr, bad, " (k=", taps.size(), ", p0=", p0, ")");
  const int64_t n = x.size(0), c = x.size(1), h = x.size(2), w = x.size(3);
  at::Tensor y = x.new_empty({n, c, 2 * h, 2 * w});
  launch_on(x, kUp2, "fm_upsample2x", [&](void* s) {
    return fm_upsample2x(x.data_ptr(), y.data_ptr(), ph, code, n * c, h, w, s);
  });
  return y;
}

at::Tensor downsample2x(const at::Tensor& x, c10::ArrayRef<double> taps, int64_t p0,
                        int64_t p1) {
  const int code = dtype_code(x, "downsample2x");
  TORCH_CHECK_VALUE(x.dim() == 4, "downsample2x takes an NCHW tensor");
  Down2Params pr;
  const char* bad = down2_params(taps.data(), (int)taps.size(), (int)p0, (int)p1, pr);
  TORCH_CHECK_VALUE(bad == nullptr, bad);
  const int64_t k = pr.k, n = x.size(0), c = x.size(1), h = x.size(2), w = x.size(3);
  TORCH_CHECK_VALUE(h + p0 + p1 - k >= 0 && w + p0 + p1 - k >= 0,
                    "downsample2x output would be empty: (", h, ", ", w, "), k=", k, ", pad=(",
                    p0, ", ", p1, ")");
  at::Tensor y = x.new_empty({n, c, (h + p0 + p1 - k) / 2 + 1, (w + p0 + p1 - k) / 2 + 1});
  launch_on(x, kDown2, "fm_downsample2x", [&](void* s) {
    return fm_downsample2x(x.data_ptr(), y.data_ptr(), pr, code, n * c, h, w, s);
  });
  return y;
}

at::Tensor fused_leaky_relu(const at::Tensor& x, const std::optional<at::Tensor>& bias,
                            double negative_slope, double scale) {
  const int code = dtype_code(x, "fused_leaky_relu");
  TORCH_CHECK_VALUE(x.dim() >= 2, "fused_leaky_relu takes [N, C, ...] input");
  const int64_t c = x.size(1);
  int64_t hw = 1;
  for (int64_t d = 2; d < x.dim(); ++d) hw *= x.size(d);
  at::Tensor b;
  if (bias.has_value()) {
    TORCH_CHECK_VALUE(bias->sizes() == at::IntArrayRef{c} && bias->device() == x.device() &&
                          bias->scalar_type() == x.scalar_type(),
                      "bias must be [", c, "] ", x.scalar_type(), " on ", x.device(), ", got ",
                      bias->sizes(), " ", bias->scalar_type(), " on ", bias->device());
    b = bias->contiguous();
  }
  at::Tensor y = x.new_empty(x.sizes());
  launch_on(x, kAct, "fm_fused_leaky_relu", [&](void* s) {
    return fm_fused_leaky_relu(x.data_ptr(), b.defined() ? b.data_ptr() : nullptr, y.data_ptr(),
                               code, x.numel(), c, hw, negative_slope, scale, s);
  });
  return y;
}

at::Tensor fused_leaky_relu_bwd(const at::Tensor& grad, const at::Tensor& out,
                                double negative_slope, double scale) {
  dtype_code(grad, "fused_leaky_relu_bwd grad");
  const int code = dtype_code(out, "fused_leaky_relu_bwd out");
  TORCH_CHECK_VALUE(grad.sizes() == out.sizes() && grad.scalar_type() == out.scalar_type() &&
                        grad.device() == out.device(),
                    "fused_leaky_relu_bwd: grad ", grad.sizes(), " ", grad.scalar_type(),
                    " and out ", out.sizes(), " ", out.scalar_type(), " must match");
  at::Tensor dx = grad.new_empty(grad.sizes());
  launch_on(out, kActBwd, "fm_fused_leaky_relu_bwd", [&](void* s) {
    return fm_fused_leaky_relu_bwd(grad.data_ptr(), out.data_ptr(), dx.data_ptr(), code,
                                   out.numel(), negative_slope, scale, s);
  });
  return dx;
}

std::vector<int64_t> launch_counts() {
  std::vector<int64_t> out;
  for (const auto& n : launches) out.push_back(n.load(std::memory_order_relaxed));
  return out;
}

void reset_launches() {
  for (auto& n : launches) n.store(0, std::memory_order_relaxed);
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(fm3dgan_torch, m) {
  m.def("launch_counts() -> int[]", &launch_counts);
  m.def("reset_launches() -> ()", &reset_launches);
}

TORCH_LIBRARY_IMPL(fm3dgan_torch, CUDA, m) {
  m.impl("blur", &blur);
  m.impl("upsample2x", &upsample2x);
  m.impl("downsample2x", &downsample2x);
  m.impl("fused_leaky_relu", &fused_leaky_relu);
  m.impl("fused_leaky_relu_bwd", &fused_leaky_relu_bwd);
}
