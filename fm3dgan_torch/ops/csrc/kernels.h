// The host side of the five kernels, shared by their CUDA sources and the
// operator registration unit (ops.cpp): K4's and K5's tap tables, built from
// an operator's raw taps, and the kernels' entry points.  Host-only: no CUDA
// and no PyTorch headers, so a plain C++ compiler builds it (the tests hold
// K4's table against the TPU kernel's `_phase_taps` this way).
#pragma once

constexpr int kMaxTaps = 8;

// K4's phase taps: out[2y + a] = sum_{j < nt} w[a][j] * x[y + base + (a ? shift1 : 0) + j].
struct Up2Phases {
  int nt;
  int base;
  int shift1;
  float w[2][4];
};

// K5's taps and pads: out[o] = sum_{t < k} w[t] * xpad[2o + t], w the flipped taps.
struct Down2Params {
  int k;
  int p0;
  int p1;
  float w[kMaxTaps];
};

// K4's table for the k taps of a 2x upsample with pads (p0, k - 1 - p0), the
// TPU kernel's `_phase_taps(k1d, 2, p0)`: phase a takes the flipped taps t
// with a - p0 + t even, at input offset (a - p0 + t) / 2.  Each phase's
// offsets are consecutive; phase 0 starts at `base`, phase 1 at base +
// shift1, shift1 = 1 when p0 is even, else 0.  Shorter phases are padded with
// zero weights to nt, an empty one (k = 1) wholly.  p0 may be negative: the
// down2 adjoint calls up2 with pads (k - p0 - 1, p0).  Returns what is wrong
// with the taps, or nullptr.
inline const char* up2_phases(const double* taps, int k, int p0, Up2Phases& ph) {
  if (k < 1 || k > kMaxTaps) return "upsample2x takes 1 to 8 taps";
  ph = Up2Phases{};
  int n[2] = {0, 0}, first[2] = {0, 0};
  for (int a = 0; a < 2; ++a) {
    for (int t = 0; t < k; ++t) {
      const int m = a - p0 + t;
      if (m % 2 != 0) continue;
      if (n[a] == 0) first[a] = m / 2;
      if (m / 2 != first[a] + n[a]) return "upsample2x: phase offsets are not consecutive";
      ph.w[a][n[a]++] = static_cast<float>(taps[k - 1 - t]);
    }
  }
  ph.nt = n[0] > n[1] ? n[0] : n[1];
  ph.base = n[0] ? first[0] : first[1];
  ph.shift1 = n[0] && n[1] ? first[1] - first[0] : 0;
  if (ph.nt < 1 || ph.nt > 4 || ph.shift1 < 0 || ph.shift1 > 1) {
    return "upsample2x: no phase table for these taps and pads";
  }
  return nullptr;
}

// K5's table: the k taps flipped, and the pads.
inline const char* down2_params(const double* taps, int k, int p0, int p1, Down2Params& pr) {
  if (k < 1 || k > kMaxTaps) return "downsample2x takes 1 to 8 taps";
  pr = Down2Params{k, p0, p1, {}};
  for (int t = 0; t < k; ++t) pr.w[t] = static_cast<float>(taps[k - 1 - t]);
  return nullptr;
}

// Entry points, called by ops.cpp once it has checked their arguments: dtype
// 0 = float32, 1 = bfloat16; NC = N * C planes.  Each launches on `stream` (a
// cudaStream_t) and returns cudaGetLastError(), or cudaErrorInvalidValue for
// planes beyond 32-bit offsets.

// taps: the kh x kw taps, unflipped; pads 0 <= p0, p1 < min(kh, kw).
int fm_blur(const void* x, void* y, const float* taps, int dtype, int NC, int H, int W, int kh,
            int kw, int p0, int p1, void* stream);
int fm_upsample2x(const void* x, void* y, const Up2Phases& ph, int dtype, int NC, int H, int W,
                  void* stream);
// Pads may be negative (a crop), with H + p0 + p1 >= k and W + p0 + p1 >= k.
int fm_downsample2x(const void* x, void* y, const Down2Params& pr, int dtype, int NC, int H,
                    int W, void* stream);
// bias: nullptr or C elements of x's dtype; total = N * C * HW.
int fm_fused_leaky_relu(const void* x, const void* bias, void* y, int dtype, long long total,
                        int C, int HW, float slope, float scale, void* stream);
int fm_fused_leaky_relu_bwd(const void* g, const void* out, void* dx, int dtype, long long total,
                            float slope, float scale, void* stream);
