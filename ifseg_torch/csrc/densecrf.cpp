// Dense CRF mean-field inference with Gaussian + bilateral pairwise
// potentials (Krähenbühl & Koltun 2011), replacing the reference's external
// pydensecrf dependency (reference crf.py:11-37: unary from softmax,
// PairwiseGaussian(sxy=1, compat=3), PairwiseBilateral(sxy=67, srgb=3,
// compat=4), N mean-field iterations).
//
// Built as a plain shared library by ifseg_torch/ops/build.py; Python binds
// via ctypes (ifseg_torch/ops/crf.py).  OpenMP-free, single-thread per call
// — callers parallelize across images.

#include <algorithm>
#include <cmath>
#include <vector>

#include "permutohedral.h"

namespace {

// symmetric normalization weights: 1/sqrt(lattice(1) + eps)
std::vector<float> norm_weights(const ifseg::Permutohedral& lat, int n) {
  std::vector<float> ones(n, 1.f), norm(n, 0.f);
  lat.compute(norm.data(), ones.data(), 1);
  for (int i = 0; i < n; i++) norm[i] = 1.0f / std::sqrt(norm[i] + 1e-20f);
  return norm;
}

// filtered = norm * lattice(norm * Q), per label channel
void filtered_message(const ifseg::Permutohedral& lat,
                      const std::vector<float>& norm, const float* q, int n,
                      int c, float* out, std::vector<float>& tmp) {
  for (int i = 0; i < n; i++)
    for (int l = 0; l < c; l++)
      tmp[static_cast<size_t>(i) * c + l] =
          q[static_cast<size_t>(i) * c + l] * norm[i];
  lat.compute(out, tmp.data(), c);
  for (int i = 0; i < n; i++)
    for (int l = 0; l < c; l++) out[static_cast<size_t>(i) * c + l] *= norm[i];
}

void exp_and_normalize(float* q, const float* logits, int n, int c) {
  for (int i = 0; i < n; i++) {
    const float* in = logits + static_cast<size_t>(i) * c;
    float* out = q + static_cast<size_t>(i) * c;
    float mx = in[0];
    for (int l = 1; l < c; l++) mx = std::max(mx, in[l]);
    float sum = 0;
    for (int l = 0; l < c; l++) {
      out[l] = std::exp(in[l] - mx);
      sum += out[l];
    }
    for (int l = 0; l < c; l++) out[l] /= sum;
  }
}

}  // namespace

extern "C" {

// probs: (H, W, C) softmax probabilities; image_bgr: (H, W, 3) uint8.
// out: (H, W, C) refined probabilities.  Mirrors reference crf.py defaults:
// rgb_dense_crf(image_bgr, probs, max_iter): sxy_gauss=1 compat_gauss=3
// sxy_bilateral=67 srgb=3 compat_bilateral=4.
void dense_crf_inference(const unsigned char* image_bgr, const float* probs,
                         int H, int W, int C, int n_iter, float sxy_gauss,
                         float compat_gauss, float sxy_bilateral,
                         float srgb_bilateral, float compat_bilateral,
                         float* out) {
  const int n = H * W;

  // unary = -log(clip(probs, 1e-5, 1))  (pydensecrf unary_from_softmax)
  std::vector<float> unary(static_cast<size_t>(n) * C);
  for (size_t i = 0; i < unary.size(); i++) {
    float p = probs[i];
    p = std::max(1e-5f, std::min(1.0f, p));
    unary[i] = -std::log(p);
  }

  // gaussian lattice: features (x/sxy, y/sxy)
  std::vector<float> feat_g(static_cast<size_t>(n) * 2);
  for (int y = 0; y < H; y++)
    for (int x = 0; x < W; x++) {
      feat_g[static_cast<size_t>(y * W + x) * 2 + 0] = x / sxy_gauss;
      feat_g[static_cast<size_t>(y * W + x) * 2 + 1] = y / sxy_gauss;
    }
  ifseg::Permutohedral lat_g;
  lat_g.init(feat_g.data(), n, 2);
  std::vector<float> norm_g = norm_weights(lat_g, n);

  // bilateral lattice: features (x/sxy, y/sxy, b/srgb, g/srgb, r/srgb)
  std::vector<float> feat_b(static_cast<size_t>(n) * 5);
  for (int y = 0; y < H; y++)
    for (int x = 0; x < W; x++) {
      size_t i = static_cast<size_t>(y * W + x);
      feat_b[i * 5 + 0] = x / sxy_bilateral;
      feat_b[i * 5 + 1] = y / sxy_bilateral;
      feat_b[i * 5 + 2] = image_bgr[i * 3 + 0] / srgb_bilateral;
      feat_b[i * 5 + 3] = image_bgr[i * 3 + 1] / srgb_bilateral;
      feat_b[i * 5 + 4] = image_bgr[i * 3 + 2] / srgb_bilateral;
    }
  ifseg::Permutohedral lat_b;
  lat_b.init(feat_b.data(), n, 5);
  std::vector<float> norm_b = norm_weights(lat_b, n);

  // Q0 = softmax(-unary) == clipped, renormalized probs
  std::vector<float> q(static_cast<size_t>(n) * C);
  std::vector<float> neg_u(static_cast<size_t>(n) * C);
  for (size_t i = 0; i < unary.size(); i++) neg_u[i] = -unary[i];
  exp_and_normalize(q.data(), neg_u.data(), n, C);

  std::vector<float> logits(static_cast<size_t>(n) * C);
  std::vector<float> msg(static_cast<size_t>(n) * C);
  std::vector<float> tmp(static_cast<size_t>(n) * C);

  for (int it = 0; it < n_iter; it++) {
    // logits = -U + w_g * filtered_g(Q) + w_b * filtered_b(Q)
    // (Potts compatibility: pairwise->apply gives -w * filtered, and
    //  stepInference subtracts it; densecrf stepInference semantics)
    std::copy(neg_u.begin(), neg_u.end(), logits.begin());
    filtered_message(lat_g, norm_g, q.data(), n, C, msg.data(), tmp);
    for (size_t i = 0; i < logits.size(); i++)
      logits[i] += compat_gauss * msg[i];
    filtered_message(lat_b, norm_b, q.data(), n, C, msg.data(), tmp);
    for (size_t i = 0; i < logits.size(); i++)
      logits[i] += compat_bilateral * msg[i];
    exp_and_normalize(q.data(), logits.data(), n, C);
  }

  std::copy(q.begin(), q.end(), out);
}

}  // extern "C"
