// Permutohedral lattice for high-dimensional Gaussian filtering
// (Adams, Baek, Davis 2010), as used by dense CRF mean-field inference.
// Own implementation of the published algorithm; API shaped for the
// densecrf.cpp mean-field loop.
#pragma once

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace ifseg {

class Permutohedral {
 public:
  // features: (N, d) row-major. Builds the splat/blur/slice plan.
  void init(const float* features, int N, int d);

  // in/out: (N, value_size) row-major; out = lattice-filtered in.
  void compute(float* out, const float* in, int value_size) const;

  int n_lattice() const { return static_cast<int>(n_vertices_); }

 private:
  struct KeyHash {
    size_t operator()(const std::vector<short>& k) const {
      size_t h = 0;
      for (short v : k) h = h * 2531011u + static_cast<size_t>(v + 32768);
      return h;
    }
  };

  int N_ = 0, d_ = 0;
  size_t n_vertices_ = 0;
  std::vector<int> offset_;        // (N, d+1) lattice vertex index per simplex corner
  std::vector<float> barycentric_; // (N, d+1)
  std::vector<int> blur_n1_, blur_n2_; // (d+1, n_vertices) neighbor indices (-1 = none)
};

inline void Permutohedral::init(const float* features, int N, int d) {
  N_ = N;
  d_ = d;
  offset_.assign(static_cast<size_t>(N) * (d + 1), 0);
  barycentric_.assign(static_cast<size_t>(N) * (d + 1), 0.f);

  std::vector<float> scale_factor(d);
  const float inv_std_dev = std::sqrt(2.0f / 3.0f) * (d + 1);
  for (int i = 0; i < d; i++)
    scale_factor[i] = 1.0f / std::sqrt(float((i + 2) * (i + 1))) * inv_std_dev;

  std::unordered_map<std::vector<short>, int, KeyHash> hash;
  hash.reserve(static_cast<size_t>(N) * 2);
  std::vector<std::vector<short>> keys;  // insertion-ordered lattice keys

  std::vector<float> elevated(d + 1), rem0(d + 1), barycentric(d + 2);
  std::vector<int> rank(d + 1);
  std::vector<short> key(d);

  for (int k = 0; k < N; k++) {
    const float* f = features + static_cast<size_t>(k) * d;
    // elevate to the hyperplane sum(x)=0 in d+1 dims
    float sm = 0;
    for (int j = d; j > 0; j--) {
      float cf = f[j - 1] * scale_factor[j - 1];
      elevated[j] = sm - j * cf;
      sm += cf;
    }
    elevated[0] = sm;

    // nearest zero-colored lattice point
    const float down_factor = 1.0f / (d + 1);
    const float up_factor = float(d + 1);
    int sum = 0;
    for (int i = 0; i <= d; i++) {
      int rd = static_cast<int>(std::round(down_factor * elevated[i]));
      rem0[i] = rd * up_factor;
      sum += rd;
    }

    // rank each dimension by residual
    for (int i = 0; i <= d; i++) rank[i] = 0;
    for (int i = 0; i < d; i++)
      for (int j = i + 1; j <= d; j++) {
        if (elevated[i] - rem0[i] < elevated[j] - rem0[j])
          rank[i]++;
        else
          rank[j]++;
      }

    // fix the sum so the point is on the right hyperplane
    for (int i = 0; i <= d; i++) {
      rank[i] += sum;
      if (rank[i] < 0) {
        rank[i] += d + 1;
        rem0[i] += d + 1;
      } else if (rank[i] > d) {
        rank[i] -= d + 1;
        rem0[i] -= d + 1;
      }
    }

    // barycentric coordinates
    for (int i = 0; i <= d + 1; i++) barycentric[i] = 0;
    for (int i = 0; i <= d; i++) {
      float v = (elevated[i] - rem0[i]) * down_factor;
      barycentric[d - rank[i]] += v;
      barycentric[d - rank[i] + 1] -= v;
    }
    barycentric[0] += 1.0f + barycentric[d + 1];

    // one key per simplex corner
    for (int remainder = 0; remainder <= d; remainder++) {
      for (int i = 0; i < d; i++) {
        key[i] = static_cast<short>(rem0[i] + remainder);
        if (rank[i] > d - remainder) key[i] -= static_cast<short>(d + 1);
      }
      auto it = hash.find(key);
      int idx;
      if (it == hash.end()) {
        idx = static_cast<int>(keys.size());
        hash.emplace(key, idx);
        keys.push_back(key);
      } else {
        idx = it->second;
      }
      offset_[static_cast<size_t>(k) * (d + 1) + remainder] = idx;
      barycentric_[static_cast<size_t>(k) * (d + 1) + remainder] =
          barycentric[remainder];
    }
  }

  n_vertices_ = keys.size();

  // blur neighbors along each lattice direction
  blur_n1_.assign((d + 1) * n_vertices_, -1);
  blur_n2_.assign((d + 1) * n_vertices_, -1);
  std::vector<short> n1(d), n2(d);
  for (int j = 0; j <= d; j++) {
    for (size_t i = 0; i < n_vertices_; i++) {
      const std::vector<short>& kk = keys[i];
      for (int m = 0; m < d; m++) {
        n1[m] = static_cast<short>(kk[m] - 1);
        n2[m] = static_cast<short>(kk[m] + 1);
      }
      if (j < d) {
        n1[j] = static_cast<short>(kk[j] + d);
        n2[j] = static_cast<short>(kk[j] - d);
      }
      auto i1 = hash.find(n1);
      auto i2 = hash.find(n2);
      blur_n1_[static_cast<size_t>(j) * n_vertices_ + i] =
          i1 == hash.end() ? -1 : i1->second;
      blur_n2_[static_cast<size_t>(j) * n_vertices_ + i] =
          i2 == hash.end() ? -1 : i2->second;
    }
  }
}

inline void Permutohedral::compute(float* out, const float* in,
                                   int value_size) const {
  const int vs = value_size;
  std::vector<float> values((n_vertices_ + 1) * vs, 0.f);  // +1 zero pad
  std::vector<float> new_values((n_vertices_ + 1) * vs, 0.f);

  // splat
  for (int k = 0; k < N_; k++) {
    for (int r = 0; r <= d_; r++) {
      int o = offset_[static_cast<size_t>(k) * (d_ + 1) + r];
      float b = barycentric_[static_cast<size_t>(k) * (d_ + 1) + r];
      float* v = values.data() + static_cast<size_t>(o) * vs;
      const float* x = in + static_cast<size_t>(k) * vs;
      for (int c = 0; c < vs; c++) v[c] += b * x[c];
    }
  }

  // blur along each lattice direction: [1, 2, 1] / 2
  for (int j = 0; j <= d_; j++) {
    for (size_t i = 0; i < n_vertices_; i++) {
      const float* old_v = values.data() + i * vs;
      float* new_v = new_values.data() + i * vs;
      int i1 = blur_n1_[static_cast<size_t>(j) * n_vertices_ + i];
      int i2 = blur_n2_[static_cast<size_t>(j) * n_vertices_ + i];
      const float* v1 =
          values.data() + static_cast<size_t>(i1 < 0 ? n_vertices_ : i1) * vs;
      const float* v2 =
          values.data() + static_cast<size_t>(i2 < 0 ? n_vertices_ : i2) * vs;
      for (int c = 0; c < vs; c++)
        new_v[c] = old_v[c] + 0.5f * (v1[c] + v2[c]);
    }
    values.swap(new_values);
  }

  // slice; alpha undoes the blur gain
  const float alpha = 1.0f / (1.0f + std::pow(2.0f, -d_));
  std::memset(out, 0, static_cast<size_t>(N_) * vs * sizeof(float));
  for (int k = 0; k < N_; k++) {
    for (int r = 0; r <= d_; r++) {
      int o = offset_[static_cast<size_t>(k) * (d_ + 1) + r];
      float b = barycentric_[static_cast<size_t>(k) * (d_ + 1) + r];
      const float* v = values.data() + static_cast<size_t>(o) * vs;
      float* x = out + static_cast<size_t>(k) * vs;
      for (int c = 0; c < vs; c++) x[c] += b * v[c] * alpha;
    }
  }
}

}  // namespace ifseg
