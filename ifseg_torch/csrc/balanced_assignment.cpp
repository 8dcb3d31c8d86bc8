// Balanced token->expert assignment via the auction algorithm
// (Bertsekas 1992), the BASE-layers routing primitive (reference:
// custom_fairseq/fairseq/clib/libbase/balanced_assignment.cpp, used by
// fairseq/modules/base_layer.py).  Own implementation of the published
// algorithm behind the same capability: assign N jobs to E agents with equal
// capacity N/E, maximizing total score.
//
// extern "C" API over plain float buffers; built as a plain shared library
// by ifseg_torch/ops/build.py, bound via ctypes
// (ifseg_torch/ops/balanced_assignment.py).

#include <algorithm>
#include <cstring>
#include <limits>
#include <queue>
#include <vector>

extern "C" {

// scores: (N, E) row-major, N divisible by E.  out: (N,) expert id per token.
// eps: bid increment (auction accuracy/speed tradeoff).
void balanced_assignment(const float* scores, int N, int E, float eps,
                         int* out) {
  const int capacity = N / E;
  std::vector<float> price(E, 0.f);
  std::vector<int> assign(N, -1);
  // per-expert min-heap of (score-derived value, token) of current holders:
  // we track holders as a vector and evict the lowest bidder
  std::vector<std::vector<int>> holders(E);
  std::vector<float> holder_value;  // value of token's current bid
  holder_value.assign(N, 0.f);

  std::queue<int> unassigned;
  for (int i = 0; i < N; i++) unassigned.push(i);

  auto value = [&](int token, int e) {
    return scores[static_cast<size_t>(token) * E + e] - price[e];
  };

  int guard = 0;
  const int guard_max = 50 * N * E + 1000;
  while (!unassigned.empty() && guard++ < guard_max) {
    int token = unassigned.front();
    unassigned.pop();

    // best and second-best expert for this token at current prices
    int best = 0;
    float best_v = -std::numeric_limits<float>::infinity();
    float second_v = -std::numeric_limits<float>::infinity();
    for (int e = 0; e < E; e++) {
      float v = value(token, e);
      if (v > best_v) {
        second_v = best_v;
        best_v = v;
        best = e;
      } else if (v > second_v) {
        second_v = v;
      }
    }
    float bid = price[best] + (best_v - second_v) + eps;

    auto& h = holders[best];
    if (static_cast<int>(h.size()) < capacity) {
      h.push_back(token);
      assign[token] = best;
      holder_value[token] = bid;
      if (static_cast<int>(h.size()) == capacity) {
        // expert full: price rises to the lowest winning bid
        float mn = std::numeric_limits<float>::infinity();
        for (int t : h) mn = std::min(mn, holder_value[t]);
        price[best] = mn;
      }
    } else {
      // evict the lowest-bidding current holder
      int evict_pos = 0;
      float mn = holder_value[h[0]];
      for (int j = 1; j < capacity; j++) {
        if (holder_value[h[j]] < mn) {
          mn = holder_value[h[j]];
          evict_pos = j;
        }
      }
      int evicted = h[evict_pos];
      h[evict_pos] = token;
      assign[token] = best;
      holder_value[token] = bid;
      assign[evicted] = -1;
      unassigned.push(evicted);
      // new price = lowest winning bid
      float mn2 = std::numeric_limits<float>::infinity();
      for (int t : h) mn2 = std::min(mn2, holder_value[t]);
      price[best] = mn2;
    }
  }

  // guard fallback: assign any stragglers to experts with spare capacity
  for (int i = 0; i < N; i++) {
    if (assign[i] >= 0) continue;
    for (int e = 0; e < E; e++) {
      if (static_cast<int>(holders[e].size()) < capacity) {
        holders[e].push_back(i);
        assign[i] = e;
        break;
      }
    }
  }
  std::memcpy(out, assign.data(), sizeof(int) * N);
}

}  // extern "C"
