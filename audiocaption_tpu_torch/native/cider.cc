// Fast CIDEr-D scorer (C++), used on the SCST reward hot path and by the
// per-epoch validation score.  A copy of the JAX package's scorer; the
// port builds and loads its own.
//
// The reference computes SCST rewards with the Python pycocoevalcap
// Cider scorer once per training step (model_util.py:117-164); during
// RL training that host-side loop competes with the device step.  This
// implementation scores tokenized (int id) sentences with hashed n-gram
// maps; semantics match metrics/cider.py (CIDEr-D: candidate-clipped
// TF-IDF cosine per n, gaussian length penalty, x10).
//
// C ABI (ctypes): sentences are flattened int32 token arrays with
// offset tables. Reference corpora define the document frequencies.
//
// Built at first use by ``native/__init__.py`` (g++ -O3 -shared -fPIC
// -std=c++17) into build/native/ at the repository root.

#include <cmath>
#include <cstdint>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kMaxN = 4;

using NgramKey = uint64_t;

// FNV-1a over the n token ids + the n value (to separate orders).
inline NgramKey hash_ngram(const int32_t* toks, int n) {
  uint64_t h = 1469598103934665603ull ^ static_cast<uint64_t>(n);
  for (int i = 0; i < n; ++i) {
    h ^= static_cast<uint64_t>(static_cast<uint32_t>(toks[i]));
    h *= 1099511628211ull;
    h ^= h >> 29;  // extra mixing: ids are small ints
    h *= 1099511628211ull;
  }
  return h;
}

struct SentVec {
  std::unordered_map<NgramKey, double> vec[kMaxN];  // tf*idf weights
  double norm[kMaxN] = {0, 0, 0, 0};
  int length = 0;
};

void count_ngrams(const int32_t* toks, int len,
                  std::unordered_map<NgramKey, int> (&counts)[kMaxN]) {
  for (int n = 1; n <= kMaxN; ++n) {
    for (int i = 0; i + n <= len; ++i) {
      counts[n - 1][hash_ngram(toks + i, n)] += 1;
    }
  }
}

}  // namespace

extern "C" {

// hyp_tokens/hyp_off: n_docs+1 offsets into hyp_tokens (one hypothesis
// per doc). ref_tokens/ref_off: flattened references; ref_doc_off maps
// doc -> [start, end) range in the reference offset table.
// out: n_docs CIDEr-D scores.
void cider_d_score(const int32_t* hyp_tokens, const int64_t* hyp_off,
                   const int32_t* ref_tokens, const int64_t* ref_off,
                   const int64_t* ref_doc_off, int64_t n_docs,
                   double sigma, double* out) {
  // ---- document frequencies from the references
  std::unordered_map<NgramKey, double> doc_freq[kMaxN];
  for (int64_t d = 0; d < n_docs; ++d) {
    std::unordered_map<NgramKey, int> seen[kMaxN];
    for (int64_t r = ref_doc_off[d]; r < ref_doc_off[d + 1]; ++r) {
      const int32_t* toks = ref_tokens + ref_off[r];
      int len = static_cast<int>(ref_off[r + 1] - ref_off[r]);
      count_ngrams(toks, len, seen);
    }
    for (int n = 0; n < kMaxN; ++n) {
      for (auto& kv : seen[n]) doc_freq[n][kv.first] += 1.0;
    }
  }
  const double log_ref_len = std::log(static_cast<double>(n_docs));

  auto make_vec = [&](const int32_t* toks, int len, SentVec& sv) {
    std::unordered_map<NgramKey, int> counts[kMaxN];
    count_ngrams(toks, len, counts);
    sv.length = len;
    for (int n = 0; n < kMaxN; ++n) {
      double norm = 0.0;
      for (auto& kv : counts[n]) {
        auto it = doc_freq[n].find(kv.first);
        double df = (it == doc_freq[n].end()) ? 0.0 : it->second;
        double idf = log_ref_len - std::log(std::max(1.0, df));
        double w = kv.second * idf;
        sv.vec[n][kv.first] = w;
        norm += w * w;
      }
      sv.norm[n] = std::sqrt(norm);
    }
  };

  for (int64_t d = 0; d < n_docs; ++d) {
    SentVec hyp;
    make_vec(hyp_tokens + hyp_off[d],
             static_cast<int>(hyp_off[d + 1] - hyp_off[d]), hyp);
    double score[kMaxN] = {0, 0, 0, 0};
    int64_t n_refs = ref_doc_off[d + 1] - ref_doc_off[d];
    for (int64_t r = ref_doc_off[d]; r < ref_doc_off[d + 1]; ++r) {
      SentVec ref;
      make_vec(ref_tokens + ref_off[r],
               static_cast<int>(ref_off[r + 1] - ref_off[r]), ref);
      double delta = static_cast<double>(hyp.length - ref.length);
      double penalty = std::exp(-(delta * delta) / (2.0 * sigma * sigma));
      for (int n = 0; n < kMaxN; ++n) {
        double s = 0.0;
        for (auto& kv : hyp.vec[n]) {
          auto it = ref.vec[n].find(kv.first);
          if (it != ref.vec[n].end()) {
            s += std::min(kv.second, it->second) * it->second;
          }
        }
        if (hyp.norm[n] != 0.0 && ref.norm[n] != 0.0) {
          s /= hyp.norm[n] * ref.norm[n];
        }
        score[n] += s * penalty;
      }
    }
    double avg = 0.0;
    for (int n = 0; n < kMaxN; ++n) avg += score[n] / n_refs;
    out[d] = avg / kMaxN * 10.0;
  }
}

}  // extern "C"
