// The port's copy of qasr_tpu/native/ctc_beam_search.cpp, built by
// qasr_tpu_torch/decode/beam_search.py into qasr_tpu_torch/native/build/.
//
// CTC prefix beam search with optional ARPA n-gram LM rescoring.
//
// Native replacement for the reference's external `ctc_decoders` C++/SWIG
// package (OpenSeq2Seq branch; built by scripts/install_ctc_decoders.sh and
// wrapped at nemo/collections/asr/modules/beam_search_decoder.py:60-104).
// Differences: the LM is a self-contained ARPA reader (no KenLM link);
// batching is parallelized with std::thread; the ABI is plain C for ctypes.
//
// Algorithm: prefix beam search (Hannun et al. 2014) in log space with
// per-step top-n/cutoff-prob pruning; word-level LM scoring applied when a
// space closes a word, final partial word scored at the end; ranking score
//   log P_ctc(prefix) + alpha * log10 P_lm(words) + beta * |words|
// matching the ctc_decoders scoring convention.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC ctc_beam_search.cpp -o libctc_beam.so -pthread

#include <atomic>
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <fstream>
#include <limits>
#include <memory>
#include <sstream>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kNegInf = -std::numeric_limits<double>::infinity();

inline double log_sum_exp(double a, double b) {
  if (a == kNegInf) return b;
  if (b == kNegInf) return a;
  double m = a > b ? a : b;
  return m + std::log1p(std::exp(-(a > b ? a - b : b - a)));
}

// ---------------------------------------------------------------------------
// n-gram language models (word level).  Two storage backends share the
// backoff recursion through LmBase::Find:
//   * ArpaLM — text ARPA parsed into an unordered_map (small/dev LMs);
//   * QlmLM  — ".qlm" binary: an open-addressing hash table of 64-bit
//     n-gram fingerprints mmap'd straight from disk (the KenLM "probing"
//     design, lm/model.hh upstream).  O(1) load for multi-GB production
//     LMs; convert once with qasr_lm_convert.
// The reference wraps KenLM via the ctc_decoders package
// (beam_search_decoder.py:60-104); .qlm fills that role natively.
// ---------------------------------------------------------------------------

inline uint64_t fnv1a64(const std::string& s) {
  uint64_t h = 1469598103934665603ull;
  for (unsigned char c : s) {
    h ^= c;
    h *= 1099511628211ull;
  }
  return h ? h : 1;  // 0 marks an empty slot
}

struct LmBase {
  int order = 0;
  float unk_logp = -10.0f;
  virtual ~LmBase() = default;
  // key is the space-joined n-gram; returns (log10 prob, log10 backoff)
  virtual bool Find(const std::string& key, float* logp, float* bo) const = 0;

  // log10 P(word | context words), standard backoff recursion.
  float Score(const std::vector<std::string>& context,
              const std::string& word) const {
    int max_ctx = std::min<int>(order - 1, (int)context.size());
    for (int n = max_ctx; n >= 0; --n) {
      std::string key;
      for (int i = (int)context.size() - n; i < (int)context.size(); ++i) {
        key += context[i];
        key += ' ';
      }
      key += word;
      float logp, bo_hit;
      if (Find(key, &logp, &bo_hit)) {
        float bo = 0.0f;
        // accumulated backoff of the skipped longer contexts
        for (int m = max_ctx; m > n; --m) {
          std::string bkey;
          for (int i = (int)context.size() - m; i < (int)context.size(); ++i) {
            if (!bkey.empty()) bkey += ' ';
            bkey += context[i];
          }
          float p2, b2;
          if (Find(bkey, &p2, &b2)) bo += b2;
        }
        return logp + bo;
      }
    }
    return unk_logp;
  }
};

struct ArpaLM : LmBase {
  // key: space-joined n-gram; value: (log10 prob, log10 backoff)
  std::unordered_map<std::string, std::pair<float, float>> table;

  bool Find(const std::string& key, float* logp, float* bo) const override {
    auto it = table.find(key);
    if (it == table.end()) return false;
    *logp = it->second.first;
    *bo = it->second.second;
    return true;
  }

  static std::unique_ptr<ArpaLM> Load(const char* path) {
    std::ifstream f(path);
    if (!f.is_open()) return nullptr;
    auto lm = std::make_unique<ArpaLM>();
    std::string line;
    int cur_order = 0;
    bool in_grams = false;
    while (std::getline(f, line)) {
      // strip trailing \r
      while (!line.empty() && (line.back() == '\r' || line.back() == '\n'))
        line.pop_back();
      if (line.empty()) continue;
      if (line[0] == '\\') {
        if (line == "\\end\\") break;
        size_t g = line.find("-grams:");
        if (g != std::string::npos) {
          cur_order = std::atoi(line.substr(1, g - 1).c_str());
          lm->order = std::max(lm->order, cur_order);
          in_grams = true;
        } else {
          in_grams = false;
        }
        continue;
      }
      if (!in_grams || cur_order == 0) continue;
      // "logp<TAB>w1 w2 ... wN[<TAB>backoff]"
      std::istringstream ss(line);
      float logp;
      if (!(ss >> logp)) continue;
      std::string words, w;
      for (int i = 0; i < cur_order; ++i) {
        if (!(ss >> w)) { words.clear(); break; }
        if (i) words += ' ';
        words += w;
      }
      if (words.empty()) continue;
      float backoff = 0.0f;
      ss >> backoff;  // absent -> stays 0
      lm->table.emplace(std::move(words), std::make_pair(logp, backoff));
      if (cur_order == 1 && line.find("<unk>") != std::string::npos)
        lm->unk_logp = logp;
    }
    return lm;
  }
};

// ---------------------------------------------------------------------------
// QLM binary: header + open-addressing slot array, mmap'd read-only.
// ---------------------------------------------------------------------------

struct QlmHeader {
  char magic[4];      // "QLM1"
  uint32_t order;
  uint64_t table_size;  // slots, power of two
  float unk_logp;
  uint32_t pad;
};

struct QlmSlot {
  uint64_t key;  // fnv1a64 of the space-joined n-gram; 0 = empty
  float logp;
  float backoff;
};

struct QlmLM : LmBase {
  void* map = MAP_FAILED;
  size_t map_len = 0;
  const QlmSlot* slots = nullptr;
  uint64_t mask = 0;

  ~QlmLM() override {
    if (map != MAP_FAILED) munmap(map, map_len);
  }

  bool Find(const std::string& key, float* logp, float* bo) const override {
    uint64_t h = fnv1a64(key);
    // probe bound: the writer keeps load factor <= 0.7, but a corrupt file
    // could be fully populated — never loop past one full table sweep
    for (uint64_t n = 0, i = h & mask; n <= mask; ++n, i = (i + 1) & mask) {
      const QlmSlot& s = slots[i];
      if (s.key == 0) return false;
      if (s.key == h) {
        *logp = s.logp;
        *bo = s.backoff;
        return true;
      }
    }
    return false;
  }

  static std::unique_ptr<QlmLM> Load(const char* path) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0 || (size_t)st.st_size < sizeof(QlmHeader)) {
      close(fd);
      return nullptr;
    }
    void* m = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
    close(fd);
    if (m == MAP_FAILED) return nullptr;
    const QlmHeader* h = reinterpret_cast<const QlmHeader*>(m);
    bool pow2 = h->table_size != 0 &&
                (h->table_size & (h->table_size - 1)) == 0;
    if (std::memcmp(h->magic, "QLM1", 4) != 0 || !pow2 ||
        h->table_size > (1ull << 40) ||
        (size_t)st.st_size <
            sizeof(QlmHeader) + h->table_size * sizeof(QlmSlot)) {
      munmap(m, st.st_size);
      return nullptr;
    }
    auto lm = std::make_unique<QlmLM>();
    lm->map = m;
    lm->map_len = st.st_size;
    lm->order = (int)h->order;
    lm->unk_logp = h->unk_logp;
    lm->slots = reinterpret_cast<const QlmSlot*>(
        reinterpret_cast<const char*>(m) + sizeof(QlmHeader));
    lm->mask = h->table_size - 1;
    return lm;
  }
};

bool WriteQlm(const ArpaLM& lm, const char* out_path) {
  uint64_t n = lm.table.size();
  uint64_t size = 64;
  while (size * 7 < n * 10) size <<= 1;  // load factor <= 0.7
  std::vector<QlmSlot> slots(size);
  uint64_t mask = size - 1;
  for (const auto& kv : lm.table) {
    uint64_t h = fnv1a64(kv.first);
    uint64_t i = h & mask;
    while (slots[i].key != 0 && slots[i].key != h) i = (i + 1) & mask;
    slots[i] = {h, kv.second.first, kv.second.second};
  }
  std::ofstream f(out_path, std::ios::binary);
  if (!f.is_open()) return false;
  QlmHeader h{};
  std::memcpy(h.magic, "QLM1", 4);
  h.order = (uint32_t)lm.order;
  h.table_size = size;
  h.unk_logp = lm.unk_logp;
  f.write(reinterpret_cast<const char*>(&h), sizeof(h));
  f.write(reinterpret_cast<const char*>(slots.data()),
          (std::streamsize)(slots.size() * sizeof(QlmSlot)));
  return f.good();
}

// ---------------------------------------------------------------------------
// Prefix beam search
// ---------------------------------------------------------------------------

struct Prefix {
  std::vector<int> ids;        // label ids (no blanks, collapsed)
  double p_b = kNegInf;        // log prob ending in blank
  double p_nb = kNegInf;       // log prob ending in non-blank
  double lm_logp = 0.0;        // accumulated log10 LM prob of closed words
  int word_count = 0;

  double p_total() const { return log_sum_exp(p_b, p_nb); }
};

struct PrefixKey {
  size_t operator()(const std::vector<int>& v) const {
    size_t h = 1469598103934665603ull;
    for (int x : v) {
      h ^= (size_t)(x + 0x9e3779b9);
      h *= 1099511628211ull;
    }
    return h;
  }
};

std::string ids_to_text(const std::vector<int>& ids,
                        const std::vector<std::string>& vocab) {
  std::string out;
  for (int id : ids) out += vocab[id];
  return out;
}

std::vector<std::string> last_words(const std::string& text, int max_words) {
  std::vector<std::string> words;
  std::istringstream ss(text);
  std::string w;
  while (ss >> w) words.push_back(w);
  if ((int)words.size() > max_words)
    words.erase(words.begin(), words.end() - max_words);
  return words;
}

using BeamMap = std::unordered_map<std::vector<int>, Prefix, PrefixKey>;

struct BeamParams {
  int V = 0;                 // vocab size incl. blank
  int blank = 0;
  int space_id = -1;
  int beam_width = 0;
  int cutoff_top_n = 0;
  float alpha = 0.0f;
  float beta = 0.0f;
  float cutoff_prob = 1.0f;
  const LmBase* lm = nullptr;
};

BeamMap beam_init() {
  BeamMap beams;
  Prefix root;
  root.p_b = 0.0;
  beams.emplace(std::vector<int>{}, root);
  return beams;
}

// One CTC prefix-beam-search time step: extend + merge + prune.  The beam
// map is the complete decode state, so the search is resumable frame by
// frame (the streaming API below feeds chunks through this same step).
void beam_step(const BeamParams& bp, const std::vector<std::string>& vocab,
               BeamMap& beams, const float* row, std::vector<int>& idx) {
  // per-step pruning: top-n symbols and cumulative cutoff_prob
  for (int v = 0; v < bp.V; ++v) idx[v] = v;
  int keep = std::min(bp.cutoff_top_n > 0 ? bp.cutoff_top_n : bp.V, bp.V);
  std::partial_sort(idx.begin(), idx.begin() + keep, idx.end(),
                    [&](int a, int b) { return row[a] > row[b]; });
  if (bp.cutoff_prob < 1.0f) {
    double cum = 0.0;
    int k = 0;
    for (; k < keep; ++k) {
      cum += std::exp((double)row[idx[k]]);
      if (cum >= bp.cutoff_prob) { ++k; break; }
    }
    keep = std::max(1, k);
  }

  BeamMap next;
  next.reserve(beams.size() * (keep + 1));
  for (auto& kv : beams) {
    const std::vector<int>& ids = kv.first;
    const Prefix& pre = kv.second;
    int last = ids.empty() ? -1 : ids.back();
    for (int k = 0; k < keep; ++k) {
      int s = idx[k];
      double p = row[s];
      if (s == bp.blank) {
        Prefix& nx = next.try_emplace(ids, Prefix{}).first->second;
        if (nx.ids.empty() && !ids.empty()) nx.ids = ids;
        nx.lm_logp = pre.lm_logp;
        nx.word_count = pre.word_count;
        nx.p_b = log_sum_exp(nx.p_b, pre.p_total() + p);
        continue;
      }
      // extend with repeated last symbol: stays same prefix (non-blank path)
      if (s == last) {
        Prefix& same = next.try_emplace(ids, Prefix{}).first->second;
        if (same.ids.empty() && !ids.empty()) same.ids = ids;
        same.lm_logp = pre.lm_logp;
        same.word_count = pre.word_count;
        same.p_nb = log_sum_exp(same.p_nb, pre.p_nb + p);
      }
      // new extended prefix
      std::vector<int> nids = ids;
      nids.push_back(s);
      Prefix& ext = next.try_emplace(std::move(nids), Prefix{}).first->second;
      if (ext.ids.empty()) {
        ext.ids = ids;
        ext.ids.push_back(s);
      }
      double base = (s == last) ? pre.p_b : pre.p_total();
      double add = base + p;
      if (ext.p_nb == kNegInf) {
        ext.lm_logp = pre.lm_logp;
        ext.word_count = pre.word_count;
        if (bp.lm && s == bp.space_id) {
          // a space closes the current word: score it
          std::string text = ids_to_text(ids, vocab);
          size_t ws = text.find_last_of(' ');
          std::string word =
              ws == std::string::npos ? text : text.substr(ws + 1);
          if (!word.empty()) {
            std::string ctx_text = ws == std::string::npos
                                       ? std::string()
                                       : text.substr(0, ws);
            auto ctx = last_words(ctx_text, bp.lm->order - 1);
            ext.lm_logp = pre.lm_logp + bp.lm->Score(ctx, word);
            ext.word_count = pre.word_count + 1;
          }
        }
      }
      ext.p_nb = log_sum_exp(ext.p_nb, add);
    }
  }
  // prune to beam_width by score
  std::vector<std::pair<double, const std::vector<int>*>> ranked;
  ranked.reserve(next.size());
  for (auto& kv : next) {
    double score = kv.second.p_total() + bp.alpha * kv.second.lm_logp +
                   bp.beta * kv.second.word_count;
    ranked.emplace_back(score, &kv.first);
  }
  int bw = std::min<int>(bp.beam_width, (int)ranked.size());
  std::partial_sort(ranked.begin(), ranked.begin() + bw, ranked.end(),
                    [](auto& a, auto& b) { return a.first > b.first; });
  BeamMap pruned;
  pruned.reserve(bw);
  for (int i = 0; i < bw; ++i)
    pruned.emplace(*ranked[i].second, next[*ranked[i].second]);
  beams.swap(pruned);
}

// Rank the current beams (scoring the trailing partial word) — used both
// for the final result and for a streaming decoder's running best.
void finalize_beams(const BeamParams& bp,
                    const std::vector<std::string>& vocab,
                    const BeamMap& beams, int n_best,
                    std::vector<std::pair<double, std::string>>* out) {
  std::vector<std::pair<double, std::string>> finals;
  finals.reserve(beams.size());
  for (auto& kv : beams) {
    const Prefix& p = kv.second;
    std::string text = ids_to_text(kv.first, vocab);
    double lm_logp = p.lm_logp;
    int wc = p.word_count;
    if (bp.lm) {
      size_t ws = text.find_last_of(' ');
      std::string word = ws == std::string::npos ? text : text.substr(ws + 1);
      if (!word.empty()) {
        auto ctx = last_words(
            ws == std::string::npos ? std::string() : text.substr(0, ws),
            bp.lm->order - 1);
        lm_logp += bp.lm->Score(ctx, word);
        wc += 1;
      }
    }
    double score = p.p_total() + bp.alpha * lm_logp + bp.beta * wc;
    finals.emplace_back(score, std::move(text));
  }
  std::sort(finals.begin(), finals.end(),
            [](auto& a, auto& b) { return a.first > b.first; });
  if ((int)finals.size() > n_best) finals.resize(n_best);
  *out = std::move(finals);
}

void decode_one(const float* lp, int T, int V /*incl blank*/, int blank,
                const std::vector<std::string>& vocab, int space_id,
                int beam_width, float alpha, float beta, float cutoff_prob,
                int cutoff_top_n, const LmBase* lm, int n_best,
                std::vector<std::pair<double, std::string>>* out) {
  BeamParams bp;
  bp.V = V;
  bp.blank = blank;
  bp.space_id = space_id;
  bp.beam_width = beam_width;
  bp.cutoff_top_n = cutoff_top_n;
  bp.alpha = alpha;
  bp.beta = beta;
  bp.cutoff_prob = cutoff_prob;
  bp.lm = lm;
  BeamMap beams = beam_init();
  std::vector<int> idx(V);
  for (int t = 0; t < T; ++t)
    beam_step(bp, vocab, beams, lp + (size_t)t * V, idx);
  finalize_beams(bp, vocab, beams, n_best, out);
}

// '\x1f'-separated utf-8 symbols (V-1 of them; blank is last id).
std::vector<std::string> parse_vocab(const char* vocab_blob) {
  std::vector<std::string> vocab;
  std::string blob(vocab_blob);
  size_t start = 0;
  while (start <= blob.size()) {
    size_t end = blob.find('\x1f', start);
    if (end == std::string::npos) {
      vocab.push_back(blob.substr(start));
      break;
    }
    vocab.push_back(blob.substr(start, end - start));
    start = end + 1;
  }
  return vocab;
}

// Streaming decoder: the beam map persists across feed() calls, so chunked
// decoding is exactly equivalent to offline decoding of the concatenated
// frames (the chunked encoder emits bit-equal log-probs — decode/streaming).
struct BeamStream {
  BeamParams bp;
  std::vector<std::string> vocab;
  BeamMap beams;
  std::vector<int> idx;
};

}  // namespace

extern "C" {

// Auto-detects the format: "QLM1" magic -> mmap'd binary, else text ARPA.
void* qasr_lm_load(const char* path) {
  {
    std::ifstream probe(path, std::ios::binary);
    char magic[4] = {0};
    if (probe.read(magic, 4) && std::memcmp(magic, "QLM1", 4) == 0) {
      auto qlm = QlmLM::Load(path);
      return qlm ? static_cast<LmBase*>(qlm.release()) : nullptr;
    }
  }
  auto lm = ArpaLM::Load(path);
  return lm ? static_cast<LmBase*>(lm.release()) : nullptr;
}

void qasr_lm_free(void* lm) { delete reinterpret_cast<LmBase*>(lm); }

int qasr_lm_order(void* lm) {
  return lm ? reinterpret_cast<LmBase*>(lm)->order : 0;
}

// Convert a text ARPA to the mmap'd ".qlm" binary.  Returns 0 on success.
int qasr_lm_convert(const char* arpa_path, const char* out_path) {
  auto lm = ArpaLM::Load(arpa_path);
  if (!lm) return -1;
  return WriteQlm(*lm, out_path) ? 0 : -2;
}

// log_probs: (B, T, V) float32 row-major; lengths: (B,) int32.
// vocab_blob: '\x1f'-separated utf-8 symbols (V-1 of them; blank is last id).
// out_texts: (B * n_best * max_text) char buffer; out_scores: (B * n_best).
// Returns 0 on success.
int qasr_beam_search_batch(const float* log_probs, const int32_t* lengths,
                           int B, int T, int V, const char* vocab_blob,
                           int beam_width, float alpha, float beta,
                           float cutoff_prob, int cutoff_top_n, void* lm_ptr,
                           int n_best, int max_text, char* out_texts,
                           double* out_scores, int num_threads) {
  std::vector<std::string> vocab = parse_vocab(vocab_blob);
  if ((int)vocab.size() != V - 1) return -1;
  int blank = V - 1;
  int space_id = -1;
  for (int i = 0; i < (int)vocab.size(); ++i)
    if (vocab[i] == " ") space_id = i;
  const LmBase* lm = reinterpret_cast<LmBase*>(lm_ptr);

  std::memset(out_texts, 0, (size_t)B * n_best * max_text);
  for (int i = 0; i < B * n_best; ++i) out_scores[i] = kNegInf;

  auto work = [&](int b) {
    std::vector<std::pair<double, std::string>> out;
    int t_len = std::min(lengths[b], T);
    decode_one(log_probs + (size_t)b * T * V, t_len, V, blank, vocab, space_id,
               beam_width, alpha, beta, cutoff_prob, cutoff_top_n, lm, n_best,
               &out);
    for (int i = 0; i < (int)out.size(); ++i) {
      out_scores[(size_t)b * n_best + i] = out[i].first;
      std::strncpy(out_texts + ((size_t)b * n_best + i) * max_text,
                   out[i].second.c_str(), max_text - 1);
    }
  };

  // dynamic work-stealing: utterance lengths vary, so a static stride
  // assignment load-imbalances the pool (the longest utterances can land
  // on one thread); an atomic counter keeps every thread busy to the end
  int nt = std::max(1, std::min(num_threads, B));
  std::atomic<int> next(0);
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&]() {
      int b;
      while ((b = next.fetch_add(1)) < B) work(b);
    });
  }
  for (auto& th : threads) th.join();
  return 0;
}

// ---------------------------------------------------------------------------
// Batched streaming: advance S independent streams by one chunk each with a
// shared thread pool — the serving shape (many concurrent live sessions,
// one device batch of log-probs per tick).  Each stream's result is
// bit-identical to feeding it alone.
// ---------------------------------------------------------------------------

int qasr_beam_stream_feed_batch(void** streams, const float* log_probs,
                                const int32_t* t_lens, int S, int T_stride,
                                int V, int num_threads) {
  std::atomic<int> next(0);
  std::atomic<int> bad(0);
  int nt = std::max(1, std::min(num_threads, S));
  std::vector<std::thread> threads;
  for (int t = 0; t < nt; ++t) {
    threads.emplace_back([&]() {
      int s;
      while ((s = next.fetch_add(1)) < S) {
        auto* bs = reinterpret_cast<BeamStream*>(streams[s]);
        if (!bs || bs->bp.V != V) {
          bad.store(1);
          continue;
        }
        const float* lp = log_probs + (size_t)s * T_stride * V;
        int T = std::min(t_lens[s], T_stride);
        for (int ft = 0; ft < T; ++ft)
          beam_step(bs->bp, bs->vocab, bs->beams, lp + (size_t)ft * V,
                    bs->idx);
      }
    });
  }
  for (auto& th : threads) th.join();
  return bad.load() ? -1 : 0;
}

// ---------------------------------------------------------------------------
// Streaming (resumable) decoder: create once, feed log-prob chunks, read the
// running best at any point.  Bit-equivalent to qasr_beam_search_batch on
// the concatenated frames.
// ---------------------------------------------------------------------------

// vocab_blob as in qasr_beam_search_batch; returns an opaque stream handle
// (nullptr on bad vocab).  The LM handle, if any, must outlive the stream.
void* qasr_beam_stream_create(int V, const char* vocab_blob, int beam_width,
                              float alpha, float beta, float cutoff_prob,
                              int cutoff_top_n, void* lm_ptr) {
  auto* s = new BeamStream();
  s->vocab = parse_vocab(vocab_blob);
  if ((int)s->vocab.size() != V - 1) {
    delete s;
    return nullptr;
  }
  s->bp.V = V;
  s->bp.blank = V - 1;
  s->bp.space_id = -1;
  for (int i = 0; i < (int)s->vocab.size(); ++i)
    if (s->vocab[i] == " ") s->bp.space_id = i;
  s->bp.beam_width = beam_width;
  s->bp.cutoff_top_n = cutoff_top_n;
  s->bp.alpha = alpha;
  s->bp.beta = beta;
  s->bp.cutoff_prob = cutoff_prob;
  s->bp.lm = reinterpret_cast<LmBase*>(lm_ptr);
  s->beams = beam_init();
  s->idx.resize(V);
  return s;
}

// Advance the search by T frames of (T, V) float32 log-probs.
int qasr_beam_stream_feed(void* stream, const float* log_probs, int T) {
  auto* s = reinterpret_cast<BeamStream*>(stream);
  if (!s) return -1;
  for (int t = 0; t < T; ++t)
    beam_step(s->bp, s->vocab, s->beams, log_probs + (size_t)t * s->bp.V,
              s->idx);
  return 0;
}

// Non-destructive n-best of the current state (trailing word LM-scored);
// the stream can keep consuming frames afterwards.  Buffers as in
// qasr_beam_search_batch.  Returns the number of hypotheses written.
int qasr_beam_stream_best(void* stream, int n_best, int max_text,
                          char* out_texts, double* out_scores) {
  auto* s = reinterpret_cast<BeamStream*>(stream);
  if (!s) return -1;
  std::vector<std::pair<double, std::string>> out;
  finalize_beams(s->bp, s->vocab, s->beams, n_best, &out);
  std::memset(out_texts, 0, (size_t)n_best * max_text);
  for (int i = 0; i < n_best; ++i) out_scores[i] = kNegInf;
  for (int i = 0; i < (int)out.size(); ++i) {
    out_scores[i] = out[i].first;
    std::strncpy(out_texts + (size_t)i * max_text, out[i].second.c_str(),
                 max_text - 1);
  }
  return (int)out.size();
}

// Reset to the empty-prefix state (reuse across utterances).
void qasr_beam_stream_reset(void* stream) {
  auto* s = reinterpret_cast<BeamStream*>(stream);
  if (s) s->beams = beam_init();
}

void qasr_beam_stream_free(void* stream) {
  delete reinterpret_cast<BeamStream*>(stream);
}

}  // extern "C"
