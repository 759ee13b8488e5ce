// Native CTC prefix beam search + ARPA n-gram scorer (component C14).
//
// The reference era shelled out to Kaldi/OpenFst/KenLM (C++) for LM-fused
// decoding; this is the rebuild's in-process equivalent, exposed through a
// plain C ABI and bound from Python via ctypes (vistaocr_tpu/decode/native.py).
// The Python implementation in decode/beam.py + decode/lm.py is the
// correctness oracle; tests/test_native_beam.py holds the two equal.
//
// Also carries the native batch assembler used by the host pipeline: the
// per-line memcpy loop with the GIL released.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 beam.cpp -o _native.so

#include <algorithm>
#include <cassert>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kNegInf = -std::numeric_limits<double>::infinity();
constexpr double kLog10 = 2.302585092994046;

inline double logaddexp(double a, double b) {
  if (a == kNegInf) return b;
  if (b == kNegInf) return a;
  double m = a > b ? a : b;
  return m + std::log(std::exp(a - m) + std::exp(b - m));
}

// ---------------------------------------------------------------------------
// ARPA LM over token ids. Vocabulary: alphabet ids 1..K-1 plus specials.
// N-gram keys are byte-packed id sequences.
// ---------------------------------------------------------------------------
struct Entry {
  float logp;     // natural log
  float backoff;  // natural log
};

struct ArpaLM {
  int order = 0;
  int bos = -1, eos = -2, unk = -3;
  std::vector<std::unordered_map<std::string, Entry>> tables;

  static std::string key(const int* ids, int n) {
    return std::string(reinterpret_cast<const char*>(ids),
                       sizeof(int) * static_cast<size_t>(n));
  }

  const Entry* lookup(const int* ids, int n) const {
    if (n < 1 || n > order) return nullptr;
    const auto& t = tables[n - 1];
    auto it = t.find(key(ids, n));
    return it == t.end() ? nullptr : &it->second;
  }

  // log P(token | hist) with standard backoff; hist length <= order-1.
  double logp(const int* hist, int n, int token) const {
    std::vector<int> ng(hist, hist + n);
    ng.push_back(token);
    const Entry* e = lookup(ng.data(), n + 1);
    if (e) return e->logp;
    if (n == 0) {
      int u = unk;
      const Entry* ue = lookup(&u, 1);
      return ue ? ue->logp : -20.0;
    }
    const Entry* bo = lookup(hist, n);
    double backoff = bo ? bo->backoff : 0.0;
    return backoff + logp(hist + 1, n - 1, token);
  }
};

// Parse ARPA text. token_of maps an LM word string to an id (alphabet
// index, or bos/eos/unk specials); unknown LM words get fresh negative ids
// so their n-grams never match queries but stay well-formed.
ArpaLM* load_arpa(const char* path,
                  const std::unordered_map<std::string, int>& token_of) {
  std::ifstream f(path);
  if (!f) return nullptr;
  auto lm = new ArpaLM();
  std::string line;
  // \data\ header
  std::vector<int> counts;
  while (std::getline(f, line)) {
    if (line.find("\\data\\") != std::string::npos) break;
  }
  while (std::getline(f, line)) {
    if (line.empty()) break;
    if (line.rfind("ngram", 0) == 0) {
      auto eq = line.find('=');
      if (eq != std::string::npos) counts.push_back(std::stoi(line.substr(eq + 1)));
    }
  }
  lm->order = static_cast<int>(counts.size());
  if (lm->order == 0) { delete lm; return nullptr; }
  // lm_hist's fixed history buffer holds order-1 <= 15 tokens; silently
  // truncating higher orders would diverge from the Python oracle, so
  // refuse the load (the binding surfaces this as a load error).
  if (lm->order > 16) { delete lm; return nullptr; }
  lm->tables.resize(lm->order);

  std::unordered_map<std::string, int> extra;
  int next_extra = -10;
  auto id_of = [&](const std::string& w) -> int {
    if (w == "<s>") return lm->bos;
    if (w == "</s>") return lm->eos;
    if (w == "<unk>" || w == "<UNK>") return lm->unk;
    auto it = token_of.find(w);
    if (it != token_of.end()) return it->second;
    auto ex = extra.find(w);
    if (ex != extra.end()) return ex->second;
    extra[w] = --next_extra;
    return extra[w];
  };

  int cur_n = 0;
  while (std::getline(f, line)) {
    // trim
    while (!line.empty() && (line.back() == '\r' || line.back() == '\n'))
      line.pop_back();
    if (line.empty()) continue;
    if (line.find("\\end\\") != std::string::npos) break;
    if (line.size() > 7 && line[0] == '\\' &&
        line.find("-grams:") != std::string::npos) {
      cur_n = std::stoi(line.substr(1));
      continue;
    }
    if (cur_n == 0) continue;
    std::istringstream ss(line);
    double lp10;
    if (!(ss >> lp10)) continue;
    std::vector<int> ids;
    ids.reserve(cur_n);
    std::string w;
    for (int i = 0; i < cur_n; i++) {
      if (!(ss >> w)) break;
      ids.push_back(id_of(w));
    }
    if (static_cast<int>(ids.size()) != cur_n) continue;
    double bo10 = 0.0;
    ss >> bo10;  // optional backoff column
    Entry e;
    e.logp = static_cast<float>(lp10 * kLog10);
    e.backoff = static_cast<float>(bo10 * kLog10);
    lm->tables[cur_n - 1][ArpaLM::key(ids.data(), cur_n)] = e;
  }
  return lm;
}

// ---------------------------------------------------------------------------
// Prefix beam search (Hannun-style), mirroring decode/beam.py exactly.
//
// Prefixes live in a TRIE ARENA: a prefix's identity is a node id, an
// extension is a (node, token) child lookup, and the per-frame dedup maps
// key on the node id alone. The first version keyed hash maps on the full
// serialized prefix, which made every extension O(prefix length) in both
// copying and hashing — quadratic in T along the surviving beam
// (measured 34 ms/line at T=232, beam 16, topk 8; this arena form is
// ~10x cheaper). The LM history needs no per-beam storage either: it is
// the last (order-1) tokens of the prefix, read by walking parent links.
// ---------------------------------------------------------------------------
struct TrieNode {
  int parent;
  int tok;
  int depth;
};

struct BeamE {
  int node;
  double p_b = kNegInf;
  double p_nb = kNegInf;
  double lm_logp = 0.0;
  int lex = 0;       // lexicon trie node (dense-table constraint)
  int wlen = 0;      // chars since word start (unk-bypass penalties)
  int wprev = 0;     // last completed word id (n_words = <s>)
  double wbonus = 0.0;  // cumulative word-LM + unk-bypass bonus
  double total() const { return logaddexp(p_b, p_nb); }
};

// Optional lexicon / word-LM context for beam_search_one — the same
// dense tables the device search consumes (Lexicon.dense_tables,
// dense_word_logp_table), so all three engines share one semantics.
struct LexCtx {
  const int* lex_next = nullptr;       // [N, K], -1 = disallowed
  const uint8_t* lex_boundary = nullptr;  // [N]
  int K = 0;
  const float* word_table = nullptr;   // [Vw+1, Vw]
  const int* word_ids = nullptr;       // [N], -1 off word-final nodes
  int n_words = 0;
  int space_id = -1;
  double word_alpha = 0.0, word_beta = 0.0;
  // Character-bypass (<unk>) escape: when unk_logp != 0 the tables must
  // carry the appended unk row (Lexicon.dense_tables(unk=True)) whose
  // index is unk_node; word_unk_logp is the shared <unk>-completion
  // constant (decode/lm.word_unk_logp).
  double unk_logp = 0.0, word_unk_logp = 0.0;
  int unk_node = -1;
  bool lex() const { return lex_next != nullptr; }
  bool wlm() const { return word_table != nullptr; }
  bool unk() const { return lex() && unk_logp != 0.0; }
};

struct Hypo {
  std::vector<int> prefix;
  double score;
};

void beam_search_one(
    const float* logprobs, int T, int K,
    const int* topk_ids, const float* topk_vals, int topk,
    const ArpaLM* lm, double lm_alpha, double lm_beta,
    int beam_width, double prune_logp,
    std::vector<Hypo>& out, const LexCtx& lx = LexCtx()) {
  const bool use_lm = lm != nullptr && lm_alpha != 0.0;

  // Child keys pack (node id << 21 | token): tokens get 21 bits (checked
  // below) and node ids the remaining 43 — unreachable (node ids are
  // ints, < 2^31) but recorded so the invariant is explicit.
  assert(K < (1 << 21) && "alphabet too large for trie child-key packing");

  std::vector<TrieNode> nodes{{-1, -1, 0}};  // node 0 = empty prefix
  std::unordered_map<uint64_t, int> children;  // (node << 21 | tok) -> node
  children.reserve(4096);
  auto child_of = [&](int node, int tok) {
    uint64_t key = (static_cast<uint64_t>(node) << 21) |
                   static_cast<uint32_t>(tok);
    auto it = children.find(key);
    if (it != children.end()) return it->second;
    int id = static_cast<int>(nodes.size());
    nodes.push_back({node, tok, nodes[node].depth + 1});
    children.emplace(key, id);
    return id;
  };
  // LM history of a prefix: last (order-1) of ([bos] ++ prefix tokens) —
  // exactly the incremental lm_state the Python oracle carries.
  int hist[16];
  auto lm_hist = [&](int node, int* h) {
    int want = std::min(lm->order - 1, 15);  // hist buffer bound
    int n = 0;
    int cur = node;
    while (n < want && cur != 0) {
      h[want - 1 - n] = nodes[cur].tok;  // fill from the back
      cur = nodes[cur].parent;
      n++;
    }
    if (n < want && cur == 0) {
      h[want - 1 - n] = lm->bos;
      n++;
    }
    // shift left if underfull (prefix + bos shorter than window)
    int off = want - n;
    if (off) std::memmove(h, h + off, sizeof(int) * n);
    return n;
  };

  BeamE root;
  root.node = 0;
  root.p_b = 0.0;
  root.wprev = lx.n_words;  // <s> row of the word table
  std::vector<BeamE> beams{root};
  std::vector<BeamE> next;
  std::unordered_map<int, int> slot;  // node id -> index into next
  next.reserve(static_cast<size_t>(beam_width) * (topk + 1));
  slot.reserve(static_cast<size_t>(beam_width) * (topk + 1));

  // slot_of: the per-frame accumulator for a prefix. lm_logp is a pure
  // function of the prefix, so whichever source beam materializes the
  // slot first seeds the same value the oracle would.
  auto slot_of = [&](const BeamE& src) -> BeamE& {
    auto it = slot.find(src.node);
    if (it == slot.end()) {
      it = slot.emplace(src.node, static_cast<int>(next.size())).first;
      BeamE e;
      e.node = src.node;
      e.lm_logp = src.lm_logp;  // prefix-determined, like lex/word state
      e.lex = src.lex;
      e.wlen = src.wlen;
      e.wprev = src.wprev;
      e.wbonus = src.wbonus;
      next.push_back(e);
    }
    return next[it->second];
  };

  std::vector<int> order_idx;
  for (int t = 0; t < T; t++) {
    const float* lp = logprobs + static_cast<size_t>(t) * K;
    double p_blank = lp[0];
    double frame_best = p_blank;
    for (int j = 0; j < topk; j++)
      frame_best = std::max(frame_best,
                            static_cast<double>(topk_vals[t * topk + j]));

    next.clear();
    slot.clear();

    for (const BeamE& beam : beams) {
      double p_total = beam.total();

      // blank -> same prefix (never pruned)
      {
        BeamE& nb = slot_of(beam);
        nb.p_b = logaddexp(nb.p_b, p_total + p_blank);
      }

      for (int j = 0; j < topk; j++) {
        int c = topk_ids[t * topk + j];
        double p_c = topk_vals[t * topk + j];
        if (c == 0 || p_c < frame_best + prune_logp) continue;
        int last = beam.node == 0 ? -1 : nodes[beam.node].tok;
        double src_p;
        if (c == last) {
          // repeat without blank: same prefix via p_nb — never
          // lexicon-gated (the prefix does not grow)
          BeamE& nb = slot_of(beam);
          nb.p_nb = logaddexp(nb.p_nb, beam.p_nb + p_c);
          src_p = beam.p_b;  // blank-separated repeat extends
        } else {
          src_p = p_total;
        }
        if (src_p == kNegInf) continue;
        int lex_child = 0;
        double lex_pen = 0.0;
        bool unk_complete = false;
        if (lx.lex()) {
          lex_child = lx.lex_next[static_cast<size_t>(beam.lex) * lx.K + c];
          if (lx.unk()) {
            // union-FST character bypass, max-parse determinized — the
            // same rule the host oracle's lex_step and the device's
            // dense-table branch implement (string-exact triple parity)
            const bool from_unk = beam.lex == lx.unk_node;
            const bool is_space = c == lx.space_id;
            if (from_unk && !is_space) {
              lex_pen = lx.unk_logp;  // unk loop char
            } else if (lex_child < 0) {
              if (is_space) {  // mid-word space: fragment reparses as unk
                lex_child = 0;
                lex_pen = lx.unk_logp * beam.wlen;
                unk_complete = true;
              } else {  // fall off the trie: retroactive fragment charge
                lex_child = lx.unk_node;
                lex_pen = lx.unk_logp * (beam.wlen + 1);
              }
            } else if (from_unk && is_space) {
              unk_complete = true;  // table already routes to the root
            }
          } else if (lex_child < 0) {
            continue;  // extension leaves the lexicon (hard mode)
          }
        }
        int child = child_of(beam.node, c);
        auto it = slot.find(child);
        if (it == slot.end()) {
          double lm_lp = beam.lm_logp;
          if (use_lm) {
            int n = lm_hist(beam.node, hist);
            lm_lp += lm->logp(hist, n, c);
          }
          it = slot.emplace(child, static_cast<int>(next.size())).first;
          BeamE e;
          e.node = child;
          e.lm_logp = lm_lp;
          e.lex = lex_child;
          e.wlen = c == lx.space_id ? 0 : beam.wlen + 1;
          e.wprev = beam.wprev;
          e.wbonus = beam.wbonus + lex_pen;
          if (lx.wlm() && c == lx.space_id) {
            if (unk_complete) {
              // unk words are transparent to the word LM: the shared
              // <unk> constant, bigram context unmoved
              e.wbonus += lx.word_alpha * lx.word_unk_logp + lx.word_beta;
            } else {
              int wid = lx.word_ids[beam.lex];
              if (wid >= 0) {  // a space at a word-final node completes it
                e.wbonus += lx.word_alpha *
                    lx.word_table[static_cast<size_t>(beam.wprev) *
                                  lx.n_words + wid] +
                    lx.word_beta;
                e.wprev = wid;
              }
            }
          }
          next.push_back(e);
        }
        BeamE& nb2 = next[it->second];
        nb2.p_nb = logaddexp(nb2.p_nb, src_p + p_c);
      }
    }

    // prune to beam_width by fused score
    order_idx.resize(next.size());
    for (size_t i = 0; i < next.size(); i++) order_idx[i] = static_cast<int>(i);
    auto fused = [&](const BeamE& e) {
      double s = e.total() + e.wbonus;
      if (use_lm)
        s += lm_alpha * e.lm_logp +
             lm_beta * static_cast<double>(nodes[e.node].depth);
      return s;
    };
    int keep = std::min<int>(beam_width, static_cast<int>(next.size()));
    std::partial_sort(order_idx.begin(), order_idx.begin() + keep,
                      order_idx.end(), [&](int a, int b) {
                        return fused(next[a]) > fused(next[b]);
                      });
    beams.clear();
    for (int i = 0; i < keep; i++) beams.push_back(next[order_idx[i]]);
  }

  // lexicon finals: prefer beams ending at a word boundary (complete
  // words), falling back to everything when none does. With the unk
  // bypass every final is representable (mid-word fragments reparse as
  // penalized unk words below), so nothing is filtered.
  std::vector<const BeamE*> finals;
  if (lx.lex() && !lx.unk()) {
    for (const BeamE& e : beams)
      if (lx.lex_boundary[e.lex]) finals.push_back(&e);
  }
  if (finals.empty())
    for (const BeamE& e : beams) finals.push_back(&e);

  out.clear();
  for (const BeamE* ep : finals) {
    const BeamE& e = *ep;
    double s = e.total() + e.wbonus;
    if (use_lm)
      s += lm_alpha * e.lm_logp +
           lm_beta * static_cast<double>(nodes[e.node].depth);
    bool trailing_unk = false;
    if (lx.unk()) {
      trailing_unk = e.lex == lx.unk_node;
      if (!lx.lex_boundary[e.lex]) {
        s += lx.unk_logp * e.wlen;  // reparse the fragment as unk
        trailing_unk = true;
      }
    }
    if (lx.wlm()) {
      // trailing (un-spaced) word scores at finalization
      int wid = lx.lex() ? lx.word_ids[e.lex] : -1;
      if (trailing_unk)
        s += lx.word_alpha * lx.word_unk_logp + lx.word_beta;
      else if (wid >= 0)
        s += lx.word_alpha *
                 lx.word_table[static_cast<size_t>(e.wprev) * lx.n_words +
                               wid] +
             lx.word_beta;
    }
    std::vector<int> prefix(nodes[e.node].depth);
    for (int cur = e.node, i = nodes[e.node].depth - 1; cur != 0;
         cur = nodes[cur].parent, i--)
      prefix[i] = nodes[cur].tok;
    out.push_back({std::move(prefix), s});
  }
  std::sort(out.begin(), out.end(),
            [](const Hypo& a, const Hypo& b) { return a.score > b.score; });
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------
extern "C" {

// alphabet_tokens: K-1 uxxxx strings for ids 1..K-1 (id 0 = blank).
void* vo_lm_load(const char* arpa_path, const char** alphabet_tokens,
                 int n_tokens) {
  std::unordered_map<std::string, int> token_of;
  for (int i = 0; i < n_tokens; i++) token_of[alphabet_tokens[i]] = i + 1;
  return load_arpa(arpa_path, token_of);
}

void vo_lm_free(void* lm) { delete static_cast<ArpaLM*>(lm); }

int vo_lm_order(void* lm) { return static_cast<ArpaLM*>(lm)->order; }

double vo_lm_logp(void* lm, const int* hist, int n, int token) {
  auto* m = static_cast<ArpaLM*>(lm);
  // Only the last order-1 history tokens can matter; truncate defensively
  // so callers may pass a full prefix.
  int want = m->order - 1;
  if (n > want) { hist += n - want; n = want; }
  return m->logp(hist, n, token);
}

int vo_beam_decode_batch_lex(
    const float* logprobs, const int* frames, int B, int Tmax, int K,
    const int* topk_ids, const float* topk_vals, int topk,
    void* lm, double lm_alpha, double lm_beta,
    int beam_width, double prune_logp,
    const int* lex_next, const uint8_t* lex_boundary,
    const float* word_table, const int* word_ids, int n_words,
    int space_id, double word_alpha, double word_beta,
    double unk_logp, double word_unk_logp, int unk_node,
    int* out_ids, int max_out, int* out_lens, double* out_scores);

// Decode a batch. logprobs: [B, Tmax, K]; frames: [B] valid frame counts;
// topk_ids/vals: [B, Tmax, topk]; out_ids: [B, max_out]; out_lens: [B];
// out_scores: [B]. Returns 0 on success.
int vo_beam_decode_batch(
    const float* logprobs, const int* frames, int B, int Tmax, int K,
    const int* topk_ids, const float* topk_vals, int topk,
    void* lm, double lm_alpha, double lm_beta,
    int beam_width, double prune_logp,
    int* out_ids, int max_out, int* out_lens, double* out_scores) {
  return vo_beam_decode_batch_lex(
      logprobs, frames, B, Tmax, K, topk_ids, topk_vals, topk, lm,
      lm_alpha, lm_beta, beam_width, prune_logp,
      nullptr, nullptr, nullptr, nullptr, 0, -1, 0.0, 0.0, 0.0, 0.0, -1,
      out_ids, max_out, out_lens, out_scores);
}

// Constrained variant: lex_next [N, K] / lex_boundary [N] (nullptr = no
// lexicon); word_table [n_words+1, n_words] + word_ids [N] (nullptr =
// no word LM; needs the lexicon). Same dense tables the device uses.
// unk_logp != 0 enables the character-bypass escape (tables must carry
// the appended unk row at index unk_node; see Lexicon.dense_tables).
int vo_beam_decode_batch_lex(
    const float* logprobs, const int* frames, int B, int Tmax, int K,
    const int* topk_ids, const float* topk_vals, int topk,
    void* lm, double lm_alpha, double lm_beta,
    int beam_width, double prune_logp,
    const int* lex_next, const uint8_t* lex_boundary,
    const float* word_table, const int* word_ids, int n_words,
    int space_id, double word_alpha, double word_beta,
    double unk_logp, double word_unk_logp, int unk_node,
    int* out_ids, int max_out, int* out_lens, double* out_scores) {
  LexCtx lx;
  lx.lex_next = lex_next;
  lx.lex_boundary = lex_boundary;
  lx.K = K;
  lx.word_table = word_table;
  lx.word_ids = word_ids;
  lx.n_words = n_words;
  lx.space_id = space_id;
  lx.word_alpha = word_alpha;
  lx.word_beta = word_beta;
  lx.unk_logp = unk_logp;
  lx.word_unk_logp = word_unk_logp;
  lx.unk_node = unk_node;
  if (unk_logp != 0.0 && (lex_next == nullptr || unk_node < 0))
    return 3;  // unk bypass needs the unk-row dense tables
  if (lx.wlm() && !lx.lex()) return 2;  // word LM needs the lexicon
  std::vector<Hypo> hyps;
  for (int b = 0; b < B; b++) {
    int T = frames[b];
    if (T < 0 || T > Tmax) return 1;
    beam_search_one(
        logprobs + static_cast<size_t>(b) * Tmax * K, T, K,
        topk_ids + static_cast<size_t>(b) * Tmax * topk,
        topk_vals + static_cast<size_t>(b) * Tmax * topk, topk,
        static_cast<ArpaLM*>(lm), lm_alpha, lm_beta, beam_width, prune_logp,
        hyps, lx);
    int n = 0;
    double score = kNegInf;
    if (!hyps.empty()) {
      n = std::min<int>(max_out, static_cast<int>(hyps[0].prefix.size()));
      std::memcpy(out_ids + static_cast<size_t>(b) * max_out,
                  hyps[0].prefix.data(), sizeof(int) * n);
      score = hyps[0].score;
    }
    out_lens[b] = n;
    out_scores[b] = score;
  }
  return 0;
}

// Host pipeline batch assembly: copy n height-H lines (widths[i] columns,
// contiguous uint8 [H, widths[i]]) into out [n, H, Wb] (pre-filled by the
// caller). srcs are per-line base pointers. ctypes releases the GIL for
// the duration, so assembly overlaps the interpreter.
void vo_assemble(const uint8_t** srcs, const int* widths, int n,
                 uint8_t* out, int H, int Wb) {
  for (int i = 0; i < n; i++) {
    const uint8_t* src = srcs[i];
    int w = widths[i] < Wb ? widths[i] : Wb;
    uint8_t* dst = out + static_cast<size_t>(i) * H * Wb;
    for (int r = 0; r < H; r++) {
      std::memcpy(dst + static_cast<size_t>(r) * Wb,
                  src + static_cast<size_t>(r) * widths[i],
                  static_cast<size_t>(w));
    }
  }
}

}  // extern "C"
