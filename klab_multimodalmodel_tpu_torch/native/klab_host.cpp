// klab_host — the port's native host runtime: its own copy of the JAX
// package's C++ host runtime, extended as noted below.
//
//   * multithreaded uint8 image resize (bilinear + bicubic, matching
//     Pillow's convolution-based resampling semantics) feeding the on-device
//     normalize; byte for byte the JAX package's code, so both give the same
//     pixels;
//   * a unigram (SentencePiece-style) Viterbi tokenizer core with the HF-T5
//     chain: precompiled-charsmap normalization (darts-clone trie), optional
//     left/right strip, optional multi-space collapse, optional whitespace
//     split, metaspace pre-tokenization with per-pre-token Viterbi, raw-text
//     special-token extraction, per-codepoint unk with fuse_unk — batch
//     encode with fixed-shape padding directly into caller buffers.
//
// What the port adds to the tokenizer core: the chain's optional steps are
// switches (klab_tok_set_chain), so a tokenizer.json is encoded as its own
// normalizer and pre-tokenizer say, not always as the spiece.model chain;
// scores and path sums are doubles, as HF tokenizers' Unigram keeps them, so
// near-tied paths resolve as there; klab_tok_encode encodes one string of a
// given length; klab_tok_encode_batch takes each text's length (a NUL is a
// character) and starts threads only for a batch with text enough to pay
// for them.
//
// Exposed with a plain C ABI for ctypes. Built at first use by
// klab_multimodalmodel_tpu_torch/native/__init__.py with
// g++ -O3 -march=native -std=c++20 -fPIC -shared -pthread.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Image resize (Pillow-compatible convolution resampling)
// ---------------------------------------------------------------------------

namespace {

struct FilterSpec {
  double support;
  double (*fn)(double);
};

double bilinear_filter(double x) {
  x = std::abs(x);
  return x < 1.0 ? 1.0 - x : 0.0;
}

// Keys-cubic with a = -0.5 (Pillow's BICUBIC).
double bicubic_filter(double x) {
  constexpr double a = -0.5;
  x = std::abs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

// Precomputed 1-D resampling plan (Pillow's precompute_coeffs).
struct Plan {
  std::vector<int> bounds_lo;  // first source index per output pixel
  std::vector<int> counts;     // taps per output pixel
  std::vector<double> coeffs;  // flattened [out][tap]
  int ksize;
};

Plan make_plan(int in_size, int out_size, const FilterSpec& f) {
  Plan p;
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = f.support * filterscale;
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  p.ksize = ksize;
  p.bounds_lo.resize(out_size);
  p.counts.resize(out_size);
  p.coeffs.assign(static_cast<size_t>(out_size) * ksize, 0.0);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    int lo = static_cast<int>(center - support + 0.5);
    if (lo < 0) lo = 0;
    int hi = static_cast<int>(center + support + 0.5);
    if (hi > in_size) hi = in_size;
    int n = hi - lo;
    double* k = &p.coeffs[static_cast<size_t>(xx) * ksize];
    double wsum = 0.0;
    for (int i = 0; i < n; ++i) {
      double w = f.fn((lo + i - center + 0.5) / filterscale);
      k[i] = w;
      wsum += w;
    }
    if (wsum != 0.0)
      for (int i = 0; i < n; ++i) k[i] /= wsum;
    p.bounds_lo[xx] = lo;
    p.counts[xx] = n;
  }
  return p;
}

inline uint8_t clip8(double v) {
  if (v <= 0.0) return 0;
  if (v >= 255.0) return 255;
  return static_cast<uint8_t>(v + 0.5);
}

void resize_one(const uint8_t* src, int H, int W, uint8_t* dst, int h, int w,
                const Plan& px, const Plan& py) {
  // horizontal pass: (H, W, 3) -> (H, w, 3) in doubles
  std::vector<double> tmp(static_cast<size_t>(H) * w * 3);
  for (int y = 0; y < H; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * W * 3;
    double* orow = &tmp[static_cast<size_t>(y) * w * 3];
    for (int x = 0; x < w; ++x) {
      const double* k = &px.coeffs[static_cast<size_t>(x) * px.ksize];
      int lo = px.bounds_lo[x], n = px.counts[x];
      double r = 0, g = 0, b = 0;
      for (int i = 0; i < n; ++i) {
        const uint8_t* pix = row + static_cast<size_t>(lo + i) * 3;
        r += k[i] * pix[0];
        g += k[i] * pix[1];
        b += k[i] * pix[2];
      }
      orow[x * 3 + 0] = r;
      orow[x * 3 + 1] = g;
      orow[x * 3 + 2] = b;
    }
  }
  // vertical pass: (H, w, 3) -> (h, w, 3) uint8
  for (int y = 0; y < h; ++y) {
    const double* k = &py.coeffs[static_cast<size_t>(y) * py.ksize];
    int lo = py.bounds_lo[y], n = py.counts[y];
    uint8_t* orow = dst + static_cast<size_t>(y) * w * 3;
    for (int x = 0; x < w * 3; ++x) {
      double acc = 0;
      for (int i = 0; i < n; ++i)
        acc += k[i] * tmp[static_cast<size_t>(lo + i) * w * 3 + x];
      orow[x] = clip8(acc);
    }
  }
}

}  // namespace

// Resize a batch of images. src: B x (H*W*3) uint8 (each image may have its
// own H/W given in dims[2*i], dims[2*i+1]); dst: B x (h*w*3).
// filter: 0 = bilinear, 1 = bicubic (Pillow default).
void klab_resize_batch(const uint8_t** src, const int* dims, int batch,
                       uint8_t* dst, int out_h, int out_w, int filter,
                       int n_threads) {
  FilterSpec f = filter == 0 ? FilterSpec{1.0, bilinear_filter}
                             : FilterSpec{2.0, bicubic_filter};
  if (n_threads <= 0)
    n_threads = std::max(1u, std::thread::hardware_concurrency() / 2);
  // Group identical input sizes to share plans.
  std::unordered_map<int64_t, Plan> px_cache, py_cache;
  auto plan_for = [&](std::unordered_map<int64_t, Plan>& cache, int in_size,
                      int out_size) -> const Plan& {
    int64_t key = (static_cast<int64_t>(in_size) << 20) | out_size;
    auto it = cache.find(key);
    if (it == cache.end())
      it = cache.emplace(key, make_plan(in_size, out_size, f)).first;
    return it->second;
  };
  // Precompute all plans serially (cheap), then resize in parallel.
  for (int i = 0; i < batch; ++i) {
    plan_for(px_cache, dims[2 * i + 1], out_w);
    plan_for(py_cache, dims[2 * i], out_h);
  }
  std::vector<std::thread> threads;
  std::atomic_int next{0};
  size_t out_stride = static_cast<size_t>(out_h) * out_w * 3;
  for (int t = 0; t < n_threads; ++t) {
    threads.emplace_back([&]() {
      int i;
      while ((i = next.fetch_add(1)) < batch) {
        const Plan& px = plan_for(px_cache, dims[2 * i + 1], out_w);
        const Plan& py = plan_for(py_cache, dims[2 * i], out_h);
        resize_one(src[i], dims[2 * i], dims[2 * i + 1], dst + i * out_stride,
                   out_h, out_w, px, py);
      }
    });
  }
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Unigram Viterbi tokenizer core
// ---------------------------------------------------------------------------

namespace {

// Transparent string_view lookup: the Viterbi inner loop probes the vocab
// with substrings of the input — string_view keys avoid a std::string
// allocation per candidate (measured ~2x on the encode hot path).
struct SvHash {
  using is_transparent = void;
  size_t operator()(std::string_view sv) const {
    return std::hash<std::string_view>{}(sv);
  }
};
struct SvEq {
  using is_transparent = void;
  bool operator()(std::string_view a, std::string_view b) const {
    return a == b;
  }
};

struct UnigramModel {
  std::unordered_map<std::string, std::pair<int, double>, SvHash, SvEq>
      vocab;  // piece -> (id, logp)
  int max_piece_len = 1;
  int unk_id = 2;
  double unk_score = -20.0;  // HF tokenizers: min vocab score - 10
  // Precompiled charsmap (sentencepiece nmt_nfkc normalization table):
  // darts-clone double-array trie + NUL-joined replacement strings.
  std::vector<uint32_t> cm_trie;
  std::string cm_norm;
  // Added special tokens (T5 <extra_id_k> sentinels): matched on the RAW
  // text before normalization, longest-at-position wins (HF
  // AddedVocabulary semantics); each split section normalizes separately.
  std::vector<std::pair<std::string, int>> specials;
  // The chain's optional steps (klab_tok_set_chain). The defaults are the
  // spiece.model chain: Strip(right), Replace(/ {2,}/ -> U+2581), Metaspace.
  bool strip_left = false;
  bool strip_right = true;
  bool collapse_spaces = true;
  bool whitespace_split = false;  // WhitespaceSplit before Metaspace
};

std::vector<UnigramModel*> g_models;

// ---- darts-clone unit decoding (matches HF's spm_precompiled crate) -----

inline uint32_t da_offset(uint32_t unit) {
  return (unit >> 10) << ((unit & (1u << 9)) >> 6);
}

// FIRST (shortest) prefix-match value over data[0..len) or -1 — exactly
// the HF crate's transform(): it takes results[0] of the common-prefix
// search, not the longest match.
int cm_first_match(const UnigramModel& m, const char* data, int len) {
  const std::vector<uint32_t>& a = m.cm_trie;
  if (a.empty()) return -1;
  size_t node_pos = 0;
  uint32_t unit = a[0];
  node_pos ^= da_offset(unit);
  for (int i = 0; i < len; ++i) {
    unsigned char c = static_cast<unsigned char>(data[i]);
    if (c == 0) break;
    node_pos ^= c;
    if (node_pos >= a.size()) return -1;
    unit = a[node_pos];
    if ((unit & (0x80000000u | 0xFFu)) != c) return -1;
    node_pos ^= da_offset(unit);
    if ((unit >> 8) & 1u) {
      if (node_pos >= a.size()) return -1;
      return static_cast<int>(a[node_pos] & 0x7FFFFFFFu);
    }
  }
  return -1;
}

inline int utf8_len(unsigned char c) {
  if (c < 0x80) return 1;
  if (c < 0xE0) return 2;
  if (c < 0xF0) return 3;
  return 4;
}

uint32_t utf8_decode(const char* s, int len) {
  unsigned char c = static_cast<unsigned char>(s[0]);
  if (len == 1) return c;
  uint32_t cp = c & (0x7F >> len);
  for (int i = 1; i < len; ++i)
    cp = (cp << 6) | (static_cast<unsigned char>(s[i]) & 0x3F);
  return cp;
}

// Combining-mark approximation of extended grapheme clusters: the HF crate
// normalizes per unicode grapheme; production charsmaps (nmt_nfkc) map
// single codepoints, so clustering only matters when combining marks
// follow a base char. Covers the common combining blocks.
inline bool is_combining(uint32_t cp) {
  return (cp >= 0x0300 && cp <= 0x036F) || (cp >= 0x1AB0 && cp <= 0x1AFF) ||
         (cp >= 0x1DC0 && cp <= 0x1DFF) || (cp >= 0x20D0 && cp <= 0x20FF) ||
         (cp >= 0xFE20 && cp <= 0xFE2F);
}

// Rust char::is_whitespace (Unicode White_Space) — the Strip normalizer's
// character class.
inline bool is_unicode_ws(uint32_t cp) {
  return cp == ' ' || (cp >= 0x09 && cp <= 0x0D) || cp == 0x85 ||
         cp == 0xA0 || cp == 0x1680 || (cp >= 0x2000 && cp <= 0x200A) ||
         cp == 0x2028 || cp == 0x2029 || cp == 0x202F || cp == 0x205F ||
         cp == 0x3000;
}

// Apply the precompiled charsmap exactly as HF's Precompiled normalizer:
// per grapheme cluster, if byte length < 6 and the trie has a prefix match,
// the WHOLE grapheme is replaced by that (first) match; otherwise each
// codepoint is individually transformed or copied.
std::string cm_normalize(const UnigramModel& m, const std::string& s) {
  std::string out;
  out.reserve(s.size());
  int n = static_cast<int>(s.size());
  int i = 0;
  while (i < n) {
    int glen = utf8_len(static_cast<unsigned char>(s[i]));
    if (i + glen > n) glen = n - i;  // truncated tail: copy as-is
    // extend by trailing combining marks
    int j = i + glen;
    while (j < n) {
      int cl = utf8_len(static_cast<unsigned char>(s[j]));
      if (j + cl > n) break;
      if (!is_combining(utf8_decode(s.data() + j, cl))) break;
      j += cl;
    }
    int total = j - i;
    if (total < 6) {
      int v = cm_first_match(m, s.data() + i, total);
      if (v >= 0 && static_cast<size_t>(v) < m.cm_norm.size()) {
        out += m.cm_norm.c_str() + v;  // NUL-terminated replacement
        i = j;
        continue;
      }
    }
    for (int k = i; k < j;) {
      int cl = utf8_len(static_cast<unsigned char>(s[k]));
      if (k + cl > j) cl = j - k;
      int v = cm_first_match(m, s.data() + k, cl);
      if (v >= 0 && static_cast<size_t>(v) < m.cm_norm.size())
        out += m.cm_norm.c_str() + v;
      else
        out.append(s, k, cl);
      k += cl;
    }
    i = j;
  }
  return out;
}

}  // namespace

// Build a model from parallel arrays of pieces (utf-8, NUL-separated blob)
// and scores. Returns a handle.
int klab_tok_new(const char* pieces_blob, const double* scores, const int* ids,
                 int n, int unk_id) {
  auto* m = new UnigramModel();
  m->unk_id = unk_id;
  const char* p = pieces_blob;
  double min_score = std::numeric_limits<double>::infinity();
  for (int i = 0; i < n; ++i) {
    std::string piece(p);
    p += piece.size() + 1;
    m->vocab[piece] = {ids[i], scores[i]};
    m->max_piece_len =
        std::max(m->max_piece_len, static_cast<int>(piece.size()));
    min_score = std::min(min_score, scores[i]);
  }
  if (n == 0) min_score = 0.0;
  // HF tokenizers Unigram: unk score = min vocab score - 10 (kUnkPenalty).
  m->unk_score = min_score - 10.0;
  g_models.push_back(m);
  return static_cast<int>(g_models.size()) - 1;
}

// Register an added special token (e.g. "<extra_id_7>" -> id).
int klab_tok_add_special(int handle, const char* token, int id) {
  if (handle < 0 || handle >= static_cast<int>(g_models.size())) return -1;
  g_models[handle]->specials.emplace_back(token, id);
  return 0;
}

// Set the chain's optional steps (see UnigramModel).
int klab_tok_set_chain(int handle, int strip_left, int strip_right,
                       int collapse_spaces, int whitespace_split) {
  if (handle < 0 || handle >= static_cast<int>(g_models.size())) return -1;
  UnigramModel& m = *g_models[handle];
  m.strip_left = strip_left != 0;
  m.strip_right = strip_right != 0;
  m.collapse_spaces = collapse_spaces != 0;
  m.whitespace_split = whitespace_split != 0;
  return 0;
}

// Attach a sentencepiece precompiled_charsmap (normalizer_spec field 2 of
// the spiece.model proto) to a model: [uint32-LE trie_size][trie][strings].
int klab_tok_set_charsmap(int handle, const uint8_t* blob, int64_t len) {
  if (handle < 0 || handle >= static_cast<int>(g_models.size())) return -1;
  if (len < 4) return -1;
  UnigramModel& m = *g_models[handle];
  uint32_t trie_size;
  std::memcpy(&trie_size, blob, 4);
  if (4 + static_cast<int64_t>(trie_size) > len || trie_size % 4 != 0)
    return -1;
  m.cm_trie.resize(trie_size / 4);
  std::memcpy(m.cm_trie.data(), blob + 4, trie_size);
  m.cm_norm.assign(reinterpret_cast<const char*>(blob) + 4 + trie_size,
                   static_cast<size_t>(len - 4 - trie_size));
  return 0;
}

namespace {

// Viterbi segmentation of one pre-token; appends ids to out. Matches HF
// tokenizers' Unigram lattice: per-CODEPOINT unk fallback at
// min_score - 10, consecutive unks fused into one unk id.
void viterbi_encode(const UnigramModel& m, const char* text, int n,
                    std::vector<int>& out) {
  if (n == 0) return;
  const double NEG = -1e300;
  std::vector<double> best(n + 1, NEG);
  std::vector<int> back(n + 1, -1);     // start index of best last piece
  std::vector<int> back_id(n + 1, -1);  // its token id
  best[0] = 0.0f;
  for (int end = 1; end <= n; ++end) {
    int lo = std::max(0, end - m.max_piece_len);
    for (int start = lo; start < end; ++start) {
      if (best[start] <= NEG / 2) continue;
      auto it = m.vocab.find(
          std::string_view(text + start, end - start));
      double score;
      int id;
      if (it != m.vocab.end()) {
        id = it->second.first;
        score = it->second.second;
      } else if (end - start ==
                 utf8_len(static_cast<unsigned char>(text[start]))) {
        id = m.unk_id;  // single unknown CODEPOINT
        score = m.unk_score;
      } else {
        continue;
      }
      double cand = best[start] + score;
      if (cand > best[end]) {
        best[end] = cand;
        back[end] = start;
        back_id[end] = id;
      }
    }
  }
  std::vector<int> rev;
  for (int pos = n; pos > 0; pos = back[pos]) rev.push_back(back_id[pos]);
  size_t first = out.size();
  for (size_t i = rev.size(); i > 0; --i) {
    int id = rev[i - 1];
    // fuse_unk: consecutive unk tokens collapse into one
    if (id == m.unk_id && out.size() > first && out.back() == m.unk_id)
      continue;
    out.push_back(id);
  }
}

inline int utf8_start_before(const std::string& s, int end) {
  int start = end - 1;
  while (start > 0 && (static_cast<unsigned char>(s[start]) & 0xC0) == 0x80)
    --start;
  return start;
}

// Metaspace on one pre-token: ' ' -> U+2581 (a run of spaces -> ONE with
// collapse_spaces, the Replace(/ {2,}/) normalizer's effect), U+2581
// prepended unless already leading, split merged-with-next at each U+2581,
// Viterbi per piece.
void metaspace_encode(const UnigramModel& m, const char* text, size_t n,
                      std::vector<int>& out) {
  static const char* kMeta = "\xe2\x96\x81";  // U+2581
  std::string ms;
  ms.reserve(n + 3);
  for (size_t i = 0; i < n;) {
    if (text[i] == ' ') {
      size_t j = i + 1;
      if (m.collapse_spaces)
        while (j < n && text[j] == ' ') ++j;
      ms += kMeta;
      i = j;
    } else {
      ms += text[i++];
    }
  }
  if (ms.compare(0, 3, kMeta) != 0) ms = std::string(kMeta) + ms;
  size_t start = 0;
  size_t pos = 3;  // ms starts with the marker
  while (pos <= ms.size()) {
    if (pos == ms.size() || ms.compare(pos, 3, kMeta) == 0) {
      viterbi_encode(m, ms.data() + start, static_cast<int>(pos - start),
                     out);
      start = pos;
      pos += 3;
    } else {
      ++pos;
    }
  }
}

// The HF T5 chain for one section of text: Precompiled charsmap ->
// Strip(left/right, unicode whitespace) -> [WhitespaceSplit] -> Metaspace
// (see metaspace_encode).
void encode_one(const UnigramModel& m, const std::string& raw,
                std::vector<int>& out) {
  if (raw.empty()) return;
  std::string s = m.cm_trie.empty() ? raw : cm_normalize(m, raw);
  if (m.strip_right) {
    while (!s.empty()) {
      int end = static_cast<int>(s.size());
      int start = utf8_start_before(s, end);
      if (!is_unicode_ws(utf8_decode(s.data() + start, end - start))) break;
      s.resize(start);
    }
  }
  if (m.strip_left) {
    size_t i = 0;
    while (i < s.size()) {
      int cl = utf8_len(static_cast<unsigned char>(s[i]));
      if (i + cl > s.size()) break;
      if (!is_unicode_ws(utf8_decode(s.data() + i, cl))) break;
      i += cl;
    }
    s.erase(0, i);
  }
  if (s.empty()) return;  // HF: empty / all-whitespace input -> no tokens
  if (!m.whitespace_split) {
    metaspace_encode(m, s.data(), s.size(), out);
    return;
  }
  // WhitespaceSplit: words between runs of unicode whitespace, each
  // through Metaspace on its own.
  size_t word = 0, i = 0;
  while (i <= s.size()) {
    int cl = 1;
    bool ws = false;
    if (i < s.size()) {
      cl = utf8_len(static_cast<unsigned char>(s[i]));
      if (i + cl > s.size()) cl = static_cast<int>(s.size() - i);
      ws = is_unicode_ws(utf8_decode(s.data() + i, cl));
    }
    if (i == s.size() || ws) {
      if (i > word) metaspace_encode(m, s.data() + word, i - word, out);
      word = i + cl;
    }
    i += cl;
  }
}

// Raw-text special-token extraction + per-section encoding.
void encode_with_specials(const UnigramModel& m, const std::string& raw,
                          std::vector<int>& out) {
  if (m.specials.empty()) {
    encode_one(m, raw, out);
    return;
  }
  size_t i = 0, sec_start = 0;
  while (i < raw.size()) {
    const std::pair<std::string, int>* best = nullptr;
    for (const auto& sp : m.specials) {
      if (raw.compare(i, sp.first.size(), sp.first) == 0 &&
          (!best || sp.first.size() > best->first.size()))
        best = &sp;
    }
    if (best) {
      if (i > sec_start)
        encode_one(m, raw.substr(sec_start, i - sec_start), out);
      out.push_back(best->second);
      i += best->first.size();
      sec_start = i;
    } else {
      ++i;
    }
  }
  if (sec_start < raw.size()) encode_one(m, raw.substr(sec_start), out);
}

}  // namespace

// Encode one utf-8 string of `len` bytes (NULs included) without eos.
// Writes at most `cap` ids to out_ids and returns the number of ids the
// string encodes to (the caller retries with a larger buffer when it
// exceeds `cap`), or -1 on an invalid handle.
int klab_tok_encode(int handle, const char* text, int64_t len,
                    int32_t* out_ids, int cap) {
  if (handle < 0 || handle >= static_cast<int>(g_models.size()) || len < 0)
    return -1;
  std::vector<int> buf;
  encode_with_specials(*g_models[handle],
                       std::string(text, static_cast<size_t>(len)), buf);
  int n = static_cast<int>(buf.size());
  for (int j = 0; j < std::min(n, cap); ++j) out_ids[j] = buf[j];
  return n;
}

// Text that one thread of klab_tok_encode_batch must have before the call
// starts another: starting a thread costs tens of microseconds, encoding a
// KiB of text some hundreds, so a batch of a few short captions runs on the
// caller's thread alone.
constexpr int64_t kBytesPerThread = 1024;

// Batch encode with fixed-shape padding. Text i is the utf-8 bytes
// texts_blob[offsets[i], offsets[i + 1]) (NULs included); offsets holds
// batch + 1 entries. out_ids/out_mask: (batch, max_len) int32,
// pre-allocated. Applies the full normalizer/pre-tokenizer chain (see
// encode_one); eos appended; pad_id fills the remainder. n_threads <= 0
// takes one thread per kBytesPerThread of text, at most half the host's
// cores; the caller's thread is one of them. Returns 0 on success, -1 on an
// invalid handle/max_len/batch/offsets (outputs untouched — the caller must
// treat the buffers as garbage and raise).
int klab_tok_encode_batch(int handle, const char* texts_blob,
                          const int64_t* offsets, int batch,
                          int32_t* out_ids, int32_t* out_mask, int max_len,
                          int pad_id, int eos_id, int n_threads) {
  // max_len must leave room for eos (cnt is clamped to max_len - 1; a
  // non-positive max_len would index ids[-1]).
  if (handle < 0 || handle >= static_cast<int>(g_models.size()) ||
      max_len < 1 || batch < 1 || offsets[0] < 0)
    return -1;
  for (int i = 0; i < batch; ++i)
    if (offsets[i + 1] < offsets[i]) return -1;
  const UnigramModel& m = *g_models[handle];
  if (n_threads <= 0) {
    const int64_t cores =
        std::max(1u, std::thread::hardware_concurrency() / 2);
    n_threads = static_cast<int>(std::clamp<int64_t>(
        (offsets[batch] - offsets[0]) / kBytesPerThread, 1, cores));
  }
  n_threads = std::min(n_threads, batch);
  std::atomic_int next{0};
  auto work = [&]() {
    int i;
    while ((i = next.fetch_add(1)) < batch) {
      std::vector<int> buf;
      encode_with_specials(
          m,
          std::string(texts_blob + offsets[i],
                      static_cast<size_t>(offsets[i + 1] - offsets[i])),
          buf);
      int cnt = std::min(static_cast<int>(buf.size()), max_len - 1);
      int32_t* ids = out_ids + static_cast<size_t>(i) * max_len;
      int32_t* mask = out_mask + static_cast<size_t>(i) * max_len;
      for (int j = 0; j < cnt; ++j) ids[j] = buf[j];
      ids[cnt] = eos_id;
      for (int j = 0; j <= cnt; ++j) mask[j] = 1;
      for (int j = cnt + 1; j < max_len; ++j) {
        ids[j] = pad_id;
        mask[j] = 0;
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < n_threads; ++t) threads.emplace_back(work);
  work();
  for (auto& th : threads) th.join();
  return 0;
}

// (A C++ epoch-shuffle generator used to live here; excised: numpy's
// Generator.permutation is already vectorized C on the host, a duplicate
// RNG would change shuffle orders vs the Python path for zero gain.)

}  // extern "C"
