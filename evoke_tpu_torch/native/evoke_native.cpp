// evoke-tpu native host-side components (C++17, no external deps).
//
// Capability parity with the reference's native dependency edge (SURVEY §2.12):
//  - the Rust `tokenizers` WordLevel encoder (EVOKE modules/tokenizers_new.py)
//    -> wl_* : whitespace-pretokenized vocab lookup with static-shape padding,
//  - the FAISS C++ inner-product index (EVOKE modules/multiview/trainer.py:549)
//    -> topk_ip : exact blocked top-k inner-product search with same-study
//    exclusion (host-side counterpart of retrieval/topk.py's on-device path).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
// Text handling is byte-oriented with ASCII lowercasing: radiology reports are
// ASCII; parity with the Python tokenizer is covered by tests.

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// ------------------------------------------------------------- WordLevel

struct WLTokenizer {
  std::unordered_map<std::string, int32_t> vocab;
  int32_t unk_id;
  bool lowercase;
};

// vocab_blob: '\n'-joined tokens whose line index IS the id.
void* wl_create(const char* vocab_blob, int32_t unk_id, int32_t lowercase) {
  auto* tok = new WLTokenizer();
  tok->unk_id = unk_id;
  tok->lowercase = lowercase != 0;
  const char* p = vocab_blob;
  int32_t id = 0;
  while (*p) {
    const char* nl = strchr(p, '\n');
    size_t len = nl ? static_cast<size_t>(nl - p) : strlen(p);
    tok->vocab.emplace(std::string(p, len), id++);
    if (!nl) break;
    p = nl + 1;
  }
  return tok;
}

void wl_destroy(void* handle) { delete static_cast<WLTokenizer*>(handle); }

static inline bool is_word_char(unsigned char c) {
  return std::isalnum(c) || c == '_' || c >= 0x80;  // non-ASCII treated as word chars
}

// Whitespace pre-tokenizer (HF semantics): runs of word chars OR runs of
// non-word non-space chars. Special tokens like [CLS] survive because the
// caller encodes them via wl_token_id, not through text.
static void pretokenize(const std::string& text, std::vector<std::string>* out) {
  size_t i = 0, n = text.size();
  while (i < n) {
    unsigned char c = text[i];
    if (std::isspace(c)) { ++i; continue; }
    size_t j = i;
    if (is_word_char(c)) {
      while (j < n && is_word_char(static_cast<unsigned char>(text[j]))) ++j;
    } else {
      while (j < n && !is_word_char(static_cast<unsigned char>(text[j])) &&
             !std::isspace(static_cast<unsigned char>(text[j]))) ++j;
    }
    out->emplace_back(text.substr(i, j - i));
    i = j;
  }
}

int32_t wl_token_id(void* handle, const char* token) {
  auto* tok = static_cast<WLTokenizer*>(handle);
  auto it = tok->vocab.find(token);
  return it == tok->vocab.end() ? -1 : it->second;
}

// Encode one text into out[0..max_len); returns the number of real tokens.
int32_t wl_encode(void* handle, const char* text, int32_t* out, int32_t max_len,
                  int32_t pad_id) {
  auto* tok = static_cast<WLTokenizer*>(handle);
  std::string s(text);
  if (tok->lowercase) {
    for (auto& ch : s) ch = static_cast<char>(std::tolower(static_cast<unsigned char>(ch)));
  }
  std::vector<std::string> words;
  pretokenize(s, &words);
  int32_t n = 0;
  for (const auto& w : words) {
    if (n >= max_len) break;
    auto it = tok->vocab.find(w);
    out[n++] = it == tok->vocab.end() ? tok->unk_id : it->second;
  }
  for (int32_t i = n; i < max_len; ++i) out[i] = pad_id;
  return n;
}

// Batched encode: texts is a '\x00'-separated blob with n_texts entries.
void wl_encode_batch(void* handle, const char* texts_blob, int32_t n_texts,
                     int32_t* out, int32_t max_len, int32_t pad_id) {
  const char* p = texts_blob;
  for (int32_t i = 0; i < n_texts; ++i) {
    wl_encode(handle, p, out + static_cast<int64_t>(i) * max_len, max_len, pad_id);
    p += strlen(p) + 1;
  }
}

// ------------------------------------------------------------ top-k search

// Exact inner-product top-k with same-study exclusion.
// db: [n, d] row-major; queries: [q, d]; db_codes/q_codes: study codes;
// out_idx: [q, k]; out_scores: [q, k]. Blocked over db rows for cache locality.
void topk_ip(const float* db, int64_t n, int64_t d, const float* queries, int64_t q,
             const int64_t* db_codes, const int64_t* q_codes, int32_t k,
             int32_t* out_idx, float* out_scores) {
  const int64_t kk = std::min<int64_t>(k, n);
  for (int64_t qi = 0; qi < q; ++qi) {
    const float* qv = queries + qi * d;
    // min-heap as sorted arrays (k is small: 5-30)
    std::vector<float> heap_s(kk, -1e30f);
    std::vector<int32_t> heap_i(kk, 0);
    for (int64_t r = 0; r < n; ++r) {
      if (db_codes[r] == q_codes[qi]) continue;
      const float* dv = db + r * d;
      float acc = 0.f;
      for (int64_t c = 0; c < d; ++c) acc += qv[c] * dv[c];
      if (acc > heap_s[kk - 1]) {
        // insertion into the sorted top list
        int64_t pos = kk - 1;
        while (pos > 0 && heap_s[pos - 1] < acc) {
          heap_s[pos] = heap_s[pos - 1];
          heap_i[pos] = heap_i[pos - 1];
          --pos;
        }
        heap_s[pos] = acc;
        heap_i[pos] = static_cast<int32_t>(r);
      }
    }
    for (int64_t j = 0; j < k; ++j) {
      out_scores[qi * k + j] = j < kk ? heap_s[j] : -1e30f;
      out_idx[qi * k + j] = j < kk ? heap_i[j] : 0;
    }
  }
}

}  // extern "C"
