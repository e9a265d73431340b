// Native grammar runtime: pushdown GBNF matcher + vocab mask builder.
//
// Role parity: the reference enforces grammars inside llama.cpp's C++
// sampler (reference: backend/cpp/llama/grpc-server.cpp:688 wiring the
// grammar into slot sampling, common_sampler_sample at :1977). Here the
// automaton runs host-side and produces per-state [V] penalty rows that
// the engine folds into the compiled sampling step's bias matrix
// (localai_tpu/functions/grammars/automaton.py documents the design; this
// file is its C++ implementation for production vocab sizes, loaded via
// ctypes with the Python automaton as fallback — see native.py).
//
// Semantics mirror automaton.py exactly:
//   state  = set of stacks; stack = (rule, alt, idx) frames, top at end.
//   States are expanded so every top frame points at a char element; an
//   empty stack in the set means the grammar may terminate (EOS allowed).
//   The mask builder walks a codepoint trie over the vocabulary while
//   advancing the automaton; rows are memoized per state.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 grammar.cc -o libgrammar.so
// (native.py compiles this on demand into a user cache directory).

#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <set>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct CharClass {
  bool negated = false;
  std::vector<std::pair<uint32_t, uint32_t>> ranges;
  bool matches(uint32_t cp) const {
    bool hit = false;
    for (auto &r : ranges)
      if (cp >= r.first && cp <= r.second) { hit = true; break; }
    return hit != negated;
  }
};

struct Elem {
  uint8_t kind = 0;  // 0 = char class, 1 = rule ref
  CharClass cc;
  uint32_t rule_id = 0;
};

using Alt = std::vector<Elem>;
using Rule = std::vector<Alt>;

struct Frame {
  uint32_t r, a, i;
  bool operator<(const Frame &o) const {
    return std::tie(r, a, i) < std::tie(o.r, o.a, o.i);
  }
  bool operator==(const Frame &o) const {
    return r == o.r && a == o.a && i == o.i;
  }
};

using Stack = std::vector<Frame>;
using StateSet = std::set<Stack>;  // canonical ordering for interning

// --- utf8 ---
static size_t utf8_next(const uint8_t *s, size_t len, size_t pos, uint32_t *cp) {
  uint8_t c = s[pos];
  if (c < 0x80) { *cp = c; return pos + 1; }
  int extra = (c >= 0xF0) ? 3 : (c >= 0xE0) ? 2 : 1;
  uint32_t v = c & (0x3F >> extra);
  size_t p = pos + 1;
  for (int k = 0; k < extra && p < len; ++k, ++p) v = (v << 6) | (s[p] & 0x3F);
  *cp = v;
  return p;
}

struct Grammar {
  std::vector<Rule> rules;
  uint32_t root_id = 0;

  // expansion memo: stack -> expanded stacks
  std::map<Stack, std::vector<Stack>> expand_memo;
  // state interning
  std::vector<StateSet> states;
  std::map<StateSet, int> state_ids;
  // transition memo: (state, cp) -> next state id (-1 reject)
  std::unordered_map<uint64_t, int> trans_memo;

  int intern(StateSet &&s) {
    auto it = state_ids.find(s);
    if (it != state_ids.end()) return it->second;
    int id = (int)states.size();
    states.push_back(s);
    state_ids.emplace(std::move(s), id);
    return id;
  }

  const std::vector<Stack> &expand(const Stack &stack) {
    auto it = expand_memo.find(stack);
    if (it != expand_memo.end()) return it->second;
    // cycle guard for left recursion: park an empty entry first
    auto &slot = expand_memo[stack];
    std::vector<Stack> result;
    if (stack.empty()) {
      result.push_back(stack);
    } else {
      const Frame &f = stack.back();
      const Alt &alt = rules[f.r][f.a];
      if (f.i >= alt.size()) {
        Stack popped(stack.begin(), stack.end() - 1);
        for (auto &s : expand(popped)) result.push_back(s);
      } else {
        const Elem &e = alt[f.i];
        if (e.kind == 0) {
          result.push_back(stack);
        } else {
          Stack cont(stack.begin(), stack.end() - 1);
          cont.push_back({f.r, f.a, f.i + 1});
          uint32_t rid = e.rule_id;
          for (uint32_t a2 = 0; a2 < rules[rid].size(); ++a2) {
            Stack next = cont;
            next.push_back({rid, a2, 0});
            for (auto &s : expand(next)) result.push_back(s);
          }
        }
      }
    }
    auto &out = expand_memo[stack] = std::move(result);
    (void)slot;
    return out;
  }

  int initial() {
    StateSet out;
    for (uint32_t a = 0; a < rules[root_id].size(); ++a) {
      Stack st{{root_id, a, 0}};
      for (auto &s : expand(st)) out.insert(s);
    }
    return intern(std::move(out));
  }

  int advance_cp(int state, uint32_t cp) {
    uint64_t key = ((uint64_t)state << 32) | cp;
    auto it = trans_memo.find(key);
    if (it != trans_memo.end()) return it->second;
    StateSet out;
    for (const Stack &stack : states[state]) {
      if (stack.empty()) continue;
      const Frame &f = stack.back();
      const Elem &e = rules[f.r][f.a][f.i];
      if (e.cc.matches(cp)) {
        Stack next(stack.begin(), stack.end() - 1);
        next.push_back({f.r, f.a, f.i + 1});
        for (auto &s : expand(next)) out.insert(s);
      }
    }
    int res = out.empty() ? -1 : intern(std::move(out));
    trans_memo.emplace(key, res);
    return res;
  }

  bool accepting(int state) const {
    const StateSet &s = states[state];
    return s.find(Stack{}) != s.end();
  }
};

struct TrieNode {
  std::map<uint32_t, std::unique_ptr<TrieNode>> children;
  std::vector<int32_t> token_ids;
};

struct MaskBuilder {
  TrieNode root;
  std::vector<int32_t> eos_ids;
  int32_t vocab_size = 0;
  // (grammar ptr, state) -> allowed mask
  std::map<std::pair<const void *, int>, std::vector<uint8_t>> memo;

  void add_token(int32_t tid, const uint8_t *s, size_t len) {
    TrieNode *node = &root;
    size_t pos = 0;
    while (pos < len) {
      uint32_t cp;
      pos = utf8_next(s, len, pos, &cp);
      auto &child = node->children[cp];
      if (!child) child = std::make_unique<TrieNode>();
      node = child.get();
    }
    node->token_ids.push_back(tid);
  }

  void visit(Grammar *g, const TrieNode *node, int state,
             std::vector<uint8_t> &mask) {
    for (int32_t tid : node->token_ids) mask[tid] = 1;
    for (auto &kv : node->children) {
      int nxt = g->advance_cp(state, kv.first);
      if (nxt >= 0) visit(g, kv.second.get(), nxt, mask);
    }
  }

  const std::vector<uint8_t> &allowed(Grammar *g, int state) {
    auto key = std::make_pair((const void *)g, state);
    auto it = memo.find(key);
    if (it != memo.end()) return it->second;
    if (memo.size() >= 8192) memo.clear();
    std::vector<uint8_t> mask(vocab_size, 0);
    visit(g, &root, state, mask);
    bool any = false;
    for (uint8_t m : mask)
      if (m) { any = true; break; }
    if (g->accepting(state) || !any) {
      // EOS when the grammar can terminate — or as a pressure valve when
      // stuck (mirrors llama.cpp resetting to EOS over sampling garbage)
      for (int32_t e : eos_ids)
        if (e >= 0 && e < vocab_size) mask[e] = 1;
    }
    return memo.emplace(key, std::move(mask)).first->second;
  }
};

static uint32_t rd32(const uint8_t *&p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  p += 4;
  return v;
}

}  // namespace

extern "C" {

void *ga_grammar_new(const uint8_t *blob, size_t len) {
  (void)len;
  auto *g = new Grammar();
  const uint8_t *p = blob;
  uint32_t n_rules = rd32(p);
  g->root_id = rd32(p);
  g->rules.resize(n_rules);
  for (uint32_t r = 0; r < n_rules; ++r) {
    uint32_t n_alts = rd32(p);
    g->rules[r].resize(n_alts);
    for (uint32_t a = 0; a < n_alts; ++a) {
      uint32_t n_elems = rd32(p);
      g->rules[r][a].resize(n_elems);
      for (uint32_t e = 0; e < n_elems; ++e) {
        Elem &el = g->rules[r][a][e];
        el.kind = *p++;
        if (el.kind == 0) {
          el.cc.negated = (*p++ != 0);
          uint32_t n_ranges = rd32(p);
          el.cc.ranges.resize(n_ranges);
          for (uint32_t k = 0; k < n_ranges; ++k) {
            el.cc.ranges[k].first = rd32(p);
            el.cc.ranges[k].second = rd32(p);
          }
        } else {
          el.rule_id = rd32(p);
        }
      }
    }
  }
  return g;
}

void ga_grammar_free(void *g) { delete (Grammar *)g; }

int ga_initial(void *g) { return ((Grammar *)g)->initial(); }

int ga_advance(void *g, int state, const uint8_t *utf8, size_t len) {
  auto *gr = (Grammar *)g;
  size_t pos = 0;
  while (pos < len && state >= 0) {
    uint32_t cp;
    pos = utf8_next(utf8, len, pos, &cp);
    state = gr->advance_cp(state, cp);
  }
  return state;
}

int ga_accepting(void *g, int state) {
  return ((Grammar *)g)->accepting(state) ? 1 : 0;
}

// vocab blob: per token: int32 tid, int32 len, bytes
void *ga_mask_builder_new(const uint8_t *blob, size_t blob_len,
                          const int32_t *eos, size_t n_eos, int32_t vocab) {
  auto *b = new MaskBuilder();
  b->vocab_size = vocab;
  b->eos_ids.assign(eos, eos + n_eos);
  const uint8_t *p = blob;
  const uint8_t *end = blob + blob_len;
  while (p + 8 <= end) {
    int32_t tid, len;
    std::memcpy(&tid, p, 4);
    std::memcpy(&len, p + 4, 4);
    p += 8;
    if (p + len > end) break;
    if (tid >= 0 && tid < vocab && len > 0) b->add_token(tid, p, (size_t)len);
    p += len;
  }
  return b;
}

void ga_mask_builder_free(void *b) { delete (MaskBuilder *)b; }

void ga_penalty_row(void *b, void *g, int state, float *out) {
  auto *mb = (MaskBuilder *)b;
  const auto &mask = mb->allowed((Grammar *)g, state);
  for (int32_t i = 0; i < mb->vocab_size; ++i)
    out[i] = mask[i] ? 0.0f : -1e9f;
}

}  // extern "C"
