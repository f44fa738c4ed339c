// cic_native: C++ replacements for the reference's Java metric tools
// (SURVEY.md §2.4): PTB-style tokenizer (stanford-corenlp PTBTokenizer jar,
// ref: ptbtokenizer.py) and METEOR scorer (meteor-1.5.jar, ref: meteor.py),
// plus a Porter stemmer.  Exposed via a C ABI consumed by ctypes
// (native/bindings.py).  The Python modules in metrics/ are the behavioral
// specification; both implementations must agree bit-for-bit on tokens and to
// float tolerance on scores (tests/test_native.py).
//
// Line protocols:
//   tokenizer: '\n'-separated captions in, '\n'-separated token strings out
//   meteor:    hypothesis '\x02' ref1 '\x01' ref2 ... in, double out

#include <algorithm>
#include <cmath>
#include <cstring>
#include <regex>
#include <sstream>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Porter stemmer (classic 1980 algorithm; mirrors metrics/porter.py)
// ---------------------------------------------------------------------------

bool is_cons(const std::string& w, int i) {
  char c = w[i];
  if (c == 'a' || c == 'e' || c == 'i' || c == 'o' || c == 'u') return false;
  if (c == 'y') return i == 0 ? true : !is_cons(w, i - 1);
  return true;
}

int measure(const std::string& w) {
  int n = 0, i = 0, L = (int)w.size();
  while (i < L && is_cons(w, i)) i++;
  while (i < L) {
    while (i < L && !is_cons(w, i)) i++;
    if (i >= L) break;
    n++;
    while (i < L && is_cons(w, i)) i++;
  }
  return n;
}

bool has_vowel(const std::string& w) {
  for (int i = 0; i < (int)w.size(); i++)
    if (!is_cons(w, i)) return true;
  return false;
}

bool ends_double_cons(const std::string& w) {
  int L = (int)w.size();
  return L >= 2 && w[L - 1] == w[L - 2] && is_cons(w, L - 1);
}

bool cvc(const std::string& w) {
  int L = (int)w.size();
  if (L < 3) return false;
  if (!(is_cons(w, L - 3) && !is_cons(w, L - 2) && is_cons(w, L - 1)))
    return false;
  char c = w[L - 1];
  return c != 'w' && c != 'x' && c != 'y';
}

bool ends_with(const std::string& w, const std::string& s) {
  return w.size() >= s.size() && w.compare(w.size() - s.size(), s.size(), s) == 0;
}

std::string chop(const std::string& w, size_t n) { return w.substr(0, w.size() - n); }

std::string porter_stem(const std::string& word) {
  std::string w;
  for (char c : word) w += (char)std::tolower((unsigned char)c);
  if (w.size() <= 2) return w;
  // step 1a
  if (ends_with(w, "sses")) w = chop(w, 2);
  else if (ends_with(w, "ies")) w = chop(w, 2);
  else if (ends_with(w, "ss")) {}
  else if (ends_with(w, "s")) w = chop(w, 1);
  // step 1b
  bool flag = false;
  if (ends_with(w, "eed")) {
    if (measure(chop(w, 3)) > 0) w = chop(w, 1);
  } else if (ends_with(w, "ed") && has_vowel(chop(w, 2))) {
    w = chop(w, 2); flag = true;
  } else if (ends_with(w, "ing") && has_vowel(chop(w, 3))) {
    w = chop(w, 3); flag = true;
  }
  if (flag) {
    if (ends_with(w, "at") || ends_with(w, "bl") || ends_with(w, "iz")) w += "e";
    else if (ends_double_cons(w) && !ends_with(w, "l") && !ends_with(w, "s") &&
             !ends_with(w, "z")) w = chop(w, 1);
    else if (measure(w) == 1 && cvc(w)) w += "e";
  }
  // step 1c
  if (ends_with(w, "y") && has_vowel(chop(w, 1))) w = chop(w, 1) + "i";
  // step 2
  static const std::pair<const char*, const char*> step2[] = {
      {"ational", "ate"}, {"tional", "tion"}, {"enci", "ence"},
      {"anci", "ance"}, {"izer", "ize"}, {"abli", "able"}, {"alli", "al"},
      {"entli", "ent"}, {"eli", "e"}, {"ousli", "ous"}, {"ization", "ize"},
      {"ation", "ate"}, {"ator", "ate"}, {"alism", "al"}, {"iveness", "ive"},
      {"fulness", "ful"}, {"ousness", "ous"}, {"aliti", "al"},
      {"iviti", "ive"}, {"biliti", "ble"}};
  for (auto& p : step2) {
    if (ends_with(w, p.first)) {
      if (measure(chop(w, strlen(p.first))) > 0)
        w = chop(w, strlen(p.first)) + p.second;
      break;
    }
  }
  // step 3
  static const std::pair<const char*, const char*> step3[] = {
      {"icate", "ic"}, {"ative", ""}, {"alize", "al"}, {"iciti", "ic"},
      {"ical", "ic"}, {"ful", ""}, {"ness", ""}};
  for (auto& p : step3) {
    if (ends_with(w, p.first)) {
      if (measure(chop(w, strlen(p.first))) > 0)
        w = chop(w, strlen(p.first)) + p.second;
      break;
    }
  }
  // step 4 (longest-suffix-first like the python implementation)
  static const char* step4[] = {"ement", "ance", "ence", "able", "ible",
                                "ment", "ent", "ism", "ate", "iti", "ous",
                                "ive", "ize", "al", "er", "ic", "ant", "ou"};
  bool matched = false;
  for (auto* suf : step4) {
    if (ends_with(w, suf)) {
      std::string base = chop(w, strlen(suf));
      if (measure(base) > 1) w = base;
      matched = true;
      break;
    }
  }
  if (!matched && ends_with(w, "ion")) {
    std::string base = chop(w, 3);
    if (measure(base) > 1 && (ends_with(base, "s") || ends_with(base, "t")))
      w = base;
  }
  // step 5a
  if (ends_with(w, "e")) {
    std::string base = chop(w, 1);
    int m = measure(base);
    if (m > 1 || (m == 1 && !cvc(base))) w = base;
  }
  // step 5b
  if (measure(w) > 1 && ends_double_cons(w) && ends_with(w, "l")) w = chop(w, 1);
  return w;
}

// ---------------------------------------------------------------------------
// PTB tokenizer (mirrors metrics/tokenizer.py rules + punctuation strip)
// ---------------------------------------------------------------------------

struct Rule { std::regex pat; std::string repl; };

const std::vector<Rule>& rules() {
  static std::vector<Rule> r = [] {
    std::vector<Rule> v;
    auto add = [&](const char* p, const char* s) {
      v.push_back({std::regex(p), s});
    };
    add("^\"", "`` ");
    add("([ (\\[{<])\"", "$1 `` ");
    add("\\.\\.\\.", " ... ");
    add("([,;:@#$%&])", " $1 ");
    add("([^.])(\\.)([\\]\\)}>\"']*)\\s*$", "$1 $2$3 ");
    add("([?!])", " $1 ");
    add("([\\]\\[(){}<>])", " $1 ");
    add("\\(", "-LRB-");
    add("\\)", "-RRB-");
    add("\\[", "-LSB-");
    add("\\]", "-RSB-");
    add("\\{", "-LCB-");
    add("\\}", "-RCB-");
    add("--", " -- ");
    add("\"", " '' ");
    add("([^'])' ", "$1 ' ");
    add("'([sSmMdD]) ", " '$1 ");
    add("('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) ", " $1 ");
    return v;
  }();
  return r;
}

const std::vector<std::string>& punctuations() {
  static std::vector<std::string> p = {
      "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-", ".", "?",
      "!", ",", ":", "-", "--", "...", ";"};
  return p;
}

std::vector<std::string> split_ws(const std::string& s) {
  std::vector<std::string> out;
  size_t i = 0;
  while (i < s.size()) {
    while (i < s.size() && std::isspace((unsigned char)s[i])) i++;
    size_t j = i;
    while (j < s.size() && !std::isspace((unsigned char)s[j])) j++;
    if (j > i) out.push_back(s.substr(i, j - i));
    i = j;
  }
  return out;
}

std::string strip(const std::string& s) {
  size_t a = 0, b = s.size();
  while (a < b && std::isspace((unsigned char)s[a])) a++;
  while (b > a && std::isspace((unsigned char)s[b - 1])) b--;
  return s.substr(a, b - a);
}

std::string tokenize_line(const std::string& line) {
  std::string s;
  for (char c : line) s += (char)std::tolower((unsigned char)c);
  s = " " + strip(s) + " ";
  for (const auto& r : rules()) s = std::regex_replace(s, r.pat, r.repl);
  std::string out;
  const auto& punct = punctuations();
  for (const auto& tok : split_ws(s)) {
    if (std::find(punct.begin(), punct.end(), tok) != punct.end()) continue;
    if (!out.empty()) out += ' ';
    out += tok;
  }
  return out;
}

// ---------------------------------------------------------------------------
// METEOR (mirrors metrics/meteor.py: METEOR 1.5 scoring model — exact+stem
// stages, English 'rank' parameters, content/function word weighting, and
// stats output for the jar's micro-averaged corpus score)
// ---------------------------------------------------------------------------

constexpr double ALPHA = 0.85, BETA = 0.2, GAMMA = 0.6, DELTA = 0.75;
constexpr double W_EXACT = 1.0, W_STEM = 0.6, W_SYN = 0.8, W_PAR = 0.6;

// Optional METEOR 1.5 resources (metrics/meteor.py MeteorResources; set via
// cic_meteor_configure with the serialize() wire format).  Empty = the
// built-in exact+stem configuration.
struct MeteorResources {
  std::unordered_set<std::string> fw_override;          // function words
  std::unordered_map<std::string, std::vector<int>> syn_ids;  // word -> gids
  // phrase (space-joined) -> list of phrases (word vectors), both directions
  std::unordered_map<std::string, std::vector<std::vector<std::string>>> par;
  int max_phrase = 1;
  bool has_syn() const { return !syn_ids.empty(); }
  bool has_par() const { return !par.empty(); }
};
MeteorResources g_res;

const std::unordered_set<std::string>& function_words() {
  // keep in sync with metrics/meteor.py FUNCTION_WORDS
  static const std::unordered_set<std::string> fw = [] {
    const char* words =
        "a an the this that these those some any each every no all both "
        "either neither i you he she it we they me him her us them my your "
        "his its our their mine yours hers ours theirs myself yourself "
        "himself herself itself ourselves themselves who whom whose which "
        "what is am are was were be been being do does did done doing have "
        "has had having will would shall should can could may might must "
        "ought need dare used and or but nor so yet for if then than as "
        "because while although though since unless until when where why "
        "how whether that of in on at by with from to into onto upon about "
        "above below under over between among through during before after "
        "against across behind beyond around near off out up down within "
        "without along toward towards not n't never also just only even "
        "still too very quite rather there here 's 'd 'll 'm 're 've "
        ". , ; : ! ? ' \" ` `` '' -- ( ) [ ]";
    std::unordered_set<std::string> s;
    std::istringstream iss(words);
    std::string w;
    while (iss >> w) s.insert(w);
    return s;
  }();
  return fw;
}

inline double content_weight(const std::string& w) {
  const auto& fw =
      g_res.fw_override.empty() ? function_words() : g_res.fw_override;
  return fw.count(w) ? 1.0 - DELTA : DELTA;
}

struct Match { int hi, ri; double w; };

// Word keys per stage (mirrors metrics/meteor.py _align keys_fn): one key
// for exact/stem, the word's synset-group ids ("g<id>") for the syn stage.
std::vector<std::string> stage_keys(const std::string& w, int stage) {
  if (stage == 0) return {w};
  if (stage == 1) return {porter_stem(w)};
  auto it = g_res.syn_ids.find(w);
  if (it == g_res.syn_ids.end()) return {};
  std::vector<std::string> keys;
  for (int gid : it->second) keys.push_back("g" + std::to_string(gid));
  return keys;
}

void run_stage(const std::vector<std::string>& hyp,
               const std::vector<std::string>& ref,
               std::vector<bool>& hyp_taken, std::vector<bool>& ref_taken,
               std::vector<Match>& matches, int stage, double weight) {
  std::unordered_map<std::string, std::vector<int>> ref_keys;
  for (int ri = 0; ri < (int)ref.size(); ri++) {
    if (!ref_taken[ri])
      for (const auto& k : stage_keys(ref[ri], stage))
        ref_keys[k].push_back(ri);
  }
  int last_ri = -1;
  for (int hi = 0; hi < (int)hyp.size(); hi++) {
    if (hyp_taken[hi]) continue;
    // sorted union of untaken candidates over the word's keys (the Python
    // tier's sorted set); per-key vectors are ascending already
    std::vector<int> cands;
    for (const auto& k : stage_keys(hyp[hi], stage)) {
      auto it = ref_keys.find(k);
      if (it == ref_keys.end()) continue;
      for (int ri : it->second)
        if (!ref_taken[ri]) cands.push_back(ri);
    }
    if (cands.empty()) continue;
    std::sort(cands.begin(), cands.end());
    cands.erase(std::unique(cands.begin(), cands.end()), cands.end());
    int pick = -1;
    for (int ri : cands)
      if (ri > last_ri) { pick = ri; break; }
    if (pick < 0) pick = cands[0];
    hyp_taken[hi] = true;
    ref_taken[pick] = true;
    matches.push_back({hi, pick, weight});
    last_ri = pick;
  }
}

std::string join_ws(const std::vector<std::string>& words, int start, int n) {
  std::string s;
  for (int i = start; i < start + n; i++) {
    if (!s.empty()) s += ' ';
    s += words[i];
  }
  return s;
}

// Phrase-level paraphrase stage (mirrors metrics/meteor.py
// _run_paraphrase_stage: longest untaken hyp span first, leftmost untaken
// ref occurrence preferring past the last match; min-length-prefix pairs).
void run_paraphrase_stage(const std::vector<std::string>& hyp,
                          const std::vector<std::string>& ref,
                          std::vector<bool>& hyp_taken,
                          std::vector<bool>& ref_taken,
                          std::vector<Match>& matches) {
  int last_ri = -1;
  auto span_free = [](const std::vector<bool>& taken, int start, int n) {
    for (int i = start; i < start + n; i++)
      if (taken[i]) return false;
    return true;
  };
  auto find_ref = [&](const std::vector<std::string>& phrase) {
    int n = (int)phrase.size();
    int first = -1;
    for (int rs = 0; rs + n <= (int)ref.size(); rs++) {
      if (!span_free(ref_taken, rs, n)) continue;
      bool eq = true;
      for (int i = 0; i < n && eq; i++) eq = ref[rs + i] == phrase[i];
      if (!eq) continue;
      if (rs > last_ri) return rs;
      if (first < 0) first = rs;
    }
    return first;
  };
  for (int hi = 0; hi < (int)hyp.size(); hi++) {
    if (hyp_taken[hi]) continue;
    int max_n = std::min(g_res.max_phrase, (int)hyp.size() - hi);
    for (int n = max_n; n >= 1; n--) {
      if (!span_free(hyp_taken, hi, n)) continue;
      auto it = g_res.par.find(join_ws(hyp, hi, n));
      if (it == g_res.par.end()) continue;
      bool matched = false;
      for (const auto& dst : it->second) {
        int rs = find_ref(dst);
        if (rs < 0) continue;
        for (int i = 0; i < n; i++) hyp_taken[hi + i] = true;
        for (int i = 0; i < (int)dst.size(); i++) ref_taken[rs + i] = true;
        for (int i = 0; i < std::min(n, (int)dst.size()); i++)
          matches.push_back({hi + i, rs + i, W_PAR});
        last_ri = rs + (int)dst.size() - 1;
        hi += n - 1;
        matched = true;
        break;
      }
      if (matched) break;
    }
  }
}

// stats: [wp_num, p_den, wr_num, r_den, chunks, matches]
double score_from_stats(const double st[6]) {
  double wp = st[0], pd = st[1], wr = st[2], rd = st[3];
  double chunks = st[4], m = st[5];
  if (m <= 0 || pd <= 0 || rd <= 0) return 0.0;
  double p = wp / pd, r = wr / rd;
  if (p == 0 || r == 0) return 0.0;
  double fmean = p * r / (ALPHA * p + (1 - ALPHA) * r);
  double pen = GAMMA * std::pow(chunks / m, BETA);
  return (1 - pen) * fmean;
}

void pair_stats(const std::vector<std::string>& hyp,
                const std::vector<std::string>& ref, double st[6]) {
  std::vector<bool> ht(hyp.size(), false), rt(ref.size(), false);
  std::vector<Match> matches;
  run_stage(hyp, ref, ht, rt, matches, 0, W_EXACT);
  run_stage(hyp, ref, ht, rt, matches, 1, W_STEM);
  if (g_res.has_syn()) run_stage(hyp, ref, ht, rt, matches, 2, W_SYN);
  if (g_res.has_par()) run_paraphrase_stage(hyp, ref, ht, rt, matches);
  double wp = 0, wr = 0, pd = 0, rd = 0;
  for (auto& w : hyp) pd += content_weight(w);
  for (auto& w : ref) rd += content_weight(w);
  for (auto& mt : matches) {
    wp += mt.w * content_weight(hyp[mt.hi]);
    wr += mt.w * content_weight(ref[mt.ri]);
  }
  std::sort(matches.begin(), matches.end(),
            [](const Match& a, const Match& b) {
              return a.hi < b.hi || (a.hi == b.hi && a.ri < b.ri);
            });
  int chunks = matches.empty() ? 0 : 1;
  for (size_t i = 1; i < matches.size(); i++) {
    if (!(matches[i].hi == matches[i - 1].hi + 1 &&
          matches[i].ri == matches[i - 1].ri + 1))
      chunks++;
  }
  st[0] = wp; st[1] = pd; st[2] = wr; st[3] = rd;
  st[4] = (double)chunks; st[5] = (double)matches.size();
}

// Segment score + best-reference stats (jar semantics: the best-scoring
// reference's statistics represent the segment in the corpus aggregate).
double sentence_meteor_stats(const std::vector<std::string>& hyp,
                             const std::vector<std::vector<std::string>>& refs,
                             double out_stats[6]) {
  double best = 0.0;
  bool found = false;
  for (int i = 0; i < 6; i++) out_stats[i] = 0.0;
  for (const auto& ref : refs) {
    if (hyp.empty() || ref.empty()) continue;
    double st[6];
    pair_stats(hyp, ref, st);
    double score = score_from_stats(st);
    if (score >= best || !found) {
      best = score;
      for (int i = 0; i < 6; i++) out_stats[i] = st[i];
      found = true;
    }
  }
  if (!found) {
    // degenerate segment (empty hypothesis and/or references): zero matches,
    // but the length denominators still count in the corpus micro-average
    // (keep in sync with metrics/meteor.py sentence_stats)
    for (const auto& w : hyp) out_stats[1] += content_weight(w);
    for (const auto& ref : refs) {
      if (ref.empty()) continue;
      for (const auto& w : ref) out_stats[3] += content_weight(w);
      break;
    }
  }
  return best;
}

thread_local std::string g_out;

}  // namespace

extern "C" {

// Tokenize '\n'-separated captions; returns pointer valid until the next call
// on the same thread.
const char* cic_tokenize(const char* input) {
  g_out.clear();
  const char* p = input;
  while (*p) {
    const char* nl = strchr(p, '\n');
    size_t len = nl ? (size_t)(nl - p) : strlen(p);
    g_out += tokenize_line(std::string(p, len));
    g_out += '\n';
    if (!nl) break;
    p = nl + 1;
  }
  if (!g_out.empty() && g_out.back() == '\n') g_out.pop_back();
  return g_out.c_str();
}

// Configure the optional METEOR 1.5 resources (MeteorResources.serialize():
// FW '\x03' SYNGROUPS '\x03' PARAPHRASES, groups/entries '\x01'-separated,
// paraphrase sides '\x02'-separated).  Empty payload resets to the built-in
// exact+stem configuration.  Returns the number of paraphrase entries.
int cic_meteor_configure(const char* payload) {
  g_res = MeteorResources();
  if (!payload || !*payload) return 0;
  std::vector<std::string> sections;
  const char* p = payload;
  while (sections.size() < 3) {
    const char* e = strchr(p, '\x03');
    size_t len = e ? (size_t)(e - p) : strlen(p);
    sections.emplace_back(p, len);
    if (!e) break;
    p = e + 1;
  }
  sections.resize(3);
  for (const auto& w : split_ws(sections[0])) g_res.fw_override.insert(w);
  auto split_on = [](const std::string& s, char sep) {
    std::vector<std::string> out;
    size_t start = 0;
    while (start <= s.size()) {
      size_t e = s.find(sep, start);
      if (e == std::string::npos) { out.push_back(s.substr(start)); break; }
      out.push_back(s.substr(start, e - start));
      start = e + 1;
    }
    return out;
  };
  if (!sections[1].empty()) {
    int gid = 0;
    for (const auto& group : split_on(sections[1], '\x01')) {
      for (const auto& w : split_ws(group))
        g_res.syn_ids[w].push_back(gid);
      gid++;
    }
  }
  int n_par = 0;
  if (!sections[2].empty()) {
    for (const auto& entry : split_on(sections[2], '\x01')) {
      size_t sep = entry.find('\x02');
      if (sep == std::string::npos) continue;
      auto src = entry.substr(0, sep);
      auto dst = split_ws(entry.substr(sep + 1));
      if (src.empty() || dst.empty()) continue;
      g_res.par[src].push_back(dst);
      // cap matches the Python tier's MAX_PHRASE
      g_res.max_phrase = std::min(6, std::max(
          g_res.max_phrase, (int)split_ws(src).size()));
      n_par++;
    }
  }
  return n_par;
}

// METEOR for one segment: hyp '\x02' ref1 '\x01' ref2 ...
// out7 (if non-null): [score, wp_num, p_den, wr_num, r_den, chunks, matches]
double cic_meteor_stats(const char* payload, double* out7) {
  const char* sep = strchr(payload, '\x02');
  if (!sep) return 0.0;
  std::string hyp(payload, sep - payload);
  std::vector<std::vector<std::string>> refs;
  const char* p = sep + 1;
  while (*p) {
    const char* e = strchr(p, '\x01');
    size_t len = e ? (size_t)(e - p) : strlen(p);
    refs.push_back(split_ws(std::string(p, len)));
    if (!e) break;
    p = e + 1;
  }
  double st[6];
  double score = sentence_meteor_stats(split_ws(hyp), refs, st);
  if (out7) {
    out7[0] = score;
    for (int i = 0; i < 6; i++) out7[i + 1] = st[i];
  }
  return score;
}

double cic_meteor(const char* payload) {
  return cic_meteor_stats(payload, nullptr);
}

// corpus micro-average: score over summed per-segment stats [6]
double cic_meteor_corpus(const double* summed_stats) {
  double st[6];
  for (int i = 0; i < 6; i++) st[i] = summed_stats[i];
  return score_from_stats(st);
}

const char* cic_porter_stem(const char* word) {
  g_out = porter_stem(word);
  return g_out.c_str();
}

int cic_version() { return 1; }

}  // extern "C"
