// cic_spice: C++ SPICE-lite scorer (replaces spice-1.0.jar; the behavioral
// specification is metrics/spice.py — both implementations must agree exactly,
// tests/test_native.py).
//
// Shallow caption parse -> scene-graph tuples (object / attribute / relation,
// Porter-stemmed) -> per-category F1 of candidate tuples vs the union of
// reference tuples.
//
// Entry: cic_spice(payload, out[12]) with payload = hyp '\x02' ref1 '\x01'
// ref2 ...; out = {All,Object,Attribute,Relation} x {p,r,f}.

#include <algorithm>
#include <tuple>
#include <cstring>
#include <map>
#include <set>
#include <string>
#include <vector>

extern "C" const char* cic_porter_stem(const char* word);

namespace {

const std::set<std::string>& determiners() {
  static std::set<std::string> s = {
      "a", "an", "the", "this", "that", "these", "those", "some", "any",
      "each", "every", "no", "another", "its", "his", "her", "their", "our",
      "my", "your"};
  return s;
}

const std::set<std::string>& prepositions() {
  static std::set<std::string> s = {
      "in", "on", "at", "of", "with", "by", "for", "from", "to", "into",
      "onto", "over", "under", "above", "below", "near", "beside", "between",
      "behind", "through", "across", "around", "against", "along", "inside",
      "outside", "next", "atop", "amid", "among", "off", "up", "down", "out"};
  return s;
}

const std::set<std::string>& copulas() {
  static std::set<std::string> s = {"is", "are", "was", "were", "be", "been",
                                    "being", "seems", "looks", "appears"};
  return s;
}

const std::set<std::string>& conjunctions() {
  static std::set<std::string> s = {"and", "or", "while", "as", "that",
                                    "which", "who"};
  return s;
}

const std::set<std::string>& common_verbs() {
  static std::set<std::string> s = {
      "has", "have", "had", "holds", "holding", "hold", "wears", "wearing",
      "wear", "sits", "sitting", "sit", "stands", "standing", "stand",
      "rides", "riding", "ride", "walks", "walking", "walk", "runs",
      "running", "run", "plays", "playing", "play", "eats", "eating", "eat",
      "drinks", "drinking", "drink", "jumps", "jumping", "jump", "flies",
      "flying", "fly", "looks", "looking", "look", "carries", "carrying",
      "carry", "uses", "using", "use", "throws", "throwing", "throw",
      "catches", "catching", "catch", "hangs", "hanging", "hang", "lies",
      "lying", "lie", "leans", "leaning", "parked", "covered", "filled",
      "topped", "surrounded"};
  return s;
}

const std::set<std::string>& noun_ing_exceptions() {
  static std::set<std::string> s = {
      "building", "painting", "clothing", "ceiling", "lightning", "morning",
      "evening", "dining", "living", "wedding", "railing", "awning", "icing"};
  return s;
}

// mirrors metrics/spice.py MULTIWORD_PREPS / PRONOUNS exactly
const std::vector<std::vector<std::string>>& multiword_preps() {
  static std::vector<std::vector<std::string>> s = {
      {"on", "top", "of"}, {"in", "front", "of"}, {"in", "back", "of"},
      {"next", "to"},      {"close", "to"},       {"out", "of"}};
  return s;
}

const std::set<std::string>& pronouns() {
  static std::set<std::string> s = {"there", "it",  "he", "she",    "they",
                                    "we",    "you", "i",  "them",   "him",
                                    "us",    "me",  "itself", "himself",
                                    "herself"};
  return s;
}

const std::set<std::string>& locative_by_participles();

bool is_verb(const std::string& tok) {
  if (copulas().count(tok) || common_verbs().count(tok) ||
      locative_by_participles().count(tok))
    return true;
  if (tok.size() > 4 && tok.compare(tok.size() - 3, 3, "ing") == 0 &&
      !noun_ing_exceptions().count(tok))
    return true;
  return false;
}

// passive voice (mirrors metrics/spice.py IRREGULAR_PARTICIPLES /
// LOCATIVE_BY_PARTICIPLES): '<patient> (is) <participle> by <agent>'
// inverts to the active relation verb(agent, patient)
const std::map<std::string, std::string>& irregular_participles() {
  static std::map<std::string, std::string> m = {
      {"thrown", "throw"},   {"eaten", "eat"},    {"worn", "wear"},
      {"ridden", "ride"},    {"driven", "drive"}, {"drawn", "draw"},
      {"broken", "break"},   {"hidden", "hide"},  {"written", "write"},
      {"taken", "take"},     {"given", "give"},   {"made", "make"},
      {"held", "hold"},      {"hung", "hang"},    {"seen", "see"},
      {"caught", "catch"},   {"built", "build"},  {"flown", "fly"},
      {"grown", "grow"},     {"shown", "show"},   {"done", "do"},
      {"torn", "tear"},      {"lit", "light"},    {"brought", "bring"},
      {"bought", "buy"},     {"sold", "sell"},    {"blown", "blow"},
      {"frozen", "freeze"},  {"beaten", "beat"},  {"bitten", "bite"},
      {"chosen", "choose"},  {"woven", "weave"},  {"swung", "swing"}};
  return m;
}

const std::set<std::string>& locative_by_participles() {
  // 'taken' is deliberately absent: caption 'taken by' is almost always
  // the agentive passive ('a photo taken by a man' -> take(man, photo))
  static std::set<std::string> s = {
      "parked", "stopped", "docked", "moored", "placed", "hung",
      "situated", "located", "positioned", "seated", "perched", "mounted",
      "displayed", "lined", "stacked"};
  return s;
}

// mirrors metrics/spice.py LY_NOT_ADVERBS / DROP_WORDS / COORD_ADJECTIVES
const std::set<std::string>& ly_not_adverbs() {
  static std::set<std::string> s = {
      "family", "butterfly", "dragonfly", "firefly", "belly", "jelly",
      "lily", "holly", "dolly", "folly", "gully", "rally", "ally",
      "assembly", "curly", "friendly", "lovely", "early", "elderly",
      "silly", "chilly", "hilly", "lonely", "ugly", "woolly", "wooly",
      "frilly", "sparkly", "wrinkly", "smelly", "jolly", "bubbly", "burly",
      "wobbly", "oily", "grizzly", "prickly", "italy"};
  return s;
}

const std::set<std::string>& drop_words() {
  static std::set<std::string> s = {"together", "very", "quite", "also",
                                    "just", "too", "again", "alone",
                                    "each other"};
  return s;
}

const std::set<std::string>& coord_adjectives() {
  static std::set<std::string> s = {
      "black", "white", "red", "blue", "green", "yellow", "brown", "orange",
      "purple", "pink", "gray", "grey", "gold", "golden", "silver", "tan",
      "beige", "maroon", "teal", "navy", "violet", "turquoise", "cream",
      "dark"};
  return s;
}

// adverbs are never scene-graph nodes (advmod edges carry no content)
bool is_adverb(const std::string& tok) {
  if (drop_words().count(tok)) return true;
  return tok.size() > 3 && tok.compare(tok.size() - 2, 2, "ly") == 0 &&
         !ly_not_adverbs().count(tok);
}

// base verb if tok can be an agent-taking past participle, else ""
std::string participle_base(const std::string& tok) {
  if (locative_by_participles().count(tok)) return "";
  auto it = irregular_participles().find(tok);
  if (it != irregular_participles().end()) return it->second;
  if (tok.size() > 3 && tok.compare(tok.size() - 2, 2, "ed") == 0)
    return tok;
  return "";
}

// True if the conjunct phrase after toks[i] (an 'and'/'or') reaches a
// non-coordinate-adjective head before a clause boundary (mirrors
// _noun_follows): pre-nominal color coordination folds into the noun;
// a terminal color list ('a photo in black and white') keeps the colors
// as real objects.
bool noun_follows(const std::vector<std::string>& toks, size_t i) {
  for (size_t j = i + 1; j < toks.size(); ++j) {
    const std::string& t = toks[j];
    if (determiners().count(t) || pronouns().count(t) || is_adverb(t) ||
        t == "and" || t == "or")
      continue;
    if (prepositions().count(t) || t.find(' ') != std::string::npos ||
        t == "'s" || conjunctions().count(t) || is_verb(t))
      return false;
    if (!coord_adjectives().count(t)) return true;
  }
  return false;
}

std::vector<std::string> tokenize_lower(const std::string& s) {
  std::vector<std::string> out;
  std::string cur;
  for (char ch : s) {
    if (isspace((unsigned char)ch)) {
      if (!cur.empty()) out.push_back(cur);
      cur.clear();
    } else {
      cur += (char)tolower((unsigned char)ch);
    }
  }
  if (!cur.empty()) out.push_back(cur);
  return out;
}

std::string stem(const std::string& w) { return cic_porter_stem(w.c_str()); }

// Porter stem with has/had normalized to 'have' so possessives ('s), 'has'
// and 'have' phrasings of the same relation all match (mirrors _stem_word)
std::string stem_word(const std::string& w) {
  if (w == "has" || w == "had" || w == "have") return "have";
  return stem(w);
}

// relations are stemmed per word ("on top of" stays three words)
std::string stem_rel(const std::string& rel) {
  std::string out, word;
  for (char ch : rel) {
    if (ch == ' ') {
      if (!word.empty()) {
        if (!out.empty()) out += ' ';
        out += stem_word(word);
        word.clear();
      }
    } else {
      word += ch;
    }
  }
  if (!word.empty()) {
    if (!out.empty()) out += ' ';
    out += stem_word(word);
  }
  return out;
}

std::vector<std::string> merge_multiword(const std::vector<std::string>& raw) {
  // split possessive clitics first ("man's" -> "man" + "'s") so the 's
  // handler sees one token form; then merge multiword preps + "each other"
  std::vector<std::string> toks;
  for (const auto& t : raw) {
    if (t.size() > 2 && t.compare(t.size() - 2, 2, "'s") == 0) {
      toks.push_back(t.substr(0, t.size() - 2));
      toks.push_back("'s");
    } else {
      toks.push_back(t);
    }
  }
  static std::vector<std::vector<std::string>> mws = [] {
    auto v = multiword_preps();
    v.push_back({"each", "other"});
    return v;
  }();
  std::vector<std::string> out;
  size_t i = 0;
  while (i < toks.size()) {
    bool matched = false;
    for (const auto& mw : mws) {
      if (i + mw.size() <= toks.size()) {
        bool eq = true;
        for (size_t k = 0; k < mw.size(); ++k)
          if (toks[i + k] != mw[k]) { eq = false; break; }
        if (eq) {
          std::string joined;
          for (size_t k = 0; k < mw.size(); ++k) {
            if (k) joined += ' ';
            joined += mw[k];
          }
          out.push_back(joined);
          i += mw.size();
          matched = true;
          break;
        }
      }
    }
    if (!matched) out.push_back(toks[i++]);
  }
  return out;
}

// union-find over NP-and-NP conjunct pairs -> per-chunk member lists
std::vector<std::vector<int>> conj_groups(
    int n, const std::vector<std::pair<int, int>>& pairs) {
  std::vector<int> parent(n);
  for (int i = 0; i < n; ++i) parent[i] = i;
  auto find = [&](int i) {
    while (parent[i] != i) i = parent[i];
    return i;
  };
  for (auto& [i, j] : pairs) {
    int ri = find(i), rj = find(j);
    if (ri != rj) parent[rj] = ri;
  }
  std::vector<std::vector<int>> members(n);
  for (int i = 0; i < n; ++i) members[find(i)].push_back(i);
  std::vector<std::vector<int>> group(n);
  for (int i = 0; i < n; ++i) group[i] = members[find(i)];
  return group;
}

// tuples serialized as tagged strings: "O\x1f<head>", "A\x1f<head>\x1f<attr>",
// "R\x1f<s>\x1f<rel>\x1f<o>".  Parse mirrors metrics/spice.py parse_tuples:
// multiword preps are single edges; abandoned verb relations become subject
// attributes; copula + bare modifiers attach to the subject; NP-and-NP
// conjuncts group, with relations/verb attributes distributing over the
// group asymmetrically (see the Python docstring for the exact rules).
void parse_tuples(const std::string& caption, std::set<std::string>& tuples) {
  auto toks = merge_multiword(tokenize_lower(caption));
  std::vector<std::pair<std::vector<std::string>, std::string>> chunks;
  std::vector<std::string> cur;
  int pending_subj = -1;
  int pending_conj = -1;   // chunk idx awaiting its 'and'/'or' partner NP
  int pending_adj_merge = -1;  // bare-adjective left conjunct to fold into
                               // the next chunk's attributes
  bool have_rel = false;
  bool rel_is_verb = false;
  bool rel_swap = false;  // passive: emit (new_chunk, rel, pending_subj)
  bool rel_no_climb = false;  // possessive: owned NP is the syntactic head
  int copula_subj = -1;
  std::string pending_rel;
  std::vector<std::tuple<int, std::string, int>> relations;
  std::vector<std::pair<int, std::string>> verb_attrs;
  std::vector<std::pair<int, int>> conj_pairs;
  std::set<int> verb_subjects;  // chunks that got their own verb attr/rel
  std::set<int> rel_objects;    // chunks that are the OBJECT of a relation
  std::set<int> suppressed;     // chunks folded into another (adj conj)
  std::set<int> rel_pinned;     // chunks whose verb a relative pronoun
                                // pinned (no conj redistribution)
  std::map<int, int> climb_link;  // chunk -> older chunk: PP/verb object ->
  // its subject, passive agent -> its patient, right conjunct -> left.
  // A FINITE verb's subject is the clause subject, reached by climbing.

  auto close_chunk = [&]() {
    if (cur.empty()) return;
    if (copula_subj >= 0) {
      // 'X is <mods>': every token modifies X, no new object chunk
      auto& attrs = chunks[copula_subj].first;
      attrs.insert(attrs.end(), cur.begin(), cur.end());
      cur.clear();
      return;
    }
    std::string head = cur.back();
    std::vector<std::string> attrs(cur.begin(), cur.end() - 1);
    chunks.push_back({attrs, head});
    if (pending_adj_merge >= 0) {
      // 'black and white photo': the bare-adjective left conjunct is an
      // attribute of this chunk's head, not an object node.  When the
      // adjective was a preposition's object ('a photo OF a black and
      // white dog'), the relation rewires to this chunk too.
      int src = pending_adj_merge;
      int nw = (int)chunks.size() - 1;
      auto& dst = chunks.back().first;
      dst.insert(dst.end(), chunks[src].first.begin(),
                 chunks[src].first.end());
      dst.push_back(chunks[src].second);
      suppressed.insert(src);
      for (auto& [s, r, o] : relations) {
        if (s == src) s = nw;
        if (o == src) {
          o = nw;
          rel_objects.insert(nw);
        }
      }
      auto cl = climb_link.find(src);
      if (cl != climb_link.end()) climb_link[nw] = cl->second;
      // a pair minted before the fold ('a cat and a BLACK and white dog')
      // must follow the merge target, not the suppressed chunk
      for (auto& [a, b] : conj_pairs) {
        if (a == src) a = nw;
        if (b == src) b = nw;
      }
      for (auto& [kk, vv] : climb_link)
        if (vv == src) vv = nw;
      pending_adj_merge = -1;
    }
    if (pending_conj >= 0) {
      conj_pairs.emplace_back(pending_conj, (int)chunks.size() - 1);
      // the right conjunct sits in the left's clause position, so a
      // following finite verb climbs out of either the same way
      climb_link[(int)chunks.size() - 1] = pending_conj;
      pending_conj = -1;
    }
    if (have_rel && pending_subj >= 0) {
      if (rel_swap) {
        // passive agent: the NEW chunk is the relation subject and the
        // patient (pending_subj) the object — throw(man, ball)
        relations.emplace_back((int)chunks.size() - 1, pending_rel,
                               pending_subj);
        rel_objects.insert(pending_subj);
      } else {
        relations.emplace_back(pending_subj, pending_rel,
                               (int)chunks.size() - 1);
        rel_objects.insert((int)chunks.size() - 1);
        if (rel_is_verb) verb_subjects.insert(pending_subj);
      }
      // both orientations point the NEWEST chunk at its older partner —
      // except possessives, where the new chunk IS the phrase head
      if (!rel_no_climb) climb_link[(int)chunks.size() - 1] = pending_subj;
      have_rel = false;
      rel_is_verb = false;
      rel_swap = false;
      rel_no_climb = false;
    }
    cur.clear();
  };

  auto flush_verb = [&]() {
    // a pending VERB relation abandoned without an object chunk turns into
    // an attribute of its subject (prep relations just drop)
    if (have_rel && rel_is_verb && pending_subj >= 0) {
      verb_attrs.emplace_back(pending_subj, pending_rel);
      verb_subjects.insert(pending_subj);
    }
    if (rel_is_verb) {
      have_rel = false;
      rel_is_verb = false;
      rel_swap = false;
      rel_no_climb = false;
    }
  };

  for (size_t i = 0; i < toks.size(); ++i) {
    std::string tok = toks[i];
    if (tok == "'s" &&
        (cur.empty() || (i + 1 < toks.size() && is_verb(toks[i + 1])))) {
      // bare ("there's", "it's") or pre-verbal ("a man's running") clitic
      // is the 'is' contraction, not a possessive — behave like a copula
      tok = "is";
    }
    std::string base = participle_base(tok);
    if (!base.empty() && i + 1 < toks.size() && toks[i + 1] == "by") {
      // passive agent: '<patient> <participle> by <agent>'; the patient is
      // the copula subject when one climbed ('the ball in the park IS
      // thrown by...' -> ball), else the chunk just built; the 'by' token
      // is consumed here and the agent NP completes the inverted relation
      close_chunk();
      flush_verb();
      int patient = copula_subj;
      copula_subj = -1;
      pending_conj = -1;
      if (patient >= 0 || !chunks.empty()) {
        pending_subj = patient >= 0 ? patient : (int)chunks.size() - 1;
        pending_rel = base;
        have_rel = true;
        rel_is_verb = true;
        rel_swap = true;
        ++i;  // skip the 'by'
        continue;
      }
      // no patient chunk to invert around: fall through (plain word)
    }
    if ((determiners().count(tok) || pronouns().count(tok)) &&
        !(tok == "that" && i + 1 < toks.size() && is_verb(toks[i + 1]))) {
      // 'that' + verb is a relativizer ('a dog that runs'), not the
      // determiner — it falls to the conjunction branch below
      close_chunk();
      copula_subj = -1;
    } else if (is_adverb(tok)) {
      // advmod edges carry no scene-graph content — transparent (checked
      // before the prep branch so the merged 'each other' never becomes
      // a multiword relation)
    } else if (conjunctions().count(tok)) {
      close_chunk();
      flush_verb();
      if ((tok == "that" || tok == "which" || tok == "who") &&
          !chunks.empty()) {
        // relative pronoun: the verb that follows belongs to THIS chunk
        // ('a man holding a dog that runs' -> run(dog)) — no climb out,
        // no conj redistribution to a left conjunct
        climb_link.erase((int)chunks.size() - 1);
        rel_pinned.insert((int)chunks.size() - 1);
      }
      // NP-and-NP grouping: clause-level conjunctions never group, and
      // neither does a left conjunct that already carries its own verb
      pending_conj = -1;
      if ((tok == "and" || tok == "or") && !chunks.empty() &&
          copula_subj < 0) {
        int last = (int)chunks.size() - 1;
        bool all_coord = coord_adjectives().count(chunks[last].second) > 0;
        for (auto& a : chunks[last].first)
          if (!coord_adjectives().count(a)) {
            all_coord = false;
            break;
          }
        if (all_coord && !verb_subjects.count(last) &&
            noun_follows(toks, i)) {
          // adjective-only left conjunct ('black and white photo', 'a
          // photo of a black and white dog', chained colors): fold into
          // the next chunk's attributes, not a conj pair
          pending_adj_merge = last;
        } else if (!verb_subjects.count(last)) {
          pending_conj = last;
        }
      }
    } else if (tok == "'s") {
      // possessive clitic -> the jar's WordNet-normalized 'have' relation
      close_chunk();
      flush_verb();
      copula_subj = -1;
      pending_conj = -1;
      if (!chunks.empty()) {
        pending_subj = (int)chunks.size() - 1;  // binds to the nearest NP
        pending_rel = "have";
        have_rel = true;
        rel_is_verb = true;
        rel_swap = false;
        rel_no_climb = true;
      }
    } else if (prepositions().count(tok) ||
               tok.find(' ') != std::string::npos) {
      close_chunk();
      // a prep right after an object-less verb shares that verb's subject
      // ('a woman holding a baby SITS ON a bench' -> woman, not baby)
      bool had_verb = rel_is_verb && have_rel && pending_subj >= 0;
      flush_verb();
      copula_subj = -1;
      pending_conj = -1;  // a relation intervened: 'and' was clausal
      if (!chunks.empty()) {
        if (!had_verb) pending_subj = (int)chunks.size() - 1;
        pending_rel = tok;
        have_rel = true;
        rel_is_verb = false;
        rel_swap = false;
      }
    } else if (is_verb(tok)) {
      bool part_ing = tok.size() > 3 &&
                      tok.compare(tok.size() - 3, 3, "ing") == 0;
      bool part_ed = tok.size() > 2 &&
                     tok.compare(tok.size() - 2, 2, "ed") == 0;
      if (cur.empty() && copula_subj < 0 &&
          !(rel_is_verb && have_rel) && !copulas().count(tok) &&
          (part_ing || part_ed || irregular_participles().count(tok) ||
           locative_by_participles().count(tok)) &&
          noun_follows(toks, i)) {
        // pre-nominal participle ('beside a PARKED car'): an attribute of
        // the upcoming head, never a relation that would clobber a
        // pending preposition (mirrors the Python tier)
        auto itb = irregular_participles().find(tok);
        cur.push_back(itb != irregular_participles().end() ? itb->second
                                                           : tok);
        continue;
      }
      close_chunk();  // may mint the conjunct NP first (pair forms there)
      flush_verb();
      copula_subj = -1;
      pending_conj = -1;
      if (!chunks.empty()) {
        pending_subj = (int)chunks.size() - 1;
        bool ing = tok.size() > 3 &&
                   tok.compare(tok.size() - 3, 3, "ing") == 0;
        bool ed = tok.size() > 2 && tok.compare(tok.size() - 2, 2, "ed") == 0;
        if (!ing && !ed && !irregular_participles().count(tok)) {
          // FINITE verb: its subject is the clause subject — climb the
          // links
          for (auto it = climb_link.find(pending_subj);
               it != climb_link.end(); it = climb_link.find(pending_subj))
            pending_subj = it->second;
        } else {
          // participles attach locally (acl on the nearest NP) — except
          // out of a chunk whose link target already carries a verb: a
          // participle chain shares one subject ('a woman SITTING on a
          // bench HOLDING a baby' -> hold(woman, baby))
          for (auto it = climb_link.find(pending_subj);
               it != climb_link.end() && verb_subjects.count(it->second);
               it = climb_link.find(pending_subj))
            pending_subj = it->second;
        }
        if (copulas().count(tok)) {
          have_rel = false;
          copula_subj = pending_subj;
        } else {
          // irregular participles record their base form so the relation
          // stem matches active voice ('hung' -> hang)
          auto itb = irregular_participles().find(tok);
          pending_rel = itb != irregular_participles().end() ? itb->second
                                                             : tok;
          have_rel = true;
          rel_is_verb = true;
        }
        rel_swap = false;
      }
    } else {
      cur.push_back(tok);
    }
  }
  close_chunk();
  flush_verb();

  // asymmetric conj propagation (mirrors metrics/spice.py): objects over
  // every pair, subjects only over pairs whose left member is not itself a
  // relation object
  // clausal-parallel dissolution: 'a man wearing a hat AND a woman wearing
  // a dress' — when the right conjunct is itself the SUBJECT of a relation
  // with the same predicate as one whose OBJECT is the left conjunct, the
  // 'and' coordinated two parallel clauses, not two objects of one verb
  // ('a table with plates and a vase OF flowers' keeps the NP attachment)
  std::map<int, std::set<std::string>> subj_rels, obj_rels;
  for (auto& [si, rel, oi] : relations) {
    std::string r = stem_rel(rel);
    subj_rels[si].insert(r);
    obj_rels[oi].insert(r);
  }
  std::vector<std::pair<int, int>> obj_pairs;
  for (auto& [i, j] : conj_pairs) {
    bool clausal = false;
    auto io = obj_rels.find(i);
    auto js = subj_rels.find(j);
    if (io != obj_rels.end() && js != subj_rels.end())
      for (auto& r : io->second)
        if (js->second.count(r)) {
          clausal = true;
          break;
        }
    if (!clausal) obj_pairs.emplace_back(i, j);
  }
  auto obj_group = conj_groups((int)chunks.size(), obj_pairs);
  std::vector<std::pair<int, int>> subj_pairs;
  for (auto& [i, j] : conj_pairs)
    if (!rel_objects.count(i) && !rel_pinned.count(j))
      subj_pairs.emplace_back(i, j);
  auto subj_group = conj_groups((int)chunks.size(), subj_pairs);

  for (int idx = 0; idx < (int)chunks.size(); ++idx) {
    if (suppressed.count(idx)) continue;  // folded into another chunk
    std::string h = stem(chunks[idx].second);
    tuples.insert("O\x1f" + h);
    for (auto& a : chunks[idx].first)
      tuples.insert("A\x1f" + h + "\x1f" + stem(a));
  }
  for (auto& [si, verb] : verb_attrs)
    for (int s : subj_group[si])
      tuples.insert("A\x1f" + stem(chunks[s].second) + "\x1f" +
                    stem_word(verb));
  for (auto& [si, rel, oi] : relations) {
    if (si < (int)chunks.size() && oi < (int)chunks.size())
      for (int s : subj_group[si])
        for (int o : obj_group[oi])
          if (s != o)
            tuples.insert("R\x1f" + stem(chunks[s].second) + "\x1f" +
                          stem_rel(rel) + "\x1f" + stem(chunks[o].second));
  }
}

// --- synonym matching (data-gated; mirrors metrics/spice.py exactly) ---
// stem -> synset group ids; empty = exact matching only
std::map<std::string, std::set<int>> g_spice_syn;

std::vector<std::string> split_us(const std::string& t) {
  std::vector<std::string> out;
  std::string cur;
  for (char ch : t) {
    if (ch == '\x1f') {
      out.push_back(cur);
      cur.clear();
    } else {
      cur += ch;
    }
  }
  out.push_back(cur);
  return out;
}

bool elem_match(const std::string& a, const std::string& b) {
  if (a == b) return true;
  auto ia = g_spice_syn.find(a);
  if (ia == g_spice_syn.end()) return false;
  auto ib = g_spice_syn.find(b);
  if (ib == g_spice_syn.end()) return false;
  for (int g : ia->second)
    if (ib->second.count(g)) return true;
  return false;
}

// jar rule: same category/arity, every element stem-equal or sharing a synset
bool tuple_match(const std::vector<std::string>& c,
                 const std::vector<std::string>& r) {
  if (c.size() != r.size() || c[0] != r[0]) return false;
  for (size_t k = 1; k < c.size(); ++k)
    if (!elem_match(c[k], r[k])) return false;
  return true;
}

// All + Object/Attribute/Relation scores from ONE pairwise sweep: a tuple
// can only match inside its own category (tuple_match requires c[0]==r[0]),
// so per-tuple matched flags serve all four scores — the jar semantics (a
// side's tuple is matched if ANY tuple on the other side is equivalent; the
// two sides' counts can differ) at 1/8th the sweeps.  out = 12 doubles:
// {All, O, A, R} x {p, r, f}.
void score_all(const std::set<std::string>& cand,
               const std::set<std::string>& ref, double* out) {
  std::vector<std::string> cs(cand.begin(), cand.end());
  std::vector<std::string> rs(ref.begin(), ref.end());
  std::vector<char> cm(cs.size(), 0), rm(rs.size(), 0);
  if (!g_spice_syn.empty()) {
    std::vector<std::vector<std::string>> cv, rv;
    for (auto& t : cs) cv.push_back(split_us(t));
    for (auto& t : rs) rv.push_back(split_us(t));
    for (size_t i = 0; i < cv.size(); ++i)
      for (size_t j = 0; j < rv.size(); ++j) {
        if (cm[i] && rm[j]) continue;
        if (tuple_match(cv[i], rv[j])) cm[i] = rm[j] = 1;
      }
  } else {
    for (size_t i = 0; i < cs.size(); ++i) cm[i] = ref.count(cs[i]) > 0;
    for (size_t j = 0; j < rs.size(); ++j) rm[j] = cand.count(rs[j]) > 0;
  }
  const char tags[4] = {0, 'O', 'A', 'R'};
  for (int k = 0; k < 4; ++k) {
    char tag = tags[k];
    int nc = 0, nr = 0, mc = 0, mr = 0;
    for (size_t i = 0; i < cs.size(); ++i)
      if (tag == 0 || cs[i][0] == tag) { ++nc; mc += cm[i]; }
    for (size_t j = 0; j < rs.size(); ++j)
      if (tag == 0 || rs[j][0] == tag) { ++nr; mr += rm[j]; }
    double* o = out + 3 * k;
    if (nc == 0 || nr == 0) {
      o[0] = o[1] = o[2] = 0.0;
      continue;
    }
    double p = (double)mc / nc;
    double rr = (double)mr / nr;
    o[0] = p;
    o[1] = rr;
    o[2] = (p + rr > 0) ? 2 * p * rr / (p + rr) : 0.0;
  }
}

}  // namespace

extern "C" {

// synonym table push (mirrors metrics/spice.py _build_synonyms): payload =
// word groups separated by '\x01', words space-separated; words are lowered
// and Porter-stemmed here, groups with <2 distinct stems dropped.  Empty or
// null payload clears back to exact matching.
int cic_spice_configure(const char* payload) {
  g_spice_syn.clear();
  if (!payload || !*payload) return 0;
  int gid = 0;
  const char* p = payload;
  while (*p) {
    const char* e = strchr(p, '\x01');
    size_t len = e ? (size_t)(e - p) : strlen(p);
    std::string line(p, len);
    std::set<std::string> stems;
    std::string word;
    auto flush = [&]() {
      if (!word.empty()) {
        for (auto& ch : word) ch = (char)tolower((unsigned char)ch);
        stems.insert(stem(word));
        word.clear();
      }
    };
    for (char ch : line) {
      if (isspace((unsigned char)ch)) flush();
      else word += ch;
    }
    flush();
    if (stems.size() >= 2) {
      for (auto& s : stems) g_spice_syn[s].insert(gid);
      ++gid;
    }
    if (!e) break;
    p = e + 1;
  }
  return (int)g_spice_syn.size();
}

// payload: hyp '\x02' ref1 '\x01' ref2 ...
// out: 12 doubles = {All, Object, Attribute, Relation} x {p, r, f}
int cic_spice(const char* payload, double* out) {
  const char* sep = strchr(payload, '\x02');
  if (!sep) return -1;
  std::string hyp(payload, sep - payload);
  std::set<std::string> cand, ref;
  parse_tuples(hyp, cand);
  const char* p = sep + 1;
  while (*p) {
    const char* e = strchr(p, '\x01');
    size_t len = e ? (size_t)(e - p) : strlen(p);
    parse_tuples(std::string(p, len), ref);
    if (!e) break;
    p = e + 1;
  }
  score_all(cand, ref, out);  // {All, Object, Attribute, Relation} x {p,r,f}
  return 0;
}

}  // extern "C"
