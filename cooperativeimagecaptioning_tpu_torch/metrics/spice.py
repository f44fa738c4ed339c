"""SPICE-lite: scene-graph tuple F-score (replaces spice-1.0.jar + CoreNLP,
ref: coco-caption/pycocoevalcap/spice/spice.py — a missing large blob even in
the reference checkout, and soft-disabled in its model selection,
train.py:264-267).

The Java SPICE parses captions with a trained dependency parser; SPICE-lite uses
a rule-based shallow parse tuned for caption-style English:
  * noun-phrase chunks from closed-class word lists (determiners, prepositions,
    copulas) + morphological verb heuristics;
  * tuples: (object), (object, attribute), (subject, relation, object);
  * matching by Porter-stem equality; per-image F1 of candidate tuples against
    the union of reference tuples, with category sub-scores (Object/Attribute/
    Relation) in the same output contract as the jar
    ({'All': {'f','p','r'}, 'Object': ..., ...}).

Synonym matching (the jar's WordNet-synset tuple equivalence) is data-gated
like METEOR's synonym stage: supply synset groups via CIC_SPICE_SYNONYMS
(a synonyms.txt: one whitespace-separated word group per line) or reuse
$CIC_METEOR_DATA/synonyms.txt, and tuples match element-wise by
stem-equality OR shared synset — exactly the jar's matching rule.  WordNet
itself is a missing blob upstream, so without data the matcher reduces
bit-identically to exact stem matching.

Documented divergence: no trained dependency parser — scores are comparable
across models evaluated with this implementation, not with jar-computed
numbers.

The port's own copy of the JAX package's metrics/spice.py; its C++ tier is
native/cic_spice.cpp (used once built, held equal to this module).
"""

from __future__ import annotations

import os

import numpy as np

from cooperativeimagecaptioning_tpu_torch.metrics.porter import stem

DETERMINERS = {"a", "an", "the", "this", "that", "these", "those", "some",
               "any", "each", "every", "no", "another", "its", "his", "her",
               "their", "our", "my", "your"}
PREPOSITIONS = {"in", "on", "at", "of", "with", "by", "for", "from", "to",
                "into", "onto", "over", "under", "above", "below", "near",
                "beside", "between", "behind", "through", "across", "around",
                "against", "along", "inside", "outside", "next", "atop",
                "amid", "among", "off", "up", "down", "out"}
COPULAS = {"is", "are", "was", "were", "be", "been", "being", "seems",
           "looks", "appears"}
CONJUNCTIONS = {"and", "or", "while", "as", "that", "which", "who"}
COMMON_VERBS = {"has", "have", "had", "holds", "holding", "hold", "wears",
                "wearing", "wear", "sits", "sitting", "sit", "stands",
                "standing", "stand", "rides", "riding", "ride", "walks",
                "walking", "walk", "runs", "running", "run", "plays",
                "playing", "play", "eats", "eating", "eat", "drinks",
                "drinking", "drink", "jumps", "jumping", "jump", "flies",
                "flying", "fly", "looks", "looking", "look", "carries",
                "carrying", "carry", "uses", "using", "use", "throws",
                "throwing", "throw", "catches", "catching", "catch", "hangs",
                "hanging", "hang", "lies", "lying", "lie", "leans", "leaning",
                "parked", "covered", "filled", "topped", "surrounded"}
NOUN_ING_EXCEPTIONS = {"building", "painting", "clothing", "ceiling",
                       "lightning", "morning", "evening", "dining", "living",
                       "wedding", "railing", "awning", "icing"}
# SPICE's scene graphs use compound spatial relations as single edges
# ("on top of" in the paper's fig. 1 girl->court example) — merge them
# before chunking so "top" never becomes a spurious object node
MULTIWORD_PREPS = (("on", "top", "of"), ("in", "front", "of"),
                   ("in", "back", "of"), ("next", "to"), ("close", "to"),
                   ("out", "of"))
# pronouns never become scene-graph objects (the jar's parse drops them);
# chunk-boundary treatment mirrors determiners
PRONOUNS = {"there", "it", "he", "she", "they", "we", "you", "i",
            "them", "him", "us", "me", "itself", "himself", "herself"}
# passive voice: '<patient> (is) <participle> by <agent>' inverts to the
# active relation (CoreNLP's nsubjpass+agent edges, which the jar's scene
# graph renders as verb(agent, patient)).  Irregular participles map to the
# base form so the relation stem matches active-voice references ('thrown'
# and 'throwing'/'throws' all land on 'throw'); regular -ed forms keep the
# surface token (the Porter stem already strips -ed).
IRREGULAR_PARTICIPLES = {
    "thrown": "throw", "eaten": "eat", "worn": "wear", "ridden": "ride",
    "driven": "drive", "drawn": "draw", "broken": "break", "hidden": "hide",
    "written": "write", "taken": "take", "given": "give", "made": "make",
    "held": "hold", "hung": "hang", "seen": "see", "caught": "catch",
    "built": "build", "flown": "fly", "grown": "grow", "shown": "show",
    "done": "do", "torn": "tear", "lit": "light", "brought": "bring",
    "bought": "buy", "sold": "sell", "blown": "blow",
    "frozen": "freeze", "beaten": "beat", "bitten": "bite",
    "chosen": "choose", "woven": "weave", "swung": "swing",
}
# ('left' is deliberately absent: 'the man on the left by the window' is a
#  noun use far more common in captions than the leave-passive.)
# participles whose following 'by' is locative, not an agent marker
# ('a car parked by a fence' must stay park(car) + by(car, fence)); these
# still parse as verbs (_is_verb) so the participle-attribute path applies
LOCATIVE_BY_PARTICIPLES = {"parked", "stopped", "docked", "moored",
                           "placed", "hung", "situated", "located",
                           "positioned", "seated", "perched", "mounted",
                           "displayed", "lined", "stacked"}
# ('taken' is deliberately absent: caption 'taken by' is almost always the
#  agentive passive — 'a photo taken by a man' -> take(man, photo))
# adverbs are never scene-graph nodes (CoreNLP advmod edges are dropped by
# the jar's scene-graph rules): -ly tokens are discarded unless they are
# caption nouns/adjectives that happen to end in -ly
LY_NOT_ADVERBS = {"family", "butterfly", "dragonfly", "firefly", "belly",
                  "jelly", "lily", "holly", "dolly", "folly", "gully",
                  "rally", "ally", "assembly", "curly", "friendly", "lovely",
                  "early", "elderly", "silly", "chilly", "hilly", "lonely",
                  "ugly", "woolly", "wooly", "frilly", "sparkly", "wrinkly",
                  "smelly", "jolly", "bubbly", "burly", "wobbly", "oily",
                  "grizzly", "prickly", "italy"}
# bare adverbial fillers with no scene-graph content ('each other' is merged
# to one token by the pre-pass so reciprocals don't mint an 'other' object)
DROP_WORDS = {"together", "very", "quite", "also", "just", "too", "again",
              "alone", "each other"}
# bare adjectives that coordinate BEFORE a noun ('a black and white photo'):
# the left conjunct folds into the next chunk's attributes instead of
# minting a fake object node (CoreNLP would tag these JJ and emit amod
# edges, not a conj of NPs)
COORD_ADJECTIVES = {"black", "white", "red", "blue", "green", "yellow",
                    "brown", "orange", "purple", "pink", "gray", "grey",
                    "gold", "golden", "silver", "tan", "beige", "maroon",
                    "teal", "navy", "violet", "turquoise", "cream", "dark"}


def _participle_base(tok: str):
    """Base verb if tok can be an agent-taking past participle, else None."""
    if tok in LOCATIVE_BY_PARTICIPLES:
        return None
    if tok in IRREGULAR_PARTICIPLES:
        return IRREGULAR_PARTICIPLES[tok]
    if tok.endswith("ed") and len(tok) > 3:
        return tok
    return None


def _is_verb(tok: str) -> bool:
    if tok in COPULAS or tok in COMMON_VERBS \
            or tok in LOCATIVE_BY_PARTICIPLES:
        return True
    if tok.endswith("ing") and len(tok) > 4 and tok not in NOUN_ING_EXCEPTIONS:
        return True
    return False


def _merge_multiword(toks):
    # split possessive clitics first ("man's" -> "man" + "'s"; PTB-tokenized
    # input already arrives split) so the 's handler sees one token form
    split = []
    for t in toks:
        if len(t) > 2 and t.endswith("'s"):
            split.extend((t[:-2], "'s"))
        else:
            split.append(t)
    toks = split
    out, i = [], 0
    mws = MULTIWORD_PREPS + (("each", "other"),)
    while i < len(toks):
        for mw in mws:
            if tuple(toks[i:i + len(mw)]) == mw:
                out.append(" ".join(mw))
                i += len(mw)
                break
        else:
            out.append(toks[i])
            i += 1
    return out


def _stem_word(w: str) -> str:
    """Porter stem, with has/had normalized to 'have' so possessives ('s),
    'has' and 'have' phrasings of the same relation all match (Porter leaves
    these irregulars apart: has->ha, have->have)."""
    if w in ("has", "had", "have"):
        return "have"
    return stem(w)


def _stem_rel(rel: str) -> str:
    """Relations are stemmed per word ('on top of' stays three words)."""
    return " ".join(_stem_word(w) for w in rel.split())


def _is_adverb(tok: str) -> bool:
    return (tok in DROP_WORDS
            or (tok.endswith("ly") and len(tok) > 3
                and tok not in LY_NOT_ADVERBS))


def _noun_follows(toks, i):
    """True if the conjunct phrase after toks[i] (an 'and'/'or') reaches a
    non-coordinate-adjective head before a clause boundary — distinguishes
    pre-nominal color coordination ('black and white dog' folds into the
    noun, even through a chain 'black and white and brown dog') from a
    terminal color list ('a photo in black and white'), where the colors
    ARE the objects."""
    j = i + 1
    while j < len(toks):
        t = toks[j]
        if (t in DETERMINERS or t in PRONOUNS or _is_adverb(t)
                or t in ("and", "or")):
            j += 1
            continue
        if (t in PREPOSITIONS or " " in t or t == "'s" or t in CONJUNCTIONS
                or _is_verb(t)):
            return False
        if t not in COORD_ADJECTIVES:
            return True
        j += 1
    return False


def parse_tuples(caption: str):
    """Shallow parse -> set of stemmed tuples.

    Beyond plain NP chunking (tuned on the SPICE paper's published parses,
    tests/test_spice_golden.py):
      * multiword prepositions are single relation edges;
      * a verb whose object never materializes (intransitive / participle
        before a preposition) becomes an ATTRIBUTE of its subject — the
        paper's fig. 1 renders 'standing' as an attribute of 'girl';
      * copula + bare modifier ('the table is white') attaches the modifier
        to the subject instead of minting a fake 'white' object;
      * NP-and-NP conjuncts form a group and relations/verb attributes
        distribute over it ('a man and a woman sitting on a bench' puts
        both on the bench; 'a table with plates and cups' links both to
        the table) — mirroring CoreNLP's enhanced conj:and propagation,
        which the jar's scene-graph rules run on.  The propagation is
        asymmetric like the enhanced dependencies: a left conjunct that
        already carries its own verb blocks grouping ('a dog running and
        a cat sleeping' stays two clauses), and a left conjunct that is a
        relation OBJECT shares only that object role ('riding a horse and
        a dog running' adds ride->dog but keeps 'running' on the dog);
      * passive voice with an agent ('a ball is thrown by a man', reduced
        relative 'a frisbee thrown by a man') inverts to the active
        relation throw(man, ball) — CoreNLP's nsubjpass+agent edges, which
        the jar's scene-graph rules render as verb(agent, patient).
        Detected by one-token lookahead (participle followed by 'by'), so
        every other participle keeps the attribute behavior ('the door is
        closed' -> close(door)); locative-'by' participles ('a car parked
        by a fence') are excluded, and conjoined agents distribute
        ('thrown by a man and a woman' -> both throw);
      * a FINITE verb's subject is the clause subject, found by climbing
        out of PP/verb-object chunks ('an old man with a cane walks' ->
        walk(man)); participles (-ing/-ed) attach locally like CoreNLP acl
        edges, and a relative pronoun pins the following verb to its head
        ('a man holding a dog that runs' -> run(dog));
      * adverbs (advmod edges) are transparent — no scene-graph content;
      * a bare-adjective left conjunct folds into the following chunk's
        attributes ('a black and white photo' -> photo+black+white, no
        fake 'black' object);
      * the possessive clitic is the jar's WordNet-normalized 'have'
        relation ("a man's hat" == 'a man has a hat' -> have(man, hat))."""
    toks = _merge_multiword(caption.lower().split())
    chunks = []       # list of (attrs, head)
    relations = []    # (subj_chunk_idx, rel, obj_chunk_idx)
    verb_attrs = []   # (subj_chunk_idx, verb) — unconsumed verb relations
    conj_pairs = []   # (left_chunk_idx, right_chunk_idx) NP-and-NP conjuncts
    verb_subjects = set()  # chunk idxs that got their own verb attr/relation
    rel_objects = set()    # chunk idxs that are the OBJECT of some relation
    suppressed = set()     # chunk idxs folded into another chunk (adj conj)
    rel_pinned = set()     # chunk idxs whose verb a relative pronoun pinned
    # ('a man and a dog that runs': run stays on the dog — the conj pair
    # must not redistribute it back to the left conjunct)
    climb_link = {}   # chunk idx -> older chunk idx: PP/verb object -> its
    # subject, passive agent -> its patient.  A FINITE verb's subject is the
    # clause subject, reached by climbing these links from the last chunk
    # ('an old man with a cane walks' -> walk attaches to man, not cane).
    cur = []
    pending_rel = None
    pending_subj = None
    pending_conj = None  # chunk idx awaiting its 'and'/'or' partner NP
    pending_adj_merge = None  # bare-adjective left conjunct to fold into
    # the next chunk's attributes ('black and white photo')
    rel_is_verb = False
    rel_swap = False    # passive: emit (new_chunk, rel, pending_subj) instead
    rel_no_climb = False  # possessive: the owned NP is the syntactic head
    copula_subj = None  # chunk idx whose post-copula modifiers are attrs

    def close_chunk():
        nonlocal cur, pending_rel, pending_subj, rel_is_verb, pending_conj, \
            rel_swap, pending_adj_merge, rel_no_climb
        if not cur:
            return
        if copula_subj is not None:
            # 'X is <mods>': every token modifies X, no new object chunk
            chunks[copula_subj][0].extend(cur)
            cur = []
            return
        head = cur[-1]
        attrs = cur[:-1]
        chunks.append((attrs, head))
        if pending_adj_merge is not None:
            # 'black and white photo': the bare-adjective left conjunct is
            # an attribute of this chunk's head, not an object node.  When
            # the adjective was a preposition's object ('a photo OF a black
            # and white dog'), the relation rewires to this chunk too.
            src = pending_adj_merge
            new = len(chunks) - 1
            attrs.extend(chunks[src][0] + [chunks[src][1]])
            suppressed.add(src)
            for k, (s, r, o) in enumerate(relations):
                s2 = new if s == src else s
                o2 = new if o == src else o
                if (s2, o2) != (s, o):
                    relations[k] = (s2, r, o2)
                    if o2 == new:
                        rel_objects.add(new)
            if src in climb_link:
                climb_link[new] = climb_link[src]
            for k, (a, b) in enumerate(conj_pairs):
                # a pair minted before the fold ('a cat and a BLACK and
                # white dog') must follow the merge target, not the
                # suppressed chunk
                conj_pairs[k] = (new if a == src else a,
                                 new if b == src else b)
            for kk in list(climb_link):
                if climb_link[kk] == src:
                    climb_link[kk] = new
            pending_adj_merge = None
        if pending_conj is not None:
            conj_pairs.append((pending_conj, len(chunks) - 1))
            # the right conjunct sits in the left's clause position, so a
            # following finite verb climbs out of either the same way
            climb_link[len(chunks) - 1] = pending_conj
            pending_conj = None
        if pending_rel is not None and pending_subj is not None:
            if rel_swap:
                # passive agent: the NEW chunk is the relation subject and
                # the patient (pending_subj) the object — throw(man, ball)
                relations.append((len(chunks) - 1, pending_rel, pending_subj))
                rel_objects.add(pending_subj)
            else:
                relations.append((pending_subj, pending_rel, len(chunks) - 1))
                rel_objects.add(len(chunks) - 1)
                if rel_is_verb:
                    verb_subjects.add(pending_subj)
            # both orientations point the NEWEST chunk at its older partner
            # — except possessives, where the new chunk IS the phrase head
            # ("the man's dog runs": run belongs to the dog)
            if not rel_no_climb:
                climb_link[len(chunks) - 1] = pending_subj
            pending_rel = None
            rel_is_verb = False
            rel_swap = False
            rel_no_climb = False
        cur = []

    def flush_verb():
        # a pending VERB relation abandoned without an object chunk turns
        # into an attribute of its subject (prep relations just drop)
        nonlocal pending_rel, rel_is_verb, rel_swap, rel_no_climb
        if pending_rel is not None and rel_is_verb and pending_subj is not None:
            verb_attrs.append((pending_subj, pending_rel))
            verb_subjects.add(pending_subj)
        if rel_is_verb:
            pending_rel = None
            rel_is_verb = False
            rel_swap = False
            rel_no_climb = False

    i = 0
    while i < len(toks):
        tok = toks[i]
        if tok == "'s" and not (cur and not (
                i + 1 < len(toks) and _is_verb(toks[i + 1]))):
            # bare ("there's", "it's") or pre-verbal ("a man's running")
            # clitic is the 'is' contraction, not a possessive — behave
            # exactly like the copula token it contracts
            tok = "is"
        base = _participle_base(tok)
        if base is not None and i + 1 < len(toks) and toks[i + 1] == "by":
            # passive agent: '<patient> <participle> by <agent>'.  The
            # patient is the copula subject when one climbed ('the ball in
            # the park IS thrown by...' -> ball, not park), else the chunk
            # just built; the agent NP that follows completes the inverted
            # relation in close_chunk.  The 'by' token is consumed here.
            close_chunk()
            flush_verb()
            patient = copula_subj
            copula_subj = None
            pending_conj = None
            if patient is not None or chunks:
                pending_subj = patient if patient is not None \
                    else len(chunks) - 1
                pending_rel = base
                rel_is_verb = True
                rel_swap = True
                i += 2
                continue
            # no patient chunk to invert around: fall through and let the
            # participle behave as a plain word
        if (tok in DETERMINERS or tok in PRONOUNS) and not (
                tok == "that" and i + 1 < len(toks)
                and _is_verb(toks[i + 1])):
            # 'that' + verb is a relativizer ('a dog that runs'), not the
            # determiner — it falls to the conjunction branch below
            close_chunk()
            copula_subj = None
        elif _is_adverb(tok):
            # advmod edges carry no scene-graph content — the token is
            # transparent (checked before the prep branch so the merged
            # 'each other' never becomes a multiword relation)
            pass
        elif tok in CONJUNCTIONS:
            close_chunk()
            flush_verb()
            if tok in ("that", "which", "who") and chunks:
                # relative pronoun: the verb that follows belongs to THIS
                # chunk ('a man holding a dog that barks' -> bark(dog)),
                # so it must not climb out of it — nor distribute back to
                # a left conjunct ('a man and a dog that runs')
                climb_link.pop(len(chunks) - 1, None)
                rel_pinned.add(len(chunks) - 1)
            # NP-and-NP grouping: the chunk just closed awaits a partner.
            # Clause-level conjunctions (while/as/that/...) never group, and
            # neither does a left conjunct that already carries its own verb
            # ('a dog RUNNING and a cat sleeping' is two clauses, not a pair)
            pending_conj = None
            if tok in ("and", "or") and chunks and copula_subj is None:
                last = len(chunks) - 1
                if (chunks[last][1] in COORD_ADJECTIVES
                        and all(a in COORD_ADJECTIVES
                                for a in chunks[last][0])
                        and last not in verb_subjects
                        and _noun_follows(toks, i)):
                    # adjective-only left conjunct ('black and white photo',
                    # 'a photo of a black and white dog', chained 'black and
                    # white and brown'): fold into the next chunk's
                    # attributes, not a conj pair
                    pending_adj_merge = last
                elif last not in verb_subjects:
                    pending_conj = last
        elif tok == "'s":
            # possessive clitic -> the jar's WordNet-normalized 'have'
            # relation, so "a man's hat" / "a man has a hat" / stemmed
            # 'have' phrasings all produce the same tuple
            close_chunk()
            flush_verb()
            copula_subj = None
            pending_conj = None
            if chunks:
                pending_subj = len(chunks) - 1  # binds to the nearest NP
                pending_rel = "have"
                rel_is_verb = True
                rel_swap = False
                rel_no_climb = True
        elif tok in PREPOSITIONS or " " in tok:
            close_chunk()
            # a prep right after an object-less verb shares that verb's
            # subject ('a woman holding a baby SITS ON a bench' -> the
            # climbed subject woman, not the last chunk baby)
            had_verb = rel_is_verb and pending_rel is not None \
                and pending_subj is not None
            flush_verb()
            copula_subj = None
            pending_conj = None  # a relation intervened: 'and' was clausal
            if chunks:
                if not had_verb:
                    pending_subj = len(chunks) - 1
                pending_rel = tok
                rel_is_verb = False
                rel_swap = False
        elif _is_verb(tok):
            if (not cur and copula_subj is None
                    and not (rel_is_verb and pending_rel is not None)
                    and tok not in COPULAS
                    and (tok.endswith("ed") or tok.endswith("ing")
                         or tok in IRREGULAR_PARTICIPLES
                         or tok in LOCATIVE_BY_PARTICIPLES)
                    and _noun_follows(toks, i)):
                # pre-nominal participle ('beside a PARKED car', 'a
                # STANDING man'): CoreNLP tags these amod — an attribute
                # of the upcoming head, never a relation that would
                # clobber a pending preposition
                cur.append(IRREGULAR_PARTICIPLES.get(tok, tok))
                i += 1
                continue
            close_chunk()  # may mint the conjunct NP first (pair forms there)
            flush_verb()
            copula_subj = None
            pending_conj = None
            if chunks:
                pending_subj = len(chunks) - 1
                if not tok.endswith("ing") and not tok.endswith("ed") \
                        and tok not in IRREGULAR_PARTICIPLES:
                    # FINITE verb: its subject is the clause subject, not
                    # the nearest PP/verb object — climb the dependency
                    # links ('an old man with a cane walks' -> walk(man)).
                    while pending_subj in climb_link:
                        pending_subj = climb_link[pending_subj]
                else:
                    # participles attach locally (CoreNLP acl on the
                    # nearest NP) — EXCEPT out of a chunk whose link
                    # target already carries a verb: that is a participle
                    # chain sharing one subject ('a woman SITTING on a
                    # bench HOLDING a baby' -> hold(woman, baby))
                    while pending_subj in climb_link \
                            and climb_link[pending_subj] in verb_subjects:
                        pending_subj = climb_link[pending_subj]
                if tok in COPULAS:
                    pending_rel = None
                    copula_subj = pending_subj
                else:
                    # irregular participles record their base form so the
                    # relation stem matches active voice ('hung' -> hang)
                    pending_rel = IRREGULAR_PARTICIPLES.get(tok, tok)
                    rel_is_verb = True
                rel_swap = False
        else:
            cur.append(tok)
        i += 1
    close_chunk()
    flush_verb()

    # Conjunct groups, asymmetric like CoreNLP's enhanced conj propagation:
    # OBJECT roles distribute over every pair, but SUBJECT roles (verb attrs
    # + relation subjects) only over pairs whose left member is not itself a
    # relation object ('riding a horse and a dog' shares the ride edge with
    # the dog without the dog's own modifiers leaking back to the horse).
    def _union_find(pairs):
        parent = list(range(len(chunks)))

        def find(i):
            while parent[i] != i:
                i = parent[i]
            return i

        for i, j in pairs:
            ri, rj = find(i), find(j)
            if ri != rj:
                parent[rj] = ri
        members = {}
        for i in range(len(chunks)):
            members.setdefault(find(i), []).append(i)
        return lambda i: members[find(i)]

    # clausal-parallel dissolution: 'a man wearing a hat AND a woman wearing
    # a dress' — when the right conjunct is itself the SUBJECT of a relation
    # with the same predicate as one whose OBJECT is the left conjunct, the
    # 'and' coordinated two parallel clauses, not two objects of one verb.
    # ('a table with plates and a vase OF flowers' keeps the NP attachment:
    # the predicates differ.)
    subj_rels, obj_rels = {}, {}
    for si, rel, oi in relations:
        r = _stem_rel(rel)
        subj_rels.setdefault(si, set()).add(r)
        obj_rels.setdefault(oi, set()).add(r)
    obj_group = _union_find(
        [(i, j) for i, j in conj_pairs
         if not (obj_rels.get(i, set()) & subj_rels.get(j, set()))])
    subj_group = _union_find([(i, j) for i, j in conj_pairs
                              if i not in rel_objects
                              and j not in rel_pinned])

    tuples = set()
    for idx, (attrs, head) in enumerate(chunks):
        if idx in suppressed:
            continue  # folded into another chunk's attributes (adj conj)
        h = stem(head)
        tuples.add(("O", h))
        for a in attrs:
            tuples.add(("A", h, stem(a)))
    for si, verb in verb_attrs:
        for s in subj_group(si):
            tuples.add(("A", stem(chunks[s][1]), _stem_word(verb)))
    for si, rel, oi in relations:
        if si < len(chunks) and oi < len(chunks):
            for s in subj_group(si):
                for o in obj_group(oi):
                    if s != o:
                        tuples.add(("R", stem(chunks[s][1]), _stem_rel(rel),
                                    stem(chunks[o][1])))
    return tuples


# --- synonym matching (data-gated; the jar's WordNet tuple equivalence) ---

_SYNONYMS = None   # None = not loaded yet; {} = no data; {stem: frozenset(gid)}


def _build_synonyms(groups):
    """Word groups -> {stem: frozenset(group ids)} (stems may recur)."""
    table = {}
    gid = 0
    for group in groups:
        stems = {stem(w.lower()) for w in group}
        if len(stems) < 2:
            continue  # a single-stem group can never change a match
        for s in stems:
            table.setdefault(s, set()).add(gid)
        gid += 1
    return {k: frozenset(v) for k, v in table.items()}


def configure_synonyms(groups=None, path=None):
    """Activate synset matching from word groups or a synonyms.txt (one
    whitespace-separated group per line).  None/empty clears back to exact
    matching.  The native tier is kept in lockstep."""
    global _SYNONYMS
    if path is not None:
        with open(path, encoding="utf-8") as f:
            groups = [line.split() for line in f if len(line.split()) > 1]
    _SYNONYMS = _build_synonyms(groups) if groups else {}
    _push_native_synonyms(groups or [])
    return _SYNONYMS


def _synonyms():
    """Lazy env-configured table: CIC_SPICE_SYNONYMS file, else
    $CIC_METEOR_DATA/synonyms.txt (one WordNet materialization serves both
    METEOR and SPICE)."""
    global _SYNONYMS
    if _SYNONYMS is None:
        path = os.environ.get("CIC_SPICE_SYNONYMS", "")
        if path and not os.path.isfile(path):
            # an explicitly requested table that cannot be honored must not
            # silently degrade to exact matching (scores would be
            # incomparable with synonym-on runs)
            raise FileNotFoundError(
                f"CIC_SPICE_SYNONYMS points at a missing file: {path!r}")
        if not path:
            d = os.environ.get("CIC_METEOR_DATA", "")
            cand = os.path.join(d, "synonyms.txt") if d else ""
            path = cand if cand and os.path.isfile(cand) else ""
        if path and os.path.isfile(path):
            configure_synonyms(path=path)
        else:
            _SYNONYMS = {}
    return _SYNONYMS


def _push_native_synonyms(groups):
    """Mirror the active groups into the C++ tier (no-op if unavailable)."""
    from cooperativeimagecaptioning_tpu_torch.native import bindings
    if bindings.available():
        bindings.spice_configure(groups)


def _elem_match(a: str, b: str, syn: dict) -> bool:
    if a == b:
        return True
    ga = syn.get(a)
    return bool(ga) and not ga.isdisjoint(syn.get(b, frozenset()))


def _tuple_match(c: tuple, r: tuple, syn: dict) -> bool:
    """Jar rule: same category/arity, every element stem-equal or sharing a
    synset."""
    return len(c) == len(r) and c[0] == r[0] and all(
        _elem_match(x, y, syn) for x, y in zip(c[1:], r[1:]))


def _match_flags(cand: set, ref: set, syn: dict):
    """Per-tuple matched flags in ONE pairwise sweep.  A tuple can only
    match inside its own category (_tuple_match requires c[0]==r[0]), so the
    same flags serve the All score and every per-category score — the jar
    semantics (a side's tuple is matched if ANY tuple on the other side is
    equivalent; the two sides' counts can differ) at 1/8th the sweeps."""
    if syn:
        cm = {c: any(_tuple_match(c, r, syn) for r in ref) for c in cand}
        rm = {r: any(_tuple_match(c, r, syn) for c in cand) for r in ref}
    else:
        cm = {c: c in ref for c in cand}
        rm = {r: r in cand for r in ref}
    return cm, rm


def _f1_from_flags(cm: dict, rm: dict, tag=None):
    cs = [m for t, m in cm.items() if tag is None or t[0] == tag]
    rs = [m for t, m in rm.items() if tag is None or t[0] == tag]
    if not cs or not rs:
        return {"p": 0.0, "r": 0.0, "f": 0.0}
    p = sum(cs) / len(cs)
    r = sum(rs) / len(rs)
    f = 2 * p * r / (p + r) if p + r > 0 else 0.0
    return {"p": p, "r": r, "f": f}


CATEGORIES = {"Object": "O", "Attribute": "A", "Relation": "R"}


def sentence_spice(hyp: str, refs: list) -> dict:
    syn = _synonyms()
    cand = parse_tuples(hyp)
    ref = set()
    for r in refs:
        ref |= parse_tuples(r)
    cm, rm = _match_flags(cand, ref, syn)
    out = {"All": _f1_from_flags(cm, rm)}
    for name, tag in CATEGORIES.items():
        out[name] = _f1_from_flags(cm, rm, tag)
    return out


_warned_lite = []


def compute_spice(gts: dict, res: dict):
    """coco-caption contract: (corpus mean F, per-image dicts)."""
    syn = _synonyms()  # also pushes the table to the native tier
    if not _warned_lite:
        _warned_lite.append(True)
        syn_note = ("synonym matching ON (%d synset stems)" % len(syn)
                    if syn else "synonym matching off — provide synsets via "
                    "CIC_SPICE_SYNONYMS / CIC_METEOR_DATA")
        print("note: SPICE here is SPICE-lite (rule-based shallow parse; "
              "the jar + CoreNLP are missing blobs upstream; %s) — scores "
              "are NOT comparable to jar-computed literature SPICE"
              % syn_note)
    ids = sorted(gts.keys(), key=lambda x: str(x))
    from cooperativeimagecaptioning_tpu_torch.native import bindings
    scorer = bindings.spice_sentence if bindings.available() \
        else sentence_spice
    per_image = [scorer(res[i][0], gts[i]) for i in ids]
    mean_f = float(np.mean([p["All"]["f"] for p in per_image]))
    return mean_f, per_image
