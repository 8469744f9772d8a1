"""Deterministic POS decisions for the SCE orange/clock special cases
(counterpart of `gpv_tpu/data/pos_gate.py`: every word list and rule
copied as it is; one dropped entry would change which samples the SCE
split discards).

Behavior spec: reference `data/split_data_by_categories.py:73-95` runs
spaCy (`en_core_web_sm`) over the lowercased `query [+ answer]` text and
asks ONE question per special case:

- orange (:75-82): is any "orange"/"oranges" token a NOUN?  If none is,
  the category match is discarded ("what color is the cat -> orange"
  must not tag the fruit category).
- clock  (:83-94): is any "watch"/"watches" token a NOUN?  (A
  sentence-FINAL watch/watches short-circuits to keep BEFORE this scan —
  handled by the caller, `splits.AssignCocoCategories._remove_special`.)

spaCy is not installable in this environment (no egress, not baked in),
but the text this gate ever sees is a CLOSED domain: the fixed task
query templates (`data/preprocess.py`), COCO VQA answers, and COCO
captions — short, present-tense, picture-description English.  Over that
domain, spaCy's NOUN-vs-ADJ (orange) and NOUN-vs-VERB (watch) decisions
are governed by local context, so we vendor them as an explicit
word + local-context decision table instead of a statistical tagger.
Each rule below states the construction it covers and an example from
the corpus; `tests/test_torch_port_data.py` holds these decisions against
the JAX package's on constructed positives/negatives, including the
reference comments' own examples.

Inputs are RAW lowercased word-tokenized text (NOT lemmatized): plural
morphology ("oranges") and inflection ("watches") are themselves POS
evidence, which lemmatization would destroy.
"""
from __future__ import annotations

from typing import List, Sequence

# Tokens that introduce a noun phrase: a following "orange"/"watch" in
# their scope is a nominal head unless an attributive reading fires
# first ("an orange cat").
_DETERMINERS = frozenset((
    "a", "an", "the", "this", "that", "these", "those", "some", "any",
    "no", "each", "every", "another", "other", "both", "few", "several",
    "many", "much", "more", "most", "one", "two", "three", "four",
    "five", "six", "seven", "eight", "nine", "ten",
    "my", "your", "his", "her", "its", "our", "their", "whose", "of",
))

# Subjects/auxiliaries that put a following "watch" in verb position:
# "do you watch tv", "they watch the game", "to watch". NOTE "and" is NOT
# here: coordination is ambiguous ("a hat and watch" = noun conjunct,
# "sit and watch" = verb conjunct) and resolved by the conjunct rule in
# watch_is_noun, which looks at the word BEFORE the "and".
_VERB_TRIGGERS = frozenset((
    "i", "you", "he", "she", "it", "we", "they", "people", "who",
    "to", "can", "could", "will", "would", "shall", "should", "may",
    "might", "must", "do", "does", "did", "don't", "doesn't", "didn't",
    "cannot", "can't", "won't", "not", "n't",
))

# Copulas/linkers whose complement "orange" is a predicate ADJECTIVE:
# "the cat is orange", "the shirt looks orange", "walls painted orange".
_COPULAS = frozenset((
    "is", "are", "was", "were", "be", "being", "been", "looks", "look",
    "appears", "appear", "seems", "seem", "turned", "turning",
    "colored", "coloured", "painted", "dyed", "in",
))

# Compound heads where a preceding "orange" is a NOUN modifier (spaCy
# parses these as noun-noun compounds, not ADJ+N: the modifier keeps
# pos_ == NOUN): "orange juice", "orange peel".
_ORANGE_COMPOUND_HEADS = frozenset((
    "juice", "juices", "peel", "peels", "tree", "trees", "slice",
    "slices", "grove", "groves", "rind", "zest", "segment", "segments",
    "wedge", "wedges", "soda", "marmalade",
))

# Person nouns: subjects for the watch rules ("the man watches"), and
# attributive heads for orange ("an orange man" -> ADJ) — listed apart
# from the object nouns so each gate's lexicon edits stay reviewable.
_PERSON_NOUNS = frozenset((
    "man", "men", "woman", "women", "boy", "boys", "girl", "girls",
    "child", "children", "kid", "kids", "lady", "ladies", "guy", "guys",
    "player", "players",
))

# Concrete objects/animals "orange" attributively modifies in COCO
# captions and VQA answers ("an orange cat", "orange traffic cone").
# ADJ reading.  Vendored from the COCO category list + the high-
# frequency caption nouns the templates/answers can produce; compound
# heads above take precedence.
_OBJECT_NOUNS = frozenset((
    # COCO categories (single-word forms + common plurals)
    "person", "people", "bicycle", "bicycles", "car", "cars",
    "motorcycle", "motorcycles", "airplane", "airplanes", "bus",
    "buses", "train", "trains", "truck", "trucks", "boat", "boats",
    "light", "lights", "hydrant", "hydrants", "sign", "signs",
    "meter", "meters", "bench", "benches", "bird", "birds", "cat",
    "cats", "dog", "dogs", "horse", "horses", "sheep", "cow", "cows",
    "elephant", "elephants", "zebra", "zebras", "giraffe", "giraffes",
    "backpack", "backpacks", "umbrella", "umbrellas", "handbag",
    "handbags", "tie", "ties", "suitcase", "suitcases", "frisbee",
    "frisbees", "skis", "snowboard", "snowboards", "ball", "balls",
    "kite", "kites", "bat", "bats", "glove", "gloves", "skateboard",
    "skateboards", "surfboard", "surfboards", "racket", "rackets",
    "bottle", "bottles", "glass", "glasses", "cup", "cups", "fork",
    "forks", "knife", "knives", "spoon", "spoons", "bowl", "bowls",
    "banana", "bananas", "apple", "apples", "sandwich", "sandwiches",
    "broccoli", "carrot", "carrots", "pizza", "pizzas", "donut",
    "donuts", "cake", "cakes", "chair", "chairs", "couch", "couches",
    "plant", "plants", "bed", "beds", "table", "tables", "toilet",
    "toilets", "tv", "laptop", "laptops", "mouse", "remote", "remotes",
    "keyboard", "keyboards", "phone", "phones", "microwave", "oven",
    "ovens", "toaster", "sink", "sinks", "refrigerator", "book",
    "books", "clock", "clocks", "vase", "vases", "scissors", "bear",
    "bears", "drier", "dryer", "toothbrush", "toothbrushes",
    # high-frequency caption/answer nouns
    "shirt", "shirts", "jacket", "jackets", "hat", "hats", "vest",
    "vests", "dress", "dresses", "coat", "coats", "cone", "cones",
    "flower", "flowers", "wall", "walls", "roof", "roofs", "building",
    "buildings", "flag", "flags", "color", "colors", "colour",
    "colours", "fruit", "fruits", "food", "frosting", "icing", "tint",
    "hue", "stripe", "stripes", "jersey", "jerseys", "uniform",
    "uniforms", "helmet", "helmets", "background", "object", "objects",
    "thing", "things", "one", "ones",
))

# Noun-noun compound INTERMEDIATES: modifiers that sit between "orange"
# and its real head ("an orange traffic cone", "orange tennis ball") —
# spaCy tags the "orange" before these ADJ (it modifies the downstream
# head), so they count as attributive context too (else the
# determiner-default would swallow these when the next token is
# outside the head lexicon).
_ATTRIB_INTERMEDIATES = frozenset((
    "traffic", "fire", "stop", "tennis", "baseball", "soccer", "dining",
    "cell", "wine", "teddy", "polar", "street", "parking", "safety",
    "construction", "road", "hard", "life", "ski", "sports",
))

# Colors defined above the synonym closure so the exclusion below can
# reference them (moved from below; contents unchanged).
_COLORS = frozenset((
    "white", "black", "brown", "red", "blue", "green", "yellow",
    "purple", "pink", "gray", "grey", "tan", "gold", "golden",
    "silver", "beige", "maroon", "teal", "cream", "dark", "light",
    "striped",
))


def _synonym_vocabulary_closure():
    """Close the gate lexicons over the vendored synonym vocabulary
    (evaluation/coco_synonyms.json — the exact noun phrases the SCE split
    machinery matches categories against, reference
    data/coco/coco_synonyms.py). Every phrase's LAST word is a nominal
    head ("an orange armchair" -> spaCy ADJ) and every non-last word is a
    noun-noun compound intermediate ("an orange alarm clock" -> ADJ on the
    downstream head); both therefore yield the attributive reading for a
    preceding "orange", and the heads double as noun evidence for the
    watch conjunct/subject rules. This makes the attributive sweep exact
    over the whole category-matchable vocabulary instead of the
    high-frequency subset above.

    Function-word/color collisions are excluded: those tokens already
    carry a more specific rule and must keep it (e.g. "light" stays a
    color/object decided by rule order, "one" a determiner).
    """
    import json
    from pathlib import Path
    syn_path = (Path(__file__).resolve().parent.parent / "evaluation" /
                "coco_synonyms.json")  # the port's copy (package data)
    table = json.loads(syn_path.read_text())
    heads, inters = set(), set()
    for cat, syns in table.items():
        for phrase in set(syns) | {cat}:
            words = phrase.lower().split()
            if not words:
                continue
            heads.add(words[-1])
            inters.update(words[:-1])
    # naive plural forms for the heads: captions pluralize freely
    # ("orange armchairs"); membership-only use means a wrongly formed
    # plural is inert
    plurals = {w + ("es" if w.endswith(("s", "x", "ch", "sh")) else "s")
               for w in heads}
    excluded = (_DETERMINERS | _COPULAS | _VERB_TRIGGERS | _COLORS |
                {"orange", "oranges", "watch", "watches", "and", "or", ""})
    return (frozenset((heads | plurals) - excluded),
            frozenset(inters - excluded))


_SYNONYM_HEADS, _SYNONYM_INTERMEDIATES = _synonym_vocabulary_closure()
_ATTRIB_INTERMEDIATES = _ATTRIB_INTERMEDIATES | _SYNONYM_INTERMEDIATES

# Each gate's lexicon, composed explicitly (a bare alias would couple the
# two gates, so that watch-lexicon edits changed orange decisions). "watch"/"watches" ARE attributive heads for orange ("an
# orange watch" -> ADJ) but stay special-cased in the watch gate itself.
_ORANGE_ADJ_HEADS = (_OBJECT_NOUNS | _PERSON_NOUNS | _SYNONYM_HEADS |
                     frozenset(("watch", "watches")))
_COMMON_NOUNS = _OBJECT_NOUNS | _PERSON_NOUNS | _SYNONYM_HEADS

# (Color words — "orange" coordinated with one is an adjective
# conjunction, "an orange and white dog" -> ADJ — are defined above the
# synonym closure.)

# Function words that can never be the middle token of a noun-noun
# compound — they block the one-token compound lookahead in
# orange_is_noun ("is the orange a fruit" is nominal, not "orange <X>
# fruit" compound-shaped).
_FUNCTION_WORDS = (_DETERMINERS | _COPULAS | _VERB_TRIGGERS
                   | frozenset(("and", "or")))

# Direct objects / particles that put a preceding "watch(es)" in verb
# position: "watch tv", "watch the game", "watch out".
_WATCH_OBJECT_CUES = frozenset((
    "tv", "television", "the", "a", "an", "this", "that", "these",
    "those", "his", "her", "their", "my", "your", "its", "our", "some",
    "it", "them", "him", "me", "us", "out", "over", "for", "movies",
    "movie", "games", "game", "sports", "birds", "what", "where",
))


def orange_is_noun(tokens: Sequence[str], i: int) -> bool:
    """Would spaCy tag tokens[i] ("orange"/"oranges") pos_ == NOUN?

    Decision order (first match wins):
      1. plural "oranges"                       -> NOUN  (NNS)
      2. next token is a compound head          -> NOUN  ("orange juice")
      3. next token is an attributive head or a
         compound intermediate (or the token
         after an unknown one is a head)        -> not   ("orange cat",
                                                          "orange traffic
                                                          cone")
      3b. coordinated/stacked with a color word -> not   ("orange and
                                                          white dog")
      4. previous token is a copula/linker      -> not   ("cat is orange")
      5. previous token is a determiner/number  -> NOUN  ("what color is
                                                          the orange" —
                                                          the fruit IS
                                                          the subject)
      6. a color question precedes it           -> not   ("what color is
                                                          the cat ->
                                                          orange")
      7. default                                -> NOUN  (bare nominal)
    """
    word = tokens[i]
    nxt = tokens[i + 1] if i + 1 < len(tokens) else None
    prev = tokens[i - 1] if i > 0 else None
    if word == "oranges":
        # plural modifiers don't occur in this domain; NNS -> NOUN
        return True
    if nxt in _ORANGE_COMPOUND_HEADS:
        return True
    if nxt in _ORANGE_ADJ_HEADS or nxt in _ATTRIB_INTERMEDIATES:
        return False
    if (nxt is not None and nxt not in _FUNCTION_WORDS
            and i + 2 < len(tokens)
            and tokens[i + 2] in _ORANGE_ADJ_HEADS):
        # next token unknown but the one after is a head noun: treat as a
        # noun-noun compound ("orange safety-vest jacket" shapes) — spaCy
        # attaches "orange" to the downstream head as ADJ. Function words
        # can't be compound intermediates ("is the orange a fruit",
        # "the orange is food", "an orange and banana on a table" are all
        # nominal) so they never trigger the lookahead.
        return False
    if nxt in ("and", "or") and i + 2 < len(tokens) and \
            tokens[i + 2] in _COLORS:
        # adjective conjunction: "an orange and white dog"
        return False
    if prev in _COLORS or (prev in ("and", "or") and i >= 2
                           and tokens[i - 2] in _COLORS):
        # "a white and orange cat", "a black orange ..." — coordinated
        # or stacked color modifiers
        return False
    if prev in _COPULAS:
        return False
    if prev in _DETERMINERS:
        return True
    if "color" in tokens[:i] or "colour" in tokens[:i]:
        # "what color is the cat orange" (query + ' ' + answer): the
        # appended bare answer parses as the question's complement ADJ
        return False
    return True


def watch_is_noun(tokens: Sequence[str], i: int) -> bool:
    """Would spaCy tag tokens[i] ("watch"/"watches") pos_ == NOUN?

    Decision order (first match wins):
      1. previous token is a determiner/number  -> NOUN  ("a watch",
                                                          "two watches")
      2. previous token is a subject/aux/"to"   -> VERB  ("do you watch",
                                                          "to watch")
      2b. "and"-conjunct: decided by the word
          BEFORE the "and" — noun conjunct vs
          verb conjunct                         -> NOUN  ("a hat and
                                                          watch"); VERB
                                                          ("sit and
                                                          watch")
      3. next token is an object/particle cue   -> VERB  ("watch tv",
                                                          "watch the
                                                          game") — this
          outranks a color before the word: "men in red watch the game"
          is a verb even though "red" precedes it
      3b. previous token is a color/material
          modifier (and no object follows)      -> NOUN  ("a gold watch",
                                                          "two gold
                                                          watches")
      4. "watches" with a noun/pronoun subject  -> VERB  ("the man
                                                          watches")
      5. default                                -> NOUN
    """
    word = tokens[i]
    nxt = tokens[i + 1] if i + 1 < len(tokens) else None
    prev = tokens[i - 1] if i > 0 else None
    if prev in _DETERMINERS:
        return True
    if prev in _VERB_TRIGGERS:
        return False
    if prev == "and":
        # conjunction: "a hat and watch" coordinates nouns (the conjunct
        # before the "and" is a noun); "sit and watch" coordinates verbs
        before = tokens[i - 2] if i >= 2 else None
        return before in _COMMON_NOUNS or before in _DETERMINERS or \
            before in ("watch", "watches", "clock", "clocks")
    if nxt in _WATCH_OBJECT_CUES:
        return False
    if prev in _COLORS:
        return True
    if word == "watches" and (prev in _COMMON_NOUNS or
                              prev in ("he", "she", "it", "who")):
        # 3rd-person-singular inflection after a subject: "the man
        # watches ..." (determiner/color directly before was caught above)
        return False
    return True


def any_orange_noun(raw_tokens: List[str]) -> bool:
    """Reference :75-82 — True iff ANY orange/oranges token is a NOUN."""
    return any(orange_is_noun(raw_tokens, i)
               for i, w in enumerate(raw_tokens)
               if w in ("orange", "oranges"))


def any_watch_noun(raw_tokens: List[str]) -> bool:
    """Reference :88-94 — True iff ANY watch/watches token is a NOUN."""
    return any(watch_is_noun(raw_tokens, i)
               for i, w in enumerate(raw_tokens)
               if w in ("watch", "watches"))
