"""WordNet morphy (noun) — exact algorithm, vendored mini-lexicon
(counterpart of `gpv_tpu/data/morphy.py`, copied as it is).

Behavior spec: the reference SCE split tags categories by comparing
WordNet-lemmatized text tokens against WordNet-lemmatized synonym tokens
(`data/split_data_by_categories.py:20-43`, nltk `WordNetLemmatizer` =
`wordnet._morphy(word, 'n')` + min-by-length). nltk and its WordNet corpus
are absent from this image, so this module reimplements `_morphy` EXACTLY
(exception map -> one rule pass incl. the original -> iterate rules to a
fixpoint; nltk/corpus/reader/wordnet.py) over a VENDORED lexicon instead of
the full 117k-lemma WordNet noun index.

Fidelity argument: lemmas only matter where they meet the
synonym table — a text token influences category assignment iff its lemma
equals some synonym-token lemma. The vendored lexicon contains every
synonym token, every exception lemma reachable from them, and known
WordNet-noun "blockers" that shadow rule paths; on that closure this
function agrees with real WordNet morphy, so subsequence matching decisions
agree. Out-of-closure words may lemmatize differently (returned unchanged
instead of reduced), which cannot change any match.

Exception entries below are copied from WordNet 3.0 `noun.exc` (Princeton
WordNet license) restricted to forms whose lemma or surface can touch the
COCO synonym vocabulary.
"""
from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path
from typing import Iterable

# nltk MORPHOLOGICAL_SUBSTITUTIONS[NOUN], in order
_SUBSTITUTIONS = (
    ("s", ""), ("ses", "s"), ("ves", "f"), ("xes", "x"), ("zes", "z"),
    ("ches", "ch"), ("shes", "sh"), ("men", "man"), ("ies", "y"),
)

# WordNet 3.0 noun.exc subset: inflected form -> lemma(s)
NOUN_EXCEPTIONS = {
    "men": ["man"], "women": ["woman"], "children": ["child"],
    # NOTE deliberately NO "people"->"person": 'people' is itself a WordNet
    # noun, so real WordNetLemmatizer returns 'people' unchanged (the
    # classic lemmatizer gotcha); the synonym table lists 'people'
    # explicitly under person for exactly this reason.
    "mice": ["mouse"], "geese": ["goose"], "feet": ["foot"],
    "teeth": ["tooth"], "knives": ["knife"], "leaves": ["leaf"],
    "loaves": ["loaf"], "lives": ["life"], "wolves": ["wolf"],
    "shelves": ["shelf"], "scarves": ["scarf"], "oxen": ["ox"],
    "dice": ["die"], "busses": ["bus", "buss"],
}

# known WordNet nouns that shadow rule paths for closure-relevant words
# (e.g. 'buss' blocks busses->bus at the first rule round, as real WN does;
# 'glasses' is a WN lemma of its own)
_BLOCKERS = ("buss", "glasses", "people", "clippers", "scissors", "shears",
             "sunglasses", "tongs", "pants", "shorts", "sports")


def _default_tokens() -> Iterable[str]:
    # the port's copy of the synonym table (package data)
    syn_path = (Path(__file__).resolve().parent.parent / "evaluation"
                / "coco_synonyms.json")
    synonyms = json.loads(syn_path.read_text())
    for syns in synonyms.values():
        for phrase in syns:
            yield from phrase.lower().replace("-", " ").split()


def build_lexicon(tokens: Iterable[str] | None = None) -> frozenset:
    """Noun lexicon: the synonym-token closure + exception lemmas +
    blockers. Tokens' own rule-reachable SHORTER forms are NOT added (they
    are only valid lemmas if independently present), matching real WordNet
    membership for this vocabulary."""
    toks = set(tokens) if tokens is not None else set(_default_tokens())
    for form, lemmas in NOUN_EXCEPTIONS.items():
        if form in toks or any(l in toks for l in lemmas):
            toks.update(lemmas)
    # exception FORMS (men, women, knives, ...) are not WordNet lemmas
    # themselves — keeping them in the lexicon would make filter_forms
    # return them and min-by-length tie-break wrongly (men/man are the
    # same length and min() is first-wins)
    toks -= set(NOUN_EXCEPTIONS)
    toks.update(_BLOCKERS)
    return frozenset(toks)


@lru_cache(maxsize=1)
def default_lexicon() -> frozenset:
    return build_lexicon()


def morphy(form: str, lexicon: frozenset) -> list:
    """nltk `wordnet._morphy(form, 'n')` over the given lexicon."""

    def apply_rules(forms):
        return [f[:-len(old)] + new
                for f in forms
                for old, new in _SUBSTITUTIONS if f.endswith(old)]

    def filter_forms(forms):
        seen, out = set(), []
        for f in forms:
            if f in lexicon and f not in seen:
                out.append(f)
                seen.add(f)
        return out

    if form in NOUN_EXCEPTIONS:
        return filter_forms([form] + NOUN_EXCEPTIONS[form])
    forms = apply_rules([form])
    results = filter_forms([form] + forms)
    if results:
        return results
    while forms:
        forms = apply_rules(forms)
        results = filter_forms(forms)
        if results:
            return results
    return []


def lemmatize_noun(word: str, lexicon: frozenset | None = None) -> str:
    """nltk `WordNetLemmatizer.lemmatize(word)` (pos='n'): shortest morphy
    lemma, or the word itself when morphy finds nothing."""
    w = word.lower()
    lemmas = morphy(w, lexicon if lexicon is not None else default_lexicon())
    return min(lemmas, key=len) if lemmas else w
