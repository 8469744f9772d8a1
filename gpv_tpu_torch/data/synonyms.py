"""COCO class synonym database (counterpart of `gpv_tpu/data/synonyms.py`).

Behavior spec: reference `data/coco/synonyms.py` ships a hand-curated
80-class synonym table (SYNONYMS) used for classification-eval credit and
SCE category assignment, plus a generator (`data/coco/coco_synonyms.py`)
that seeds candidates before curation. The generator's executed pipeline
(:49-62) is: WordNet lemma names over ALL synsets of the class name →
underscores to spaces, lowercased → add the class name itself → merge the
16-entry hand ALIASES table → for every multiword synonym also add the
concatenated and hyphenated spellings. NOTE the PyDictionary lookup is
commented out in the reference itself (`:50` — `#set(dictionary.synonym(
category))`), so WordNet + ALIASES IS full parity with the executed code;
a PyDictionary object is constructed but never queried.

The curated table lives as data in
`gpv_tpu_torch/evaluation/coco_synonyms.json` (same content, attributed). `generate_candidate_synonyms` reproduces the
seeding step; the curated table remains the source of truth for eval
parity.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Set

from ..evaluation.vocab_mask import coco_synonyms

# resolved lazily via module __getattr__ (PEP 562 only fires for MISSING
# attributes — an eager `SYNONYMS = None` here would shadow it and make
# `from gpv_tpu_torch.data.synonyms import SYNONYMS` permanently None)
SYNONYMS: Dict[str, List[str]]

# Hand-maintained alias table, vendored verbatim from the reference
# generator (`data/coco/coco_synonyms.py:12-28`) — pure data merged into
# every candidate set before curation.
ALIASES: Dict[str, List[str]] = {
    "person": ["people", "man", "woman", "men", "women"],
    "surfboard": ["surf board"],
    "tv": ["television"],
    "toothbrush": ["tooth brush"],
    "dining table": ["dinner table", "table"],
    "motorcycle": ["motor cycle", "motor bike"],
    "handbag": ["hand bag", "bag"],
    "backpack": ["back pack"],
    "airplane": ["air plane", "aeroplane"],
    "couch": ["sofa"],
    "skateboard": ["skate board"],
    "snowboard": ["snow board"],
    "toilet": ["toilette"],
    "sports ball": ["ball", "football", "basketball"],
    "hair drier": ["hair dryer", "dryer", "drier"],
    "baseball glove": ["glove"],
}


def __getattr__(name):
    if name == "SYNONYMS":
        return coco_synonyms()
    raise AttributeError(name)


def _nltk_wordnet_lemmas(word: str) -> Set[str]:
    """Reference `wnsynonyms` (:30-35): lemma names over ALL synsets (every
    POS, no truncation). nltk is imported here, at use (the card machine
    has none). Requires the nltk 'wordnet' corpus; raises
    LookupError otherwise (the corpus is not shipped in every environment —
    the curated table in evaluation/ is what production paths read)."""
    from nltk.corpus import wordnet  # may raise LookupError without data

    syn: Set[str] = set()
    for synset in wordnet.synsets(word):
        for lemma in synset.lemmas():
            syn.add(lemma.name())
    return syn


def generate_candidate_synonyms(
        class_names: Iterable[str],
        wn_lemmas: Optional[Callable[[str], Set[str]]] = None,
) -> Dict[str, List[str]]:
    """Candidate synonyms per class — the reference generator's executed
    pipeline (`data/coco/coco_synonyms.py:49-62`), pre-curation.

    `wn_lemmas(word) -> set of lemma names` defaults to the nltk WordNet
    lookup (LookupError without the corpus); injectable so the merge/
    variant logic is testable corpus-free.
    """
    if wn_lemmas is None:
        wn_lemmas = _nltk_wordnet_lemmas

    out: Dict[str, List[str]] = {}
    for name in class_names:
        cands = {" ".join(s.split("_")).lower() for s in wn_lemmas(name)}
        cands.add(name)
        if name in ALIASES:
            cands.update(ALIASES[name])
        # multiword synonyms also get concatenated + hyphenated spellings
        for syn in list(cands):
            tokens = syn.split(" ")
            if len(tokens) > 1:
                cands.add("".join(tokens))
                cands.add("-".join(tokens))
        out[name] = sorted(cands)
    return out
