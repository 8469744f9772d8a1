from .bleu import bleu_corpus
from .cider import cider_d
from .evaluators import (EVALUATOR_CLASSES, CocoCaptioning,
                         CocoClassification, CocoDetection, CocoVqa,
                         RefCocop)
from .ptb import ptb_tokenize, ptb_tokenize_caption
from .vocab_mask import coco_synonyms, coco_vocab_mask
from .voc_ap import voc_ap

__all__ = [
    "bleu_corpus", "cider_d", "EVALUATOR_CLASSES", "CocoCaptioning",
    "CocoClassification", "CocoDetection", "CocoVqa", "RefCocop",
    "coco_synonyms", "coco_vocab_mask", "ptb_tokenize",
    "ptb_tokenize_caption", "voc_ap",
]
