from .vocab_mask import coco_synonyms, coco_vocab_mask

__all__ = ["coco_synonyms", "coco_vocab_mask"]
