from .preprocess import (CAPTION_TEMPLATES, CLASSIFICATION_TEMPLATES,
                         DETECTION_TEMPLATES, dump_samples,
                         preprocess_captions, preprocess_classification,
                         preprocess_detection, preprocess_vqa)
from .splits import (AssignCocoCategories, lemmatize, split_categories,
                     split_data_by_categories, split_images)
from .vocab_builder import build_vocab, iter_dataset_answers, write_vocab

# vocab_embed builds the BERT tower; resolve lazily so that
# `import gpv_tpu_torch.data` for the pure-python offline pipeline does
# not build it
_LAZY = {"embed_vocab": "vocab_embed", "write_vocab_embed": "vocab_embed"}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(mod, name)
    raise AttributeError(name)


__all__ = [
    "CAPTION_TEMPLATES", "CLASSIFICATION_TEMPLATES", "DETECTION_TEMPLATES",
    "dump_samples", "preprocess_captions", "preprocess_classification",
    "preprocess_detection", "preprocess_vqa",
    "AssignCocoCategories", "lemmatize", "split_categories",
    "split_data_by_categories", "split_images",
    "build_vocab", "iter_dataset_answers", "write_vocab",
    "embed_vocab", "write_vocab_embed",
]
