from .treebank import detokenize, word_tokenize
from .vocab import PAD, CLS, STOP, UNK, SPECIAL_TOKENS, AnswerVocab
from .wordpiece import WordPieceTokenizer, basic_tokenize

__all__ = [
    "detokenize", "word_tokenize", "PAD", "CLS", "STOP", "UNK",
    "SPECIAL_TOKENS", "AnswerVocab", "WordPieceTokenizer", "basic_tokenize",
]
