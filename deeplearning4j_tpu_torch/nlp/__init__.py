"""The port's ``nlp``: the BERT data pipeline (WordPiece tokenizer and
``BertIterator``). The rest of the reference's ``nlp/`` (word2vec,
GloVe, fastText, the tokenizer factories, the vocab) is not ported yet."""

from .bert_iterator import BertIterator, BertWordPieceTokenizer

__all__ = ["BertIterator", "BertWordPieceTokenizer"]
