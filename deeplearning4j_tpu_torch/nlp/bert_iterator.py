"""BERT data pipeline: WordPiece tokenizer + BertIterator — port of
``deeplearning4j_tpu/nlp/bert_iterator.py``.

Reference parity: ``org.deeplearning4j.text.tokenization.tokenizerfactory
.BertWordPieceTokenizerFactory`` (greedy longest-match-first wordpiece over
a BERT vocab file) and ``org.deeplearning4j.iterator.BertIterator``
(sentences → fixed-length [ids, segment ids] features + attention masks,
Task.SEQ_CLASSIFICATION labels or Task.UNSUPERVISED MLM targets).

Tokenization is host ETL in numpy, and the batches are the port's
``MultiDataSet`` of numpy arrays, equal to the JAX package's array for
array; sequences are padded to ``max_length``. A dataset not divisible by
batch_size yields one ragged final batch (one more graph signature for a
compiled step) — pass ``drop_last=True`` to keep every batch identically
shaped. For UNSUPERVISED the 15%/80-10-10 masking runs on the device in
the step (``zoo.transformer.bert_mask_tokens``); the iterator supplies the
ids, so the masks are drawn afresh every epoch.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.dataset import MultiDataSet


class BertWordPieceTokenizer:
    """Greedy longest-match-first WordPiece (BERT's tokenizer).

    vocab: dict token->id or an iterable of tokens (ids = positions); the
    standard special tokens ([PAD]/[UNK]/[CLS]/[SEP]/[MASK]) must be in
    the vocab (vocab.txt order for real BERT checkpoints).
    """

    def __init__(self, vocab, lower_case: bool = True,
                 max_chars_per_word: int = 100):
        if not isinstance(vocab, dict):
            vocab = {tok: i for i, tok in enumerate(vocab)}
        self.vocab: Dict[str, int] = dict(vocab)
        self.lower_case = lower_case
        self.max_chars = max_chars_per_word
        for special in ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"):
            if special not in self.vocab:
                raise ValueError(f"vocab is missing {special}")

    @classmethod
    def load_vocab(cls, path: str, **kw) -> "BertWordPieceTokenizer":
        """Read a BERT vocab.txt (one token per line, line number = id)."""
        with open(path, encoding="utf-8") as f:
            return cls([ln.rstrip("\r\n") for ln in f], **kw)

    def _basic_split(self, text: str) -> List[str]:
        if self.lower_case:
            text = text.lower()
        out, word = [], []
        for ch in text:
            if ch.isspace():
                if word:
                    out.append("".join(word))
                    word = []
            elif not ch.isalnum():
                # ALL punctuation splits (BERT BasicTokenizer semantics:
                # "don't" -> don ' t — matches pretrained checkpoints)
                if word:
                    out.append("".join(word))
                    word = []
                out.append(ch)
            else:
                word.append(ch)
        if word:
            out.append("".join(word))
        return out

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars:
            return ["[UNK]"]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return ["[UNK]"]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out = []
        for word in self._basic_split(text):
            out.extend(self._wordpiece(word))
        return out

    def encode(self, text: str) -> List[int]:
        return [self.vocab[t] for t in self.tokenize(text)]

    def id_of(self, token: str) -> int:
        return self.vocab[token]


class BertIterator:
    """Sentences → padded BERT features (reference BertIterator.Builder).

    Tasks:
      - ``SEQ_CLASSIFICATION``: labeled (sentence, class) pairs →
        MultiDataSet(features=[ids, segment_ids], masks=[attention],
        labels=[one-hot]).
      - ``UNSUPERVISED``: raw sentences; MLM masking happens on device in
        the training step, so labels carry the UNMASKED ids.

    Builder args mirror the reference: tokenizer, max length, batch size,
    padding to fixed shapes.
    """

    SEQ_CLASSIFICATION = "SEQ_CLASSIFICATION"
    UNSUPERVISED = "UNSUPERVISED"

    def __init__(self, tokenizer: BertWordPieceTokenizer, sentences,
                 labels: Optional[Sequence[int]] = None,
                 num_classes: Optional[int] = None,
                 task: str = "SEQ_CLASSIFICATION", max_length: int = 128,
                 batch_size: int = 32, pair_sentences=None,
                 drop_last: bool = False):
        if task not in (self.SEQ_CLASSIFICATION, self.UNSUPERVISED):
            raise ValueError(f"unknown task {task}")
        if task == self.SEQ_CLASSIFICATION and labels is None:
            raise ValueError("SEQ_CLASSIFICATION needs labels")
        self.tok = tokenizer
        self.task = task
        self.drop_last = drop_last
        self.max_length = max_length
        self.batch_size = batch_size
        sentences = list(sentences)
        pairs = list(pair_sentences) if pair_sentences is not None else None

        cls_id = tokenizer.id_of("[CLS]")
        sep_id = tokenizer.id_of("[SEP]")
        pad_id = tokenizer.id_of("[PAD]")
        self.pad_id, self.mask_id = pad_id, tokenizer.id_of("[MASK]")
        # positions never selected as MLM targets (feed to
        # make_bert_mlm_train_step(special_ids=it.special_ids))
        self.special_ids = (pad_id, cls_id, sep_id)
        n = len(sentences)
        ids = np.full((n, max_length), pad_id, np.int32)
        seg = np.zeros((n, max_length), np.int32)
        attn = np.zeros((n, max_length), np.float32)
        for i, sent in enumerate(sentences):
            toks = [cls_id] + tokenizer.encode(sent) + [sep_id]
            segs = [0] * len(toks)
            if pairs is not None:
                second = tokenizer.encode(pairs[i]) + [sep_id]
                toks += second
                segs += [1] * len(second)
            toks, segs = toks[:max_length], segs[:max_length]
            ids[i, :len(toks)] = toks
            seg[i, :len(segs)] = segs
            attn[i, :len(toks)] = 1.0
        self._ids, self._seg, self._attn = ids, seg, attn
        if task == self.SEQ_CLASSIFICATION:
            labels = np.asarray(labels, np.int64)
            k = num_classes or int(labels.max()) + 1
            self._labels = np.eye(k, dtype=np.float32)[labels]
        else:
            self._labels = ids.copy()       # MLM targets = unmasked ids
        self._pos = 0

    # ------------------------------------------------------------ iteration
    def __iter__(self):
        self.reset()
        return self

    def __next__(self) -> MultiDataSet:
        remaining = len(self._ids) - self._pos
        if remaining <= 0 or (self.drop_last and remaining < self.batch_size):
            # drop_last keeps every batch the same shape, so that a
            # compiled step never captures a graph for a ragged tail
            raise StopIteration
        lo, hi = self._pos, min(self._pos + self.batch_size, len(self._ids))
        self._pos = hi
        feats = [self._ids[lo:hi], self._seg[lo:hi]]
        fmasks = [self._attn[lo:hi], None]
        return MultiDataSet(feats, [self._labels[lo:hi]],
                            features_masks=fmasks)

    def next(self):
        return self.__next__()

    def has_next(self) -> bool:
        remaining = len(self._ids) - self._pos
        if self.drop_last:
            return remaining >= self.batch_size
        return remaining > 0

    def reset(self):
        self._pos = 0
