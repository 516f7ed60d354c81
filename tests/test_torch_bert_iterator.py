"""The port's ``BertWordPieceTokenizer`` and ``BertIterator``
(``deeplearning4j_tpu_torch.nlp``) against the JAX package's: the cases of
``tests/test_bert_iterator.py`` run through both packages, every token
list and batch array equal, and the port's MLM step fed from the
iterator."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import nlp as jnlp
from deeplearning4j_tpu_torch import nlp as tnlp
from deeplearning4j_tpu_torch.data import MultiDataSet
from deeplearning4j_tpu_torch.zoo import transformer as tfm

torch.set_num_threads(2)

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
         "the", "quick", "brown", "fox", "jump", "##s", "##ed", "##ing",
         "dog", "lazy", "over", ",", ".", "un", "##break", "##able"]
PACKAGES = {"jax": jnlp, "port": tnlp}


def _toks(vocab=VOCAB):
    return {k: m.BertWordPieceTokenizer(vocab) for k, m in PACKAGES.items()}


def _iters(sents, **kw):
    return {k: m.BertIterator(m.BertWordPieceTokenizer(VOCAB), sents, **kw)
            for k, m in PACKAGES.items()}


def _batches(it):
    return [b for b in it]


def _assert_batches_equal(jb, tb):
    assert isinstance(tb, MultiDataSet)
    for name in ("features", "labels", "features_masks"):
        ja, ta = getattr(jb, name), getattr(tb, name)
        assert len(ja) == len(ta), name
        for a, b in zip(ja, ta):
            if a is None:
                assert b is None
                continue
            assert isinstance(b, np.ndarray) and b.dtype == a.dtype, name
            np.testing.assert_array_equal(b, a)
    assert tb.labels_masks is None and jb.labels_masks is None


@pytest.mark.parametrize("text", ["the quick fox", "jumps", "jumping",
                                  "unbreakable", "fox, dog.", "zebra",
                                  "The QUICK", "lazy dog", "don't"])
def test_wordpiece_tokenization_matches(text):
    toks = _toks(VOCAB + ["don", "'", "t"])
    assert toks["port"].tokenize(text) == toks["jax"].tokenize(text)
    assert toks["port"].encode(text) == toks["jax"].encode(text)


def test_wordpiece_tokenization():
    tok = tnlp.BertWordPieceTokenizer(VOCAB)
    assert tok.tokenize("the quick fox") == ["the", "quick", "fox"]
    assert tok.tokenize("jumps") == ["jump", "##s"]
    assert tok.tokenize("unbreakable") == ["un", "##break", "##able"]
    assert tok.tokenize("fox, dog.") == ["fox", ",", "dog", "."]
    assert tok.tokenize("zebra") == ["[UNK]"]
    assert tok.tokenize("The QUICK") == ["the", "quick"]
    assert tok.encode("the") == [VOCAB.index("the")]
    assert tok.tokenize("x" * 101) == ["[UNK]"]       # max_chars_per_word


@pytest.mark.parametrize("newline", ["\n", "\r\n"])
def test_vocab_file_and_missing_specials(tmp_path, newline):
    p = tmp_path / "vocab.txt"
    p.write_bytes((newline.join(VOCAB) + newline).encode())
    tok = tnlp.BertWordPieceTokenizer.load_vocab(str(p))
    ref = jnlp.BertWordPieceTokenizer.load_vocab(str(p))
    assert tok.vocab == ref.vocab
    assert tok.tokenize("lazy dog") == ["lazy", "dog"]
    with pytest.raises(ValueError, match=r"\[PAD\]"):
        tnlp.BertWordPieceTokenizer(["just", "words"])


def test_bert_iterator_classification_batches():
    sents = ["the quick fox", "the lazy dog", "fox jumps over the dog",
             "the dog"]
    its = _iters(sents, labels=[0, 1, 0, 1], max_length=10, batch_size=2)
    jb, tb = _batches(its["jax"]), _batches(its["port"])
    assert len(jb) == len(tb) == 2
    for a, b in zip(jb, tb):
        _assert_batches_equal(a, b)
    ids, seg = tb[0].features
    assert ids.shape == (2, 10) and seg.shape == (2, 10)
    assert tb[0].features_masks[0][0].sum() == 5
    assert ids[0, 0] == VOCAB.index("[CLS]")
    assert ids[0, 4] == VOCAB.index("[SEP]")
    assert tb[0].labels[0].shape == (2, 2)
    assert sum(b.num_examples() for b in its["port"]) == 4


def test_bert_iterator_sentence_pairs_segments():
    its = _iters(["the fox"], labels=[1], num_classes=3, max_length=12,
                 batch_size=1, pair_sentences=["lazy dog"])
    jb, tb = next(iter(its["jax"])), next(iter(its["port"]))
    _assert_batches_equal(jb, tb)
    ids, seg = tb.features
    assert list(np.where(ids[0] == VOCAB.index("[SEP]"))[0]) == [3, 6]
    np.testing.assert_array_equal(seg[0, :7], [0, 0, 0, 0, 1, 1, 1])
    assert tb.labels[0].shape == (1, 3)


def test_bert_iterator_truncates_to_max_length():
    its = _iters(["the quick brown fox jumps over the lazy dog"],
                 labels=[0], max_length=6, batch_size=1,
                 pair_sentences=["the dog"])
    _assert_batches_equal(next(iter(its["jax"])), next(iter(its["port"])))


def test_bert_iterator_unsupervised_targets():
    sents = ["the quick fox", "jumping dog"]
    its = _iters(sents, task=tnlp.BertIterator.UNSUPERVISED, max_length=8,
                 batch_size=2)
    jb, tb = next(iter(its["jax"])), next(iter(its["port"]))
    _assert_batches_equal(jb, tb)
    np.testing.assert_array_equal(tb.labels[0], tb.features[0])
    assert its["port"].mask_id == VOCAB.index("[MASK]")
    assert its["port"].special_ids == its["jax"].special_ids == (
        VOCAB.index("[PAD]"), VOCAB.index("[CLS]"), VOCAB.index("[SEP]"))
    with pytest.raises(ValueError):
        tnlp.BertIterator(tnlp.BertWordPieceTokenizer(VOCAB), sents,
                          task="SEQ_CLASSIFICATION")
    with pytest.raises(ValueError, match="unknown task"):
        tnlp.BertIterator(tnlp.BertWordPieceTokenizer(VOCAB), sents,
                          task="NER")


@pytest.mark.parametrize("drop_last", [True, False])
def test_drop_last_and_iteration_protocol(drop_last):
    its = _iters(["the fox"] * 5, labels=[0] * 5, max_length=6,
                 batch_size=2, drop_last=drop_last)
    jb, tb = _batches(its["jax"]), _batches(its["port"])
    assert [b.num_examples() for b in tb] == ([2, 2] if drop_last
                                              else [2, 2, 1])
    for a, b in zip(jb, tb):
        _assert_batches_equal(a, b)
    it = its["port"]
    it.reset()
    n = 0
    while it.has_next():
        n += it.next().num_examples()
    assert n == (4 if drop_last else 5)


def test_bert_iterator_feeds_mlm_training():
    """tests/test_bert_iterator.py:96-124 on the port: UNSUPERVISED
    batches drive ``make_bert_mlm_train_step`` (masking on the device,
    specials excluded, the attention mask fed) and the loss drops."""
    tok = tnlp.BertWordPieceTokenizer(VOCAB)
    sents = ["the quick fox jumps over the lazy dog",
             "the dog jumps", "the quick dog", "fox jumping over the dog"] * 4
    it = tnlp.BertIterator(tok, sents, task=tnlp.BertIterator.UNSUPERVISED,
                           max_length=12, batch_size=8)
    cfg = tfm.BertConfig(vocab_size=len(VOCAB), d_model=32, n_heads=2,
                         n_layers=2, d_ff=64, max_seq=12,
                         dtype=torch.float32)
    params = tfm.bert_init(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    opt = torch.optim.Adam(tfm.param_leaves(params), lr=1e-3)
    step = tfm.make_bert_mlm_train_step(
        cfg, opt, mask_token_id=it.mask_id, special_ids=it.special_ids,
        generator=torch.Generator().manual_seed(1))
    losses = []
    for _ in range(40):
        for b in it:
            losses.append(float(step(params, b.features[0], b.features[1],
                                     b.features_masks[0])))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) * 0.7, losses


def test_mlm_masks_never_select_specials():
    """tests/test_bert_iterator.py:127-152 on the port."""
    tok = tnlp.BertWordPieceTokenizer(VOCAB)
    it = tnlp.BertIterator(tok, ["the quick fox", "dog"], max_length=10,
                           batch_size=2,
                           task=tnlp.BertIterator.UNSUPERVISED)
    cfg = tfm.BertConfig(vocab_size=len(VOCAB), d_model=16, n_heads=2,
                         n_layers=1, d_ff=32, max_seq=10,
                         dtype=torch.float32)
    ids = torch.as_tensor(it._ids)
    special = torch.isin(ids, torch.tensor(it.special_ids))
    selected = 0.0
    for trial in range(20):
        _, _, w = tfm.bert_mask_tokens(torch.Generator().manual_seed(trial),
                                       ids, cfg, it.mask_id, 0.5,
                                       special_mask=special)
        assert float((w * special).sum()) == 0.0
        selected += float(w.sum())
    assert selected > 0
