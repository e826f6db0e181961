"""The port's Japanese tokenizer (hivemall_tpu_torch/nlp/) against the JAX
package's (hivemall_tpu/nlp/) on the gold fixtures in tests/data/: the same
backend in one environment, the same tokens for every sentence in every
mode, and the bulk path (the port's native Viterbi,
`native.lattice_tokenize_bulk`) equal to `tokenize()`."""

import os

import numpy as np
import pytest

from hivemall_tpu.nlp import tokenizer as jtok
from hivemall_tpu.nlp.evaluate import load_gold as jload_gold
from hivemall_tpu.nlp.evaluate import segmentation_prf as jprf
from hivemall_tpu_torch import native
from hivemall_tpu_torch.nlp import tokenize_ja, tokenize_ja_bulk
from hivemall_tpu_torch.nlp import tokenizer as ttok
from hivemall_tpu_torch.nlp.evaluate import load_gold, segmentation_prf

DATA = os.path.join(os.path.dirname(__file__), "data")
FIXTURES = sorted(f[:-4] for f in os.listdir(DATA)
                  if f.startswith("tokenize_ja_") and f.endswith(".tsv"))


def test_same_backend_in_both_packages():
    assert ttok.backend_name() == jtok.backend_name()


@pytest.mark.parametrize("fixture", FIXTURES)
@pytest.mark.parametrize("mode", ["normal", "search", "extended"])
def test_tokenize_ja_equals_jax_on_gold(fixture, mode):
    path = os.path.join(DATA, f"{fixture}.tsv")
    gold = load_gold(path)
    assert gold == jload_gold(path) and len(gold) >= 30
    sents = [s for s, _ in gold]
    got = [tokenize_ja(s, mode) for s in sents]
    assert got == [jtok.tokenize_ja(s, mode) for s in sents]
    if mode == "normal":
        pairs = [(toks, g) for (_, toks), g in zip(gold, got)]
        assert segmentation_prf(pairs) == jprf(pairs)


def test_stopwords_and_stoptags_equal_jax():
    gold = load_gold(os.path.join(DATA, "tokenize_ja_gold.tsv"))
    for sent, _ in gold[:40]:
        for kw in ({"stopwords": ["は", "です"]}, {"stoptags": ["助詞"]},
                   {"stoptags": ["助詞-格助詞"]}):
            assert tokenize_ja(sent, **kw) == jtok.tokenize_ja(sent, **kw)


@pytest.mark.parametrize("fixture", ["tokenize_ja_gold",
                                     "tokenize_ja_heldout"])
def test_bulk_path_equals_tokenize(fixture):
    """tokenize_ja_bulk runs the native Viterbi (one call into the library)
    and equals the per-text path and the JAX package's bulk path."""
    sents = [s for s, _ in load_gold(os.path.join(DATA, f"{fixture}.tsv"))]
    before = native.CALLS["lattice_tokenize_bulk"]
    bulk = tokenize_ja_bulk(sents, stopwords=["は"], stoptags=["助動詞"])
    assert native.CALLS["lattice_tokenize_bulk"] == before + 1
    assert bulk == [tokenize_ja(s, stopwords=["は"], stoptags=["助動詞"])
                    for s in sents]
    assert bulk == jtok.tokenize_ja_bulk(sents, stopwords=["は"],
                                         stoptags=["助動詞"])


def test_native_lattice_equals_python_viterbi_on_odd_text():
    """Mixed scripts, digits, punctuation runs and empty texts through the
    native pass equal the Python lattice."""
    from hivemall_tpu_torch.nlp.lattice import LatticeTokenizer

    rng = np.random.RandomState(0)
    alphabet = list("あいうえおかきくけこアイウエオ漢字東京都123ABC、。 ！?")
    texts = ["", "。。。", "ＡＢＣ１２３テスト"] + [
        "".join(rng.choice(alphabet, size=rng.randint(1, 30)))
        for _ in range(200)]
    lt = LatticeTokenizer()
    assert lt.tokenize_bulk(texts) == [lt.tokenize(t) for t in texts]
