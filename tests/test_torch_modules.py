"""The port's word-level ST modules (`sgpt_tpu_torch/modules.py`) == the JAX package's.

The cases of tests/test_modules.py, each held against the JAX function on
the same inputs: the tokenizers and BoW (host code, equal outputs), the
length buckets and word embeddings (equal), the CNN and the LSTM with the
JAX parameters carried over by `module_params_from_jax` (fp32, within
1e-5 absolute plus 1e-4 relative, tests/test_modules.py's tolerance against
torch), their composition with mean pooling, and embedding dropout's
keep/scale semantics.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
pytest.importorskip("jax").config.update("jax_platforms", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sgpt_tpu import modules as jm  # noqa: E402
from sgpt_tpu.ops.pooling import mean_pool as jax_mean_pool  # noqa: E402
from sgpt_tpu_torch import modules as m  # noqa: E402
from sgpt_tpu_torch.ops.pooling import mean_pool  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as in tests/test_torch_short_attention.py: beside
    other test processes on the host's cores, a pool of threads makes each
    of this file's many small operations wait on descheduled threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

TEXTS = ["Hello world! NLP the xyz", "HELLO Hello hello", "", "the the the",
         "nlp, nlp; World...", "New York is a big city", "a b c", "Paris PARIS Berlin,"]


@pytest.mark.parametrize("lower", [False, True])
def test_whitespace_tokenizer_three_stage_lookup(lower):
    vocab = ["Hello", "world", "nlp", "hello", "york"]
    for stop in ({"the"}, m.ENGLISH_STOP_WORDS):
        tok = m.WhitespaceTokenizer(vocab, stop_words=stop, do_lower_case=lower)
        want = jm.WhitespaceTokenizer(vocab, stop_words=stop, do_lower_case=lower)
        assert [tok.tokenize(t) for t in TEXTS] == [want.tokenize(t) for t in TEXTS]
    assert m.ENGLISH_STOP_WORDS == jm.ENGLISH_STOP_WORDS
    tok = m.WhitespaceTokenizer(["Hello", "world", "nlp"], stop_words={"the"})
    assert tok.tokenize("Hello world! NLP the xyz") == [0, 1, 2]


def test_bow_vectors():
    for kw in (dict(word_weights={"b": 2.0}, unknown_word_weight=1.0),
               dict(cumulative_term_frequency=False), dict(word_weights={"A": 3.0})):
        texts = ["a a b", "c", "", "a b c a"]
        np.testing.assert_array_equal(m.BoW(["a", "b", "c", "a"], **kw).encode(texts),
                                      jm.BoW(["a", "b", "c", "a"], **kw).encode(texts))
    np.testing.assert_allclose(m.BoW(["a", "b", "c"], word_weights={"b": 2.0}).encode(
        ["a a b", "c"]), [[2.0, 2.0, 0.0], [0.0, 0.0, 1.0]])


def test_word_embeddings_lookup_and_buckets():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(5, 8)).astype(np.float32)
    vocab = ["w0", "w1", "w2", "w3", "w4"]
    texts = ["w0 w3", "w4 w1 w2 w0 w4", "", " ".join(["w1"] * 9)]
    tok, jtok = (mod.WhitespaceTokenizer(vocab, stop_words=set()) for mod in (m, jm))
    got = m.batch_token_ids(tok, texts)
    want = jm.batch_token_ids(jtok, texts)
    for g, j in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    assert got[0].shape[1] == 16                     # power-of-two bucket
    assert m.batch_token_ids(tok, texts[:2])[0].shape[1] == 8
    emb = m.word_embeddings_forward(m.init_word_embeddings(w), got[0])
    np.testing.assert_array_equal(
        emb.numpy(), np.asarray(jm.word_embeddings_forward(jm.init_word_embeddings(w),
                                                           want[0])))
    with pytest.raises(ValueError, match="vocab, dim"):
        m.init_word_embeddings(np.zeros(3))


@pytest.mark.parametrize("kernel_sizes", [(1, 3, 5), (2, 4)])
def test_cnn_matches_jax(kernel_sizes):
    B, T, D, C = 2, 16, 12, 7
    jparams = jm.init_cnn(jax.random.key(0), D, out_channels=C, kernel_sizes=kernel_sizes)
    params = m.module_params_from_jax(jparams)
    x = np.random.default_rng(1).normal(size=(B, T, D)).astype(np.float32)
    got = m.cnn_forward(params, torch.from_numpy(x)).numpy()
    want = np.asarray(jm.cnn_forward(jparams, jnp.asarray(x)))
    T_out = T - 1 if kernel_sizes[0] % 2 == 0 else T  # an even k pads (k-1)//2 a side
    assert got.shape == want.shape == (B, T_out, C * len(kernel_sizes))
    np.testing.assert_allclose(got, want, **TOL)
    ours = m.init_cnn(torch.Generator().manual_seed(0), D, out_channels=C,
                      kernel_sizes=kernel_sizes)
    assert ours["kernel_sizes"] == jparams["kernel_sizes"]
    for a, b, ks in zip(ours["convs"], jparams["convs"], kernel_sizes):
        assert a["w"].shape == b["w"].shape and a["b"].shape == b["b"].shape
        assert float(a["w"].abs().max()) <= 1 / np.sqrt(D * ks)


@pytest.mark.parametrize("bidirectional,num_layers", [(False, 1), (True, 1), (True, 2)])
def test_lstm_matches_jax_packed(bidirectional, num_layers):
    """Ragged lengths: the reverse direction starts at each row's last valid
    token, padded outputs are zero."""
    B, T, D, H = 3, 10, 6, 5
    lengths = np.asarray([10, 4, 7], np.int32)
    jparams = jm.init_lstm(jax.random.key(2), D, H, num_layers=num_layers,
                           bidirectional=bidirectional)
    params = m.module_params_from_jax(jparams)
    x = np.random.default_rng(3).normal(size=(B, T, D)).astype(np.float32)
    got = m.lstm_forward(params, torch.from_numpy(x), torch.from_numpy(lengths)).numpy()
    want = np.asarray(jm.lstm_forward(jparams, jnp.asarray(x), jnp.asarray(lengths)))
    assert got.shape == (B, T, H * (2 if bidirectional else 1))
    np.testing.assert_allclose(got, want, **TOL)
    assert not got[1, 4:].any()
    ours = m.init_lstm(torch.Generator().manual_seed(0), D, H, num_layers=num_layers,
                       bidirectional=bidirectional)
    assert jax.tree.map(np.shape, jparams) == jax.tree.map(
        lambda t: tuple(t.shape) if isinstance(t, torch.Tensor) else np.shape(t), ours)


def test_lstm_cnn_compose_into_pooling():
    """WordEmbeddings -> LSTM -> Pooling and WordEmbeddings -> CNN -> Pooling,
    the upstream pipelines' shapes, against the JAX stack."""
    vocab = [f"w{i}" for i in range(20)]
    w = np.random.default_rng(4).normal(size=(20, 8)).astype(np.float32)
    texts = ["w1 w2 w3", "w4 w5 w6 w7 w8 w9"]
    ids, mask, lengths = m.batch_token_ids(m.WhitespaceTokenizer(vocab, stop_words=set()), texts)
    jids, jmask, jlengths = jm.batch_token_ids(jm.WhitespaceTokenizer(vocab, stop_words=set()),
                                               texts)
    emb = m.word_embeddings_forward(m.init_word_embeddings(w), ids)
    jemb = jm.word_embeddings_forward(jm.init_word_embeddings(w), jids)
    jlstm = jm.init_lstm(jax.random.key(5), 8, 4)
    jcnn = jm.init_cnn(jax.random.key(6), 8, out_channels=3)
    got = (mean_pool(m.lstm_forward(m.module_params_from_jax(jlstm), emb, lengths), mask),
           mean_pool(m.cnn_forward(m.module_params_from_jax(jcnn), emb), mask))
    want = (jax_mean_pool(jm.lstm_forward(jlstm, jemb, jlengths), jmask),
            jax_mean_pool(jm.cnn_forward(jcnn, jemb), jmask))
    assert got[0].shape == (2, 8) and got[1].shape == (2, 9)
    for g, j in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **TOL)


def test_phrase_tokenizer_merges_ngrams():
    vocab = ["New_York", "New", "York", "is", "big", "city"]
    tok = m.PhraseTokenizer(vocab, stop_words={"is"})
    ids = tok.tokenize("New York is a big city")
    assert ids == [vocab.index("New_York"), vocab.index("big"), vocab.index("city")]
    want = jm.PhraseTokenizer(vocab, stop_words={"is"})
    assert [tok.tokenize(t) for t in TEXTS] == [want.tokenize(t) for t in TEXTS]


def test_phrase_tokenizer_longest_ngram_wins_and_limits():
    vocab = ["a_b_c", "a_b", "c", "x__y", "one_two_three_four_five_six"]
    tok = m.PhraseTokenizer(vocab, stop_words=set())
    want = jm.PhraseTokenizer(vocab, stop_words=set())
    assert tok.tokenize("a b c") == want.tokenize("a b c") == [vocab.index("a_b_c")]
    assert tok.ngram_lookup == want.ngram_lookup and tok.ngram_lengths == want.ngram_lengths
    assert "x__y" not in tok.ngram_lookup
    assert "one_two_three_four_five_six" not in tok.ngram_lookup


def test_phrase_tokenizer_lookup_order():
    vocab = ["Paris", "paris", "berlin"]
    tok = m.PhraseTokenizer(vocab, stop_words=set())
    assert tok.tokenize("Paris") == [vocab.index("Paris")]     # raw hit first
    assert tok.tokenize("PARIS") == [vocab.index("paris")]     # lower stage
    assert tok.tokenize("Berlin,") == [vocab.index("berlin")]  # strip stage
    assert m.PhraseTokenizer(["new_york"], stop_words=set()).tokenize("New York") == [0]
    want = jm.PhraseTokenizer(vocab, stop_words=set())
    assert [tok.tokenize(t) for t in TEXTS] == [want.tokenize(t) for t in TEXTS]


def test_embedding_dropout_semantics():
    x = torch.ones(16, 64)
    # deterministic / rate 0: identity, no generator needed (as the JAX
    # function needs no key there)
    assert m.embedding_dropout(x, 0.5) is x
    assert m.embedding_dropout(x, 0.0, deterministic=False) is x
    np.testing.assert_array_equal(
        np.asarray(jm.embedding_dropout(jnp.ones((16, 64)), 0.5)), x.numpy())
    with pytest.raises(ValueError, match="generator"):
        m.embedding_dropout(x, 0.5, deterministic=False)
    y = m.embedding_dropout(x, 0.5, torch.Generator().manual_seed(0), deterministic=False)
    jy = np.asarray(jm.embedding_dropout(jnp.ones((16, 64)), 0.5, key=jax.random.key(0),
                                         deterministic=False))
    for out in (y.numpy(), jy):
        kept = out != 0.0
        assert 0.3 < kept.mean() < 0.7                   # ~ the keep fraction
        np.testing.assert_allclose(out[kept], 2.0)       # inverted-dropout scale 1/(1-p)
    again = m.embedding_dropout(x, 0.5, torch.Generator().manual_seed(0), deterministic=False)
    assert torch.equal(y, again) and y.dtype == x.dtype
