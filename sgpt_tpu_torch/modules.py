"""Word-level encoder modules of sentence-transformers (counterpart of `sgpt_tpu/modules.py`).

The SGPT pipelines never reach these, but a word-level ST pipeline needs them:

  * WhitespaceTokenizer, PhraseTokenizer — word tokenizers with stop-word
    removal and their staged vocab lookups (host code, copied from the JAX
    module);
  * WordEmbeddings — a (V, D) word-vector lookup;
  * BoW — weighted bag-of-words sentence vectors (host code, copied);
  * CNN — a bank of 1-D convolutions over token embeddings;
  * LSTM — a stacked (bi)LSTM with packed-sequence semantics: the state
    freezes past each row's length, and the backward direction starts at
    each row's last valid token;
  * embedding_dropout — inverted dropout on the pooled embedding.

Parameters are dicts of tensors in the JAX trees' layout (torch's gate
order i, f, g, o and Conv1d's (out, in, k), which the JAX module keeps), so
`module_params_from_jax` converts a JAX tree leaf for leaf. Random draws
take an explicit `torch.Generator`. `batch_token_ids` pads to power-of-two
length buckets, as the JAX one does for its compiled shapes.
"""
from __future__ import annotations

import string
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

# the upstream fork's ENGLISH_STOP_WORDS (models/tokenizer/WordTokenizer.py)
# is sklearn's list; keep a compact common subset — callers pass their own
# list for exact parity with a specific upstream checkpoint
ENGLISH_STOP_WORDS = frozenset(
    "a an and are as at be by for from has he in is it its of on that the to "
    "was were will with".split())


class WhitespaceTokenizer:
    """Whitespace split + three-stage vocab lookup (raw, punctuation-stripped,
    lowercased), dropping stop words and OOV tokens — the upstream
    WhitespaceTokenizer.tokenize contract."""

    def __init__(self, vocab: Iterable[str] = (),
                 stop_words: Iterable[str] = ENGLISH_STOP_WORDS,
                 do_lower_case: bool = False):
        self.stop_words = set(stop_words)
        self.do_lower_case = do_lower_case
        self.vocab = list(vocab)
        self.word2idx = {w: i for i, w in enumerate(self.vocab)}

    def tokenize(self, text: str) -> List[int]:
        if self.do_lower_case:
            text = text.lower()
        out: List[int] = []
        for token in text.split():
            if token in self.stop_words:
                continue
            if token in self.word2idx:
                out.append(self.word2idx[token])
                continue
            token = token.strip(string.punctuation)
            if token in self.stop_words:
                continue
            if token and token in self.word2idx:
                out.append(self.word2idx[token])
                continue
            token = token.lower()
            if token in self.stop_words:
                continue
            if token in self.word2idx:
                out.append(self.word2idx[token])
        return out


class PhraseTokenizer(WhitespaceTokenizer):
    """Phrase-aware word tokenizer (models/tokenizer/PhraseTokenizer.py):
    vocab entries joined by `ngram_separator` (word2vec-style `New_York`) are
    detected in text — longest n-grams first, left to right — and emitted as
    one token. Lookup order follows the upstream phrase variant: raw ->
    lowercased -> punctuation-stripped (the plain WhitespaceTokenizer strips
    punctuation before lowering), each stage dropping stop words.

    Word splitting uses nltk's treebank word tokenizer when available (the
    upstream choice; `preserve_line=True` needs no downloaded data) and falls
    back to a punctuation-separating regex split otherwise."""

    def __init__(self, vocab: Iterable[str] = (),
                 stop_words: Iterable[str] = ENGLISH_STOP_WORDS,
                 do_lower_case: bool = False, ngram_separator: str = "_",
                 max_ngram_length: int = 5):
        super().__init__(vocab, stop_words, do_lower_case)
        self.ngram_separator = ngram_separator
        self.max_ngram_length = max_ngram_length
        self.ngram_lookup = set()
        self.ngram_lengths = set()
        for word in self.vocab:
            if ngram_separator and ngram_separator in word:
                n = word.count(ngram_separator) + 1
                # doubled separators mark malformed source vectors upstream
                if ngram_separator * 2 not in word and n <= max_ngram_length:
                    self.ngram_lookup.add(word)
                    self.ngram_lengths.add(n)

    @staticmethod
    def _word_split(text: str) -> List[str]:
        try:
            import nltk
            return nltk.word_tokenize(text, preserve_line=True)
        except Exception:
            import re
            return re.findall(r"\w+(?:[-']\w+)*|[^\w\s]", text)

    def tokenize(self, text: str) -> List[int]:
        if self.do_lower_case:
            text = text.lower()
        tokens = self._word_split(text)
        # merge phrases, longest n-grams first so 4-grams beat their bigrams
        for n in sorted(self.ngram_lengths, reverse=True):
            i = 0
            while i <= len(tokens) - n:
                ngram = self.ngram_separator.join(tokens[i : i + n])
                if ngram in self.ngram_lookup:
                    tokens[i : i + n] = [ngram]
                elif ngram.lower() in self.ngram_lookup:
                    tokens[i : i + n] = [ngram.lower()]
                i += 1
        out: List[int] = []
        for token in tokens:
            for stage in (token, token.lower(),
                          token.lower().strip(string.punctuation)):
                if stage in self.stop_words:
                    break
                if stage and stage in self.word2idx:
                    out.append(self.word2idx[stage])
                    break
        return out


# ---------------------------------------------------------------------------
# Dropout (sentence-embedding module)
# ---------------------------------------------------------------------------

def embedding_dropout(embeddings: torch.Tensor, rate: float,
                      generator: Optional[torch.Generator] = None,
                      deterministic: bool = True) -> torch.Tensor:
    """models/Dropout.py — dropout on the pooled sentence embedding. Inverted
    dropout (kept values scaled by 1/(1-p)), identity when deterministic or
    rate 0; the train path draws its keep mask from an explicit `generator`
    (on the embeddings' device), as the JAX function takes a key."""
    if deterministic or rate <= 0.0:
        return embeddings
    if generator is None:
        raise ValueError("embedding_dropout(deterministic=False) needs a generator")
    keep = 1.0 - rate
    mask = torch.rand(embeddings.shape, generator=generator,
                      device=embeddings.device) < keep
    return torch.where(mask, embeddings / keep,
                       torch.zeros((), device=embeddings.device)).to(embeddings.dtype)


def _pad_bucket(n: int, cap: int = 1 << 14) -> int:
    b = 8
    while b < n and b < cap:
        b <<= 1
    return min(max(b, n), max(cap, n))


def batch_token_ids(tokenizer: WhitespaceTokenizer, texts: Sequence[str], device=None):
    """(ids, mask, lengths) int32 tensors, padded to a power-of-two length
    bucket (at least 8); an empty row holds the one id 0."""
    rows = [tokenizer.tokenize(t) or [0] for t in texts]
    lengths = np.asarray([len(r) for r in rows], np.int32)
    T = _pad_bucket(int(lengths.max()))
    ids = np.zeros((len(rows), T), np.int32)
    mask = np.zeros((len(rows), T), np.int32)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
        mask[i, :len(r)] = 1
    return tuple(torch.from_numpy(a).to(device) for a in (ids, mask, lengths))


def module_params_from_jax(tree):
    """A JAX parameter tree of this module's functions (`init_cnn`,
    `init_lstm`, `init_word_embeddings`) → the same structure with each
    array a float32 CPU tensor; other leaves (kernel sizes, flags) are kept."""
    if isinstance(tree, dict):
        return {k: module_params_from_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [module_params_from_jax(v) for v in tree]
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        return torch.from_numpy(np.array(tree, np.float32))
    return tree


def params_to(params, device):
    """A module's parameter dict with every tensor moved to `device`."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device) for v in params]
    return params.to(device) if isinstance(params, torch.Tensor) else params


# ---------------------------------------------------------------------------
# WordEmbeddings
# ---------------------------------------------------------------------------

def init_word_embeddings(weights) -> Dict[str, torch.Tensor]:
    """Parameters from a (V, D) word-vector matrix (models/WordEmbeddings.py:
    nn.Embedding loaded from pretrained vectors)."""
    w = torch.as_tensor(np.asarray(weights, np.float32))
    if w.dim() != 2:
        raise ValueError(f"expected (vocab, dim) weights, got {tuple(w.shape)}")
    return {"emb": w}


def word_embeddings_forward(params: Dict, ids: torch.Tensor) -> torch.Tensor:
    """(B, T) ids -> (B, T, D) token embeddings."""
    return params["emb"][ids.long()]


# ---------------------------------------------------------------------------
# BoW
# ---------------------------------------------------------------------------

class BoW:
    """Weighted bag-of-words sentence vectors (models/BoW.py): output dim =
    len(vocab); token weights default to 1 with a tf-idf style override map;
    `cumulative_term_frequency` sums repeated tokens (else binary-with-weight).
    A host-side scatter, as the reference computes it in
    get_sentence_features."""

    def __init__(self, vocab: Sequence[str],
                 word_weights: Optional[Dict[str, float]] = None,
                 unknown_word_weight: float = 1.0,
                 cumulative_term_frequency: bool = True):
        vocab = list(dict.fromkeys(vocab))  # unique, order-preserving
        self.vocab = vocab
        word_weights = word_weights or {}
        self.weights = np.asarray(
            [word_weights.get(w, word_weights.get(w.lower(),
                                                  unknown_word_weight))
             for w in vocab], np.float32)
        self.cumulative_term_frequency = cumulative_term_frequency
        self.tokenizer = WhitespaceTokenizer(vocab, stop_words=set(),
                                             do_lower_case=False)
        self.dim = len(vocab)

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, text in enumerate(texts):
            toks = np.asarray(self.tokenizer.tokenize(text), np.int64)
            if toks.size == 0:
                continue
            if self.cumulative_term_frequency:
                np.add.at(out[i], toks, self.weights[toks])
            else:
                out[i, toks] = self.weights[toks]
        return out


# ---------------------------------------------------------------------------
# CNN
# ---------------------------------------------------------------------------

def init_cnn(generator: Optional[torch.Generator], in_dim: int, out_channels: int = 256,
             kernel_sizes: Sequence[int] = (1, 3, 5)) -> Dict:
    """Multi-kernel conv bank (models/CNN.py): one Conv1d per kernel size,
    outputs concatenated -> (B, T, out_channels * len(kernel_sizes)); torch
    Conv1d's default init U(-1/sqrt(fan_in), +), fan_in = in_dim * k."""
    params = {"convs": []}
    for ks in kernel_sizes:
        bound = 1.0 / np.sqrt(in_dim * ks)
        w = (torch.rand((out_channels, in_dim, ks), generator=generator) * 2 - 1) * bound
        b = (torch.rand((out_channels,), generator=generator) * 2 - 1) * bound
        params["convs"].append({"w": w, "b": b})
    params["kernel_sizes"] = tuple(int(k) for k in kernel_sizes)
    return params


def cnn_forward(params: Dict, token_embeddings: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> (B, T', out_channels * n_kernels); padding (k-1)//2 on
    each side, stride 1: T' = T for odd k."""
    x = token_embeddings.transpose(1, 2)                    # (B, D, T)
    outs = [F.conv1d(x, conv["w"], conv["b"], padding=(ks - 1) // 2)
            for conv, ks in zip(params["convs"], params["kernel_sizes"])]
    return torch.cat(outs, dim=1).transpose(1, 2)


# ---------------------------------------------------------------------------
# LSTM
# ---------------------------------------------------------------------------

def init_lstm(generator: Optional[torch.Generator], in_dim: int, hidden_dim: int,
              num_layers: int = 1, bidirectional: bool = True) -> Dict:
    """Stacked (bi)LSTM parameters in torch's gate order i, f, g, o
    (models/LSTM.py wraps nn.LSTM), drawn U(-1/sqrt(H), +) as nn.LSTM's."""
    layers = []
    n_dir = 2 if bidirectional else 1
    bound = 1.0 / np.sqrt(hidden_dim)

    def u(*shape):
        return (torch.rand(shape, generator=generator) * 2 - 1) * bound

    for layer in range(num_layers):
        d_in = in_dim if layer == 0 else hidden_dim * n_dir
        layers.append([{"w_ih": u(4 * hidden_dim, d_in), "w_hh": u(4 * hidden_dim, hidden_dim),
                        "b_ih": u(4 * hidden_dim), "b_hh": u(4 * hidden_dim)}
                       for _ in range(n_dir)])
    return {"layers": layers, "hidden_dim": hidden_dim, "bidirectional": bidirectional}


def _lstm_scan(p: Dict, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """One direction over (B, T, D) with a (B, T) validity mask: the state
    freezes at masked steps (packed-sequence semantics for trailing pads).
    Returns every step's h, (B, T, H)."""
    H = p["w_hh"].shape[1]
    B, T, _ = x.shape
    h = torch.zeros(B, H, dtype=x.dtype, device=x.device)
    c = torch.zeros_like(h)
    outs = []
    for t in range(T):
        gates = x[:, t] @ p["w_ih"].T + h @ p["w_hh"].T + p["b_ih"] + p["b_hh"]
        i, f, g, o = gates.chunk(4, dim=-1)                 # torch gate order
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c_new = f * c + i * torch.tanh(g)
        h_new = o * torch.tanh(c_new)
        valid = mask[:, t, None].bool()
        h = torch.where(valid, h_new, h)
        c = torch.where(valid, c_new, c)
        outs.append(h)
    return torch.stack(outs, dim=1)


def lstm_forward(params: Dict, token_embeddings: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """(B, T, D), (B,) lengths -> (B, T, H * n_dir), zero at padded
    positions. The reverse direction runs from each row's last valid token
    (a per-row index flip of the valid prefix), as torch's
    pack_padded_sequence does."""
    B, T, _ = token_embeddings.shape
    lengths = torch.clamp(lengths.to(token_embeddings.device).long(), 1, T)
    t_idx = torch.arange(T, device=token_embeddings.device)[None, :]
    mask = (t_idx < lengths[:, None]).to(token_embeddings.dtype)
    x = token_embeddings
    flip = torch.clamp(lengths[:, None] - 1 - t_idx, 0, T - 1)[..., None]  # (B, T, 1)
    for dirs in params["layers"]:
        outs = [_lstm_scan(dirs[0], x, mask)]
        if params["bidirectional"]:
            xr = torch.gather(x, 1, flip.expand(-1, -1, x.shape[-1]))
            hr = _lstm_scan(dirs[1], xr, mask)
            outs.append(torch.gather(hr, 1, flip.expand(-1, -1, hr.shape[-1])))
        x = torch.cat(outs, dim=-1) * mask[..., None]
    return x
