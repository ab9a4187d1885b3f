"""What the entry drivers share: the program's model from a configuration
file and the seed, and the traffic's text generator.

Texts are made from the seed on the host: a vocabulary of random lowercase
words, and documents whose lengths in words are the quantiles of the mix's
clipped lognormal, in an order drawn from the seed. Every call of a mix
therefore holds the same multiset of lengths: the work of a call does not
depend on the seed, only its words and order do.
"""
from __future__ import annotations

import statistics
from typing import List

import numpy as np

from ..reference import model as ref

LETTERS = np.array(list("abcdefghijklmnopqrstuvwxyz"))


def program_model(config: dict, seed: int, device, lm_head: bool = False):
    """(Decoder, DecoderConfig, reference arch) of a configuration file: the
    port's own reading of the published config.json (`config_from_hf`) in
    the served dtype, as its checkpoint loader builds it, holding the
    benchmark's weights for `seed`."""
    import torch
    from sgpt_tpu_torch.models.decoder import Decoder
    from sgpt_tpu_torch.models.hf_loader import config_from_hf

    serving = config["serving"]
    dtype = getattr(torch, serving["dtype"])
    cfg = config_from_hf(config["hf_config"], config["family"]).replace(dtype=dtype)
    if dtype != torch.float32:
        cfg = cfg.replace(matmul_precision="default")
    a = ref.arch(config, lm_head=lm_head)
    weights = ref.draw_all(a, seed, device)
    model = Decoder(cfg, device=device, weights=weights)
    del weights
    return model, cfg, a


def tokenizer(cfg):
    from sgpt_tpu_torch.tokenization.base import SimpleTokenizer

    return SimpleTokenizer(cfg.vocab_size)


class Texts:
    """Random words and documents from one numpy generator."""

    def __init__(self, rng: np.random.Generator, vocabulary: int):
        self.rng = rng
        lens = rng.integers(2, 9, vocabulary)
        self.words = ["".join(rng.choice(LETTERS, int(n))) for n in lens]

    def text(self, n_words: int) -> str:
        idx = self.rng.integers(0, len(self.words), n_words)
        w = self.words
        return " ".join([w[i] for i in idx.tolist()])

    def shuffled(self, values) -> list:
        """values in an order drawn from the generator."""
        return [values[i] for i in self.rng.permutation(len(values)).tolist()]


def lognormal_lengths(n: int, mu: float, sigma: float, lo: int, hi: int) -> List[int]:
    """The n quantiles (i + 1/2)/n of lognormal(mu, sigma) words, clipped to
    [lo, hi]."""
    nd = statistics.NormalDist(mu, sigma)
    return [int(min(hi, max(lo, np.exp(nd.inv_cdf((i + 0.5) / n))))) for i in range(n)]


def even_lengths(n: int, lo: int, hi: int) -> List[int]:
    """n lengths spread evenly over [lo, hi] words."""
    return [lo + (i * (hi - lo + 1)) // n for i in range(n)]


def stratified_sample(rng: np.random.Generator, lengths: List[int], edges, per: int) -> List[int]:
    """Indices: up to `per` drawn from each length stratum (edges: upper
    bounds, ascending) and the longest item."""
    picked = {int(np.argmax(lengths))}
    lo = -1
    for hi in edges:
        pool = [i for i, n in enumerate(lengths) if lo < n <= hi]
        if pool:
            picked.update(int(i) for i in rng.choice(pool, min(per, len(pool)), replace=False))
        lo = hi
    return sorted(picked)
