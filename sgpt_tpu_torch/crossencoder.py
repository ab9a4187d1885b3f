"""Zero-shot cross-encoder reranking, SGPT-CE: score(query, doc) = log P(query | prompt(doc))
(counterpart of `sgpt_tpu/crossencoder.py`).

Same behaviour as the JAX rankers:

  * main prompt "G": 'Documents are searched to find matches with the same
    content.\\nThe document "{doc}" is a good search result for "',
  * left truncation of (context + continuation) that keeps the instruction
    prefix, raising where the continuation would be cut,
  * request dedup and length-descending order,
  * continuation windows C from `pick_bucket`,
  * score = sum of the continuation tokens' log-probs
    (`ops/logprobs.py`), optional vocab subset and few-shot prefix,
  * `pack_t`: requests no longer than pack_t/2 tokens bin-pack several to a
    row (windowed first-fit-decreasing, at most 16 segments a row) with
    per-segment positions and block-diagonal attention, so each segment
    scores as its own row would.

Unlike the JAX rankers, whose dispatches take the length and row ladders
that bound XLA's compile count, the rows outside the packed path go to the
card in dispatches planned around them (`plan_dispatches`): the
length-sorted rows are cut where the padded token slots plus a fixed cost a
dispatch (`DISPATCH_COST` slots) are least, each dispatch at T = its
longest row rounded up to a multiple of 16, holding at most batch_size ×
max_length slots and no pad rows but a mesh's. The scores are the same up to
the rounding of other GEMM shapes.

The model is the port's `Decoder` on `device` (the card by default). Every
row is built on the host and copied from pinned memory without a
synchronise; each batch's scores start their copy to pinned host memory
right behind its forward and are waited for one batch late (a depth-2
pipeline), so the host packs batch i+1 while the card runs batch i.
`quantize="int8"` scores with int8 decoder projections (`ops/quant.py`) on a
quantized copy of the model. `mesh=` scores over a `parallel.Mesh`, as the
JAX ranker does: each batch's row count is a multiple of dp, dp row i
scores the batch's i-th block of rows (bucketed or packed) on its replica
(tp=1) or its tensor-parallel group (`models.decoder.TPGroup`: K1 per head
shard, the vocab shards of the LM head gathered), and the blocks' scores
come back in row order.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .encoder import place_model
from .models.config import DecoderConfig
from .models.decoder import Decoder, check_token_ids
from .ops.logprobs import continuation_scores_gathered, continuation_scores_packed
from .parallel.collectives import copy_rows_to_host, rows_to_device, wait_rows
from .parallel.mesh import placement
from .tokenization.base import Tokenizer
from .tokenization.specb import ROW_BUCKETS, pick_bucket, row_bucket
from .utils.profiling import span

logger = logging.getLogger(__name__)

# in-flight dispatches before their device-to-host fetch
FETCH_PIPELINE_DEPTH = 2

PROMPT_G = ('Documents are searched to find matches with the same content.\n'
            'The document "{}" is a good search result for "')


def plan_dispatches(lengths: Sequence[int], budget: int, cost: int, cap: int,
                    row_multiple: int = 1) -> List[Tuple[int, int, int]]:
    """Cut rows of non-increasing `lengths` (each at most `cap`) into
    consecutive dispatches [(start, n, T)]: rows start .. start + n - 1 at T
    = the first (longest) row's length rounded up to a multiple of 16, or
    `cap`. A dispatch's slots are its rows, rounded up to `row_multiple` (a
    mesh's dp; the pad rows' scores are dropped), times T; they stay within
    `budget`, except where even `row_multiple` rows at T exceed it, and its
    rows within `ROW_BUCKETS[-1]` (512), which bounds the (rows, C, vocab)
    logits as the row ladder did. The cuts minimise the plan's slots plus
    `cost` slots a dispatch.

    An exact dynamic programme over the sorted rows: each row relaxes the
    dispatches it can start, at most budget // T of them, with one numpy
    update, so the plan costs time linear in the rows."""
    lens = np.asarray(lengths, np.int64)
    n = len(lens)
    if n and (lens[1:] > lens[:-1]).any():
        raise ValueError("plan_dispatches: lengths must be non-increasing")
    T = np.minimum(-(-lens // 16) * 16, cap)
    max_rows = ROW_BUCKETS[-1]
    rows = np.arange(1, max(max_rows, row_multiple) + 1)
    padded = -(-rows // row_multiple) * row_multiple
    best = np.full(n + 1, np.inf)
    best[0] = 0.0
    start = np.zeros(n + 1, np.int64)
    for i in range(n):
        t = int(T[i])
        m = min(max_rows, budget // t) // row_multiple * row_multiple or row_multiple
        m = min(m, n - i)
        cand = best[i] + padded[:m] * t + cost
        seg = best[i + 1 : i + 1 + m]
        better = cand < seg
        seg[better] = cand[better]
        start[i + 1 : i + 1 + m][better] = i
    plan = []
    j = n
    while j > 0:
        i = int(start[j])
        plan.append((i, j - i, int(T[i])))
        j = i
    return plan[::-1]


class CrossEncoderRanker:
    """predict([(query, doc), ...]) -> list of log-prob scores."""

    # segments per packed row: bounds the segment reduction
    PACK_SEG_CAP = 16
    # first-fit-decreasing runs inside windows of this many requests: FFD
    # over a whole BEIR rerank would be quadratic, and neighbours in the
    # length-sorted order are the natural bin partners anyway
    PACK_FFD_WINDOW = 2048
    # a dispatch's fixed cost in token slots (its launches, the LM head's
    # and log-softmax's work, the host's packing of its rows): the bucket
    # path's plan takes one more dispatch where that saves more padded slots
    # (1,024 read 2.0 % more pairs a second than 2,048 on an H100 in the
    # rerank benchmark; PERF.md)
    DISPATCH_COST = 1024

    def __init__(self, model: Decoder, cfg: DecoderConfig, tokenizer: Tokenizer, *,
                 device=None, prompt_doc: str = PROMPT_G, use_prompt: bool = True,
                 fewshots: Optional[Tuple[str, str]] = None,
                 prompt_doc_start: str = "{}\n{}\n",
                 batch_size: int = 16, max_length: Optional[int] = None,
                 vocab_subset: Optional[Sequence[int]] = None,
                 quantize: Optional[str] = None, mesh=None,
                 pack_t: Optional[int] = None):
        """device: where the model runs, the card ("cuda") by default; "cuda"
        without a card raises, and CPU use passes device="cpu"; with a mesh,
        the mesh's first device. quantize: "int8" scores with int8 decoder
        projections on a quantized copy (the caller's model stays float; for
        a model whose two copies do not fit, pass one quantized with
        `free_source=True` and quantize=None). mesh: a `parallel.Mesh` (see
        the module docstring); `model` a `Decoder` (sharded here, after the
        int8 copy) or a `ShardedDecoder` on it. Every other argument has the
        JAX ranker's meaning."""
        if model.cfg != cfg:
            raise ValueError("CrossEncoderRanker: cfg differs from the model's config")
        self.mesh = mesh
        self.device = device = placement(device, mesh, "CrossEncoderRanker")
        self.model = place_model(model, quantize, device, mesh)
        self.quantize = quantize
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.prompt_doc = prompt_doc
        self.use_prompt = use_prompt
        self.batch_size = batch_size
        self.max_length = max_length or cfg.max_position_embeddings
        if cfg.position_embedding == "learned" and self.max_length > cfg.max_position_embeddings:
            # a position past wpe is a device assert on the card, not an error;
            # rotary (GPT-J) and ALiBi (BLOOM) positions have no table, and the
            # JAX ranker takes any max_length for them
            raise ValueError(f"max_length={self.max_length} exceeds the model's "
                             f"{cfg.max_position_embeddings} positions")

        self.pack_t = pack_t
        if pack_t is not None:
            if not 32 <= pack_t <= cfg.max_position_embeddings:
                raise ValueError(
                    f"pack_t={pack_t} out of range [32, "
                    f"{cfg.max_position_embeddings}]")

        # tokens before the doc slot are the protected instruction prefix
        self.instruction_len = len(tokenizer.encode(
            prompt_doc[: prompt_doc.index("{")])) if use_prompt else 0
        self.fewshot_prefix = ""
        if fewshots:
            if not use_prompt:
                # predict() builds the context without the prefix when
                # use_prompt=False, but instruction_len would still count it
                raise ValueError("fewshots require use_prompt=True")
            self.fewshot_prefix = prompt_doc_start.format(fewshots[0], fewshots[1])
            self.instruction_len += len(tokenizer.encode(self.fewshot_prefix))

        self.vocab_mask = None
        if vocab_subset is not None:
            vm = np.zeros((cfg.vocab_size,), bool)
            vm[np.asarray(list(vocab_subset))] = True
            self.vocab_mask = torch.from_numpy(vm).to(device)
        self._vocab_masks = {device: self.vocab_mask}   # its copy on each dp row's device

    # ------------------------------------------------------------------
    def _pack(self, context_enc: List[int], continuation_enc: List[int]):
        """Instruction-preserving left truncation."""
        ilen = min(self.instruction_len, len(context_enc))
        if ilen + len(continuation_enc) > self.max_length + 1:
            # truncation would eat continuation tokens while the full
            # continuation is still scored, at positions inside the instruction
            raise ValueError(
                f"instruction ({ilen} tokens) + continuation "
                f"({len(continuation_enc)}) exceed max_length+1 "
                f"({self.max_length + 1}): continuation tokens would be "
                "truncated away — shorten the instruction/few-shot prefix "
                "or raise max_length")
        body = (context_enc[ilen:] + continuation_enc)[-(self.max_length + 1 - ilen):]
        inp = (context_enc[:ilen] + body)[:-1]
        return inp, len(inp), len(continuation_enc)

    def _check_ids(self, ids: np.ndarray, targets: np.ndarray) -> None:
        """Refuse token ids outside the vocab on the host: on the card an
        out-of-range embedding or gather index is a device assert that
        poisons the context, not an error."""
        for name, a in (("input", ids), ("continuation", targets)):
            check_token_ids(a, self.cfg.vocab_size, name)

    def _dispatch(self, scorer, arrays, *static) -> List[torch.Tensor]:
        """scorer(model, *rows on its device, *static, vocab_mask) for one
        batch: on the model's device, or on a mesh for each dp row's block
        of rows (all launched before any result is read). Returns the
        device results in row order."""
        if self.mesh is None:
            return [scorer(self.model, *rows_to_device(self.device, *arrays), *static,
                           self.vocab_mask)]
        groups = self.model.groups
        n = arrays[0].shape[0] // len(groups)
        outs = []
        for i, g in enumerate(groups):
            if g.device not in self._vocab_masks:
                self._vocab_masks[g.device] = (None if self.vocab_mask is None
                                               else self.vocab_mask.to(g.device))
            rows = [a[i * n:(i + 1) * n] for a in arrays]
            outs.append(scorer(g, *rows_to_device(g.device, *rows), *static,
                               self._vocab_masks[g.device]))
        return outs

    def _rows(self, B: int) -> int:
        """Rows per dispatch: B, on a mesh rounded up to a multiple of dp
        (the pad rows' scores are dropped)."""
        if self.mesh is None:
            return B
        dp = self.mesh.shape["dp"]
        return ((max(B, dp) + dp - 1) // dp) * dp

    def _score_packed(self, keys, rows, uniq, scores):
        """Bin-pack short requests several to a row and score per segment.

        keys/rows arrive length-descending with every inplen <= pack_t//2, so
        each bin holds >= 2 segments and first-fit-decreasing packs rows to
        near-full. Scores land in `scores` via the same uniq fan-out as the
        bucket path."""
        T = self.pack_t
        bins: List[List] = []                      # [used, [(key, inp, inplen, contlen)]]
        with span("ce.plan"):
            for w0 in range(0, len(keys), self.PACK_FFD_WINDOW):
                window_bins: List[List] = []
                for key, (inp, inplen, contlen) in zip(
                        keys[w0 : w0 + self.PACK_FFD_WINDOW],
                        rows[w0 : w0 + self.PACK_FFD_WINDOW]):
                    for b in window_bins:
                        if b[0] + inplen <= T and len(b[1]) < self.PACK_SEG_CAP:
                            b[0] += inplen
                            b[1].append((key, inp, inplen, contlen))
                            break
                    else:
                        window_bins.append([inplen, [(key, inp, inplen, contlen)]])
                bins.extend(window_bins)

        budget = self.batch_size * self.max_length
        B = self._rows(row_bucket(max(1, budget // T)))
        pending: List[Tuple[List, list]] = []   # (rows, copies of the scores to the host)

        def drain():
            with span("ce.drain"):
                pbins, pout = pending.pop(0)
                vals = wait_rows(pout).astype(np.float64)
                for bi, segs in enumerate(pbins):
                    for s, (key, _inp, _il, _cl) in enumerate(segs):
                        for orig in uniq[key]:
                            scores[orig] = vals[bi, s]

        i = 0
        while i < len(bins):
            batch = bins[i : i + min(B, len(bins) - i)]
            i += len(batch)
            with span("ce.pad", rows=B, T=T, tokens=sum(b[0] for b in batch)):
                S = pick_bucket(max(len(b[1]) for b in batch),
                                (2, 4, 8, 16), self.PACK_SEG_CAP)
                maxcont = max(sum(seg[3] for seg in b[1]) for b in batch)
                C = pick_bucket(maxcont, (8, 16, 32, 64, 128, 256), T)
                C = max(C, maxcont)

                ids = np.zeros((B, T), np.int32)
                amask = np.zeros((B, T), np.int32)
                posids = np.zeros((B, T), np.int32)
                segids = np.full((B, T), -1, np.int32)
                cpos = np.zeros((B, C), np.int32)
                ctgt = np.zeros((B, C), np.int32)
                cmask = np.zeros((B, C), np.float32)
                cseg = np.zeros((B, C), np.int32)
                for bi, (_used, segs) in enumerate(batch):
                    off = 0
                    cslot = 0
                    for s, (key, inp, inplen, contlen) in enumerate(segs):
                        ids[bi, off : off + inplen] = inp
                        amask[bi, off : off + inplen] = 1
                        posids[bi, off : off + inplen] = np.arange(inplen)
                        segids[bi, off : off + inplen] = s
                        cont_ids = list(key[1])[-contlen:]
                        cpos[bi, cslot : cslot + contlen] = np.arange(
                            off + inplen - contlen, off + inplen)
                        ctgt[bi, cslot : cslot + contlen] = cont_ids
                        cmask[bi, cslot : cslot + contlen] = 1.0
                        cseg[bi, cslot : cslot + contlen] = s
                        cslot += contlen
                        off += inplen

            with span("ce.dispatch"):
                self._check_ids(ids, ctgt)
                out = self._dispatch(continuation_scores_packed,
                                     (ids, amask, posids, segids, cpos, ctgt, cmask, cseg), S)
                pending.append(([b[1] for b in batch], copy_rows_to_host(out)))
            if len(pending) >= FETCH_PIPELINE_DEPTH:
                drain()
        while pending:
            drain()

    def score_pairs(self, pairs: Sequence[Tuple[str, str]]) -> List[float]:
        """pairs: (continuation, context) token-level requests, already prompted."""
        with span("ce.tokenize"):
            enc_batch = getattr(self.tokenizer, "encode_batch", None)
            if enc_batch is not None and pairs:
                cont_rows = enc_batch([c for c, _ in pairs])
                ctx_rows = enc_batch([x for _, x in pairs])
            else:
                cont_rows = [self.tokenizer.encode(c) for c, _ in pairs]
                ctx_rows = [self.tokenizer.encode(x) for _, x in pairs]
            enc = []
            for (continuation, context), cont, ctx in zip(pairs, cont_rows, ctx_rows):
                if context == "":
                    ctx = [self.tokenizer.eos_id]
                if not cont:
                    cont = [self.tokenizer.eos_id]
                if len(cont) > self.max_length:
                    raise ValueError(
                        f"continuation has {len(cont)} tokens but max_length is "
                        f"{self.max_length}")
                enc.append((ctx, cont))

        scores = np.zeros(len(enc), np.float64)
        short_keys = []
        with span("ce.plan"):
            # dedupe + length-descending order
            uniq: Dict[Tuple, List[int]] = {}
            for i, (ctx, cont) in enumerate(enc):
                uniq.setdefault((tuple(ctx), tuple(cont)), []).append(i)
            keys = sorted(uniq, key=lambda kc: -len(kc[0] + kc[1]))
            packed = [self._pack(list(c), list(t)) for c, t in keys]
            if self.pack_t is not None:
                # short rows leave the bucket path for the bin-packed path; the
                # length-descending order survives the partition in both halves
                half = self.pack_t // 2
                short = [j for j in range(len(keys)) if packed[j][1] <= half]
                if short:
                    short_set = set(short)
                    long_idx = [j for j in range(len(keys)) if j not in short_set]
                    short_keys = [keys[j] for j in short]
                    short_rows = [packed[j] for j in short]
                    keys = [keys[j] for j in long_idx]
                    packed = [packed[j] for j in long_idx]
            # batch_size is the rows per dispatch at full max_length
            plan = plan_dispatches([r[1] for r in packed],
                                   self.batch_size * self.max_length, self.DISPATCH_COST,
                                   self.max_length,
                                   row_multiple=1 if self.mesh is None else self.mesh.shape["dp"])
        if short_keys:
            self._score_packed(short_keys, short_rows, uniq, scores)
        pending: List[Tuple[List, list]] = []   # (rows, copies of the scores to the host)

        def drain():
            with span("ce.drain"):
                pbatch, pout = pending.pop(0)
                vals = wait_rows(pout).astype(np.float64)
                for bi, key in enumerate(pbatch):
                    for orig in uniq[key]:
                        scores[orig] = vals[bi]

        for i, n, T in plan:
            batch = keys[i : i + n]
            rows = packed[i : i + n]
            B = self._rows(n)
            with span("ce.pad", rows=B, T=T, tokens=sum(r[1] for r in rows)):
                # the LM head runs only on these C positions: the (B, T, V)
                # logits never exist
                maxcont = max(r[2] for r in rows)
                C = pick_bucket(maxcont, (8, 16, 32, 64, 128, 256), T)
                C = max(C, maxcont)

                ids = np.zeros((B, T), np.int32)
                cpos = np.zeros((B, C), np.int32)
                ctgt = np.zeros((B, C), np.int32)
                cmask = np.zeros((B, C), np.float32)
                for bi, (inp, inplen, contlen) in enumerate(rows):
                    ids[bi, :inplen] = inp
                    # logits at position t predict token t+1: the continuation
                    # occupies input positions [inplen-contlen, inplen)
                    cpos[bi, :contlen] = np.arange(inplen - contlen, inplen)
                    ctgt[bi, :contlen] = list(batch[bi][1])[-contlen:]
                    cmask[bi, :contlen] = 1.0
                # causal attention: right padding cannot reach a scored position,
                # so a full-ones mask is safe
                amask = np.ones((B, T), np.int32)
            with span("ce.dispatch"):
                self._check_ids(ids, ctgt)
                out = self._dispatch(continuation_scores_gathered,
                                     (ids, amask, cpos, ctgt, cmask))
                pending.append((batch, copy_rows_to_host(out)))
            if len(pending) >= FETCH_PIPELINE_DEPTH:
                drain()
        while pending:
            drain()
        return scores.tolist()

    def predict(self, sentences: Sequence[Tuple[str, str]],
                batch_size: Optional[int] = None, **kw) -> List[float]:
        """sentences: (query, document) pairs — the query is the scored continuation."""
        del batch_size  # fixed at construction
        requests = []
        for query, doc in sentences:
            ctx = (self.fewshot_prefix + self.prompt_doc.format(doc)
                   if self.use_prompt else doc)
            requests.append((query, ctx))
        return self.score_pairs(requests)


PROMPT_YESNO = ('An intelligent, helpful bot is given. The bot responds "Yes" '
                'if the document is a fit to the query and "No" otherwise.\n###\n'
                'Document: {}\nQuery: {}\nBot:')


class YesNoRanker(CrossEncoderRanker):
    """Yes/No classifier variant (prompt "L"): score = log P("Yes" | doc,
    query) with the softmax restricted to the {Yes, No} vocabulary."""

    def __init__(self, model, cfg, tokenizer, *, prompt_doc: str = PROMPT_YESNO,
                 continuation: str = " Yes",
                 sub_select_voc: Sequence[str] = (" Yes", " No"), **kw):
        vocab_ids: List[int] = []
        for word in sub_select_voc:
            vocab_ids.extend(tokenizer.encode(word))
        kw.setdefault("vocab_subset", vocab_ids)
        super().__init__(model, cfg, tokenizer, prompt_doc=prompt_doc, **kw)
        self.continuation = continuation
        if self.fewshot_prefix:
            # the expected answer is appended to the few-shot example and the
            # whole string tokenized once: summing separate encodes would
            # miscount across merge boundaries
            prompt_part = (len(tokenizer.encode(
                prompt_doc[: prompt_doc.index("{")]))
                if self.use_prompt else 0)
            self.fewshot_prefix += continuation
            self.instruction_len = prompt_part + len(
                tokenizer.encode(self.fewshot_prefix))

    def predict(self, sentences: Sequence[Tuple[str, str]],
                batch_size: Optional[int] = None, **kw) -> List[float]:
        requests = []
        for query, doc in sentences:
            ctx = self.fewshot_prefix + self.prompt_doc.format(doc, query)
            requests.append((self.continuation, ctx))
        return self.score_pairs(requests)


def rerank(ranker: CrossEncoderRanker, corpus: Dict[str, Dict[str, str]],
           queries: Dict[str, str], first_stage: Dict[str, Dict[str, float]],
           top_k: int = 100) -> Dict[str, Dict[str, float]]:
    """Rerank first-stage (e.g. BM25) results: each query's top_k documents
    by first-stage score, scored by the ranker."""
    pairs, keys = [], []
    for qid, hits in first_stage.items():
        docs = sorted(hits.items(), key=lambda x: -x[1])[:top_k]
        for did, _ in docs:
            doc = corpus[did]
            text = (doc.get("title", "") + " " + doc.get("text", "")).strip()
            pairs.append((queries[qid], text))
            keys.append((qid, did))
    logger.info("Reranking %d pairs", len(pairs))
    scores = ranker.predict(pairs)
    out: Dict[str, Dict[str, float]] = {qid: {} for qid in first_stage}
    for (qid, did), sc in zip(keys, scores):
        out[qid][did] = float(sc)
    return out
