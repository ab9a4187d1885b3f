"""IVFIndex — the balanced IVF approximate index (counterpart of `sgpt_tpu/index_ivf.py`).

The exact `DenseIndex` reads the whole corpus for every query batch; an IVF
index reads only the clusters a query probes. The JAX design, step for step,
on one torch device:

  * spherical k-means over a training sample (≤ max_train_rows rows), in
    fp32: an argmax of (S, D) @ (D, K) a slab of rows at a time, a segment
    sum (`index_add_`), centroids renormalised each iteration; an empty
    cluster keeps its centroid;
  * the full corpus is assigned in chunks copied to the device
    (`assign_chunk` rows), scored in bf16 (the int8 rows' positive row
    scales cannot change an argmax, so they are skipped);
  * the balanced layout: every cluster pads to one size C_pad (a multiple
    of 8), so the corpus is one (K, C_pad, D) block array; the members past
    C_pad of an oversized cluster spill to an overflow slab that every
    search scans exactly (`blockmax_topk`);
  * search: queries @ centroidsᵀ → the top-nprobe clusters → those blocks
    gathered (`index_select`: only the probed clusters are read, never the
    whole table) → fp32 scores → top-k over the probed union → merged with
    the overflow scan's top-k;
  * `n_clusters="auto"` sweeps K = 8, 16, ... on the training sample (a
    short k-means and one assignment each), estimates each K's overflow
    share against the real C_pad formula, and takes the largest K under
    `auto_overflow_target`;
  * int8 (`quantize="int8"`): rows quantize per row at `add()` (int8 rows
    and fp32 scales, as `DenseIndex`) and stay int8 through every rebuild;
    queries are rounded to bf16 and scores are (q · row) × scale in fp32.

The host draws the sample and the seed rows from one
`np.random.default_rng(seed)` in the JAX order (the auto-K sweep's draws
first), so both packages cluster the same rows. Adds after `build()` go to
a pending slab scanned exactly until the next `build()`; deletes are
tombstones (id -1 in the layout, masked in the pending slab) until then.
`save`/`load` use the JAX `.npz` format, so either package loads the
other's file. Masked slots score -inf; the result filter keeps scores
above -1e29, as the JAX index does.

With `mesh=` (a `parallel.Mesh`) the cluster blocks are cut contiguously
over dp (K padded to a multiple of dp with empty clusters; cluster c on
row block c // (K/dp), on the mesh's `devices[c // (K/dp), 0]`), and so
are the centroids and the overflow slab (padded to block_size × dp rows).
k-means and assignment stay on the first device. Each block probes its
own centroid slice with ceil(nprobe / dp) probes, scans its overflow rows,
and the blocks' candidates merge into the top-k on the first device, as
the JAX sharded probe does: at nprobe < K the union of the blocks' probes
is not the meshless index's global top-nprobe set (nprobe = K is exact).
Saves do not depend on the mesh: a file loads onto any mesh shape, or none.
"""
from __future__ import annotations

import json
import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .index import (_DTYPE_NAMES, _compact_deleted, _decode_ids, _encode_ids, _host,
                    _round_up, _torch_dtype, merge_candidates)
from .ops.pooling import normalize
from .ops.topk import NEG, _top_k, blockmax_topk
from .parallel.mesh import placement
from .parallel.sharding import RowShards

logger = logging.getLogger(__name__)


def _kmeans(corpus: torch.Tensor, seed_idx: np.ndarray, n_clusters: int, iters: int,
            slab: int) -> torch.Tensor:
    """Spherical k-means over (S, D) fp32 normalised rows; returns the
    normalised (K, D) fp32 centroids. seed_idx: the K initial rows."""
    cent = normalize(corpus[torch.from_numpy(np.asarray(seed_idx)).to(corpus.device)])
    for _ in range(iters):
        a = torch.cat([torch.argmax(corpus[s:s + slab] @ cent.T, dim=1)
                       for s in range(0, corpus.shape[0], slab)])
        sums = torch.zeros_like(cent).index_add_(0, a, corpus)
        counts = torch.zeros(n_clusters, device=corpus.device).index_add_(
            0, a, torch.ones(a.shape[0], device=corpus.device))
        new = sums / torch.clamp_min(counts[:, None], 1.0)
        cent = normalize(torch.where(counts[:, None] > 0, new, cent))
    return cent


def _assign_corpus(rows: torch.Tensor, cent: torch.Tensor, slab: int) -> torch.Tensor:
    """Nearest-centroid ids (R,) of int8 or float rows, scored in bf16 (the
    JAX product: bf16 operands, bf16 scores) a slab of rows at a time."""
    cent_t = cent.to(torch.bfloat16).T
    return torch.cat([torch.argmax(rows[s:s + slab].to(torch.bfloat16) @ cent_t, dim=1)
                      for s in range(0, rows.shape[0], slab)])


def _score_probed(q: torch.Tensor, probe: torch.Tensor, blocks: torch.Tensor,
                  block_ids: torch.Tensor, scales: Optional[torch.Tensor], k: int):
    """Score the probed blocks (Q, P) → (scores (Q, k), positions (Q, k)):
    only the probed clusters are read (`index_select`), int8 rows against
    the query in bf16 times the row scales, float rows against the query in
    the stored dtype, all in fp32; pad and tombstoned slots (id -1) at
    -inf. Shared by the meshless probe and each row block of a mesh's."""
    Q, nprobe = probe.shape
    flat = probe.reshape(-1)                                           # (Q·P,)
    quantized = scales is not None
    qc = q.to(torch.bfloat16 if quantized else blocks.dtype).float()
    blk = blocks.index_select(0, flat).float()                         # (Q·P, C, D)
    ids = block_ids.index_select(0, flat)                              # (Q·P, C)
    s = torch.bmm(blk, qc.repeat_interleave(nprobe, dim=0)[:, :, None])[:, :, 0]
    if quantized:
        s = s * scales.index_select(0, flat)
    s = torch.where(ids < 0, NEG, s)
    vals, pos = _top_k(s.reshape(Q, -1), k)
    return vals, torch.gather(ids.reshape(Q, -1), 1, pos)


def _np(t) -> np.ndarray:
    """A device tensor or `RowShards` on the host, in its own dtype."""
    if isinstance(t, RowShards):
        return torch.cat([p.cpu() for p in t.pieces]).numpy()
    return t.cpu().numpy()


def _quantize_rows(emb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8 (the scheme of `DenseIndex(quantize="int8")`)."""
    scale = np.clip(np.abs(emb).max(axis=-1), 1e-12, None) / 127.0
    q = np.round(emb / scale[..., None]).astype(np.int8)
    return q, scale.astype(np.float32)


class IVFIndex:
    """Balanced IVF-flat approximate index on one torch device, with
    `DenseIndex`'s surface (add / build / search_embeddings / delete / save /
    load / len / pending_docs / is_built), so `SearchService` takes either."""

    def __init__(self, dim: int, *, n_clusters="auto",
                 normalize_embeddings: bool = True, pad_factor: float = 1.5,
                 kmeans_iters: int = 10, train_slab: int = 1 << 15,
                 max_train_rows: int = 1 << 18, assign_chunk: int = 1 << 20,
                 nprobe: int = 32, seed: int = 0,
                 dtype=torch.bfloat16, quantize: Optional[str] = None,
                 block_size: int = 128, gather_budget: int = 1 << 28,
                 auto_overflow_target: float = 0.10,
                 auto_sweep_iters: int = 4, mesh=None, device=None):
        """The JAX index's arguments, plus device: where the layout lives, the
        card ("cuda") by default ("cuda" without a card raises; CPU use
        passes device="cpu"), or with a mesh its first device. dtype: of the
        stored float rows (a torch dtype, its name, or a numpy/JAX dtype).
        gather_budget: bytes of probed blocks (in their stored dtype) a
        query chunk may gather on one device; the probe's fp32 copy of them
        is 4 / itemsize times that. mesh: a `parallel.Mesh` whose dp axis
        shards the layout (see the module docstring); `nprobe` keeps meaning
        the total of probed clusters."""
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        if n_clusters != "auto" and (not isinstance(n_clusters, (int, np.integer))
                                     or n_clusters < 1):
            raise ValueError(f"n_clusters must be a positive int or 'auto', "
                             f"got {n_clusters!r}")
        self.dim = dim
        self.n_clusters = n_clusters
        self.normalize = normalize_embeddings
        self.pad_factor = pad_factor
        self.kmeans_iters = kmeans_iters
        self.train_slab = train_slab
        self.max_train_rows = max_train_rows
        self.assign_chunk = assign_chunk
        self.nprobe = nprobe
        self.seed = seed
        self.dtype = _torch_dtype(dtype)
        self.mesh = mesh
        self.device = placement(device, mesh, "IVFIndex")
        self.quantize = quantize
        self.block_size = block_size
        self.gather_budget = gather_budget
        self.auto_overflow_target = auto_overflow_target
        self.auto_sweep_iters = auto_sweep_iters
        self.selected_k: Optional[int] = None
        self._chunks: List[np.ndarray] = []       # int8 when quantized, else fp32
        self._scale_chunks: List[np.ndarray] = []
        self._ids: List[str] = []
        self._count = 0
        self._built_count = 0
        self._k_real = 0
        self._clear_layout()
        self._pending_arr = self._pending_scales = self._pending_mask = None
        self._pending_count = 0
        self._pending_dirty = False
        self._deleted: set = set()   # tombstoned absolute positions
        self._id_pos = None          # lazy id -> position map
        self._pos_loc = None         # lazy position -> (cluster, slot) | overflow

    def _clear_layout(self):
        self._centroids = self._blocks = self._block_ids = self._scales = None
        self._overflow = self._overflow_scales = None
        self._overflow_ids = self._overflow_ids_dev = None   # host (M_pad,) and device
        self._overflow_count = 0

    @property
    def _host_dtype(self):
        return np.int8 if self.quantize == "int8" else np.float32

    def _to_device(self, host: np.ndarray, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(host))
        return (t if dtype is None else t.to(dtype)).to(self.device)

    @property
    def _row_dtype(self) -> Optional[torch.dtype]:
        """Stored rows: int8 verbatim (None: the host dtype), or float in self.dtype."""
        return None if self.quantize == "int8" else self.dtype

    @property
    def _n_dev(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape["dp"]

    def _place(self, host: np.ndarray, dtype: Optional[torch.dtype] = None):
        """Layout state on the device, or cut into the mesh's row blocks."""
        if self.mesh is None:
            return self._to_device(host, dtype)
        return RowShards.put(host, self.mesh, dtype)

    # ------------------------------------------------------------------
    def _install_layout(self, cent, blocks, block_ids, block_scales,
                        ov_rows, ov_scale_vals, ov_id_vals, k_real: int):
        """Place a host block layout on the device or the mesh (build() and
        load(), so a saved index loads onto any mesh shape): K pads to a
        multiple of dp (zero centroids, -1 ids, masked out of the probe by
        k_real), the overflow slab to block_size × dp rows.
        cent (K, D) fp32; blocks (K, C_pad, D); block_ids (K, C_pad);
        ov_rows (m, D) unpadded; ov_id_vals (m,) doc positions."""
        c_pad, d = blocks.shape[1], blocks.shape[2]
        self._k_real = k_real
        n_dev = self._n_dev
        k_pad = _round_up(k_real, n_dev)
        if k_pad != blocks.shape[0]:
            blocks = np.concatenate([blocks[:k_real],
                                     np.zeros((k_pad - k_real, c_pad, d), self._host_dtype)])
            block_ids = np.concatenate([block_ids[:k_real],
                                        np.full((k_pad - k_real, c_pad), -1, np.int32)])
            if block_scales is not None:
                block_scales = np.concatenate([block_scales[:k_real],
                                               np.ones((k_pad - k_real, c_pad), np.float32)])
            cent = np.concatenate([cent[:k_real], np.zeros((k_pad - k_real, d), np.float32)])
        self._centroids = self._place(np.asarray(cent, np.float32))
        self._block_ids = self._place(np.asarray(block_ids, np.int32))
        self._blocks = self._place(blocks, self._row_dtype)
        self._scales = (self._place(np.asarray(block_scales, np.float32))
                        if block_scales is not None else None)
        m = ov_rows.shape[0]
        m_pad = _round_up(max(m, 1), self.block_size * n_dev)
        ov = np.zeros((m_pad, d), self._host_dtype)
        ov_ids = np.full((m_pad,), -1, np.int32)
        ov[:m] = ov_rows
        ov_ids[:m] = ov_id_vals
        self._overflow = self._place(ov, self._row_dtype)
        self._overflow_scales = None
        if self.quantize == "int8":
            ov_scales = np.ones((m_pad,), np.float32)   # pad rows: a harmless scale
            ov_scales[:m] = ov_scale_vals
            self._overflow_scales = self._place(ov_scales)
        self._overflow_ids = ov_ids
        self._overflow_ids_dev = self._place(ov_ids)
        self._overflow_count = m

    def add(self, embeddings, ids: Optional[Sequence[str]] = None):
        """Add embeddings (normalised and quantised on the host). After
        build() they join the pending slab until the next build()."""
        emb = np.asarray(embeddings, np.float32)
        if emb.ndim != 2 or emb.shape[1] != self.dim:
            raise ValueError(f"expected (n, {self.dim}) embeddings, got {emb.shape}")
        if self.normalize:
            emb = emb / np.clip(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12, None)
        start = self._count
        if self.quantize == "int8":
            q, s = _quantize_rows(emb)
            self._chunks.append(q)
            self._scale_chunks.append(s)
        else:
            self._chunks.append(emb)
        self._ids.extend(ids if ids is not None
                         else (str(start + i) for i in range(emb.shape[0])))
        self._count += emb.shape[0]
        self._id_pos = None
        if self._blocks is not None:
            self._pending_dirty = True

    def __len__(self) -> int:
        return self.live_count

    @property
    def live_count(self) -> int:
        """Searchable documents: allocated minus tombstoned."""
        return self._count - len(self._deleted)

    @property
    def is_built(self) -> bool:
        return self._blocks is not None

    @property
    def pending_docs(self) -> int:
        dead = sum(1 for p in self._deleted if p >= self._built_count)
        return self._count - self._built_count - dead

    # -- deletion ------------------------------------------------------------
    def _id_positions(self) -> dict:
        if self._id_pos is None:
            self._id_pos = {i: p for p, i in enumerate(self._ids)}
        return self._id_pos

    def _position_locations(self):
        """Position -> (cluster, slot), or (-1, overflow slot); valid until
        the next build()."""
        if self._pos_loc is None:
            bi = _np(self._block_ids)
            loc_c = np.full(self._built_count, -1, np.int32)
            loc_s = np.full(self._built_count, -1, np.int32)
            ks, ss = np.nonzero(bi >= 0)
            loc_c[bi[ks, ss]] = ks
            loc_s[bi[ks, ss]] = ss
            ov = np.nonzero(self._overflow_ids >= 0)[0]
            loc_s[self._overflow_ids[ov]] = ov   # loc_c stays -1: overflow
            self._pos_loc = (loc_c, loc_s)
        return self._pos_loc

    def delete(self, ids: Sequence[str]) -> int:
        """Tombstone documents: their block or overflow slots get id -1 (which
        search masks), pending rows are masked; the next build() re-clusters
        without them. Raises KeyError for unknown or already deleted ids."""
        ids = list(ids)
        if len(set(ids)) != len(ids):
            raise KeyError("duplicate ids in one delete() call")
        pos_map = self._id_positions()
        missing = [i for i in ids if i not in pos_map or pos_map[i] in self._deleted]
        if missing:
            raise KeyError(f"cannot delete unknown ids: {missing[:5]}")
        blk_c, blk_s, ov_slots = [], [], []
        touched_pending = False
        for i in ids:
            p = pos_map[i]
            self._deleted.add(p)
            if p >= self._built_count:
                touched_pending = True
                continue
            loc_c, loc_s = self._position_locations()
            if loc_c[p] >= 0:
                blk_c.append(int(loc_c[p]))
                blk_s.append(int(loc_s[p]))
            else:
                ov_slots.append(int(loc_s[p]))
        if blk_c:
            if self.mesh is None:
                self._block_ids[torch.tensor(blk_c, device=self.device),
                                torch.tensor(blk_s, device=self.device)] = -1
            else:   # cluster c is row c % (K/dp) of block c // (K/dp)
                per = self._block_ids.pieces[0].shape[0]
                for c, slot in zip(blk_c, blk_s):
                    self._block_ids.pieces[c // per][c % per, slot] = -1
        if ov_slots:
            self._overflow_ids[ov_slots] = -1
            self._overflow_ids_dev = self._place(self._overflow_ids)
        if touched_pending:
            self._pending_mask = None
        return len(ids)

    # ------------------------------------------------------------------
    def _host_corpus(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Every doc (built + pending) as host rows in position order: (int8
        rows, fp32 scales) when quantized, (fp32 rows, None) otherwise."""
        chunks = list(self._chunks)
        scale_chunks = list(self._scale_chunks)
        if self._blocks is not None:
            prev, prev_scales = self._rebuild_host_rows()
            chunks.insert(0, prev)
            if prev_scales is not None:
                scale_chunks.insert(0, prev_scales)
        rows = np.concatenate(chunks, axis=0)
        scales = np.concatenate(scale_chunks) if self.quantize == "int8" else None
        return rows, scales

    def _estimate_overflow(self, counts: np.ndarray, train_n: int, n: int, k: int) -> float:
        """Overflow share for K from the sample's cluster counts, scaled to the
        corpus and spilled against the C_pad that build() will use."""
        c_pad = max(_round_up(int(self.pad_factor * max(1, n // k)), 8), 8)
        est_sizes = counts * (n / train_n)
        return float(np.maximum(est_sizes - c_pad, 0.0).sum() / n)

    def _select_k(self, dev: torch.Tensor, train_n: int, n: int, rng, slab: int) -> int:
        """n_clusters="auto": the largest power-of-two K (8 up to
        train_n // 64, so every estimate averages ≥ 64 sample rows a
        cluster) whose estimated overflow stays under auto_overflow_target;
        if none does, the K of the least overflow."""
        kmax = min(train_n // 64, max(1, n // 8), 1 << 16)
        cands = []
        k = 8
        while k <= kmax:
            cands.append(k)
            k <<= 1
        if not cands:
            return max(1, min(8, n))
        sweep = []
        for K in cands:
            seed_idx = rng.choice(train_n, size=K, replace=False)
            cent = _kmeans(dev, seed_idx, K, self.auto_sweep_iters, slab)
            a = _assign_corpus(dev, cent, slab).cpu().numpy()
            ovf = self._estimate_overflow(np.bincount(a, minlength=K), train_n, n, K)
            sweep.append((K, ovf))
        logger.info("IVF auto-K sweep (sample=%d, target overflow ≤ %.0f%%): %s",
                    train_n, 100 * self.auto_overflow_target,
                    ", ".join(f"K={k}: {o:.1%}" for k, o in sweep))
        under = [k for k, o in sweep if o <= self.auto_overflow_target]
        if under:
            return max(under)
        best = min(sweep, key=lambda t: t[1])
        logger.warning(
            "IVF auto-K: no candidate meets the %.0f%% overflow target (best: K=%d at "
            "%.1f%%) — the corpus has little cluster structure at these granularities; "
            "picking K=%d. Consider a larger pad_factor or the exact DenseIndex.",
            100 * self.auto_overflow_target, best[0], 100 * best[1], best[0])
        return best[0]

    def build(self):
        """(Re-)cluster every doc (built + pending) into the block layout: a
        k-means on the sample, the corpus assigned assign_chunk rows at a
        time, the layout made on the host and copied to the device."""
        if not self._chunks and self._blocks is None:
            raise RuntimeError("build() on an empty index")
        if self._blocks is not None and not self._chunks and not self._deleted:
            return self  # built, nothing pending, nothing to compact
        corpus, scales = self._host_corpus()
        if self._deleted:  # compact tombstones away; positions renumber here
            corpus, scales, self._ids = _compact_deleted(
                corpus, scales, self._ids, self._deleted, self.quantize == "int8")
            self._deleted = set()
        n, d = corpus.shape
        if n == 0:  # everything was deleted: back to the empty, unbuilt state
            self._clear_layout()
            self._count = self._built_count = self._k_real = 0
            self._chunks, self._scale_chunks = [], []
            self._pending_arr = self._pending_scales = self._pending_mask = None
            self._pending_count, self._pending_dirty = 0, False
            self._id_pos = self._pos_loc = None
            return self
        auto = self.n_clusters == "auto"
        K = None if auto else min(self.n_clusters, n)
        rng = np.random.default_rng(self.seed)

        # train on a sample, fp32 on the device
        train_n = min(n, max(self.max_train_rows, K or 0))
        if train_n < n:
            sample_idx = np.sort(rng.choice(n, size=train_n, replace=False))
        else:
            sample_idx = np.arange(n)
        sample = corpus[sample_idx].astype(np.float32)
        if self.quantize == "int8":
            sample *= scales[sample_idx][:, None]
        slab = min(self.train_slab, _round_up(train_n, 8))
        dev = self._to_device(sample)
        del sample
        if auto:
            K = self._select_k(dev, train_n, n, rng, slab)
            logger.info("IVF auto-K selected n_clusters=%d for %d docs", K, n)
        self.selected_k = K
        seed_idx = rng.choice(train_n, size=K, replace=False)
        cent = _kmeans(dev, seed_idx, K, self.kmeans_iters, slab)
        del dev

        # the full corpus, assign_chunk rows at a time
        assign = np.empty(n, np.int64)
        chunk = _round_up(min(self.assign_chunk, n), slab)
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            assign[s:e] = _assign_corpus(self._to_device(corpus[s:e]), cent, slab).cpu().numpy()

        # the balanced block layout (host; rows keep their stored dtype)
        order = np.argsort(assign, kind="stable")
        sizes = np.bincount(assign, minlength=K)
        c_pad = max(_round_up(int(self.pad_factor * max(1, n // K)), 8), 8)
        blocks = np.zeros((K, c_pad, d), self._host_dtype)
        block_ids = np.full((K, c_pad), -1, np.int32)
        block_scales = np.zeros((K, c_pad), np.float32) if self.quantize == "int8" else None
        overflow_ids = []
        pos = 0
        for c in range(K):
            members = order[pos:pos + sizes[c]]
            pos += sizes[c]
            take = members[:c_pad]
            blocks[c, :len(take)] = corpus[take]
            block_ids[c, :len(take)] = take
            if block_scales is not None:
                block_scales[c, :len(take)] = scales[take]
            if len(members) > c_pad:   # spill: scanned exactly, never dropped
                overflow_ids.append(members[c_pad:])
        m = sum(len(o) for o in overflow_ids)
        if m and m / n > self.auto_overflow_target:
            logger.warning(
                "IVF overflow is %.1f%% of the corpus (%d/%d docs past C_pad=%d) — every "
                "search exact-scans that slab, eroding the probe's latency win. K=%d likely "
                "exceeds the corpus's natural cluster count; rebuild with n_clusters='auto' "
                "(sweeps K on the training sample) or a smaller K.",
                100.0 * m / n, m, n, c_pad, K)
        elif m:
            logger.info("IVF overflow: %d/%d docs (%.1f%%) spill past C_pad=%d; they are "
                        "exact-scanned each search", m, n, 100.0 * m / n, c_pad)
        ov_id_vals = np.concatenate(overflow_ids) if m else np.zeros((0,), np.int64)
        ov_rows = corpus[ov_id_vals]
        ov_scale_vals = scales[ov_id_vals] if self.quantize == "int8" else None
        self._install_layout(cent.cpu().numpy(), blocks, block_ids, block_scales,
                             ov_rows, ov_scale_vals, ov_id_vals, K)
        self._built_count = self._count = n
        self._chunks, self._scale_chunks = [], []
        self._pending_arr = self._pending_scales = self._pending_mask = None
        self._pending_count, self._pending_dirty = 0, False
        self._id_pos = self._pos_loc = None
        return self

    def _rebuild_host_rows(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """The built corpus back on the host in position order, in its stored
        dtype (int8 rows and scales when quantized: a rebuild never
        re-quantizes)."""
        flat_ids = _np(self._block_ids).reshape(-1)
        flat = _host(self._blocks).reshape(-1, self.dim)
        ov = _host(self._overflow)
        out = np.zeros((self._built_count, self.dim), self._host_dtype)
        live = flat_ids >= 0
        out[flat_ids[live]] = flat[live]
        keep = self._overflow_ids >= 0
        out[self._overflow_ids[keep]] = ov[keep]
        if self.quantize != "int8":
            return out, None
        scales = np.ones((self._built_count,), np.float32)
        scales[flat_ids[live]] = _np(self._scales).reshape(-1)[live]
        scales[self._overflow_ids[keep]] = _np(self._overflow_scales)[keep]
        return out, scales

    # -- persistence --------------------------------------------------------
    def save(self, path: str):
        """The built state (centroids, block layout, overflow), the pending
        docs and the tombstones in one .npz of the JAX format: float rows as
        float32, int8 rows and scales verbatim."""
        payload = {
            "ids": _encode_ids(self._ids),
            "meta": np.bytes_(json.dumps({
                "kind": "ivf", "dim": self.dim, "n_clusters": self.n_clusters,
                "selected_k": self.selected_k,
                "normalize": self.normalize, "quantize": self.quantize,
                "pad_factor": self.pad_factor, "nprobe": self.nprobe,
                "block_size": self.block_size, "dtype": _DTYPE_NAMES[self.dtype],
                "count": self._count, "built_count": self._built_count,
                "overflow_count": self._overflow_count, "k_real": self._k_real,
                "built": self._blocks is not None,
            }).encode()),
        }
        if self._blocks is not None:
            m, kr = self._overflow_count, self._k_real
            payload.update(
                centroids=_np(self._centroids)[:kr],
                blocks=_host(self._blocks)[:kr],
                block_ids=_np(self._block_ids)[:kr],
                overflow=_host(self._overflow)[:m], overflow_ids=self._overflow_ids[:m])
            if self.quantize == "int8":
                payload["scales"] = _np(self._scales)[:kr]
                payload["overflow_scales"] = _np(self._overflow_scales)[:m]
        if self._chunks:
            payload["pending"] = np.concatenate(self._chunks)
            if self.quantize == "int8":
                payload["pending_scales"] = np.concatenate(self._scale_chunks)
        if self._deleted:
            payload["deleted"] = np.asarray(sorted(self._deleted), np.int64)
        np.savez(path, **payload)

    @classmethod
    def load(cls, path: str, **kw) -> "IVFIndex":
        """Restore a save()d index (either package's) without re-clustering.
        kw: device, mesh and the other constructor arguments."""
        z = np.load(path)
        meta = json.loads(bytes(z["meta"]))
        if meta.get("kind") != "ivf":
            raise ValueError(f"{path} holds a {meta.get('kind')!r} index; "
                             "use the matching class to load it")
        idx = cls(meta["dim"], n_clusters=meta["n_clusters"],
                  normalize_embeddings=meta["normalize"], quantize=meta["quantize"],
                  pad_factor=meta["pad_factor"], nprobe=meta["nprobe"],
                  block_size=meta["block_size"], dtype=meta["dtype"], **kw)
        idx._ids = _decode_ids(z["ids"], meta["count"])
        idx._count = meta["count"]
        idx._built_count = meta["built_count"]
        idx.selected_k = meta.get("selected_k")
        if meta["built"]:
            quant = meta["quantize"] == "int8"
            kr = meta.get("k_real", z["centroids"].shape[0])
            m = meta["overflow_count"]
            host_dtype = idx._host_dtype
            idx._install_layout(
                z["centroids"][:kr], z["blocks"][:kr].astype(host_dtype, copy=False),
                z["block_ids"][:kr], z["scales"][:kr] if quant else None,
                z["overflow"][:m].astype(host_dtype, copy=False),
                z["overflow_scales"][:m] if quant else None, z["overflow_ids"][:m], kr)
        if "pending" in z.files:
            idx._chunks = [z["pending"]]
            if meta["quantize"] == "int8":
                idx._scale_chunks = [z["pending_scales"]]
            idx._pending_dirty = True
        if "deleted" in z.files:
            idx._deleted = set(z["deleted"].tolist())
        return idx

    # ------------------------------------------------------------------
    def _probe(self, q: torch.Tensor, k: int, nprobe: int):
        """The top-nprobe clusters of each query, their blocks scored
        (`_score_probed`) → (scores (Q, k), positions (Q, k))."""
        probe = _top_k(q @ self._centroids.T, nprobe)[1]                 # (Q, P)
        return _score_probed(q, probe, self._blocks, self._block_ids, self._scales, k)

    def _probe_sharded(self, q: torch.Tensor, k_eff: int, nprobe_local: int):
        """The JAX sharded probe: each row block probes its own centroid
        slice (padded clusters masked) with nprobe_local probes and scans its
        overflow rows; the blocks' candidates merge into the top k_final."""
        n_dev = self._n_dev
        k_local = self._centroids.shape[0] // n_dev
        c_pad = self._blocks.shape[1]
        kc_l = min(k_eff, nprobe_local * c_pad)
        ov_rows = self._overflow.shape[0] // n_dev
        k_ov = min(k_eff, ov_rows)
        k_final = min(k_eff, n_dev * (kc_l + k_ov))

        results = []
        for i in range(n_dev):
            def piece(t):
                return None if t is None else t.pieces[i]
            qd = q.to(piece(self._centroids).device)
            cs = qd @ piece(self._centroids).T                          # (Q, K/dp)
            gc = i * k_local + torch.arange(k_local, device=qd.device)
            cs = torch.where(gc[None, :] < self._k_real, cs, NEG)      # pad clusters out
            probe = _top_k(cs, nprobe_local)[1]
            tv, ti = _score_probed(qd, probe, piece(self._blocks), piece(self._block_ids),
                                   piece(self._scales), kc_l)
            # the overflow rows: pad slots and tombstones masked by their ids
            ov_ids = piece(self._overflow_ids_dev)
            ov_v, ov_i = blockmax_topk(qd, piece(self._overflow), ov_rows, k=k_ov,
                                       block_size=self.block_size,
                                       corpus_scale=piece(self._overflow_scales),
                                       row_mask=ov_ids >= 0)
            results.append((torch.cat([tv, ov_v], dim=1),
                            torch.cat([ti, ov_ids[ov_i.long()]], dim=1)))
        return merge_candidates(results, k_final, q.device)

    def _probe_overflow(self, q: torch.Tensor, k: int, k_ov: int, nprobe: int):
        """The probe, the exact overflow scan (pad and tombstoned rows masked)
        and their top (k + k_ov) candidates."""
        tv, ti = self._probe(q, k, nprobe)
        ov_v, ov_i = blockmax_topk(q, self._overflow, self._overflow_count, k=k_ov,
                                   block_size=self.block_size,
                                   corpus_scale=self._overflow_scales,
                                   row_mask=self._overflow_ids_dev >= 0)
        # blockmax's -inf filler slots carry row 0: their score keeps them
        # out of any top-k with real candidates left, and the result filter
        # drops the rest
        gi = torch.cat([ti, self._overflow_ids_dev[ov_i.long()]], dim=1)
        gv = torch.cat([tv, ov_v], dim=1)
        vals, pos = _top_k(gv, min(k + k_ov, gv.shape[1]))
        return vals, torch.gather(gi, 1, pos)

    def _search_pending(self, qd: torch.Tensor, k: int):
        if self._pending_arr is None or self._pending_dirty:
            pend = np.concatenate(self._chunks, axis=0)
            n = pend.shape[0]
            blocks = -(-n // self.block_size)
            n_pad = self.block_size * (1 << max(0, (blocks - 1).bit_length()))
            padded = np.zeros((n_pad, self.dim), self._host_dtype)
            padded[:n] = pend
            self._pending_arr = self._to_device(padded, self._row_dtype)  # first device
            self._pending_scales = None
            if self.quantize == "int8":
                s = np.ones((n_pad,), np.float32)
                s[:n] = np.concatenate(self._scale_chunks)
                self._pending_scales = self._to_device(s)
            self._pending_count = n
            self._pending_dirty = False
            self._pending_mask = None
        if self._pending_mask is None:
            dead = [p - self._built_count for p in self._deleted if p >= self._built_count]
            if dead:
                m = np.ones(self._pending_arr.shape[0], bool)
                m[dead] = False
                self._pending_mask = self._to_device(m)
        # k is clamped after the refresh above: _pending_count is stale until then
        vals, idx = blockmax_topk(qd, self._pending_arr, self._pending_count,
                                  k=min(k, self._pending_count), block_size=self.block_size,
                                  corpus_scale=self._pending_scales,
                                  row_mask=self._pending_mask)
        return vals.cpu().numpy(), idx.cpu().numpy()

    def search_embeddings(self, query_embeddings, k: int = 10, *,
                          nprobe: Optional[int] = None, qchunk: Optional[int] = None
                          ) -> Tuple[List[np.ndarray], List[List[str]]]:
        """(per-query score arrays, per-query doc-id lists), DenseIndex's
        contract. qchunk: queries a dispatch; by default as many (≤ 16) as
        keep the gathered blocks under gather_budget."""
        q = np.asarray(query_embeddings, np.float32)
        if q.size == 0:
            return [], []
        if self._blocks is None:
            if self._chunks:
                raise RuntimeError("search before build(): added embeddings are still "
                                   "pending — call build() first")
            return [np.zeros((0,), np.float32) for _ in q], [[] for _ in q]
        if self.live_count == 0:
            return [np.zeros((0,), np.float32) for _ in q], [[] for _ in q]
        if self.normalize:
            q = q / np.clip(np.linalg.norm(q, axis=1, keepdims=True), 1e-12, None)
        nprobe = min(nprobe or self.nprobe, self._k_real)
        c_pad = int(self._blocks.shape[1])
        n_dev = self._n_dev
        nprobe_local = min(-(-nprobe // n_dev), int(self._centroids.shape[0]) // n_dev)
        if qchunk is None:   # the JAX budget: one device's gathered blocks, stored dtype
            row_bytes = nprobe_local * c_pad * self.dim * self._blocks.element_size()
            qchunk = max(1, min(16, self.gather_budget // max(row_bytes, 1)))
        k_eff = min(k, self.live_count)
        kc = min(k_eff, nprobe * c_pad)

        vals_l, ids_l = [], []
        for s in range(0, q.shape[0], qchunk):
            qs = self._to_device(q[s:s + qchunk])
            if self.mesh is not None:
                tv, ti = self._probe_sharded(qs, k_eff, nprobe_local)
            elif self._overflow_count:
                tv, ti = self._probe_overflow(qs, kc, min(k_eff, self._overflow_count), nprobe)
            else:
                tv, ti = self._probe(qs, kc, nprobe)
            tv, ti = tv.cpu().numpy(), ti.cpu().numpy()
            if self._chunks:
                pv, pi = self._search_pending(qs, k_eff)
                tv = np.concatenate([tv, pv], axis=1)
                ti = np.concatenate([ti, pi + self._built_count], axis=1)
                order = np.argsort(-tv, axis=1, kind="stable")
                tv = np.take_along_axis(tv, order, axis=1)
                ti = np.take_along_axis(ti, order, axis=1)
            vals_l.append(tv[:, :k_eff])
            ids_l.append(ti[:, :k_eff])
        vals = np.concatenate(vals_l, axis=0)
        idx = np.concatenate(ids_l, axis=0)
        finite = (vals > -1e29) & (idx >= 0)
        ids = [[self._ids[int(i)] for i, ok in zip(row_i, row_f) if ok]
               for row_i, row_f in zip(idx, finite)]
        return [row_v[row_f] for row_v, row_f in zip(vals, finite)], ids
