"""DenseIndex — the embed → index → query engine (counterpart of `sgpt_tpu/index.py`).

The corpus lives on one torch device, padded to a static shape;
`kernel="blockmax"` (the default) searches it with the plain-torch
block-max scan of `ops/topk.py`, and `kernel="pallas"` (the JAX name, kept
so that code written against the JAX API runs unchanged) with the streaming
MIPS kernel of `ops/mips.py` (K5 on a CUDA device). Adds after `build()`
join a pending slab that search scans alongside the built corpus; deletes
are tombstones until the next `build()` or `save()`; `save`/`load` use the
JAX package's `.npz` format, so an index saved by either package loads in
the other.

With `mesh=` (a `parallel.Mesh`; block-max only, as in JAX) the padded
corpus is cut into dp contiguous row blocks, block i on the mesh's
`devices[i, 0]` (`parallel.RowShards`; int8 scales and tombstone masks cut
with it). A query batch goes to every block; each scans its rows with its
base offset and `clip(count − base, 0, rows)` valid rows, and the blocks'
candidates merge into the top-k on the first device (ties to the lower
block, as JAX's all_gather + top_k order them). The pending slab stays on
the first device. Saves do not depend on the mesh: a file loads onto any
mesh shape, or none.
"""
from __future__ import annotations

import json
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .ops.pooling import normalize
from .ops.topk import _top_k, blockmax_topk
from .parallel.mesh import placement
from .parallel.sharding import RowShards
from .utils.profiling import span

# dtype names of the saved format (`meta["dtype"]`); mapped by name, since
# numpy has no bfloat16 without ml_dtypes
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a name, or a numpy/JAX dtype-like."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    if name not in _DTYPES:
        raise ValueError(f"DenseIndex: dtype {dtype!r}; supported: {sorted(_DTYPES)}")
    return _DTYPES[name]


def _host(t, n: Optional[int] = None) -> np.ndarray:
    """A device tensor (or `RowShards`), its first n rows, on the host:
    float rows as float32 (exact for bf16), int8 rows as int8."""
    if isinstance(t, RowShards):
        return t.host()[:n]
    t = t[:n].detach().cpu()
    return t.numpy() if t.dtype == torch.int8 else t.float().numpy()


def merge_candidates(results, k: int, device) -> tuple:
    """Each row block's (values (Q, c), positions (Q, c)) → the top-k of
    their union on `device`, ties to the lower block (JAX's all_gather +
    top_k order)."""
    all_v = torch.cat([v.to(device) for v, _ in results], dim=1)
    all_i = torch.cat([i.long().to(device) for _, i in results], dim=1)
    top_v, pos = _top_k(all_v, min(k, all_v.shape[1]))
    return top_v, torch.gather(all_i, 1, pos)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _encode_ids(ids: List[str]) -> np.ndarray:
    """Doc ids → one newline-joined utf-8 uint8 buffer (the JAX format)."""
    joined = "\n".join(ids)
    if joined.count("\n") != max(len(ids) - 1, 0):
        raise ValueError("doc ids containing newlines cannot be persisted")
    return np.frombuffer(joined.encode("utf-8"), np.uint8)


def _decode_ids(buf: np.ndarray, n: int) -> List[str]:
    """Inverse of _encode_ids; `n` tells zero ids from one empty id."""
    raw = buf.tobytes().decode("utf-8")
    ids = raw.split("\n") if n else []
    if len(ids) != n:
        raise ValueError(f"corrupt id buffer: {len(ids)} ids for {n} docs")
    return ids


def _compact_deleted(rows: np.ndarray, scales: Optional[np.ndarray],
                     ids: List[str], deleted: set, quantized: bool):
    """Drop tombstoned absolute positions from position-ordered host state."""
    keep = np.ones(rows.shape[0], bool)
    keep[list(deleted)] = False
    rows = rows[keep]
    if quantized:
        scales = scales[keep]
    ids = [i for i, kp in zip(ids, keep) if kp]
    return rows, scales, ids


class DenseIndex:
    """Exact MIPS index over corpus embeddings on one torch device."""

    def __init__(self, dim: int, *, normalize_embeddings: bool = True,
                 mesh=None, block_size: int = 128, dtype=torch.bfloat16,
                 kernel: str = "blockmax", slab_size: int = 1 << 20,
                 quantize: Optional[str] = None, device=None):
        """kernel: 'blockmax' (block-max scan, any k) or 'pallas' (the
        streaming MIPS kernel K5, k <= 16; single device). slab_size: max
        docs scored per matmul (per row block on a mesh). quantize: 'int8'
        stores per-row symmetric int8 rows and fp32 scales (blockmax only).
        dtype: of the stored corpus and the queries (a torch dtype, its
        name, or a numpy/JAX dtype). device: where the corpus lives, the card
        ('cuda') by default; 'cuda' without a card raises, and CPU use passes
        device='cpu'. mesh: a `parallel.Mesh` whose dp axis shards the corpus
        (see the module docstring); device is then its first device."""
        if kernel not in ("blockmax", "pallas"):
            raise ValueError(f"unknown kernel {kernel!r}; supported: 'blockmax', 'pallas'")
        if kernel == "pallas" and mesh is not None:
            raise ValueError("pallas kernel is single-device; use blockmax with a mesh")
        self.dim = dim
        self.normalize = normalize_embeddings
        self.mesh = mesh
        self.block_size = block_size
        self.slab_size = _round_up(max(slab_size, block_size), block_size)
        self.dtype = _torch_dtype(dtype)
        self.device = placement(device, mesh, "DenseIndex")
        self.kernel = kernel
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r}; "
                             "supported: 'int8'")
        if kernel == "pallas" and quantize is not None:
            raise ValueError("the pallas streaming kernel scores float tiles; "
                             "use kernel='blockmax' with quantize='int8'")
        self.quantize = quantize
        self._chunks: List[np.ndarray] = []
        self._scale_chunks: List[np.ndarray] = []
        self._ids: List[str] = []
        self._corpus: Optional[torch.Tensor] = None  # device tensor after build()
        self._scales: Optional[torch.Tensor] = None  # (N,) fp32 when quantized
        self._count = 0           # total valid docs (built + pending)
        self._built_count = 0     # docs inside the built device corpus
        self._slab_eff = self.slab_size   # set per corpus by _padded_size
        self._pending_arr = None
        self._pending_scales = None
        self._pending_count = 0
        self._pending_dirty = False
        self._deleted: set = set()   # tombstoned absolute positions
        self._mask_host = None       # (N_pad,) bool over the BUILT corpus
        self._row_mask = None        # its device copy
        self._pending_mask = None    # device (pad,) bool over the pending slab
        self._id_pos = None          # lazy id -> position map for delete()

    # ------------------------------------------------------------------
    def add(self, embeddings, ids: Optional[Sequence[str]] = None):
        """Add embeddings (normalised and quantised on the host). Before
        build(): accumulate. After build(): they join the pending slab that
        search scans until the next build()."""
        emb = np.asarray(embeddings, np.float32)
        if self.normalize:
            emb = emb / np.clip(np.linalg.norm(emb, axis=1, keepdims=True),
                                1e-12, None)
        start = self._count
        if self.quantize == "int8":
            scale = np.clip(np.abs(emb).max(axis=1), 1e-12, None) / 127.0
            self._scale_chunks.append(scale.astype(np.float32))
            emb = np.round(emb / scale[:, None]).astype(np.int8)
        self._chunks.append(emb)
        self._ids.extend(ids if ids is not None
                         else (str(start + i) for i in range(emb.shape[0])))
        self._count += emb.shape[0]
        self._id_pos = None
        if self._corpus is not None:
            self._pending_dirty = True

    def _id_positions(self) -> dict:
        if self._id_pos is None:
            # duplicates map to the LAST-added occurrence
            self._id_pos = {i: p for p, i in enumerate(self._ids)}
        return self._id_pos

    def delete(self, ids: Sequence[str]) -> int:
        """Tombstone documents: they never appear in results from now on;
        the next build() or save() compacts them away. Raises KeyError for
        unknown or already deleted ids."""
        if self.kernel == "pallas":
            raise ValueError("delete() requires kernel='blockmax' (the pallas "
                             "streaming kernel has no tombstone-mask input)")
        ids = list(ids)
        if len(set(ids)) != len(ids):
            raise KeyError("duplicate ids in one delete() call")
        pos_map = self._id_positions()
        missing = [i for i in ids
                   if i not in pos_map or pos_map[i] in self._deleted]
        if missing:
            raise KeyError(f"cannot delete unknown ids: {missing[:5]}")
        built_pos = []
        touched_pending = False
        for i in ids:
            p = pos_map[i]
            self._deleted.add(p)
            if p < self._built_count:
                built_pos.append(p)
            else:
                touched_pending = True
        if built_pos and self._corpus is not None:
            if self._mask_host is None:
                self._mask_host = np.ones(self._corpus.shape[0], bool)
            self._mask_host[built_pos] = False
            self._row_mask = self._place(self._mask_host, torch.bool)
        if touched_pending:
            self._pending_mask = None  # rebuilt lazily in _search_pending
        return len(ids)

    @property
    def live_count(self) -> int:
        """Searchable documents: allocated minus tombstoned."""
        return self._count - len(self._deleted)

    @classmethod
    def from_device_embeddings(cls, corpus: torch.Tensor,
                               ids: Optional[Sequence[str]] = None, *,
                               mesh=None, normalize_embeddings: bool = False,
                               block_size: int = 128) -> "DenseIndex":
        """Wrap an (N, D) embedding tensor already on its device (no host
        copy; with a mesh, its row blocks are copied to the mesh's devices)."""
        n, dim = corpus.shape
        if normalize_embeddings:
            corpus = normalize(corpus)  # on the device; queries normalise at search
        idx = cls(dim, normalize_embeddings=normalize_embeddings, mesh=mesh,
                  block_size=block_size, dtype=corpus.dtype,
                  device=None if mesh is not None else corpus.device)
        idx._count = n
        idx._built_count = n
        idx._ids = list(ids) if ids is not None else [str(i) for i in range(n)]
        n_pad = idx._padded_size(n)
        if n_pad != n:
            corpus = torch.cat([corpus, corpus.new_zeros((n_pad - n, dim))])
        idx._corpus = (corpus.contiguous() if mesh is None
                       else RowShards.put(corpus, mesh))
        return idx

    @property
    def _n_dev(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape["dp"]

    def _padded_size(self, n: int) -> int:
        """Corpus rows after padding: a multiple of block_size × dp. A row
        block larger than the slab budget splits into equal block-aligned
        slabs of at most slab_size rows (sets self._slab_eff). The JAX
        arithmetic."""
        n_dev = self._n_dev
        granularity = self.block_size * n_dev
        n_pad = max(_round_up(n, granularity), granularity)
        shard = n_pad // n_dev
        self._slab_eff = self.slab_size
        if shard > self.slab_size:
            shard_blocks = shard // self.block_size
            slab_blocks = self.slab_size // self.block_size
            k = -(-shard_blocks // slab_blocks)
            self._slab_eff = -(-shard_blocks // k) * self.block_size
            n_pad = k * self._slab_eff * n_dev
        return n_pad

    def _to_device(self, host: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        return torch.from_numpy(host).to(dtype).to(self.device)

    def _place(self, host: np.ndarray, dtype: torch.dtype):
        """Built-corpus state (rows, scales, masks) on the device, or cut
        into the mesh's row blocks."""
        if self.mesh is None:
            return self._to_device(host, dtype)
        return RowShards.put(host, self.mesh, dtype)

    def build(self):
        """Pad to a static shape and place on the device. If a corpus is
        built and docs were added or deleted since, the built rows come back
        to the host once and merge with the pending ones."""
        host_dtype = np.int8 if self.quantize == "int8" else np.float32
        chunks = list(self._chunks)
        scale_chunks = list(self._scale_chunks)
        if self._corpus is not None:
            if not chunks and not self._deleted:
                return self  # nothing pending, nothing to compact
            chunks.insert(0, _host(self._corpus, self._built_count).astype(host_dtype))
            if self.quantize == "int8":
                scale_chunks.insert(0, _host(self._scales, self._built_count))
        emb = (np.concatenate(chunks, axis=0) if chunks
               else np.zeros((0, self.dim), host_dtype))
        all_scales = (np.concatenate(scale_chunks) if scale_chunks
                      else np.zeros((0,), np.float32))
        if self._deleted:  # compact tombstones away; positions renumber here
            emb, all_scales, self._ids = _compact_deleted(
                emb, all_scales, self._ids, self._deleted,
                self.quantize == "int8")
            self._deleted = set()
        self._mask_host = None
        self._row_mask = None
        self._pending_mask = None
        self._id_pos = None
        self._count = emb.shape[0]
        self._built_count = self._count
        n_pad = self._padded_size(self._count)
        padded = np.zeros((n_pad, self.dim), host_dtype)
        padded[: self._count] = emb
        if self.quantize == "int8":
            self._corpus = self._place(padded, torch.int8)
            scales = np.ones((n_pad,), np.float32)  # pad rows: harmless scale
            scales[: self._count] = all_scales
            self._scales = self._place(scales, torch.float32)
        else:
            self._corpus = self._place(padded, self.dtype)
        self._chunks = []
        self._scale_chunks = []
        self._pending_arr = None
        self._pending_scales = None
        return self

    # ------------------------------------------------------------------
    def _search_built(self, queries: torch.Tensor, k: int):
        if self.kernel == "pallas":
            from .ops.mips import mips_topk
            return mips_topk(queries, self._corpus, self._built_count, k=k)
        if self.mesh is None:
            return blockmax_topk(queries, self._corpus, self._built_count, k=k,
                                 block_size=self.block_size, slab_size=self._slab_eff,
                                 corpus_scale=self._scales, row_mask=self._row_mask)
        # each row block: its rows from `base`, clip(count − base, 0, rows) valid
        rows = self._corpus.pieces[0].shape[0]
        slab = self._slab_eff if rows % self._slab_eff == 0 else rows
        results = []
        for i, piece in enumerate(self._corpus.pieces):
            base = i * rows
            vals, idx = blockmax_topk(
                queries.to(piece.device), piece, min(max(self._built_count - base, 0), rows),
                k=k, block_size=self.block_size, slab_size=slab,
                corpus_scale=None if self._scales is None else self._scales.pieces[i],
                row_mask=None if self._row_mask is None else self._row_mask.pieces[i])
            results.append((vals, idx.long() + base))
        return merge_candidates(results, k, queries.device)

    def _search_pending(self, qd: torch.Tensor, k: int):
        """Exact top-k over the pending docs with blockmax_topk (for either
        kernel, as in JAX). The slab pads to a power-of-two multiple of
        block_size."""
        if self._pending_arr is None or self._pending_dirty:
            host_dtype = np.int8 if self.quantize == "int8" else np.float32
            pend = np.concatenate(self._chunks, axis=0)
            n = pend.shape[0]
            blocks = -(-n // self.block_size)
            n_pad = self.block_size * (1 << max(0, (blocks - 1).bit_length()))
            padded = np.zeros((n_pad, self.dim), host_dtype)
            padded[:n] = pend
            if self.quantize == "int8":
                scales = np.ones((n_pad,), np.float32)
                scales[:n] = np.concatenate(self._scale_chunks)
                self._pending_scales = self._to_device(scales, torch.float32)
                self._pending_arr = self._to_device(padded, torch.int8)
            else:
                self._pending_arr = self._to_device(padded, self.dtype)
            self._pending_count = n
            self._pending_dirty = False
            self._pending_mask = None
        if self._pending_mask is None:
            dead = [p - self._built_count for p in self._deleted
                    if p >= self._built_count]
            if dead:
                m = np.ones(self._pending_arr.shape[0], bool)
                m[dead] = False
                self._pending_mask = torch.from_numpy(m).to(self.device)
        vals, idx = blockmax_topk(qd, self._pending_arr, self._pending_count,
                                  k=k, block_size=self.block_size,
                                  slab_size=self.slab_size,
                                  corpus_scale=self._pending_scales,
                                  row_mask=self._pending_mask)
        return vals.cpu().numpy(), idx.cpu().numpy()

    def search_embeddings(self, query_embeddings, k: int = 10
                          ) -> Tuple[List[np.ndarray], List[List[str]]]:
        """(per-query score arrays, per-query doc-id lists), in query order.
        Rows may be shorter than k when the index holds fewer live docs."""
        q = np.asarray(query_embeddings, np.float32)
        if q.size == 0:
            return [], []
        if self._corpus is None and self._chunks:
            raise RuntimeError(
                "search before build(): added embeddings are still pending — "
                "call build() first (searching now would silently return "
                "zero hits)")
        if self.live_count == 0:
            return ([np.zeros((0,), np.float32) for _ in q], [[] for _ in q])
        with span("index.search"):
            qd = self._to_device(q, self.dtype)  # queries round to the index dtype
            if self.normalize:
                qd = normalize(qd)
            k = min(k, self.live_count)
            vals, idx = self._search_built(qd, k)
            vals = vals.cpu().numpy().astype(np.float32)
            idx = idx.cpu().numpy()
            if self._chunks:
                # docs added after build(): scan the pending slab too and merge
                # the candidates on the host (stable: built rows first on ties)
                p_vals, p_idx = self._search_pending(qd, k)
                vals = np.concatenate([vals, p_vals], axis=1)
                idx = np.concatenate([idx, p_idx + self._built_count], axis=1)
                order = np.argsort(-vals, axis=1, kind="stable")[:, :k]
                vals = np.take_along_axis(vals, order, axis=1)
                idx = np.take_along_axis(idx, order, axis=1)
        # filler slots (masked padding) carry index 0: trim scores and ids together
        finite = vals > -1e29
        ids = [[self._ids[int(i)] for i, ok in zip(row_i, row_f) if ok]
               for row_i, row_f in zip(idx, finite)]
        return [row_v[row_f] for row_v, row_f in zip(vals, finite)], ids

    def __len__(self) -> int:
        return self.live_count

    @property
    def is_built(self) -> bool:
        """True once build() has placed a searchable corpus on the device."""
        return self._corpus is not None

    @property
    def pending_docs(self) -> int:
        """Live docs added since the last build() (pending-slab scanned)."""
        dead = sum(1 for p in self._deleted if p >= self._built_count)
        return self._count - self._built_count - dead

    # -- persistence --------------------------------------------------------
    def save(self, path: str):
        """Persist all docs (built + pending), compacted, to one .npz in the
        JAX package's format (float rows as float32, int8 rows and scales
        verbatim)."""
        host_dtype = np.int8 if self.quantize == "int8" else np.float32
        rows, scales = [], []
        if self._corpus is not None:
            rows.append(_host(self._corpus, self._built_count).astype(host_dtype))
            if self.quantize == "int8":
                scales.append(_host(self._scales, self._built_count))
        rows.extend(self._chunks)
        scales.extend(self._scale_chunks)
        all_rows = (np.concatenate(rows) if rows
                    else np.zeros((0, self.dim), host_dtype))
        all_scales = (np.concatenate(scales) if scales
                      else np.zeros((0,), np.float32))
        save_ids = self._ids
        if self._deleted:
            all_rows, all_scales, save_ids = _compact_deleted(
                all_rows, all_scales, self._ids, self._deleted,
                self.quantize == "int8")
        payload = {
            "rows": all_rows,
            "ids": _encode_ids(save_ids),
            "meta": np.bytes_(json.dumps({
                "kind": "dense", "dim": self.dim,
                "normalize": self.normalize, "quantize": self.quantize,
                "block_size": self.block_size, "dtype": _DTYPE_NAMES[self.dtype],
                "count": len(save_ids), "built": self._corpus is not None,
            }).encode()),
        }
        if self.quantize == "int8":
            payload["scales"] = all_scales
        np.savez(path, **payload)

    @classmethod
    def load(cls, path: str, *, mesh=None, **kw) -> "DenseIndex":
        """Restore a save()d index (either package's), onto `mesh` or none
        whatever the mesh it was saved from; re-runs build() if it was built
        when saved. kw: kernel, device, slab_size."""
        z = np.load(path)
        meta = json.loads(bytes(z["meta"]))
        if meta.get("kind") != "dense":
            raise ValueError(f"{path} holds a {meta.get('kind')!r} index; "
                             "use the matching class to load it")
        idx = cls(meta["dim"], normalize_embeddings=meta["normalize"],
                  quantize=meta["quantize"], block_size=meta["block_size"],
                  dtype=meta["dtype"], mesh=mesh, **kw)
        rows = z["rows"]
        if rows.shape[0]:
            idx._chunks = [rows]
            if meta["quantize"] == "int8":
                idx._scale_chunks = [z["scales"]]
        idx._ids = _decode_ids(z["ids"], meta["count"])
        idx._count = meta["count"]
        if meta["built"] and rows.shape[0]:
            idx.build()
        return idx


def index_corpus(engine, corpus, *, mesh=None, batch_docs: int = 50_000,
                 normalize_embeddings: bool = True, **index_kw) -> DenseIndex:
    """Embed a BEIR-shaped corpus ({docid: {title, text}}, or a list) into a
    DenseIndex on the engine's device (unless index_kw names another) or
    sharded over `mesh`, longest documents first, batch_docs at a time."""
    doc_ids = sorted(
        corpus, key=lambda d: len(corpus[d].get("title", "") + corpus[d].get("text", "")),
        reverse=True) if isinstance(corpus, dict) else list(range(len(corpus)))
    get = corpus.__getitem__  # works for dict (by id) and list (by position)

    if mesh is None:
        index_kw.setdefault("device", engine.device)
    index = DenseIndex(engine.out_dim, normalize_embeddings=normalize_embeddings, mesh=mesh,
                       **index_kw)
    for s in range(0, len(doc_ids), batch_docs):
        chunk = doc_ids[s: s + batch_docs]
        emb = engine.encode_corpus([get(d) for d in chunk])
        index.add(emb, ids=[str(d) for d in chunk])
    return index.build()
