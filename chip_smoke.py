#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (`sgpt_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py [--parent DIR]

Phases, each of which asserts; any failure exits non-zero:
  1. build   — compile the CUDA kernels from `sgpt_tpu_torch/csrc/` with nvcc (sm_90a)
  2. kernel  — the fused short-T attention kernel (K1) against its plain
               PyTorch version on the card, at the encode path's shape and
               variants, and at the train slice's (fp32, B=32); then at
               GPT-J's head size 256 (bf16 `mma_kernel<256, …>`, fp32
               `tf32_kernel_wide`) and with BLOOM's real slopes (H 16 and 32,
               Dh 128), unpacked and packed, with key padding and fully
               masked rows, and at the CE's unpacked dispatches (the
               length ladder's T 128, 512, 1024 and 2048, and T 1440, 464
               and 80 as the ranker's plan cuts the rerank benchmark's
               rows), and GPT-J's packed rows
               at T=2048 with ALiBi, bf16 and fp32 (fp32 with BLOOM's slopes held to
               an fp64 evaluation where it misses the fp32 gate); times of
               GPT-J's and BLOOM-1b7's encode and packed-CE cells, and of
               fp32 K1 at GPT-J's training launch (B=4) and B=16 and at
               BLOOM-1b7's (B=32)
  3. bwd     — the short-attention backward kernel (K2) against its plain
               version, same variants and GPT-J's and BLOOM-1b7's MS MARCO
               training shapes (B=32, T=300, H=16: Dh 256 on fp32's
               `tf32_rows_wide`/`tf32_cols_wide` and bf16's CUDA-core pair,
               also packed at T=2048 with BLOOM's slopes; Dh 128 with BLOOM's
               real slopes; fp32 with BLOOM's slopes held to fp64 where it
               misses the gate; a fully padded row), with a random
               output gradient, bf16 and fp32 (bf16's gate scaled to each
               gradient's RMS and norm, and shown to refuse a planted zeroed
               key strip); times of each pass, plain, SDPA backward, bound
  4. slice   — bulk encode with full-width GPT-Neo-125M (random weights from a
               seed, bf16) through `EmbeddingEngine`, documents and queries;
               the kernel's launch count must be 12 × the number of batches;
               one batch of 64 at T=300 under torch.profiler
 4b. pipeline — the encode pipeline on phase 4's weights and 1,280 texts:
               the default engine (FETCH_PIPELINE_DEPTH 2, dispatch_chain
               8) against depth 1 with dispatch_chain 1 (and, with
               --parent, that checkout's `encoder.py` on this tree's
               modules): embeddings equal bit for bit, K1 = 12 × batches on
               each side, emb/s (the median of 3 encodes, the sides in
               turns) and the busy share of one encode under
               torch.profiler; depth 2 against depth 1 on a dp=2 mesh of
               `cuda:0` named twice, bit for bit, K1 = 12 × 2 × batches;
               one encode inside `utils.profiling.Timer` and
               `profile_trace(build/pipeline_trace)`, whose Chrome trace
               must name K1's kernel and the engine's spans
  5. parity  — the same weights in fp32 on the card (kernel) against fp32 on
               the CPU (plain path), and bf16-card against fp32-CPU cosines
  6. mips    — the streaming MIPS top-k kernel (K5) against its plain
               version: NQ's corpus size (2,681,468 × 768 bf16), Q = 64,
               k = 10, and variants (Q 1, 8, 16, 65 and 1024, k 1 and 16,
               fp32, D 2048 and 2560, valid_count < N, duplicate rows,
               all-equal rows, duplicates on both sides of the wrapper's
               split boundaries, valid_count < k); kernel, plain, library
               and bound at Q = 64, the kernel's time and GB/s at Q = 1, 8,
               16 and 1024, and the fp32 path (CUDA cores) at Q = 64 over
               2^20 rows beside its bound and the library
  7. search  — 4,096 synthetic documents encoded with the engine of phase 4
               into `index_corpus(kernel="pallas")` and a blockmax index: the
               same top-10 for the texts as queries, K5 launched once per
               search dispatch; an index of 2^20 rows answers Q = 64 via K5
  8. serve   — `SearchService(kernel="pallas")` behind `make_server` on
               127.0.0.1: POST /documents, POST /search from 8 threads;
               answers equal a direct search; p50/p99 latency, queries/s
  9. train   — MS MARCO contrastive training (SGPT-BE: BitFit, SPECB, MNRL,
               batch 32, max_seq_len 300, fp32) of full-width GPT-Neo-125M
               through `ContrastiveTrainer.fit` at the CLI's matmul_precision
               "default" (TF32 products): K1 and K2 counted 12 × 3 towers ×
               steps, only biases move, one step profiled; the same steps at
               "highest" (strict fp32) for its rate; at "highest" the loss of
               a repeated batch falls and GradCache's loss equals the direct one
 10. tparity — one training step's loss and bias gradients, card against CPU,
               at T=300 (K1, K2) and with use_flash at T=512 (K3, K4a, K4b)
 11. beir    — the port's `cli.beir_retriever` on a synthetic BEIR folder
               (2,000 docs, 100 queries) with full-width GPT-Neo-125M
 12. flash   — the flash attention forward kernel (K3) against its plain
               version: B=64, T=2048, H=12, Dh=64 in bf16, global and window
               256, on the decoder's projection views; variants T 128-1024,
               block_kv 128 and 256, scale 1/8, ALiBi, Dh 32 and 128, fp32;
               key padding with fully masked rows; output and lse; times in
               bf16 at B=64 and in fp32 at the long train's B=8 (fp32 bound:
               3 × its operations at the TF32 peak, the CUDA cores' beside
               it; kernel and plain errors against an fp64 evaluation); then
               Dh 256 (`flash_fwd_bf16<256>`, `flash_fwd_tf32<256>`) and
               BLOOM's real slopes, times of GPT-J's and BLOOM-1b7's long
               encode cell (B=16, T=2048) and of K3 fp32 at Dh 256
 13. long    — long-context encode: full-width GPT-Neo-125M with use_flash
               (bf16, max_seq_len 2048, batch_size 64) over 512 documents of
               300-3,000 words (buckets 512, 1024, 2048; 154 truncated) and
               short queries: K3 in every layer of every T % 128 == 0 batch,
               K1 in the others; against the non-flash engine (K1 at every
               T), card fp32 against CPU fp32 on 8 documents, and an index of
               the documents (K5) in which each finds itself first
 14. fbwd    — the flash attention backward kernels (K4a dQ, K4b dK/dV)
               against their plain version: B=8, T=2048, H=12, Dh=64 in
               fp32, global and window 256, block_kv 256, on the decoder's
               projection views with a random output gradient, key padding
               and fully masked rows; variants T 128-1024, block_kv 128,
               scale 1/8, ALiBi, Dh 32 and 128, bf16; times of each kernel,
               the plain version and the library's SDPA backward, beside
               each kernel's bound (3 × its operations at the TF32 peak,
               the CUDA cores' beside it); the same at GPT-J's head size 256
               (`flash_bwd_dq_wide`, `flash_bwd_dkv_wide`: B=4, T=2048, H=16,
               global and window 256, T 128-1024, scale 1/16 and 1, fully
               padded rows) and with BLOOM-1b7's real slopes (T=2048, fp32
               held to fp64 where it misses the gate), times at both
               families' long-context cell (B=4); bf16's gate as in phase 3,
               its planted fault a zeroed 64-key block of GPT-J's dk
 15. ltrain  — long-context contrastive training: full-width GPT-Neo-125M
               with use_flash, fp32, max_seq_len 2048, BitFit, SPECB,
               GradCache (chunks of 8), batches of 16 triplets with documents
               of 300-3,000 words, 4 steps on one batch at constant lr at the
               CLI's "default" precision (TF32 products): K3 12 × 3 towers ×
               (2 + 2) chunks a step, K4a = K4b = 12 × 3 × 2, K1 = K2 = 0;
               only biases move, the loss falls; ms/step, sequences/s,
               tokens/s, peak memory, one step under torch.profiler; 3 steps
               at "highest" (strict fp32) for its rate, one more profiled;
               GradCache (chunks of 2) == direct on 4 triplets at "highest"
               (tparity also holds one use_flash step at max_seq_len 512,
               card K3/K4 against the CPU's plain versions); both profiles
               name `flash_fwd_tf32` alone for K3, `flash_bwd_dq_tf32` alone
               for K4a and `flash_bwd_dkv_tf32` alone for K4b
 16. ce      — the cross-encoder (SGPT-CE) on the weights of phase 4 (bf16,
               max_length 2048, batch_size 16): K1 (bf16) at the CE shapes
               against its plain version, window 0 and 256 (packed rows
               with up to 16 segments at T=256, B=128; T=1,024, B=32;
               T=2,048, B=16), with kernel, plain, library and bound times;
               prompt G over a BEIR-like mix's BM25 top-100 (2,000 documents
               of lognormal(5, 1) words in [20, 1,400], 32 queries: 3,200
               pairs), a short mix (3,200 pairs of 5-60 words) unpacked and
               at pack_t=256, and prompt L on 256 short pairs: pairs/s and
               tokens/s, K1 = 12 × dispatches, one dispatch of each mix
               profiled; fp32 card == fp32 CPU (32 pairs), fp32 packed ==
               unpacked (64 pairs), bf16 ranks against fp32 (Spearman of
               each query's top-100); `SearchService(ranker=...)` over HTTP:
               POST /rerank from 8 threads == the direct rerank, p50/p99;
               `cli.bm25_retriever` → `cli.sgptce` on a synthetic BEIR
               folder writes BM25's and the CE's nDCG
 17. families — GPT-J-6B (28 layers, D 4,096, Dh 256, its biased head),
               then BLOOM-1b7 (24 layers, D 2,048, ALiBi, vocab 250,880),
               full width, bf16, random weights drawn on the card, each
               freed before the next: the encode slice's 1,280 texts (K1 =
               L × batches, one batch profiled, peak memory), an index of
               them (K5 at D) where each finds itself first, a long encode
               with use_flash of 112 documents (one batch each at T 2048,
               1024 and 512; K3 = L × flash batches), the CE on 4 queries
               × BM25 top-100 (K1 = L × dispatches; BLOOM also a short mix
               packed at pack_t 256 against unpacked); kernel path against
               plain path at full depth (cosines, CE Spearman); fp32 card
               against fp32 CPU at full width with the depth cut to 2
               layers (the CPU cannot run 6B in fp32 in the time limit),
               and fp32 packed CE rows against unpacked on the card; the
               HF loader: a checkpoint written from the 2-layer model's
               weights as safetensors (by hand) and as .bin, reloaded,
               gives the same embeddings bit for bit
 17b. families train — GPT-J-6B, then BLOOM-1b7, full width, fp32 weights
               drawn on the card, "default" precision, BitFit, SPECB, MNRL,
               1 warm-up and 2 timed steps on a repeated batch (the loss
               falls): the MS MARCO configuration (32 triplets, T=300,
               GradCache chunk 4: K1 = L × 3 × 2 × 8, K2 = L × 3 × 8 a step),
               for GPT-J also SGPT-5.8B-weightedmean-nli-bitfit's NLI
               configuration (64 triplets, T=75, GradCache chunk 16, no
               SPECB: K1 = 28 × 3 × 2 × 4, K2 = 28 × 3 × 4 a step, the
               profile names only `_wide` kernels; card == CPU at 2 layers
               at T=75 too), and long context with use_flash (T=2048, 8 or 16 triplets,
               GradCache chunks of 2 or 4: K3 = L × 3 × 2 × chunks, K4a =
               K4b = L × 3 × chunks; the profile names only Dh-256 or Dh-128
               instantiations); only biases move; ms/step, sequences/s, peak
               memory, one profiled step each; card against CPU at 2 layers
               (loss and bias gradients at T=300 and, with use_flash, 512)
 19. kernel nli — K1 and K2 fp32 at T=75 (NLI's max_seq_len: no multiple
               of 16, below one 64-key tile) at GPT-Neo's Dh 64 (global and
               window 256) and GPT-J's Dh 256, and bf16 K1 at the USEB
               encode's buckets 16, 32 and 64, each with key padding and a
               fully padded row, against their plain versions; times beside
               the plain version, SDPA (and its backward) and the bound
 20. nli     — NLI training (symmetric SGPT-BE) of full-width GPT-Neo-125M in
               fp32 at "default": synthetic AllNLI (2,000 premises) →
               build_nli_triplets → NoDuplicatesBatcher of 64, T=75, BitFit,
               weightedmean, 5 timed steps (K1 = K2 = 12 × 3 a step, one
               profiled), 2 steps each with the learnt mean, a post-pool GELU
               head and a pre-pool head (only biases and the aux move), a
               repeated batch (the loss falls), GradCache (chunk 16) ==
               direct and card == CPU at "highest" (bias and aux
               gradients), and `cli.train_nli` end to end with an STS-B dev
               set, whose best model `SGPTModel.load` reloads bit for bit
 21. useb    — `cli.useb_retriever` with full-width GPT-Neo-125M in bf16 on
               synthetic folders of the four USEB tasks: weightedmean at
               --layeridx -1, 0, 4, 8, 12, meanmean and lasttokenmean (K1 =
               12 × batches, emb/s); the kernel path against the plain path
               (cosines ≥ 0.99, main scores within 1.0); fp32 card == CPU for
               max, cls, meanmean, lasttokenmean and layer 6
 22. int8    — int8 inference (`ops/quant.py`): `int8_project` at GPT-J's
               shapes (19,200 rows; 4,096 → 4,096 and → 16,384, 16,384 →
               4,096) and a 5-row batch (padded to `_int_mm`'s 17): the int32
               accumulators of `torch._int_mm` and the outputs equal the
               plain version's (fp64 on the card) exactly; the times of the
               activation quantize pass, `_int_mm` and the rescale beside
               `F.linear` in bf16 and the bound (int8 peak 1,979 TOPS); the
               encode slice of phase 4 with `quantize="int8"` (emb/s against
               bf16, peak memory, a profiled batch, cosine to the bf16
               embeddings ≥ 0.99 for every text, top-10 overlap of a search;
               `_int_mm` = 6 × 12 × batches); `cli.beir_retriever --quantize
               int8`. In phase 17, GPT-J-6B the same (`family_int8`), its CE
               with `quantize="int8"` (pairs/s, Spearman against bf16 for
               each query) and `quantize_decoder_params(free_source=True)`
               on the bf16 model (peak ≤ the float total + one fp32 D × F slab)
 23. ivf     — the balanced IVF index (`index_ivf.IVFIndex`) at NQ's corpus
               size (2,681,468 × 768, a mixture of 4,096 unit centres at
               spread 0.75, drawn on the card), int8 rows, auto-K: add and
               build seconds, K, overflow share; recall@10 at nprobe 8, 32
               and 64 against K5's exact top-10 of the bf16 rows and against
               the exact scan of the index's own int8 rows, p50 of
               `search_embeddings` at Q=1 and Q=64 beside K5's exact search;
               a save/load round trip gives the same results bit for bit;
               `cli.serve --index ivf --quantize int8 --quantize-index int8`
               over HTTP on the 4,096 documents of phase 7: /search p50 and
               p99, answers equal a direct `search_embeddings`
 24. kernel tsdae — K1 and K2 fp32 at GPT-Neo's heads where the training
               objectives beyond MNRL run them: TSDAE's encoder (B=8, T=75)
               and tied decoder (B=8, T=74, an all-ones key mask), the
               trainable cross-encoder's pair rows (B=32, T=512; B=2,
               T=2,048), global and window 256, against their plain
               versions; times beside the plain version, SDPA and the bound
 25. tsdae   — `cli.train_tsdae` at its defaults (batch 8, T=75, del_ratio
               0.6, weightedmean, fp32 at "default") with full-width
               GPT-Neo-125M on synthetic sentences: 1 warm-up and 6 timed
               steps (K1 = K2 = 12 × 2 a step), ms/step, sentences/s, peak
               memory, one step profiled (K1, K2, GEMMs, the LM head at
               vocab 50,257, the log-softmax, the rest); 2 steps with
               --freezenonbias (only biases and the projections move);
               card == CPU at 2 layers ("highest"); the trained model
               through `save_hf_checkpoint` and `load_pretrained` gives its
               embeddings bit for bit
 26. ce train — `CrossEncoderTrainable` (num_labels 1) with full-width
               GPT-Neo-125M, fp32 at "default": batch 32 at max_length 512,
               1 warm-up and 5 timed steps (K1 = K2 = 12 a step), pairs/s,
               peak memory, one step profiled; one step at the class
               defaults (batch 16, max_length 2,048) and its peak memory;
               `predict` and `CECorrelationEvaluator` card == CPU at 2 layers
 27. search utils — `ops.search_utils.semantic_search` on the card over the
               encode slice's embeddings == the exact (fp64) top-10;
               paraphrase mining's pairs and the communities held to fp64
               cosines
 28. encoders — the encoder families at full width with random weights from
               the seed: BERT-base, T5-base (v1.0, ReLU) and T5 v1.1 (gated
               GELU), each a bf16 bulk encode of 1,024 documents at
               max_seq_len 256 through `EmbeddingEngine(method="mean")`
               (emb/s; no K1 or K3 launch: bidirectional attention takes the
               decoder's plain path) with the plain attention's share of one
               T=256 batch (CUDA events), fp32 card == fp32 CPU on one batch
               of 8 (1e-4) and bf16 card against fp32 CPU cosines (≥ 0.99);
               BERT's token types move the output, K5 over its embeddings ==
               its plain version, and 3 BitFit MNRL steps (fp32 "default",
               batch 32, T=128; only biases move); T5's relative bias on the
               card == the CPU's at T=256; CLIP ViT-B/32 in bf16 through
               `CLIPEncoder` on 256 texts and 256 uint8 images, mixed (K1 =
               12 × text batches, the same image the same embedding, fp32
               card == CPU on 8 + 8 items), K1 at the text tower's shape
               (B=32, T=77, H=8, Dh=64, bf16, padded rows) against its plain
               version, timed beside SDPA and its bound; `cli.beir_retriever
               --modelname bert-base-uncased --randominit` on 1,000 synthetic
               documents; `modules.py`'s CNN and LSTM, card == CPU (fp32)
 29. mesh    — the serving meshes (`sgpt_tpu_torch.parallel`) on a mesh of
               `cuda:0` named twice (each shard's kernels launch; it checks
               a mesh's results and per-shard overhead, not scaling across
               cards): GPT-Neo-125M's encode of the slice's 1,280 texts at
               (dp, tp) = (2, 1), (1, 2), (2, 2) held to the meshless
               embeddings (cosine ≥ 0.999 a row; K1 = 12 × dp × tp ×
               batches); K1 at the tp shard's heads (B=64, T=300, H=6, bf16)
               against its plain version, timed beside H=12; GPT-J-6B at
               tp=2 (H/tp 8, Dh 256) on 256 texts against its meshless
               encode; a DenseIndex and an IVFIndex (K 32) on dp=2 over the
               4,096 search documents against the meshless indexes (IVF at
               nprobe = K); the CE on 512 short pairs at dp=2 and tp=2
               (Spearman ≥ 0.99 against the meshless ranker); `cli.serve
               --device cuda:0,cuda:0 --dp 2 --rerank` answering /search
               and /rerank over HTTP
 30. mesh train — training under a (dp, tp) mesh of `cuda:0` named 2 or 4
               times: full-width GPT-Neo-125M, the MS MARCO CLI's configuration
               (32 triplets, T=300, BitFit, fp32), 3 steps at "highest" on
               (dp, tp) = (2, 1), (1, 2), (2, 2) and GradCache (chunks of 8)
               at (2, 2), each held to the meshless run (losses rtol 2e-4,
               parameters rtol 3e-3 atol 2e-5, every copy of a leaf bit-equal
               across shards; K1 = K2 = L × dp × tp × 3 × steps, GradCache K1
               twice that × chunks); ms/step at "default" beside meshless;
               long context (T=2048, use_flash, GradCache chunks of 8, 16
               triplets) at dp=2 for one step against meshless (K3, K4a, K4b
               per dp row)
 31. sp      — sequence parallelism (ring attention) over `cuda:0` named
               twice, T=2048 in two shards of 1,024, GPT-Neo-125M with
               use_flash in fp32 against the meshless flash paths: the
               engine's encode of 64 long documents (cosine ≥ 0.9999), one
               contrastive step on 4 pairs at a constant lr (loss 1e-4,
               parameters atol 2e-4, moved > 4e-4) and one TSDAE step
               (loss 1e-4); each path's time and peak
 18. report  — kernel, plain-version and library times beside each
               kernel's bound, encode, long-context, train, CE and serve rates,
               the card's name and power limit, one `{"kernels": [...]}`
               line, and last `{"ok": true, "device": {...}}`

With `--parent DIR` (another checkout of this repo, e.g. the parent commit
unpacked by `git archive` into the git-ignored build/parent), it also builds
that checkout's kernels beside this tree's and, after phase 14, times K1, K2,
K3, K4a, K4b and K5 from both builds in turns (parent, change, change,
parent): phase `ab`. K1, K2, K3, K4b and the D buffer that K4a writes must
give the parent's outputs bit for bit (BLOOM's ALiBi shapes included),
except the cells of a kernel the change redesigned: K1 fp32 at GPT-J's Dh
256 (B=4 and 16) within K1's fp32 gate of the parent's output and K2 fp32
there (B=4 and 32) within K2's, each build's error against an fp64
evaluation logged; K4a's fp32 path the parent's dq
within K4's fp32 gate, at window 0 and 256, each build's error against an
fp64 evaluation of dQ logged. K4's inputs come from this tree's K3. K5 (Q =
1, 8, 16, 64 and 1024 over NQ's corpus) runs each side through its own
wrapper, the parent's loaded from that checkout, and is held by K5's rule.
Phase `pipeline` then also times the parent's engine beside this tree's.

Without a CUDA card it exits non-zero and prints no result. Imports no JAX.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import functools
import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
BF16_ATOL, BF16_RTOL = 2e-2, 1e-2   # bf16 outputs: a flipped rounding of P or O
FP32_ATOL, FP32_RTOL = 1e-5, 1e-5   # fp32, TF32 off: summation order only
GRAD_RMS_ATOL, GRAD_NORM_RTOL = 1e-2, 1e-2  # bf16 gradients: atol per RMS(ref), |Δ|/|ref|
# the card's datasheet peaks (H100 SXM, dense): the bound of a kernel is the
# larger of its bytes over the memory rate and its operations over the peak
HBM_BYTES_PER_S = 3.35e12
# tensor cores (bf16; TF32, which the fp32 paths of K1, K2, K3 and K4 issue
# three of for each fp32 product, 3xTF32; int8, `torch._int_mm`); fp32 on the
# CUDA cores
PEAK_OPS_PER_S = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12, "int8": 1979e12}


T0 = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str) -> None:
    log(f"== {name} (at {time.perf_counter() - T0:.1f} s)")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def card_normal(torch, rng, shape, std: float, dtype=None):
    """N(0, std²) values of `shape`, drawn on the card from a generator that
    `rng` seeds (numpy's draws at the families' sizes, ~4e8 values a case,
    take seconds each on the host); fp32, cast to `dtype` when given."""
    gen = torch.Generator("cuda").manual_seed(int(rng.integers(2**62)))
    out = torch.randn(shape, generator=gen, device="cuda").mul_(std)
    return out if dtype is None else out.to(dtype)


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def parent_ops(path: str):
    """The `sgpt_tpu_torch.ops` package of another checkout of this repo (the
    parent commit unpacked into a git-ignored directory), loaded as a package
    of its own (`parent_ops`, its `__init__` not run): `parent_ops._build`
    compiles that checkout's `csrc/` into that checkout's own build
    directory, and `parent_ops.mips` is that checkout's K5 wrapper, whose
    planning (splits, query block) goes with its kernel."""
    import importlib
    import types
    from pathlib import Path

    pkg = types.ModuleType("parent_ops")
    pkg.__path__ = [str(Path(path).resolve() / "sgpt_tpu_torch" / "ops")]
    sys.modules["parent_ops"] = pkg
    return importlib.import_module("parent_ops._build"), importlib.import_module("parent_ops.mips")


@contextlib.contextmanager
def kernels_of(lib):
    """Run the port's wrappers on another kernel library (same C entry
    points): they look `_build.library` up at each call."""
    from sgpt_tpu_torch.ops import _build

    saved = _build.library
    _build.library = lambda: lib
    try:
        yield
    finally:
        _build.library = saved


def phase_ab(torch, sa, fa, mips, parent_lib, this_lib, parent_mips):
    """K1, K2, K3, K4a, K4b and K5 built from the parent checkout and from
    this tree, timed in one process on one card in turns (parent, change,
    change, parent) at the main paths' shapes. K1, K2, K3 and K4b must give
    the parent's outputs bit for bit; K4a's fp32 path (both windows) its D
    buffer bit for bit and its dq within K4's fp32 gate of the parent's,
    |Δ| ≤ 1e-5·max|ref| + 1e-5·|ref|, with both builds' errors against an
    fp64 evaluation of dQ from the same q, k, v, dO, lse and D logged. K5
    (NQ's corpus, 768 bf16, k=10, Q = 1, 8, 16, 64, 1024) runs each side through
    its own wrapper (`parent_mips`: the parent's planning with the parent's
    kernel) and is held by K5's rule (`check_topk`: values within 1e-5 of
    the parent's, ids equal except on a near-tie)."""
    rng = np.random.default_rng(SEED + 7)
    cells = {}

    def short(B, dtype, window, bwd=False):
        args, _ = attention_inputs(torch, rng, B, 300, 12, 64, dtype)
        if not bwd:
            return functools.partial(sa.short_attention, *args, 1.0, window, 12, False)
        g = card_normal(torch, rng, (B, 300, 768), 1.0, dtype)
        return functools.partial(sa.short_attention_bwd, *args, g, scale=1.0, window=window,
                                 H=12, use_alibi=False)

    def flash(B, dtype, window):
        (q, k, v, km, _), _ = attention_inputs(torch, rng, B, 2048, 12, 64, dtype)
        qh, kh, vh = (heads(t, 12) for t in (q, k, v))
        return functools.partial(fa.flash_attention, qh, kh, vh, km, window=window, block_kv=256)

    (q, k, v, km, _), _ = attention_inputs(torch, rng, 8, 2048, 12, 64, torch.float32)
    qh, kh, vh = (heads(t, 12) for t in (q, k, v))
    g = heads(card_normal(torch, rng, (8, 2048, 768), 1.0), 12)
    bwd = {}  # window: K4's arguments, from this tree's K3
    for window in (0, 256):
        out, lse = fa.flash_attention(qh, kh, vh, km, return_residuals=True, window=window,
                                      block_kv=256)
        bwd[window] = fa._bwd_args(qh, kh, vh, km, None, g, out, lse, 1.0, window, 128, 256)

    def k4(launch, window, outs):
        def run():  # K4b reads the D that the K4a cell of its window wrote before
            launch(bwd[window])
            return tuple(t.clone() for t in outs)
        run.window = window
        return run

    from sgpt_tpu_torch.models.decoder import alibi_slopes

    def family_short(B, T, H, Dh, dtype, alibi, packed):  # GPT-J's and BLOOM's K1 calls
        q, k, v, km, seg, pos = family_inputs(torch, rng, B, T, H, Dh, dtype,
                                              "packed" if packed else "pad")
        sl = alibi_slopes(H, "cuda") if alibi else None
        run = functools.partial(sa.short_attention, q, k, v, km, sl, Dh ** -0.5, 0, H, alibi,
                                segments=seg, positions=pos if alibi else None)
        run.fp64 = lambda: (k1_fp64(torch, (q, k, v, km, sl), 0, Dh ** -0.5, H, seg,
                                    pos if alibi else None),)
        return run

    def family_bwd(B, H, Dh):  # GPT-J's K2 call at T=300 (fp32, padded rows)
        q, k, v, km, _, _ = family_inputs(torch, rng, B, 300, H, Dh, torch.float32, "pad")
        g = card_normal(torch, rng, (B, 300, H * Dh), 1.0)
        run = functools.partial(sa.short_attention_bwd, q, k, v, km, None, g, scale=Dh ** -0.5,
                                window=0, H=H, use_alibi=False)
        run.fp64 = lambda: k2_fp64(torch, (q, k, v, km, None), g, 0, Dh ** -0.5, H)
        return run

    def family_flash(B, H, Dh, dtype, alibi):
        (q, k, v, km, _), _ = attention_inputs(torch, rng, B, 2048, H, Dh, dtype)
        qh, kh, vh = (heads(t, H) for t in (q, k, v))
        return functools.partial(fa.flash_attention, qh, kh, vh, km,
                                 alibi_slopes(H, "cuda") if alibi else None, scale=Dh ** -0.5,
                                 block_kv=256)

    runs = [  # name, function, how the output is held to the parent's: "exact" (bit for
        # bit), "bf16" (within K1's bf16 gate), "k4a" (fp32 K4a: dq within its gate, fp64
        # errors logged, the D buffer bit for bit), "k1" or "k2" (fp32 K1 and K2 at GPT-J's
        # Dh 256, which the parent ran on the CUDA cores: within K1's fp32 gate, or K2's in
        # dq, dk and dv, both builds' errors against an fp64 evaluation logged)
        ("K1 bf16 B=64 T=300 window=0", short(64, torch.bfloat16, 0), "exact"),
        ("K1 bf16 B=64 T=300 window=256", short(64, torch.bfloat16, 256), "exact"),
        ("K1 fp32 B=32 T=300 window=0", short(32, torch.float32, 0), "exact"),
        ("K1 fp32 B=32 T=300 window=256", short(32, torch.float32, 256), "exact"),
        ("K2 fp32 B=32 T=300 window=0", short(32, torch.float32, 0, bwd=True), "exact"),
        ("K2 fp32 B=32 T=300 window=256", short(32, torch.float32, 256, bwd=True), "exact"),
        ("K2 bf16 B=32 T=300 window=0", short(32, torch.bfloat16, 0, bwd=True), "exact"),
        ("K3 bf16 B=64 T=2048 window=0", flash(64, torch.bfloat16, 0), "exact"),
        ("K3 bf16 B=64 T=2048 window=256", flash(64, torch.bfloat16, 256), "exact"),
        ("K3 fp32 B=8 T=2048 window=0", flash(8, torch.float32, 0), "exact"),
        ("K3 fp32 B=8 T=2048 window=256", flash(8, torch.float32, 256), "exact"),
        *[run for w in (0, 256) for run in (
            (f"K4a fp32 B=8 T=2048 window={w}",
             k4(fa._launch_dq, w, (bwd[w]["grads"][0], bwd[w]["keep"][8])), "k4a"),
            (f"K4b fp32 B=8 T=2048 window={w}", k4(fa._launch_dkv, w, bwd[w]["grads"][1:]),
             "exact"))],
        ("K1 bf16 BLOOM-1b7 B=64 T=300 H=16 Dh=128 alibi",
         family_short(64, 300, 16, 128, torch.bfloat16, True, False), "exact"),
        ("K1 bf16 BLOOM-1b7 CE packed B=128 T=256 H=16 Dh=128 alibi",
         family_short(128, 256, 16, 128, torch.bfloat16, True, True), "exact"),
        ("K1 fp32 BLOOM-1b7 B=32 T=300 H=16 Dh=128 alibi",
         family_short(32, 300, 16, 128, torch.float32, True, False), "exact"),
        ("K3 bf16 BLOOM-1b7 B=16 T=2048 H=16 Dh=128 alibi",
         family_flash(16, 16, 128, torch.bfloat16, True), "exact"),
        ("K3 fp32 BLOOM-1b7 B=4 T=2048 H=16 Dh=128 alibi",
         family_flash(4, 16, 128, torch.float32, True), "exact"),
        ("K1 fp32 GPT-J B=16 T=300 H=16 Dh=256",
         family_short(16, 300, 16, 256, torch.float32, False, False), "k1"),
        ("K1 fp32 GPT-J B=4 T=300 H=16 Dh=256",
         family_short(4, 300, 16, 256, torch.float32, False, False), "k1"),
        ("K2 fp32 GPT-J B=32 T=300 H=16 Dh=256", family_bwd(32, 16, 256), "k2"),
        ("K2 fp32 GPT-J B=4 T=300 H=16 Dh=256", family_bwd(4, 16, 256), "k2"),
        ("K1 bf16 GPT-J B=64 T=300 H=16 Dh=256",
         family_short(64, 300, 16, 256, torch.bfloat16, False, False), "bf16"),
    ]
    for name, fn, held in runs:
        outs = {}
        for tag, lib in (("parent", parent_lib), ("change", this_lib)):
            with kernels_of(lib):
                got = fn()
                torch.cuda.synchronize()
            outs[tag] = [t.float() for t in (got if isinstance(got, tuple) else (got,))]
        diff = max((a - b).abs().max().item() for a, b in zip(outs["parent"], outs["change"]))
        fp64_errs = {}
        if held == "exact":
            assert diff == 0, f"ab {name}: the change moved the output by {diff:.3e}"
        elif held == "bf16":
            (a,), (b,) = outs["parent"], outs["change"]
            assert ((a - b).abs() <= BF16_ATOL + BF16_RTOL * a.abs()).all(), (name, diff)
        elif held in ("k1", "k2"):  # redesigned fp32 K1 / K2: their gate, fp64 logged
            for a, b in zip(outs["parent"], outs["change"]):
                atol = FP32_ATOL if held == "k1" else FP32_ATOL * a.abs().max().item()
                assert ((a - b).abs() <= atol + FP32_RTOL * a.abs()).all(), (name, diff)
            refs = fn.fp64()
            errs = {tag: [(o.double() - r).abs().max().item() for o, r in zip(outs[tag], refs)]
                    for tag in ("parent", "change")}
            parts = "out" if held == "k1" else "dq, dk, dv"
            log(f"ab {name}: max |out - fp64 evaluation| ({parts}) "
                f"parent {', '.join(f'{e:.3e}' for e in errs['parent'])}, change "
                f"{', '.join(f'{e:.3e}' for e in errs['change'])}; within "
                f"{'K1' if held == 'k1' else 'K2'}'s fp32 gate of the parent's")
            fp64_errs = {f"fp64_err_{tag}": e for tag, e in errs.items()}
            del refs
        else:  # K4a fp32: D bit for bit, dq within K4's fp32 gate, both against fp64
            (a, a_d), (b, b_d) = outs["parent"], outs["change"]
            assert torch.equal(a_d, b_d), f"ab {name}: the change moved D"
            atol = FP32_ATOL * a.abs().max().item()
            assert ((a - b).abs() <= atol + FP32_RTOL * a.abs()).all(), (name, diff)
            ref = k4_fp64(torch, bwd[fn.window]["keep"], fn.window)[0]
            errs = {tag: (outs[tag][0].double() - ref).abs().max().item()
                    for tag in ("parent", "change")}
            log(f"ab {name}: max |dq - fp64 evaluation| parent {errs['parent']:.3e}, change "
                f"{errs['change']:.3e}; D equal bit for bit")
            del ref
        times = []
        for lib in (parent_lib, this_lib, this_lib, parent_lib):
            with kernels_of(lib):
                times.append(cuda_ms(torch, fn, iters=10, warmup=2))
        p1, c1, c2, p2 = times
        cells[name] = {"parent_ms": (p1 + p2) / 2, "ms": (c1 + c2) / 2,
                       "runs": [p1, c1, c2, p2], "max_abs_diff": diff, **fp64_errs}
        log(f"ab {name}: parent {p1:.4f} / {p2:.4f} ms, change {c1:.4f} / {c2:.4f} ms "
            f"(change/parent {(c1 + c2) / (p1 + p2):.3f}); outputs "
            f"{'equal bit for bit' if diff == 0 else f'differ by at most {diff:.3e}'}")
    del q, k, v, qh, kh, vh, g, out, lse, bwd
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    c = unit_rows(torch, gen, NQ_ROWS, 768, torch.bfloat16)
    queries = unit_rows(torch, gen, 1024, 768, torch.bfloat16)
    for Q in (64, 1, 8, 16, 1024):
        name = f"K5 bf16 Q={Q} N={NQ_ROWS} D=768 k=10"
        qq = queries[:Q].contiguous()
        fns = {tag: functools.partial(mod.mips_topk, qq, c, NQ_ROWS, 10)
               for tag, mod in (("parent", parent_mips), ("change", mips))}
        outs = {tag: fn() for tag, fn in fns.items()}
        torch.cuda.synchronize()
        err, near = check_topk(torch, qq, c, outs["change"], outs["parent"], f"ab {name}")
        p1, c1, c2, p2 = (cuda_ms(torch, fns[tag], iters=10, warmup=2)
                          for tag in ("parent", "change", "change", "parent"))
        cells[name] = {"parent_ms": (p1 + p2) / 2, "ms": (c1 + c2) / 2,
                       "runs": [p1, c1, c2, p2], "max_abs_diff": err, "near_tie_slots": near}
        log(f"ab {name}: parent {p1:.4f} / {p2:.4f} ms, change {c1:.4f} / {c2:.4f} ms "
            f"(change/parent {(c1 + c2) / (p1 + p2):.3f}); values within {err:.3e} of the "
            f"parent's, {near} ids differ on a near-tie")
    del c, queries
    torch.cuda.empty_cache()
    return cells


def bound(nbytes: float, ops: float, kind: str):
    """(bound_ms, bound_by): the least time the card could take to move
    nbytes and do ops at the datasheet peaks, and which of the two binds."""
    mem, comp = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / PEAK_OPS_PER_S[kind]
    return (mem, "bytes") if mem >= comp else (comp, "operations")


def attention_pairs(torch, key_mask, window: int) -> int:
    """(query, key) pairs the mask leaves: key ≤ query, inside the window,
    key not padded — the pairs this run's data needs, summed over rows."""
    B, T = key_mask.shape
    cs = torch.cat([torch.zeros(B, 1, dtype=torch.long, device=key_mask.device),
                    (key_mask > 0).long().cumsum(1)], 1)
    i = torch.arange(T, device=key_mask.device)
    lo = (i - window + 1).clamp(min=0) if window > 0 else torch.zeros_like(i)
    return int((cs[:, i + 1] - cs[:, lo]).sum().item())


def sdpa_mask(torch, key_mask, window: int):
    """The boolean (B, 1, T, T) mask of causal ∧ [window] ∧ key padding, for
    the library yardstick `F.scaled_dot_product_attention`."""
    T = key_mask.shape[1]
    i = torch.arange(T, device=key_mask.device)
    m = i[None, :] <= i[:, None]
    if window > 0:
        m = m & (i[None, :] > i[:, None] - window)
    return m[None, None] & (key_mask > 0)[:, None, None, :]


def k1_fp64(torch, args, window: int, scale: float = 1.0, H: int = 12, segments=None,
            positions=None):
    """K1's formula evaluated in fp64 on the card: the yardstick of K1's fp32
    error (the plain version evaluates it in fp32), and of the fp32 paths
    under BLOOM's slopes, whose scores of ~10^2-10^3 put one fp32 rounding of
    a score (6e-5 at 724) past K1's 1e-5 gate in the kernel and the plain
    version alike. args: (q2, k2, v2, key_mask, slopes); ALiBi when slopes
    is not None, at `positions` (default: the key index)."""
    q2, k2, v2, km, slopes = args
    B, T, HD = q2.shape
    q, k, v = (t.reshape(B, T, H, HD // H).double() for t in (q2, k2, v2))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if slopes is not None:
        kp = positions if positions is not None else torch.arange(T, device=q2.device).expand(B, T)
        s = s + slopes.double()[None, :, None, None] * kp.double()[:, None, None, :]
    s = torch.where(family_mask(torch, km, window, segments), s,
                    torch.full((), -1e9, dtype=s.dtype, device=s.device))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return o.reshape(B, T, HD)


def k4_fp64(torch, keep, window: int, scale: float = 1.0):
    """K4's formula evaluated in fp64 on the card, one batch row at a time:
    dQ = Σ dS·K·scale, dV = Σ Pᵀ·dO and dK = Σ dSᵀ·Q·scale with P =
    where(mask, exp(s − lse), 0) and dS = P∘(dP − D), from the kernels' own
    lse and D (the yardstick of K4's fp32 error), ALiBi at the key index
    where the slopes are not None. keep: `_bwd_args`'s tensors (q, k, v, g,
    out, key_mask, slopes, lse, D), q/k/v/g (B, H, T, Dh). Returns (dq, dk,
    dv)."""
    q, k, v, g, _, km, slopes, lse, dsum = keep
    mask = sdpa_mask(torch, km, window)
    T = q.shape[2]
    dq, dk, dv = [], [], []
    for b in range(q.shape[0]):
        qb, kb, vb, gb = (t[b].double() for t in (q, k, v, g))
        s = torch.einsum("hqd,hkd->hqk", qb, kb) * scale
        if slopes is not None:
            s = s + slopes.double()[:, None, None] * torch.arange(
                T, device=q.device, dtype=torch.float64)
        p = torch.where(mask[b], torch.exp(s - lse[b].double()[..., None]), 0.0)
        ds = p * (torch.einsum("hqd,hkd->hqk", gb, vb) - dsum[b].double()[..., None])
        dq.append(torch.einsum("hqk,hkd->hqd", ds, kb) * scale)
        dv.append(torch.einsum("hqk,hqd->hkd", p, gb))
        dk.append(torch.einsum("hqk,hqd->hkd", ds, qb) * scale)
        del s, p, ds
    return torch.stack(dq), torch.stack(dk), torch.stack(dv)


def k3_fp64(torch, args, window: int, scale: float = 1.0, slopes=None):
    """K3's formula (with ALiBi at the key index when slopes is not None)
    evaluated in fp64 on the card, one batch row at a time: the yardstick of
    K3's fp32 error. args: (q, k, v, key_mask) as the kernel takes them,
    q/k/v (B, H, T, Dh). Returns the fp64 output and the (B, 1, T, 1) mask
    of the rows that hold a valid key (a row without one is the mean of V
    over the TPU tiles' visited keys, a property of the walk and not of the
    formula; it is 0 here)."""
    q, k, v, km = args[:4]
    mask = sdpa_mask(torch, km, window)
    T = q.shape[2]
    out = []
    for b in range(q.shape[0]):
        s = torch.einsum("hqd,hkd->hqk", q[b].double(), k[b].double()) * scale
        if slopes is not None:
            s = s + slopes.double()[:, None, None] * torch.arange(
                T, device=q.device, dtype=torch.float64)
        p = torch.softmax(s.masked_fill(~mask[b], float("-inf")), dim=-1).nan_to_num(0.0)
        out.append(torch.einsum("hqk,hkd->hqd", p, v[b].double()))
        del s, p
    return torch.stack(out), mask.any(-1, keepdim=True)


def heads(t, H):
    """(B, T, H·Dh) → the (B, H, T, Dh) view the decoder hands the flash kernel."""
    B, T, HD = t.shape
    return t.view(B, T, H, HD // H).transpose(1, 2)


def attention_inputs(torch, rng, B, T, H, Dh, dtype, *, alibi=False, segments=False):
    """q/k/v at the scale of real projections (std 0.5), ~10 % right padding
    including a row short enough that a window leaves its tail fully masked.
    Returns (q2, k2, v2, key_mask, slopes) and the segments/positions keywords."""
    q, k, v = (card_normal(torch, rng, (B, T, H * Dh), 0.5, dtype) for _ in range(3))
    lengths = np.full(B, T)
    n_pad = max(1, B // 5)
    lengths[:n_pad] = rng.integers(max(1, T // 2), T, n_pad)
    lengths[0] = max(1, min(30, T // 4))
    km = torch.from_numpy((np.arange(T)[None, :] < lengths[:, None]).astype(np.int32)).cuda()
    extra = {}
    if segments or alibi:  # three contiguous segments; positions restart in each
        cuts = np.sort(rng.choice(np.arange(1, T), size=2, replace=False))
        seg = np.searchsorted(cuts, np.arange(T), side="right").astype(np.int32)
        pos = (np.arange(T) - np.concatenate([[0], cuts])[seg]).astype(np.int32)
        if segments:
            extra["segments"] = torch.from_numpy(np.tile(seg, (B, 1))).cuda()
        if alibi:
            extra["positions"] = torch.from_numpy(np.tile(pos, (B, 1))).cuda()
    slopes = torch.from_numpy(rng.random(H).astype(np.float32)).cuda() if alibi else None
    return (q, k, v, km, slopes), extra


CASES = [  # name, B, T, H, Dh, scale, window, alibi, segments
    ("main-global", 64, 300, 12, 64, 1.0, 0, False, False),
    ("main-local256", 64, 300, 12, 64, 1.0, 256, False, False),
    ("scale", 8, 300, 12, 64, 0.125, 0, False, False),
    ("alibi-kpos", 8, 300, 12, 64, 1.0, 256, True, False),
    ("segments", 8, 300, 12, 64, 0.125, 0, False, True),
    ("odd-T77", 5, 77, 12, 64, 1.0, 16, False, False),
    ("T2048", 2, 2048, 12, 64, 1.0, 256, False, False),
    ("Dh128-T2048", 1, 2048, 16, 128, 1.0, 256, True, True),  # GPT-Neo 1.3B/2.7B heads
    ("Dh32", 4, 100, 4, 32, 0.25, 0, False, False),
    ("Dh16", 4, 100, 4, 16, 1.0, 8, True, False),
    ("Dh48-scalar", 4, 130, 4, 48, 1.0, 0, False, True),  # bf16 off the tensor cores
]


def time_k1(torch, sa, label: str, args, H: int, scale: float, window: int) -> dict:
    """K1's time on (q, k, v, key_mask, slopes) beside its plain version, the
    library's SDPA (boolean mask) and the bound (4·Dh operations a pair; fp32:
    3 × them at the TF32 peak, the 3xTF32 products)."""
    q, k, v, km, _ = args
    B, T, HD = q.shape
    Dh = HD // H
    dt = "fp32" if q.dtype == torch.float32 else "bf16"

    def kernel():
        return sa.short_attention(q, k, v, km, None, scale, window, H, False)

    def plain():
        return sa.short_attention_reference(q, k, v, km, None, scale=scale, window=window,
                                            H=H, use_alibi=False)

    mask = sdpa_mask(torch, km, window)
    qh, kh, vh = (heads(t, H) for t in (q, k, v))

    def library():
        return torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                                scale=scale)

    p1, k1, k2, p2 = (cuda_ms(torch, f) for f in (plain, kernel, kernel, plain))
    lib = cuda_ms(torch, library)
    nbytes = 4 * q.numel() * q.element_size() + km.numel() * 4
    ops = 4 * Dh * H * attention_pairs(torch, km, window)
    b = bound(nbytes, 3 * ops, "tf32") if dt == "fp32" else bound(nbytes, ops, "bf16")
    simt = bound(nbytes, ops, "fp32")
    t = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": lib,
         "bound_ms": b[0], "bound_by": b[1]}
    log(f"time K1 {label}B={B} T={T} H={H} Dh={Dh} {dt} window={window}: kernel "
        f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library (SDPA, boolean mask) "
        f"{lib:.4f} ms, bound {b[0]:.4f} ms ({b[1]}: {nbytes} bytes, "
        + (f"3 x {ops} TF32 operations at {PEAK_OPS_PER_S['tf32'] / 1e12:.0f} TFLOP/s; on "
           f"the CUDA cores {simt[0]:.4f} ms, {simt[1]}" if dt == "fp32"
           else f"{ops} operations")
        + f") (runs: kernel {k1:.4f} {k2:.4f}, plain {p1:.4f} {p2:.4f})")
    return t


def phase_kernel(torch, sa, rng):
    """K1 against its plain version; returns the main-path error and times."""
    main_err = 0.0
    for dtype, atol, rtol in ((torch.bfloat16, BF16_ATOL, BF16_RTOL),
                              (torch.float32, FP32_ATOL, FP32_RTOL)):
        for name, B, T, H, Dh, scale, window, alibi, segments in CASES:
            args, extra = attention_inputs(torch, rng, B, T, H, Dh, dtype,
                                           alibi=alibi, segments=segments)
            got = sa.short_attention(*args, scale, window, H, alibi, **extra)
            want = sa.short_attention_reference(*args, scale=scale, window=window, H=H,
                                                use_alibi=alibi, **extra)
            torch.cuda.synchronize()
            assert got.shape == want.shape and got.dtype == want.dtype, name
            g, w = got.float(), want.float()
            assert torch.isfinite(g).all(), f"{name}: non-finite kernel output"
            err = (g - w).abs()  # every row, fully masked ones included
            worst = (err - rtol * w.abs()).max().item()
            _, allowed = sa._scores(args[0], args[1], args[3], args[4], scale=scale,
                                    window=window, H=H, use_alibi=alibi,
                                    segments=extra.get("segments"),
                                    positions=extra.get("positions"))
            dead = int((~allowed.any(-1)).sum().item()) * (H // allowed.shape[1])  # (b, h, q)
            del allowed
            log(f"kernel {name:14s} {str(dtype)[6:]:8s} B={B} T={T} H={H} Dh={Dh} "
                f"max_abs_err={err.max().item():.3e} (atol {atol}, rtol {rtol}), "
                f"fully masked rows {dead}")
            assert worst <= atol, f"kernel {name} {dtype}: exceeds tolerance"
            if name.startswith("main") and dtype == torch.bfloat16:
                main_err = max(main_err, err.max().item())

    times = {}
    for window in (0, 256):
        args, _ = attention_inputs(torch, rng, 64, 300, 12, 64, torch.bfloat16)
        t = time_k1(torch, sa, "", args, 12, 1.0, window)
        times[window] = tuple(t[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                             "bound_by"))
    # the train slice's shape: fp32, B=32; 3xTF32 products on the tensor cores
    for window in (0, 256):
        args, _ = attention_inputs(torch, rng, 32, 300, 12, 64, torch.float32)
        t = time_k1(torch, sa, "", args, 12, 1.0, window)
        key = "fp32" if window == 0 else "fp32_w256"
        times[key] = tuple(t[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                          "bound_by"))
        ref = k1_fp64(torch, args, window)
        err64 = (sa.short_attention(*args, 1.0, window, 12, False).double() - ref).abs().max()
        plain64 = (sa.short_attention_reference(*args, scale=1.0, window=window, H=12,
                                                use_alibi=False).double() - ref).abs().max()
        del ref
        log(f"time K1 B=32 T=300 H=12 Dh=64 fp32 window={window}: max |out - fp64 "
            f"evaluation|: kernel {err64.item():.3e}, plain {plain64.item():.3e}")
    return main_err, times


BWD_CASES = [(*c, False) for c in CASES] + [  # ..., alibi, segments, a fully padded row
    # GPT-J-6B's and BLOOM-1b7's MS MARCO training shapes: fp32 on the 3xTF32
    # pairs (`tf32_rows_wide`/`tf32_cols_wide` at Dh 256), bf16 at Dh 256 on
    # the CUDA-core pair; BLOOM's own slopes at the key index; and GPT-J's
    # head size on packed rows at T=2,048 with BLOOM's slopes
    ("gptj-train", 32, 300, 16, 256, 1 / 16, 0, False, False, True),
    ("bloom1b7-train", 32, 300, 16, 128, 128 ** -0.5, 0, "bloom", False, True),
    ("gptj-t2048-packed-alibi", 2, 2048, 16, 256, 1 / 16, 0, "bloom", True, False),
]

BWD_TIMED = [  # cell, dtype, B, T, H, Dh, scale, window, alibi
    *[((dt, w), dt, 32, 300, 12, 64, 1.0, w, False) for dt in ("fp32", "bf16") for w in (0, 256)],
    ("gptj-train", "fp32", 32, 300, 16, 256, 1 / 16, 0, False),
    ("gptj-train-b4", "fp32", 4, 300, 16, 256, 1 / 16, 0, False),  # the training launch
    ("bloom1b7-train", "fp32", 32, 300, 16, 128, 128 ** -0.5, 0, "bloom"),
]


def case_inputs(torch, rng, B, T, H, Dh, dtype, alibi, segments=False, dead=False):
    """`attention_inputs` for a case row: alibi True draws slopes (and
    restarts positions in segments), "bloom" takes BLOOM's own slopes
    (`alibi_slopes`) at the key index; `dead` pads batch row 1 fully."""
    (q, k, v, km, slopes), extra = attention_inputs(torch, rng, B, T, H, Dh, dtype,
                                                    alibi=alibi is True, segments=segments)
    if alibi == "bloom":
        from sgpt_tpu_torch.models.decoder import alibi_slopes
        slopes = alibi_slopes(H, q.device)
    if dead:
        km[1] = 0
    return (q, k, v, km, slopes), extra


def library_mask(torch, km, window: int, slopes):
    """The library's mask of the same attention: boolean, or with slopes its
    additive form (slope·key index, -inf where masked)."""
    mask = sdpa_mask(torch, km, window)
    if slopes is None:
        return mask
    T = km.shape[1]
    return torch.where(mask, slopes[None, :, None, None] * torch.arange(
        T, device=km.device, dtype=torch.float32), float("-inf"))


def bf16_grad_gate(torch, got, want) -> tuple:
    """bf16's gate of a gradient, scaled to the tensor: |Δ| ≤ 1e-2·|ref| +
    min(2e-2, 1e-2·RMS(ref)) everywhere and ‖Δ‖ ≤ 1e-2·‖ref‖. Kernel and
    plain version both sum in fp32 and round once to bf16, so a sound kernel
    differs by flipped roundings (≤ 2^-7·|ref|); a fixed 2e-2 alone would
    pass a zeroed tile where gradients are ~5e-3 (dq and dk at T=2048).
    Returns (holds, max(|Δ| − 1e-2·|ref|, 0)/RMS(ref), ‖Δ‖/‖ref‖)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    rms = w.pow(2).mean().sqrt().item()
    excess = max((err - BF16_RTOL * w.abs()).max().item(), 0.0)
    ref_norm = w.norm().item()
    ratio = excess / rms if rms > 0 else (0.0 if excess == 0 else float("inf"))
    norm = err.norm().item() / ref_norm if ref_norm > 0 else (
        0.0 if err.max().item() == 0 else float("inf"))
    return excess <= min(BF16_ATOL, GRAD_RMS_ATOL * rms) and norm <= GRAD_NORM_RTOL, ratio, norm


def hold_grads(torch, name, got, want, dtype, fp64=None) -> tuple:
    """K2's and K4's gate on (dq, dk, dv) against the plain version: fp32
    within 1e-5·max|ref| + 1e-5·|ref|, bf16 by `bf16_grad_gate`; an fp32
    case with BLOOM's slopes that misses it passes only if each part lies no
    further from an fp64 evaluation (`fp64()` → (dq, dk, dv)) than twice the
    plain version does. Returns the max abs errors, which gate held them,
    and bf16's readings (the largest excess/RMS and ‖Δ‖/‖ref‖; None in fp32)."""
    errs, missed, readings = [], [], []
    for part, gg, ww in zip(("dq", "dk", "dv"), got, want):
        assert gg.dtype == ww.dtype == dtype and gg.shape == ww.shape, (name, part)
        assert torch.isfinite(gg.float()).all(), f"{name} {part}: non-finite output"
        err = (gg.float() - ww.float()).abs()
        errs.append(err.max().item())
        if dtype == torch.bfloat16:
            holds, ratio, norm = bf16_grad_gate(torch, gg, ww)
            assert holds, (f"{name} {part}: outside bf16's gate (excess/RMS {ratio:.3e}, "
                           f"|Δ|/|ref| {norm:.3e})")
            readings.append((part, ratio, norm))
        elif (err - FP32_RTOL * ww.abs()).max().item() > FP32_ATOL * ww.abs().max().item():
            missed.append(part)
    if readings:
        return errs, "bf16 gate: excess/RMS, |Δ|/|ref| " + ", ".join(
            f"{p} {r:.2e} {n:.2e}" for p, r, n in readings), (
            max(r for _, r, _ in readings), max(n for _, _, n in readings))
    if not missed:
        return errs, "gate", None
    assert fp64 is not None, f"{name} {dtype}: {missed} exceed the tolerance ({errs})"
    ref = fp64()
    held = []
    for i, part in enumerate(("dq", "dk", "dv")):
        if part in missed:
            k64 = (got[i].double() - ref[i]).abs().max().item()
            p64 = (want[i].double() - ref[i]).abs().max().item()
            assert k64 <= 2 * p64, f"{name} {part}: |kernel - fp64| {k64:.3e} > 2 x {p64:.3e}"
            held.append(f"{part} kernel {k64:.3e} plain {p64:.3e}")
    return errs, "fp64 (" + ", ".join(held) + ")", None


def planted_fault(torch, name, faulty, want) -> dict:
    """bf16's gradient gate checked on a gradient with one tile of keys
    zeroed: it must refuse it. Logs its readings and whether the fixed
    2e-2 + 1e-2·|ref| gate alone would have passed the fault."""
    holds, ratio, norm = bf16_grad_gate(torch, faulty, want)
    err = (faulty.float() - want.float()).abs()
    fixed = (err - BF16_RTOL * want.float().abs()).max().item() <= BF16_ATOL
    log(f"{name}: planted fault (one key tile of dk zeroed): excess/RMS {ratio:.3e}, "
        f"|Δ|/|ref| {norm:.3e}; bf16's gate refuses it: {not holds}; the fixed 2e-2 + "
        f"1e-2·|ref| gate alone {'passes' if fixed else 'refuses'} it")
    assert not holds, f"{name}: bf16's gate passed a zeroed key tile"
    return {"excess_per_rms": ratio, "norm_ratio": norm, "fixed_gate_passes": fixed}


def k2_fp64(torch, args, g, window: int, scale: float, H: int, segments=None,
            positions=None):
    """K2's function evaluated in fp64 on the card by autograd through the
    masked softmax (-1e9 at masked pairs, ALiBi at `positions` (default: the
    key index) when slopes is not None, packed `segments`): (dq, dk, dv) as
    (B, T, H·Dh)."""
    q2, k2, v2, km, slopes = args
    B, T, HD = q2.shape
    q, k, v = (t.detach().reshape(B, T, H, HD // H).double().requires_grad_()
               for t in (q2, k2, v2))
    with torch.enable_grad():
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
        if slopes is not None:
            kp = positions if positions is not None else torch.arange(T, device=q.device).expand(
                B, T)
            s = s + slopes.double()[None, :, None, None] * kp.double()[:, None, None, :]
        s = torch.where(family_mask(torch, km, window, segments), s,
                        torch.full((), -1e9, dtype=s.dtype, device=s.device))
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
        grads = torch.autograd.grad(o, (q, k, v), g.reshape(B, T, H, HD // H).double())
    return [x.reshape(B, T, HD) for x in grads]


def time_k2(torch, sa, label: str, args, g, H: int, scale: float, window: int,
            note: str = "") -> dict:
    """K2's time on (q, k, v, key_mask, slopes) and output gradient g: the
    pair and each pass (torch.profiler), the plain version, the library's
    SDPA backward of the same attention and the bound (10·Dh operations a
    pair; the fp32 pair issues three TF32 products for each fp32 one, so its
    bound is 3 × its operations at the TF32 peak, the CUDA cores' logged
    beside it)."""
    q, k, v, km, sl = args
    B, T, HD = q.shape
    Dh = HD // H
    dt = "fp32" if q.dtype == torch.float32 else "bf16"
    kw = dict(scale=scale, window=window, H=H, use_alibi=sl is not None)

    def kernel():
        return sa.short_attention_bwd(q, k, v, km, sl, g, **kw)

    def plain():
        return sa.short_attention_bwd_reference(q, k, v, km, sl, g, **kw)

    qh, kh, vh = (heads(t, H).detach().contiguous().requires_grad_() for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=library_mask(torch, km, window, sl), scale=scale)
    gh = heads(g, H).contiguous()

    def library():  # the library's backward of the same attention
        return torch.autograd.grad(out, (qh, kh, vh), gh, retain_graph=True)

    p1, k1, k2, p2 = (cuda_ms(torch, f, iters=10) for f in (plain, kernel, kernel, plain))
    lib = cuda_ms(torch, library, iters=10)
    rows_ms, cols_ms = pass_ms(torch, kernel)
    # read q, k, v, g once, write dq, dk, dv; 10·Dh operations a pair:
    # Q·Kᵀ again, dP = g·Vᵀ, dV = Pᵀ·g, dQ = dS·K, dK = dSᵀ·Q
    nbytes = 7 * q.numel() * q.element_size() + km.numel() * 4
    ops = 10 * Dh * H * attention_pairs(torch, km, window)
    simt = bound(nbytes, ops, "fp32")
    b = bound(nbytes, 3 * ops, "tf32") if dt == "fp32" else bound(nbytes, ops, dt)
    t = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": lib,
         "bound_ms": b[0], "bound_by": b[1], "rows_ms": rows_ms, "cols_ms": cols_ms,
         "bound_ms_cuda_cores": simt[0]}
    log(f"time K2 {label}B={B} T={T} H={H} Dh={Dh} {dt} window={window}{note}: kernel "
        f"{t['ms']:.4f} ms (rows pass {rows_ms}, cols pass {cols_ms} ms), plain "
        f"{t['plain_ms']:.4f} ms, library (SDPA backward"
        f"{', fp32 additive mask' if sl is not None else ''}) {lib:.4f} ms, bound "
        f"{b[0]:.4f} ms ({b[1]}: {nbytes} bytes, "
        + (f"3 x {ops} TF32 operations" if dt == "fp32" else f"{ops} operations")
        + f"; on the CUDA cores {simt[0]:.4f} ms, {simt[1]}) (runs: kernel {k1:.4f} "
        f"{k2:.4f}, plain {p1:.4f} {p2:.4f})")
    return t


def phase_bwd_kernel(torch, sa, rng):
    """K2 against its plain version over K1's variants (the main shapes at
    the train slice's B=32) and GPT-J-6B's and BLOOM-1b7's MS MARCO training
    shapes (B=32, T=300, H=16; Dh 256 on `tf32_rows_wide` / `tf32_cols_wide`
    in fp32 and the CUDA-core `rows_kernel` / `cols_kernel` in bf16, Dh 128
    with BLOOM's real slopes on the 3xTF32 pair, each with a fully padded
    row; Dh 256 on packed rows at T=2,048 with BLOOM's slopes), with a
    random output gradient (`hold_grads`:
    fp32 only the summation order differs, fp32 with BLOOM's slopes held to
    fp64 where it misses; bf16 scaled to each gradient, checked on a planted
    fault at GPT-J's shape). Then the times (`BWD_TIMED`): the pair and each
    pass under torch.profiler, the plain version, the library's SDPA
    backward and the bound (10·Dh operations a pair; the fp32 pair issues
    three TF32 products for each fp32 one, so its bound is 3 × its
    operations at the TF32 peak, the CUDA cores' logged beside it). Returns
    the largest fp32 main-shape error (the train slice runs fp32), every
    case's, bf16's gate readings and the times."""
    main_err, worst, readings = 0.0, {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype)[6:]
        for name, B, T, H, Dh, scale, window, alibi, segments, dead in BWD_CASES:
            B = 32 if name.startswith("main") else B
            args, extra = case_inputs(torch, rng, B, T, H, Dh, dtype, alibi, segments, dead)
            g = card_normal(torch, rng, (B, T, H * Dh), 1.0, dtype)
            kw = dict(scale=scale, window=window, H=H, use_alibi=bool(alibi), **extra)
            got = sa.short_attention_bwd(*args, g, **kw)
            want = sa.short_attention_bwd_reference(*args, g, **kw)
            torch.cuda.synchronize()
            errs, gate, reading = hold_grads(torch, f"bwd {name}", got, want, dtype, fp64=(
                (lambda: k2_fp64(torch, args, g, window, scale, H, **extra))
                if alibi == "bloom" and dtype == torch.float32 else None))
            if dead:
                assert (got[0][1] == 0).all(), f"bwd {name}: dq of a fully padded row"
            log(f"bwd    {name:14s} {dt:8s} B={B} T={T} H={H} Dh={Dh} window={window}"
                f"{' alibi (BLOOM)' if alibi == 'bloom' else ''}: max_abs_err dq {errs[0]:.3e} "
                f"dk {errs[1]:.3e} dv {errs[2]:.3e} (held by {gate})"
                f"{', a fully padded row' if dead else ''}{', packed' if segments else ''}")
            worst[f"{name}_{dt}"] = max(errs)
            if reading:
                readings[name] = reading
            if name.startswith("main") and dtype == torch.float32:
                main_err = max(main_err, *errs)
            if name == "gptj-train" and dtype == torch.bfloat16:
                faulty = got[1].clone()
                faulty[:, 2 * T // 3:2 * T // 3 + 16] = 0  # one of cols_kernel's 16-key strips
                readings["planted fault"] = planted_fault(torch, f"bwd {name}", faulty, want[1])
            del args, extra, g, got, want
    log(f"bwd    bf16 gate readings, largest over the cases: excess/RMS "
        f"{max(r[0] for k, r in readings.items() if k != 'planted fault'):.3e}, |Δ|/|ref| "
        f"{max(r[1] for k, r in readings.items() if k != 'planted fault'):.3e} (allowances "
        f"{GRAD_RMS_ATOL}, {GRAD_NORM_RTOL})")

    times = {}
    for cell, dt, B, T, H, Dh, scale, window, alibi in BWD_TIMED:
        dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dt]
        (q, k, v, km, sl), _ = case_inputs(torch, rng, B, T, H, Dh, dtype, alibi)
        g = card_normal(torch, rng, (B, T, H * Dh), 1.0, dtype)
        times[cell] = time_k2(torch, sa, "" if isinstance(cell, tuple) else cell + " ",
                              (q, k, v, km, sl), g, H, scale, window,
                              " alibi (BLOOM)" if alibi == "bloom" else "")
        del q, k, v, km, sl, g
        torch.cuda.empty_cache()
    return main_err, worst, readings, times


def pass_ms(torch, kernel, iters: int = 10):
    """K2's two passes timed apart: device time of the rows and the cols
    kernels over `iters` calls of `kernel` under torch.profiler, per call
    (None where the profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile

    kernel()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            kernel()
        torch.cuda.synchronize()
    ms = device_ms(prof, {"rows": ("tf32_rows", "rows_kernel"),
                          "cols": ("tf32_cols", "cols_kernel")})
    if ms["rows"] == 0 or ms["cols"] == 0:
        return None, None
    return ms["rows"] / iters, ms["cols"] / iters


def synthetic_triplets(rng, n: int) -> list:
    """(query, positive, hard negative) triples: queries of 3-11 words,
    documents of 40-450 words, so that some truncate at 300 SPECB tokens."""
    words = ["".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"), rng.integers(2, 9)))
             for _ in range(5000)]

    def text(lo, hi):
        return " ".join(rng.choice(words, int(rng.integers(lo, hi))))

    return [(text(3, 12), text(40, 451), text(40, 451)) for _ in range(n)]


def profile_step(torch, trainer, batch, label: str, families: dict,
                 name_keys: tuple = ()) -> dict:
    """One training step of `trainer` under torch.profiler: device time by
    kernel family, the device's busy share of the wall time, and the names
    of the device kernels that hold one of `name_keys`. Device activity
    only: the host's op events, which no figure here reads, took the
    profiler tens of seconds to process for a 6B step."""
    from torch.profiler import ProfilerActivity, profile

    towers = trainer._prep_batch(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(trainer._step(towers))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    ms = device_ms(prof, families)
    total = sum(ms.values())
    names = sorted({ev.key for ev in prof.key_averages()
                    if str(getattr(ev, "device_type", "")).endswith("CUDA")
                    and any(k in ev.key for k in name_keys)})
    if total == 0:
        log(f"{label}: the profiler saw no device time (wall {wall_ms:.1f} ms)")
        return {"profile_wall_ms": wall_ms, "profile_kernel_ms": None, "kernel_names": names}
    shares = ", ".join(f"{k} {v:.2f} ms ({v / total:.3f})" for k, v in ms.items())
    log(f"{label}: {total:.2f} ms of kernels in {wall_ms:.2f} ms wall (busy share "
        f"{total / wall_ms:.3f}): {shares}" + (f"; kernels {names}" if name_keys else ""))
    return {"profile_wall_ms": wall_ms, "profile_kernel_ms": total, "kernel_names": names,
            **{f"profile_{k.lower()}_ms": v for k, v in ms.items()}}


def phase_train(torch, sa, rng, tok):
    """The train slice: the MS MARCO CLI's configuration (train_msmarco
    --train_batch_size 32 --specb --freezenonbias --lr 2e-4, max_seq_len 300,
    weightedmean, MNRL at scale 20, warmuplinear) on full-width
    GPT-Neo-125M in fp32, through `ContrastiveTrainer.fit`, at the CLI's
    matmul_precision "default" (TF32 products), one step profiled; then the
    same steps at "highest" (strict fp32) for the rate, and the loss and
    GradCache checks at "highest"."""
    import dataclasses

    from sgpt_tpu_torch.models import Decoder, gpt_neo
    from sgpt_tpu_torch.training import BIAS_NAMES, ContrastiveTrainer, TrainConfig

    steps, B = 5, 32
    cfg = gpt_neo("125m", matmul_precision="default")  # as cli.common.build_model
    model = Decoder(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
    tc = TrainConfig(lr=2e-4, batch_size=B, max_seq_len=300, specb=True,
                     freeze_nonbias=True, pooling="weightedmean", scheduler="warmuplinear")
    triplets = synthetic_triplets(rng, B * (steps + 1))
    batches = [triplets[i * B:(i + 1) * B] for i in range(steps)]
    trainer = ContrastiveTrainer(model, cfg, tok, tc)
    _, n_trunc, _ = trainer.codec.encode_rows([t[1] for t in triplets])
    assert n_trunc > 0, "no document reached truncation"
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    stamps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tc.log_fn = lambda rec: stamps.append(time.perf_counter())  # float(loss) synchronises
    sa.launches = sa.bwd_launches = 0
    t0 = time.perf_counter()
    out = trainer.fit(lambda: iter(batches), steps_per_epoch=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd_launches, bwd_launches = sa.launches, sa.bwd_launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [h["loss"] for h in out["history"]]
    log(f"train: {steps} steps in {wall:.2f} s, losses {[round(x, 5) for x in losses]}, "
        f"{n_trunc} docs truncated; K1 launches {fwd_launches}, K2 launches {bwd_launches}")
    assert len(losses) == steps and all(np.isfinite(losses)), losses
    want = cfg.num_layers * 3 * steps
    assert bwd_launches == want, f"K2 launched {bwd_launches} times, expected {want}"
    assert fwd_launches == want, f"K1 launched {fwd_launches} times, expected {want}"
    for name, p in model.named_parameters():
        moved = not torch.equal(p.detach(), before[name])
        assert moved == (name.rsplit(".", 1)[-1] in BIAS_NAMES), \
            f"{name}: {'moved' if moved else 'did not move'} under BitFit"
    intervals = np.diff(stamps)  # step 1 carries the first launches' set-up
    ms_per_step = 1e3 * float(np.median(intervals))
    seq_per_s = 3 * B / (ms_per_step / 1e3)
    log(f"train: {ms_per_step:.1f} ms/step, {seq_per_s:.1f} seq/s at matmul_precision "
        f"\"default\" (TF32)")
    # K2's fp32 pair; its CUDA-core kernels (bf16, other head sizes) must not show
    families = {"K1": K1_KEYS, "K2": ("tf32_rows", "tf32_cols"),
                "K2scalar": ("rows_kernel", "cols_kernel"), "GEMM": GEMM_KEYS}
    prof = profile_step(torch, trainer, batches[0], "train profile, one step (TF32)", families)

    # the same steps in strict fp32 ("highest"), on the same model
    strict = cfg.replace(matmul_precision="highest")
    model.cfg = strict
    stamps_strict = []
    ContrastiveTrainer(model, strict, tok, dataclasses.replace(
        tc, log_fn=lambda rec: stamps_strict.append(time.perf_counter()))).fit(
        lambda: iter(batches), steps_per_epoch=steps)
    ms_highest = 1e3 * float(np.median(np.diff(stamps_strict)))
    log(f"train: {ms_highest:.1f} ms/step, {3 * B / (ms_highest / 1e3):.1f} seq/s at "
        f"matmul_precision \"highest\" (strict fp32); TF32 takes {ms_per_step / ms_highest:.3f} "
        f"of it")
    strict_trainer = ContrastiveTrainer(model, strict, tok, tc)
    strict_trainer._opt, strict_trainer._sched = strict_trainer._build_optimizer(1)
    prof_highest = profile_step(torch, strict_trainer, batches[0],
                                "train profile, one step (strict fp32)", families)
    for pr in (prof, prof_highest):
        if pr["profile_kernel_ms"] is not None:
            assert pr["profile_k2_ms"] > 0 and pr["profile_k2scalar_ms"] == 0, \
                "the fp32 train step did not run K2's tensor-core pair alone"

    # one batch repeated at a constant lr: the loss falls
    const = dataclasses.replace(tc, scheduler="constantlr", log_fn=None)
    rep = ContrastiveTrainer(model, strict, tok, const).fit(
        lambda: iter([triplets[-B:]] * 4), steps_per_epoch=4)
    rep_losses = [h["loss"] for h in rep["history"]]
    log(f"train: one batch repeated at constant lr 2e-4: losses "
        f"{[round(x, 5) for x in rep_losses]}")
    assert rep_losses[-1] < rep_losses[0], rep_losses

    # one GradCache step (chunks of 8) against one direct step, same weights
    snap = {n: p.detach().clone() for n, p in model.state_dict().items()}
    direct = ContrastiveTrainer(model, strict, tok, const).fit(
        lambda: iter([batches[0]]), steps_per_epoch=1)["history"][0]["loss"]
    model.load_state_dict(snap)
    sa.launches = sa.bwd_launches = 0
    gc = ContrastiveTrainer(model, strict, tok, dataclasses.replace(
        const, use_gradcache=True, chunk_size=8)).fit(
        lambda: iter([batches[0]]), steps_per_epoch=1)["history"][0]["loss"]
    n_chunks = B // 8
    log(f"train: GradCache (chunk 8) loss {gc:.7f}, direct {direct:.7f}, "
        f"|diff| {abs(gc - direct):.3e}; K1 {sa.launches}, K2 {sa.bwd_launches} launches")
    assert abs(gc - direct) <= 1e-5 * abs(direct)
    assert sa.bwd_launches == cfg.num_layers * 3 * n_chunks
    assert sa.launches == 2 * cfg.num_layers * 3 * n_chunks  # pass 1 (no grad) and pass 2
    return {"ms_per_step": ms_per_step, "seq_per_s": seq_per_s, "peak_gib": peak_gib,
            "ms_per_step_highest": ms_highest, "seq_per_s_highest": 3 * B / (ms_highest / 1e3),
            "fwd_launches": fwd_launches, "bwd_launches": bwd_launches, **prof,
            **{k.replace("profile", "profile_highest", 1): v for k, v in prof_highest.items()}}


def phase_train_parity(torch, fa, rng, tok):
    """One BitFit step on the same weights and batch (3 triplets, full
    width, fp32): the card against the CPU (plain versions), at max_seq_len
    300 (K1, K2) and with use_flash at max_seq_len 512 (K3, K4a, K4b in every
    layer). Loss within 1e-5 relative; each bias gradient within 1e-4 of its
    leaf's norm."""
    import copy

    from sgpt_tpu_torch.models import Decoder, gpt_neo
    from sgpt_tpu_torch.training import ContrastiveTrainer, TrainConfig

    batch = synthetic_triplets(rng, 3)
    for use_flash, T in ((False, 300), (True, 512)):
        cfg = gpt_neo("125m", use_flash=use_flash)
        cpu = Decoder(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED + 1))
        gpu = copy.deepcopy(cpu).to("cuda")
        tc = TrainConfig(lr=2e-4, batch_size=3, max_seq_len=T, specb=True, freeze_nonbias=True)
        res = []
        for model in (cpu, gpu):
            trainer = ContrastiveTrainer(model, cfg, tok, tc)
            trainer._opt, trainer._sched = trainer._build_optimizer(1)
            fa.launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
            loss = float(trainer._loss_and_grads(trainer._prep_batch(batch)))
            res.append((loss, {n: p.grad.cpu() for n, p in model.named_parameters()
                               if p.requires_grad}))
        counts = (fa.launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
        want = (cfg.num_layers * 3,) * 3 if use_flash else (0, 0, 0)
        assert counts == want, (counts, want)
        (loss_cpu, g_cpu), (loss_gpu, g_gpu) = res
        worst = max(((g_gpu[n] - g).abs().max() / g.norm().clamp_min(1e-12)).item()
                    for n, g in g_cpu.items())
        log(f"tparity T={T} use_flash={use_flash}: loss card {loss_gpu:.7f} CPU "
            f"{loss_cpu:.7f} (|diff| {abs(loss_gpu - loss_cpu):.3e}, tolerance 1e-5 relative); "
            f"{len(g_cpu)} bias gradients, worst max|diff|/norm {worst:.3e} (tolerance 1e-4); "
            f"K3, K4a, K4b launches on the card {counts}")
        assert abs(loss_gpu - loss_cpu) <= 1e-5 * abs(loss_cpu)
        assert worst <= 1e-4
        del cpu, gpu


def cosine(a, b):
    return np.sum(a * b, axis=1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def synthetic_texts(rng) -> list:
    """1,280 texts whose SPECB lengths give every length bucket from 16 to 300
    a batch of its own, and truncate 70 past 300 tokens. Rows per batch grow
    as the bucket shrinks (64 at T=300, 512 at T=32), so each shorter bucket
    holds more texts than the longer batch before it can swallow."""
    words = ["".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"), rng.integers(2, 9)))
             for _ in range(5000)]
    spans = [(1, 15, 530), (15, 31, 280), (31, 63, 150), (63, 127, 100),
             (127, 255, 100), (255, 299, 50), (299, 450, 70)]  # words: lo, hi, count
    lengths = np.concatenate([rng.integers(lo, hi, n) for lo, hi, n in spans])
    rng.shuffle(lengths)
    return [" ".join(rng.choice(words, int(m))) for m in lengths]


NQ_ROWS = 2_681_468  # BEIR NQ's corpus: a real one-card index, 4.1 GB in bf16


def unit_rows(torch, gen, n, d, dtype, chunk=1 << 20):
    """n random unit vectors (n, d) made on the card from `gen`, in chunks."""
    out = torch.empty((n, d), dtype=dtype, device="cuda")
    for s in range(0, n, chunk):
        x = torch.randn((min(chunk, n - s), d), generator=gen, device="cuda")
        out[s:s + x.shape[0]] = (x / x.norm(dim=1, keepdim=True)).to(dtype)
    return out


def check_topk(torch, q, c, got, want, what):
    """K5's rule against its plain version: values within 1e-5 (unit-norm
    rows; only the summation order differs) and ids equal in every slot above
    -1e29, except where two candidates' plain scores lie within 1e-5 of each
    other: there the kernel's ids, scored as the plain version scores, lie
    within 1e-5 of the plain top-k. Returns (max_abs_err, near-tie slots)."""
    (gv, gi), (wv, wi) = got, want
    assert gv.shape == wv.shape and gv.dtype == torch.float32 and gi.dtype == torch.int32, what
    err = (gv - wv).abs().max().item()
    assert err <= 1e-5, f"{what}: max_abs_err {err:.3e} > 1e-5"
    real = wv > -1e29
    assert torch.equal(gv > -1e29, real), f"{what}: filler slots differ"
    assert (gi[~real] == 0).all(), f"{what}: filler index is not 0"
    diff = real & (gi != wi)
    if diff.any():
        rescored = torch.einsum("qd,qkd->qk", q.float(), c[gi.long()].float())
        assert ((rescored - wv).abs()[diff] <= 1e-5).all(), f"{what}: ids differ off a near-tie"
    return err, int(diff.sum().item())


def phase_mips(torch, mips, gen):
    """K5 against `mips_topk_reference` at the main shape (NQ-sized corpus,
    768 bf16, Q = 64, k = 10) and the variants, the bf16 scan's hazards
    among them (all-equal rows, duplicates on both sides of the wrapper's
    split boundaries); then the times: kernel, plain, library and bound at
    the main shape, the kernel at Q = 1, 8, 16 and 1024, and the fp32 path
    (the CUDA-core scan) at Q = 64 over 2^20 rows."""
    N, D = NQ_ROWS, 768
    c = unit_rows(torch, gen, N, D, torch.bfloat16)
    q = unit_rows(torch, gen, 1024, D, torch.bfloat16)
    main_err = None

    def run(name, qq, cc, valid, k):
        nonlocal main_err
        got = mips.mips_topk(qq, cc, valid, k)
        torch.cuda.synchronize()
        want = mips.mips_topk_reference(qq, cc, valid, k)
        err, near = check_topk(torch, qq, cc, got, want, name)
        log(f"mips {name:12s} Q={qq.shape[0]} N={cc.shape[0]} D={cc.shape[1]} k={k} "
            f"{str(cc.dtype)[6:]} valid={valid}: max_abs_err {err:.3e}, near-tie slots {near}")
        if name == "main":
            main_err = err
        return got

    run("main", q[:64], c, N, 10)
    for Q in (1, 8, 16, 65, 1024):
        run(f"Q{Q}", q[:Q], c, N, 10)
    run("k1", q[:64], c, N, 1)
    run("k16", q[:64], c, N, 16)
    valid = N - 12_345  # rows past valid_count hold a large value: never seen
    saved = c[valid:].clone()
    c[valid:] = 10.0
    got = run("valid<N", q[:64], c, valid, 10)
    assert (got[1] < valid).all()
    c[valid:] = saved
    dup = c[:200_000].clone()  # duplicate rows: an exact tie goes to the lower row
    dup[150_000:151_000] = dup[:1000]
    qd = dup[[3, 500, 999]].clone()
    got = run("duplicates", qd, dup, dup.shape[0], 10)
    assert got[1][:, :2].tolist() == [[3, 150_003], [500, 150_500], [999, 150_999]], got[1][:, :2]
    dup[:] = dup[11].clone()  # every score of a query equal: ids 0 .. k-1 in every list
    got = run("all-equal", q[:64], dup, dup.shape[0], 10)
    assert (got[1] == torch.arange(10, device="cuda", dtype=torch.int32)).all(), got[1][:2]
    # exact duplicates on both sides of the first two split boundaries of
    # the wrapper's plan at Q = 64 (one block an SM, each with one split)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = mips._splits(64, N, sms, mips.query_block(64, D, torch.bfloat16),
                          mips.MMA_TILE_ROWS)
    b = mips._rows_per_split(N, splits, mips.MMA_TILE_ROWS)
    rows = [b - 1, b, b + 1, 2 * b - 1, 2 * b]
    saved = c[rows].clone()
    c[rows] = c[5].clone()
    qs = q[:64].clone()
    qs[0] = c[5]
    got = run("split-dups", qs, c, N, 10)
    assert got[1][0, :6].tolist() == [5, *rows], (b, got[1][0])
    c[rows] = saved
    got = run("valid<k", q[:64], c, 5, 10)
    assert (got[0][:, 5:] == mips.NEG).all()
    del dup, saved
    for n, d, dt in ((65_536, 768, torch.float32), (500_000, 2048, torch.bfloat16),
                     (500_000, 2560, torch.bfloat16)):
        cc = unit_rows(torch, gen, n, d, dt)
        run(f"{str(dt)[6:]}-D{d}", unit_rows(torch, gen, 64, d, dt), cc, n, 10)
        del cc

    qm = q[:64].contiguous()

    def kernel():
        return mips.mips_topk(qm, c, N, 10)

    def plain():
        return mips.mips_topk_reference(qm, c, N, 10)

    def library():  # two library calls: bf16 scores, then their top 10
        return torch.topk(torch.mm(qm, c.T), 10)

    p1, k1, k2, p2 = (cuda_ms(torch, f, iters=n, warmup=1)
                      for f, n in ((plain, 3), (kernel, 20), (kernel, 20), (plain, 3)))
    lib = cuda_ms(torch, library, iters=5, warmup=1)
    ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    qb = mips.query_block(64, D, torch.bfloat16)
    corpus_bytes = c.numel() * c.element_size()
    read = corpus_bytes * -(-64 // qb)
    nbytes = (c.numel() + qm.numel()) * 2 + 64 * 10 * 8  # corpus, queries once; (value, id) out
    bound_ms, bound_by = bound(nbytes, 2 * 64 * N * D, "bf16")
    log(f"time K5 N={N} D={D} bf16 Q=64 k=10: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library (torch.mm + torch.topk) {lib:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}) "
        f"(runs: kernel {k1:.4f} {k2:.4f}, plain {p1:.4f} {p2:.4f}); query block {qb}, "
        f"corpus bytes read per search {read} = {read / (ms / 1e3) / 1e9:.1f} GB/s")
    by_q = {}
    for Q in (1, 8, 16, 64, 1024):
        qq = q[:Q].contiguous()
        t = cuda_ms(torch, functools.partial(mips.mips_topk, qq, c, N, 10),
                    iters=5 if Q > 64 else 20, warmup=2)
        qbq = mips.query_block(Q, D, torch.bfloat16)
        passes = -(-Q // qbq)
        by_q[Q] = {"ms": t, "query_block": qbq, "corpus_reads": passes,
                   "gb_per_s": corpus_bytes * passes / (t / 1e3) / 1e9,
                   "corpus_gb_per_s": corpus_bytes / (t / 1e3) / 1e9}
        log(f"time K5 bf16 Q={Q} N={N} D={D} k=10: {t:.4f} ms, query block {qbq}, corpus read "
            f"{passes}× = {by_q[Q]['gb_per_s']:.1f} GB/s ({by_q[Q]['corpus_gb_per_s']:.1f} GB/s "
            f"of the corpus once)")
    del c, q
    torch.cuda.empty_cache()
    # the fp32 path (scan_simt on the CUDA cores) at Q = 64 over 2^20 rows
    n32 = 1 << 20
    c32 = unit_rows(torch, gen, n32, D, torch.float32)
    q32 = unit_rows(torch, gen, 64, D, torch.float32)
    run("fp32-2^20", q32, c32, n32, 10)
    t32 = cuda_ms(torch, lambda: mips.mips_topk(q32, c32, n32, 10), iters=10, warmup=2)
    lib32 = cuda_ms(torch, lambda: torch.topk(torch.mm(q32, c32.T), 10), iters=5, warmup=1)
    b32, b32_by = bound((c32.numel() + q32.numel()) * 4 + 64 * 10 * 8, 2 * 64 * n32 * D, "fp32")
    qb32 = mips.query_block(64, D, torch.float32)
    log(f"time K5 fp32 Q=64 N={n32} D={D} k=10 (CUDA cores): {t32:.4f} ms, library "
        f"(torch.mm + torch.topk, fp32) {lib32:.4f} ms, bound {b32:.4f} ms ({b32_by}; fp32 "
        f"{PEAK_OPS_PER_S['fp32'] / 1e12:.0f} TFLOP/s), query block {qb32}, "
        f"{c32.numel() * 4 * -(-64 // qb32) / (t32 / 1e3) / 1e9:.1f} GB/s")
    del c32, q32
    torch.cuda.empty_cache()
    return {"max_abs_err": main_err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib,
            "bound_ms": bound_ms, "bound_by": bound_by, "query_block": qb,
            "bytes_per_search": read, "gb_per_s": read / (ms / 1e3) / 1e9, "by_q": by_q,
            "fp32_q64_n2p20": {"ms": t32, "library_ms": lib32, "bound_ms": b32,
                               "bound_by": b32_by, "query_block": qb32}}


def synthetic_corpus(rng, n: int) -> dict:
    """n BEIR-shaped documents ({id: {title, text}}) of 20-400 words."""
    words = ["".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"), rng.integers(2, 9)))
             for _ in range(5000)]
    return {f"doc{i}": {"title": "" if i % 3 else " ".join(rng.choice(words, 4)),
                        "text": " ".join(rng.choice(words, int(rng.integers(20, 401))))}
            for i in range(n)}


def rescore(torch, index, qrow, doc_ids):
    """The plain scores of doc_ids for one query row, as the index scores:
    the query rounded to the index dtype and normalised, fp32 products."""
    from sgpt_tpu_torch.ops.pooling import normalize

    pos = [index._id_positions()[d] for d in doc_ids]
    q = normalize(torch.from_numpy(np.asarray(qrow, np.float32)[None]).to(index.device,
                                                                          index.dtype))
    return (q.float() @ index._corpus[pos].float().T)[0].cpu().numpy()


def phase_search(torch, mips, sa, engine, corpus, gen):
    """The search slice: index_corpus with kernel="pallas" (K5) and with
    blockmax over the encoded documents, searched with the documents' texts
    as queries in dispatches of 64; then an index of 2^20 rows through
    add/build answering Q = 64 through K5."""
    from sgpt_tpu_torch.index import DenseIndex, index_corpus
    from sgpt_tpu_torch.ops.pooling import normalize

    mips.launches = sa.launches = 0
    t0 = time.perf_counter()
    idx_k5 = index_corpus(engine, corpus, kernel="pallas")
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    idx_bm = index_corpus(engine, corpus)
    ids = list(corpus)
    texts = [(corpus[i]["title"] + " " + corpus[i]["text"]).strip() for i in ids]
    qemb = engine.encode(texts, is_query=True)
    hits = {}
    for name, index in (("pallas", idx_k5), ("blockmax", idx_bm)):
        vals, got = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(0, len(ids), 64):
            v, i = index.search_embeddings(qemb[s:s + 64], k=10)
            vals += v
            got += i
        torch.cuda.synchronize()
        hits[name] = (np.stack(vals), got, time.perf_counter() - t0)
    dispatches = -(-len(ids) // 64)
    k5_launches, k1_launches = mips.launches, sa.launches
    (va, ia, ta), (vb, ib, tb) = hits["pallas"], hits["blockmax"]
    err = float(np.abs(va - vb).max())
    same = sum(a == b for a, b in zip(ia, ib))
    first = np.mean([row[0] == d for row, d in zip(ia, ids)])
    corpus_equal = torch.equal(idx_k5._corpus, idx_bm._corpus)
    log(f"search: {len(ids)} docs indexed in {index_s:.2f} s (kernel=pallas); "
        f"{len(ids)} queries in {dispatches} dispatches of 64: pallas {ta:.3f} s, blockmax "
        f"{tb:.3f} s; top-10 lists equal {same}/{len(ids)}, max |score diff| {err:.3e}; "
        f"own document first for {first:.4f} of queries; K5 launches {k5_launches}, "
        f"K1 launches {k1_launches}; the two encodes equal bit for bit: {corpus_equal}")
    assert k5_launches == dispatches, (k5_launches, dispatches)
    assert k1_launches > 0 and err <= 1e-5
    for n in range(len(ids)):  # a differing id sits on a near-tie (K5's rule)
        if ia[n] != ib[n]:
            assert corpus_equal, "the two encodes of the corpus differ"
            np.testing.assert_allclose(rescore(torch, idx_bm, qemb[n], ia[n]), vb[n],
                                       atol=1e-5, rtol=0, err_msg=f"query {n}")
    # 2^20 rows: the encoded documents plus unit-norm filler, through add/build
    big = DenseIndex(engine.out_dim, kernel="pallas", device="cuda")
    big.add(idx_k5._corpus[: len(ids)].float().cpu().numpy(), ids=idx_k5._ids)
    filler = unit_rows(torch, gen, (1 << 20) - len(ids), engine.out_dim, torch.float32)
    big.add(filler.cpu().numpy(), ids=[f"fill{i}" for i in range(filler.shape[0])])
    del filler
    big.build()
    assert len(big) == 1 << 20
    q = normalize(torch.from_numpy(qemb[:64]).to("cuda", torch.bfloat16))
    mips.launches = 0
    v, i = big.search_embeddings(qemb[:64], k=10)
    assert mips.launches == 1
    got = mips.mips_topk(q, big._corpus, big._built_count, 10)
    want = mips.mips_topk_reference(q, big._corpus, big._built_count, 10)
    err2, _ = check_topk(torch, q, big._corpus, got, want, "index 2^20")
    assert [[big._ids[j] for j in row] for row in got[1].tolist()] == i
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        big.search_embeddings(qemb[:64], k=10)
    torch.cuda.synchronize()
    big_ms = (time.perf_counter() - t0) * 1e3 / 10
    log(f"search: index of {len(big)} rows ({big._corpus.shape[0]} padded), Q=64 k=10 "
        f"through K5: max_abs_err {err2:.3e} against the plain version; {big_ms:.3f} ms a "
        f"dispatch (host clock, 10 dispatches); 4,096-doc index: {ta * 1e3 / dispatches:.3f} "
        f"ms a Q=64 dispatch (pallas), {tb * 1e3 / dispatches:.3f} (blockmax)")
    del big
    torch.cuda.empty_cache()
    return {"k5_launches": k5_launches, "k1_launches": k1_launches,
            "lists_equal": same / len(ids), "own_first": float(first),
            "ms_per_dispatch": ta * 1e3 / dispatches, "ms_per_dispatch_2p20": big_ms}


def phase_serve(torch, mips, engine, corpus):
    """SearchService(kernel="pallas") behind make_server on 127.0.0.1:
    POST /documents with the documents, then POST /search from 8 threads, 8
    one-query requests each; the answers equal a direct search_embeddings."""
    import http.client
    import threading

    from sgpt_tpu_torch.serving import SearchService, make_server

    def post(addr, path, payload):
        conn = http.client.HTTPConnection(*addr, timeout=120)
        try:
            conn.request("POST", path, json.dumps(payload), {"Content-Type": "application/json"})
            r = conn.getresponse()
            return r.status, json.loads(r.read().decode())
        finally:
            conn.close()

    service = SearchService(engine, index_kw={"kernel": "pallas"})
    server = make_server(service, "127.0.0.1", 0, model_name="gpt-neo-125m")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        addr = server.server_address[:2]
        ids = list(corpus)
        docs = [{"id": i, "text": (corpus[i]["title"] + " " + corpus[i]["text"]).strip()}
                for i in ids]
        status, body = post(addr, "/documents", {"documents": docs, "build": True})
        assert status == 200 and body["documents"] == len(ids), (status, body)
        service.warm_search()
        # short queries (one length bucket): an embedding does not depend on
        # which requests it is coalesced with
        queries = [" ".join(d["text"].split()[:8]) for d in docs[::len(docs) // 64]][:64]
        lat, answers, errors = {}, {}, []

        def client(t):
            try:
                for j in range(8):
                    n = t * 8 + j
                    t0 = time.perf_counter()
                    status, body = post(addr, "/search", {"queries": [queries[n]], "k": 10})
                    lat[n] = time.perf_counter() - t0
                    assert status == 200, body
                    answers[n] = body["results"][0]
            except Exception as e:  # reported below
                errors.append(e)

        mips.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(t,)) for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        launches = mips.launches
        assert not errors, errors
        qemb = engine.encode(queries, is_query=True)
        vals, want = service.index.search_embeddings(qemb, k=10)
        differ = 0
        for n in range(len(queries)):
            got_ids = [h["id"] for h in answers[n]]
            got_v = np.array([h["score"] for h in answers[n]], np.float32)
            assert np.abs(got_v - vals[n]).max() <= 1e-5, n
            if got_ids != want[n]:  # only on a near-tie (K5's rule)
                differ += 1
                np.testing.assert_allclose(rescore(torch, service.index, qemb[n], got_ids),
                                           vals[n], atol=1e-5, rtol=0, err_msg=f"query {n}")
        ms = 1e3 * np.array([lat[n] for n in range(len(queries))])
        p50, p99 = float(np.median(ms)), float(np.percentile(ms, 99))
        qps = len(queries) / wall
        log(f"serve: {len(ids)} documents via POST /documents; {len(queries)} POST /search "
            f"from 8 threads: p50 {p50:.2f} ms, p99 {p99:.2f} ms, {qps:.1f} queries/s, "
            f"{service._s_batcher.dispatches} search dispatches in all; K5 launches "
            f"{launches}; answers equal a direct search_embeddings ({differ} of "
            f"{len(queries)} lists differ on a near-tie)")
        assert launches > 0
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=10)
    return {"p50_ms": p50, "p99_ms": p99, "qps": qps, "k5_launches": launches}


FLASH_CASES = [  # name, B, T, H, Dh, block_kv, scale, window, alibi
    ("main-global", 64, 2048, 12, 64, 256, 1.0, 0, False),
    ("main-local256", 64, 2048, 12, 64, 256, 1.0, 256, False),
    ("T128", 8, 128, 12, 64, 256, 1.0, 256, False),   # block_kv clamps to 128
    ("T256", 8, 256, 12, 64, 256, 1.0, 256, False),
    ("T512-bkv128", 8, 512, 12, 64, 128, 1.0, 256, False),
    ("T1024-global", 8, 1024, 12, 64, 256, 1.0, 0, False),
    ("scale", 8, 512, 12, 64, 256, 0.125, 0, False),
    ("alibi", 8, 1024, 12, 64, 256, 1.0, 256, True),
    ("Dh128-T2048", 2, 2048, 16, 128, 256, 1.0, 256, True),  # GPT-Neo 1.3B/2.7B heads
    ("Dh32-w64", 4, 384, 4, 32, 128, 0.25, 64, False),
]


def phase_flash(torch, fa, rng):
    """K3 against `flash_attention_reference` on the decoder's (B, T, H·Dh)
    projection views, output and lse on every row (each case has a short row
    that a window leaves fully masked): bf16 within 2e-2 + 1e-2·|ref|, fp32
    within 1e-5 + 1e-5·|ref|; fully masked rows' lse equal -1e30 on both
    sides. Then the times at the main shape, global and window 256: kernel,
    plain version, the library's SDPA with the same boolean mask, and the
    bound from this run's pairs and bytes (fp32: 3 × the operations at the
    TF32 peak, as 3xTF32 issues them, with the CUDA cores' bound and the
    kernel's and plain version's errors against fp64 beside it)."""
    main_err = 0.0
    for dtype, atol, rtol in ((torch.bfloat16, BF16_ATOL, BF16_RTOL),
                              (torch.float32, FP32_ATOL, FP32_RTOL)):
        for name, B, T, H, Dh, block_kv, scale, window, alibi in FLASH_CASES:
            if dtype == torch.float32:  # the main path runs bf16: fp32 at a smaller batch
                B = min(B, 8)
            (q, k, v, km, slopes), _ = attention_inputs(torch, rng, B, T, H, Dh, dtype,
                                                        alibi=alibi)
            if alibi:
                slopes = slopes * 0.03  # BLOOM-sized slopes
            qh, kh, vh = (heads(t, H) for t in (q, k, v))
            kw = dict(scale=scale, window=window, block_kv=block_kv)
            got, lse = fa.flash_attention(qh, kh, vh, km, slopes, return_residuals=True, **kw)
            torch.cuda.synchronize()
            want, want_lse = fa.flash_attention_reference(qh, kh, vh, km, slopes, **kw)
            assert got.dtype == dtype and got.stride() == qh.stride(), name
            g, w = got.float(), want.float()
            assert torch.isfinite(g).all(), f"flash {name}: non-finite kernel output"
            err = (g - w).abs()
            assert (err - rtol * w.abs()).max().item() <= atol, f"flash {name} {dtype}: output"
            dead = want_lse == fa.NEG_INF
            assert torch.equal(lse == fa.NEG_INF, dead), f"flash {name}: masked rows differ"
            lerr = (lse - want_lse).abs()[~dead]
            assert (lerr - rtol * want_lse.abs()[~dead]).max().item() <= atol, f"flash {name} lse"
            log(f"flash  {name:14s} {str(dtype)[6:]:8s} B={B} T={T} H={H} Dh={Dh} "
                f"block_kv={min(block_kv, T)} window={window}: max_abs_err {err.max().item():.3e}, "
                f"lse {lerr.max().item():.3e}, fully masked rows {int(dead.sum())}")
            if name.startswith("main") and dtype == torch.bfloat16:
                main_err = max(main_err, err.max().item())
            del q, k, v, qh, kh, vh, got, want, lse, want_lse

    # bf16 at the long encode's shape (B=64); fp32 at the long train's (B=8)
    times = {}
    for dt, B, window in (("bf16", 64, 0), ("bf16", 64, 256), ("fp32", 8, 0), ("fp32", 8, 256)):
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        (q, k, v, km, _), _ = attention_inputs(torch, rng, B, 2048, 12, 64, dtype)
        qh, kh, vh = (heads(t, 12) for t in (q, k, v))
        mask = sdpa_mask(torch, km, window)

        def kernel():
            return fa.flash_attention(qh, kh, vh, km, window=window, block_kv=256)

        def plain():
            return fa.flash_attention_reference(qh, kh, vh, km, window=window, block_kv=256)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                                    scale=1.0)

        p1, k1, k2, p2 = (cuda_ms(torch, f, iters=n, warmup=1)
                          for f, n in ((plain, 3), (kernel, 10), (kernel, 10), (plain, 3)))
        lib = cuda_ms(torch, library, iters=5, warmup=1)
        # q, k, v read once, out written once, fp32 lse written, int32 mask read
        nbytes = 4 * q.numel() * q.element_size() + B * 12 * 2048 * 4 + km.numel() * 4
        pairs = attention_pairs(torch, km, window)
        ops = 4 * 64 * 12 * pairs
        if dt == "bf16":
            t = ((k1 + k2) / 2, (p1 + p2) / 2, lib, *bound(nbytes, ops, dt))
            times[window] = t
            extra = ""
        else:  # 3xTF32: three TF32 products for each fp32 one
            simt = bound(nbytes, ops, "fp32")
            ref, valid = k3_fp64(torch, (qh, kh, vh, km), window)
            errs = [torch.where(valid, (o.double() - ref).abs(), 0.0).max().item()
                    for o in (kernel(), plain()[0])]
            del ref, valid
            t = ((k1 + k2) / 2, (p1 + p2) / 2, lib, *bound(nbytes, 3 * ops, "tf32"),
                 simt[0], *errs)
            times[(dt, window)] = t
            extra = (f"; 3 x {ops} TF32 operations at {PEAK_OPS_PER_S['tf32'] / 1e12:.0f} "
                     f"TFLOP/s; on the CUDA cores {simt[0]:.4f} ms, {simt[1]}; max |out - fp64 "
                     f"evaluation| on rows with a valid key: kernel {errs[0]:.3e}, plain "
                     f"{errs[1]:.3e}")
        log(f"time K3 B={B} T=2048 H=12 Dh=64 {dt} window={window}: kernel {t[0]:.4f} "
            f"ms, plain {t[1]:.4f} ms, library (SDPA {dt}, boolean mask) {lib:.4f} ms, "
            f"bound {t[3]:.4f} ms ({t[4]}: {nbytes} bytes, {ops} "
            f"operations over {pairs} pairs; {ops / (t[0] / 1e3) / 1e12:.1f} "
            f"TFLOP/s{extra}) (runs: kernel {k1:.4f} {k2:.4f}, plain {p1:.4f} {p2:.4f})")
        del q, k, v, qh, kh, vh, mask
    torch.cuda.empty_cache()
    return main_err, times


GEMM_KEYS = ("gemm", "nvjet", "xmma", "cutlass", "sm90_")


def device_ms(prof, families: dict) -> dict:
    """Device time (ms) under a torch.profiler run, summed by kernel family
    (the first family one of whose keys the kernel's name holds), the rest
    under "other"."""
    ms = {name: 0.0 for name in (*families, "other")}
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        us = getattr(ev, "self_cuda_time_total", 0.0) if us is None else us
        name = next((f for f, keys in families.items()
                     if any(k in ev.key.lower() for k in keys)), "other")
        ms[name] += us / 1e3
    return ms


def profile_batch(torch, engine, texts, label: str, families: dict) -> dict:
    """Where the time of one encode batch goes: device time by kernel family
    under torch.profiler, and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    engine.encode(texts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.encode(texts)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    ms = device_ms(prof, families)
    total = sum(ms.values())
    if total == 0:
        log(f"{label}: the profiler saw no device time (wall {wall_ms:.1f} ms)")
        return {"profile_wall_ms": wall_ms, "profile_kernel_ms": None}
    shares = ", ".join(f"{k} {v:.2f} ms ({v / total:.3f})" for k, v in ms.items())
    log(f"{label}: {total:.2f} ms of kernels in {wall_ms:.2f} ms wall (busy share "
        f"{total / wall_ms:.3f}): {shares}")
    return {"profile_wall_ms": wall_ms, "profile_kernel_ms": total,
            **{f"profile_{k.split()[0].lower()}_ms": v for k, v in ms.items()}}


# K1's kernels; "::scalar_kernel", as PyTorch's `compare_scalar_kernel` holds "scalar_kernel"
K1_KEYS = ("mma_kernel", "tf32_kernel", "::scalar_kernel")


PIPELINE_REPS = 3   # timed encodes of each side (the median is reported)


def encode_busy(torch, engine, texts) -> dict:
    """One encode under torch.profiler (device activity only: host op
    events would slow a host-bound encode): the kernels' device time and
    the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.encode(texts)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    total = sum(device_ms(prof, {"K1 short": K1_KEYS, "GEMM": GEMM_KEYS}).values())
    return {"wall_ms": wall_ms, "kernel_ms": total or None,
            "busy_share": total / wall_ms if total else None}


def phase_pipeline(torch, sa, model, cfg, tok, texts, docs, card, parent=None) -> dict:
    """The encode pipeline on the slice's weights and texts: the default
    engine (FETCH_PIPELINE_DEPTH 2, dispatch_chain 8) against depth 1 with
    dispatch_chain 1, and against depth 2 with a blocking fetch (each
    entry's rows fetched by `.cpu()` when drained, which queues behind the
    batches dispatched since: the design the asynchronous host copy
    replaces). The embeddings equal bit for bit, K1 = 12 × batches on every
    side; each side's emb/s (the median of PIPELINE_REPS encodes, the sides
    in turns) and its busy share under torch.profiler. With `parent`
    (another checkout), that checkout's `encoder.py` runs as one more side
    on this tree's modules (the engine's change alone), held to the same
    bits. Then depth 2 against depth 1 on a dp=2 mesh of `cuda:0` named
    twice (the chain is 1 on a mesh), and one encode wrapped in
    `utils.profiling.Timer` and `profile_trace`, whose Chrome trace must
    name K1's kernel and the engine's spans."""
    import importlib.util
    import shutil
    from pathlib import Path

    import sgpt_tpu_torch.encoder as enc_mod
    from sgpt_tpu_torch.encoder import EmbeddingEngine
    from sgpt_tpu_torch.parallel import make_mesh
    from sgpt_tpu_torch.utils import Timer, profile_trace

    kw = dict(specb=True, max_seq_len=300, batch_size=64, normalize_embeddings=True)
    L = cfg.num_layers
    # name: (FETCH_PIPELINE_DEPTH, engine keywords, blocking fetch)
    sides = {"depth2_chain8": (2, dict(device="cuda"), False),
             "depth1_chain1": (1, dict(device="cuda", dispatch_chain=1), False),
             "depth2_chain8_blocking_fetch": (2, dict(device="cuda"), True)}

    @contextlib.contextmanager
    def side(name):
        d, _, blocking = sides[name]
        saved = enc_mod.FETCH_PIPELINE_DEPTH, enc_mod.copy_rows_to_host
        enc_mod.FETCH_PIPELINE_DEPTH = d
        if blocking:   # wait_rows then fetches the device tensors by `.cpu()`
            enc_mod.copy_rows_to_host = lambda parts: [(p.detach(), None) for p in parts]
        try:
            yield
        finally:
            enc_mod.FETCH_PIPELINE_DEPTH, enc_mod.copy_rows_to_host = saved

    def counted_encode(engine, name):
        """One encode of side `name` with K1's launches and the batches
        dispatched (`_embed` calls: one a batch, chained or not) counted."""
        batches = counted(engine, "_embed")
        torch.cuda.synchronize()
        sa.launches = 0
        with side(name):
            got = engine.encode(texts)
        torch.cuda.synchronize()
        return got, sa.launches, len(batches)

    out = {}
    engines = {name: EmbeddingEngine(model, cfg, tok, **kw, **extra)
               for name, (_, extra, _) in sides.items()}
    if parent:
        spec = importlib.util.spec_from_file_location(
            "sgpt_tpu_torch.parent_encoder",
            Path(parent).resolve() / "sgpt_tpu_torch" / "encoder.py")
        parent_encoder = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(parent_encoder)
        engines["parent"] = parent_encoder.EmbeddingEngine(model, cfg, tok, device="cuda", **kw)
        sides["parent"] = (1, {}, False)   # no pipeline, no chain: nothing is read
    got = {}
    for name in sides:
        engines[name].warmup()
        got[name], k1, n_batches = counted_encode(engines[name], name)
        assert k1 == L * n_batches > 0, (name, k1, n_batches)
        out[name] = {"k1_launches": k1, "batches": n_batches}
    chained = engines["depth2_chain8"]
    same = all(np.array_equal(got["depth2_chain8"], g) for g in got.values())
    log(f"pipeline: depth 2 chain {chained.dispatch_chain} == depth 1 chain 1 == blocking "
        f"fetch{' == the parent' if parent else ''} bit for bit: {same}; equal to phase slice's "
        f"documents: "
        f"{np.array_equal(got['depth2_chain8'], docs)}; K1 launches "
        f"{out['depth2_chain8']['k1_launches']} / {out['depth1_chain1']['k1_launches']} = "
        f"{L} x {out['depth2_chain8']['batches']} batches")
    assert same, {k: np.abs(got["depth2_chain8"] - g).max() for k, g in got.items()}
    assert np.isfinite(got["depth2_chain8"]).all()
    walls = {name: [] for name in sides}
    for rep in range(PIPELINE_REPS):   # the sides in turns, the order reversed each round
        for name in list(sides)[::1 if rep % 2 == 0 else -1]:
            with side(name):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engines[name].encode(texts)
                torch.cuda.synchronize()
                walls[name].append(time.perf_counter() - t0)
    for name in sides:
        with side(name):
            busy = encode_busy(torch, engines[name], texts)
        wall = float(np.median(walls[name]))
        out[name].update({"emb_per_s": len(texts) / wall, "walls_s": walls[name], **busy})
        log(f"pipeline {name}: {len(texts) / wall:.1f} emb/s (median of {PIPELINE_REPS}: "
            + ", ".join(f"{w * 1e3:.2f}" for w in walls[name]) + " ms), busy share "
            + (f"{busy['busy_share']:.3f} ({busy['kernel_ms']:.2f} ms of kernels in "
               f"{busy['wall_ms']:.2f} ms)" if busy["kernel_ms"] else "not measured (the "
               "profiler saw no device time)") + f"; GPT-Neo-125M bf16, {len(texts)} texts "
            f"({card})")
    out["speedup"] = out["depth2_chain8"]["emb_per_s"] / out["depth1_chain1"]["emb_per_s"]
    out["vs_blocking_fetch"] = (out["depth2_chain8"]["emb_per_s"]
                                / out["depth2_chain8_blocking_fetch"]["emb_per_s"])
    log(f"pipeline: depth 2 chain 8 at {out['speedup']:.3f} x depth 1 chain 1, "
        f"{out['vs_blocking_fetch']:.3f} x depth 2 with the blocking fetch" + (
        f", {out['depth2_chain8']['emb_per_s'] / out['parent']['emb_per_s']:.3f} x the "
        f"parent's engine" if parent else "") + f" ({card})")

    # the dp=2 mesh of the one card named twice: depth 2 == depth 1
    mesh = make_mesh(dp=2, tp=1, devices=MESH_DEVICES[:1] * 2)
    mgot = {}
    for name in ("depth2_chain8", "depth1_chain1"):
        engine = EmbeddingEngine(model, cfg, tok, mesh=mesh, **kw,
                                 **{k: v for k, v in sides[name][1].items() if k != "device"})
        engine.encode(texts[:64])
        mgot[name], k1, n = counted_encode(engine, name)
        assert k1 == L * 2 * n > 0, (name, k1, n)   # K1 per dp row
        out[f"mesh_dp2_{name}"] = {"k1_launches": k1, "batches": n}
        del engine
    msame = np.array_equal(mgot["depth2_chain8"], mgot["depth1_chain1"])
    mcos = cosine(mgot["depth2_chain8"], docs)
    log(f"pipeline mesh dp=2 ({' '.join(MESH_DEVICES[:1] * 2)}): depth 2 == depth 1 bit for "
        f"bit: {msame}; K1 launches {out['mesh_dp2_depth2_chain8']['k1_launches']} / "
        f"{out['mesh_dp2_depth1_chain1']['k1_launches']} = {L} x 2 x "
        f"{out['mesh_dp2_depth2_chain8']['batches']}; cosine to the meshless rows min "
        f"{mcos.min():.6f}")
    assert msame and mcos.min() >= MESH_COS_MIN, (msame, mcos.min())

    # the profiling utilities around one encode
    trace_dir = Path(__file__).resolve().parent / "build" / "pipeline_trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    with profile_trace(str(trace_dir)), Timer() as timer:
        chained.encode(texts)
    emb_per_s = len(texts) / timer.elapsed
    traces = sorted(trace_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1, traces
    events = json.loads(traces[0].read_text())["traceEvents"]
    kernels = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    k1_names = sorted(n for n in kernels if any(k in n.lower() for k in K1_KEYS))
    spans = sorted({e.get("name", "") for e in events
                    if e.get("cat") == "cpu_op" and e.get("name", "").startswith("engine.")})
    log(f"pipeline profile_trace: {traces[0].name} ({traces[0].stat().st_size} bytes, "
        f"{len(kernels)} kernel names, K1's: {[n[:60] for n in k1_names]}, spans {spans}); "
        f"Timer {timer.elapsed * 1e3:.2f} ms, {emb_per_s:.1f} emb/s under the profiler ({card})")
    assert k1_names, sorted(kernels)[:20]
    assert spans == ["engine.dispatch", "engine.drain", "engine.pad", "engine.plan",
                     "engine.tokenize"], spans
    out["trace"] = {"file": traces[0].name, "bytes": traces[0].stat().st_size,
                    "kernel_names": len(kernels), "k1_names": k1_names, "spans": spans,
                    "timer_ms": timer.elapsed * 1e3, "emb_per_s": emb_per_s}
    out["k1_launches"] = sum(v["k1_launches"] for v in out.values()
                             if isinstance(v, dict) and "k1_launches" in v)
    return out


def long_texts(rng):
    """512 documents of 300-3,000 words whose SPECB lengths fill the 2048
    bucket with 5 batches of 64 (154 truncated), the 1024 bucket with one
    batch of 128 and the 512 bucket with one batch; and 512 short queries
    (3-60 words: the T=64 bucket, one batch of 512)."""
    words = ["".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"), rng.integers(2, 9)))
             for _ in range(20000)]
    # words: lo, hi, count; past 2046 words a document loses words to the budget
    spans = [(2047, 3001, 154), (1023, 2047, 166), (511, 1023, 128), (300, 511, 64)]
    lengths = np.concatenate([rng.integers(lo, hi, n) for lo, hi, n in spans])
    rng.shuffle(lengths)
    docs = [" ".join(rng.choice(words, int(m))) for m in lengths]
    queries = [" ".join(d.split()[: int(rng.integers(3, 61))]) for d in docs]
    return docs, queries


def phase_long(torch, fa, sa, mips, model, tok, rng, card):
    """The long-context slice: full-width GPT-Neo-125M with use_flash (the
    weights of `model`, bf16) through EmbeddingEngine at max_seq_len 2048,
    batch_size 64; documents then queries. K3 must run in every layer of
    every batch at T % 128 == 0 and K1 in every layer of the others."""
    import copy

    from sgpt_tpu_torch.encoder import EmbeddingEngine
    from sgpt_tpu_torch.index import index_corpus
    from sgpt_tpu_torch.models import Decoder, gpt_neo

    cfg = gpt_neo("125m", dtype=torch.bfloat16, use_flash=True)
    flash_model = Decoder(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
    assert all(torch.equal(a, b) for a, b in zip(flash_model.state_dict().values(),
                                                 model.state_dict().values()))
    kw = dict(specb=True, max_seq_len=2048, batch_size=64, normalize_embeddings=True)
    engine = EmbeddingEngine(flash_model, cfg, tok, device="cuda", **kw)
    docs, queries = long_texts(rng)
    rows, n_trunc, _ = engine.codec.encode_rows(docs)
    tokens = sum(len(r) for r in rows)
    engine.warmup()
    torch.cuda.synchronize()

    shapes = []
    hook = flash_model.register_forward_pre_hook(
        lambda m, args: shapes.append(tuple(args[0].shape)))
    fa.launches = sa.launches = 0
    t0 = time.perf_counter()
    demb = engine.encode(docs)
    torch.cuda.synchronize()
    doc_s = time.perf_counter() - t0
    n_doc_batches = len(shapes)
    qemb = engine.encode(queries, is_query=True)
    k3, k1 = fa.launches, sa.launches
    hook.remove()
    flash_batches = sum(T % 128 == 0 for _, T in shapes)
    log(f"long: {len(docs)} docs ({n_trunc} truncated at 2048) in {n_doc_batches} batches, "
        f"{len(queries)} queries in {len(shapes) - n_doc_batches}; shapes {shapes}; "
        f"K3 launches {k3}, K1 launches {k1}")
    assert k3 == cfg.num_layers * flash_batches > 0, (k3, flash_batches)
    assert k1 == cfg.num_layers * (len(shapes) - flash_batches) > 0, (k1, shapes)
    assert {512, 1024, 2048} <= {T for _, T in shapes[:n_doc_batches]}, shapes
    assert n_trunc == 154, n_trunc
    for name, emb in (("docs", demb), ("queries", qemb)):
        assert emb.shape == (len(docs), cfg.hidden_size) and np.isfinite(emb).all(), name
        norms = np.linalg.norm(emb, axis=1)
        assert np.abs(norms - 1).max() < 1e-2, (name, norms.min(), norms.max())
    emb_per_s, tok_per_s = len(docs) / doc_s, tokens / doc_s
    log(f"long encode: {emb_per_s:.1f} emb/s ({tok_per_s:.0f} tokens/s), {len(docs)} docs "
        f"of {tokens} tokens in {doc_s:.3f} s, bf16, batch_size 64, max_seq_len 2048 ({card})")
    order = np.argsort([len(r) for r in rows], kind="stable")
    profile = profile_batch(torch, engine, [docs[i] for i in order[-64:]],
                            "long profile, one batch of 64 at T=2048",
                            {"K3 flash": ("flash_fwd",), "K1 short": K1_KEYS, "GEMM": GEMM_KEYS})

    # the same weights without use_flash: K1 at every T
    plain = EmbeddingEngine(model, model.cfg, tok, device="cuda", **kw)
    sa.launches = 0
    pemb = plain.encode(docs)
    assert sa.launches > 0
    cos = cosine(demb, pemb)
    log(f"long: flash engine against the non-flash engine (K1 at every T), bf16: cosine min "
        f"{cos.min():.6f} mean {cos.mean():.6f} (tolerance min 0.999)")
    assert cos.min() > 0.999
    del plain, pemb

    # card fp32 (K3, K1) against CPU fp32 (plain versions) on 8 documents
    pick = list(order[-3:]) + list(order[[70, 100, 150]]) + list(order[[5, 40]])
    few = [docs[i] for i in pick]
    cfg32 = gpt_neo("125m", use_flash=True)
    cpu_model = Decoder(cfg32, device="cpu", generator=torch.Generator().manual_seed(SEED))
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    kw32 = dict(specb=True, max_seq_len=2048, batch_size=1, normalize_embeddings=True)
    t0 = time.perf_counter()
    on_cpu = EmbeddingEngine(cpu_model, cfg32, tok, device="cpu", **kw32).encode(few)
    cpu_s = time.perf_counter() - t0
    fa.launches = 0
    on_gpu = EmbeddingEngine(gpu_model, cfg32, tok, device="cuda", **kw32).encode(few)
    assert fa.launches > 0
    err32 = float(np.abs(on_gpu - on_cpu).max())
    log(f"long: fp32 card against fp32 CPU, 8 docs of {sorted(len(rows[i]) for i in pick)} "
        f"tokens: max abs diff {err32:.3e} (tolerance 1e-4; CPU took {cpu_s:.1f} s)")
    assert err32 < 1e-4
    del cpu_model, gpu_model

    # index the documents with K5: each finds itself first
    corpus = {f"long{i}": {"title": "", "text": d} for i, d in enumerate(docs)}
    mips.launches = 0
    index = index_corpus(engine, corpus, kernel="pallas")
    _, hits = index.search_embeddings(demb, k=10)
    own = np.mean([row[0] == f"long{i}" for i, row in enumerate(hits)])
    log(f"long: index of {len(index)} documents (kernel=pallas): own document first for "
        f"{own:.4f} of them; K5 launches {mips.launches}")
    assert own == 1.0 and mips.launches > 0
    del engine, flash_model, index
    torch.cuda.empty_cache()
    return {"k3_launches": k3, "k1_launches": k1, "emb_per_s": emb_per_s,
            "tokens_per_s": tok_per_s, "flash_vs_plain_cos_min": float(cos.min()),
            "fp32_err": err32, "batches": len(shapes), "flash_batches": flash_batches,
            **profile}


# the cross-encoder slice's gates (phase ce)
CE_RTOL, CE_ATOL = 2e-5, 1e-4  # summed log-probs: fp32 card == CPU, packed == unpacked
CE_SPEARMAN_FLOOR = 0.99  # bf16 against fp32 ranks of each query's top-100: the least
CE_SERVE_TOL = 0.05  # |Δ ce_score| of a pair scored in bf16 dispatches of other shapes
# bf16 kernel path against bf16 plain path, one query's top-100 at 24-28 layers: random
# weights score a query's 100 documents within a narrow band, and 24-28 layers of bf16
# roundings move a summed log-prob by up to ~0.2, so single queries reorder near-ties
FAMILY_SPEARMAN_MIN = 0.98


def ce_mix(rng):
    """The CE slice's traffic, after tools/bench_ce_ragged.py:make_lengths: a
    BEIR-like corpus of 2,000 documents of lognormal(5.0, 1.0) words clipped
    to [20, 1,400], 32 queries of 12 words drawn from documents (so BM25
    finds them); and a short mix of 3,200 (12-word query, 5-60 word
    document) pairs."""
    words = ["".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"), rng.integers(2, 9)))
             for _ in range(5000)]
    lengths = np.clip(rng.lognormal(5.0, 1.0, 2000), 20, 1400).astype(int)
    corpus = {f"ce{i}": {"title": "", "text": " ".join(rng.choice(words, int(m)))}
              for i, m in enumerate(lengths)}
    src = rng.choice(len(corpus), 32, replace=False)
    queries = {f"q{n}": " ".join(rng.choice(corpus[f"ce{d}"]["text"].split(), 12,
                                            replace=False)) for n, d in enumerate(src)}
    short = [(" ".join(rng.choice(words, 12)), " ".join(rng.choice(words, int(m))))
             for m in rng.integers(5, 60, 3200)]
    return corpus, queries, short


def ce_tokens(ranker, pairs) -> int:
    """Tokens in the rows the ranker builds for these pairs (truncation
    applied; no pair repeats here, so nothing is deduplicated)."""
    enc = ranker.tokenizer.encode
    return sum(ranker._pack(enc(ranker.prompt_doc.format(d)), enc(q))[1] for q, d in pairs)


def ce_attention_inputs(torch, rng, B, T, packed: bool, H: int = 12, Dh: int = 64,
                        dtype=None):
    """K1's inputs at a CE shape: q/k/v (std 0.5; bf16 unless `dtype`) of H
    heads of Dh; packed rows carry segments of 8-90 tokens (up to 16 a row,
    the ranker's cap), positions restarting in each, and a padding tail
    (segment -1, key mask 0); unpacked rows the ranker's full-ones key mask.
    Returns (q, k, v, key_mask, segments or None, positions or None)."""
    q, k, v = (card_normal(torch, rng, (B, T, H * Dh), 0.5, dtype or torch.bfloat16)
               for _ in range(3))
    km = np.ones((B, T), np.int32)
    seg = pos = None
    if packed:
        km[:] = 0
        seg = np.full((B, T), -1, np.int32)
        pos = np.zeros((B, T), np.int32)
        for b in range(B):
            off = 0
            for s in range(16):
                n = int(rng.integers(8, 91))
                if off + n > T:
                    break
                km[b, off:off + n], seg[b, off:off + n], pos[b, off:off + n] = 1, s, np.arange(n)
                off += n
        seg, pos = torch.from_numpy(seg).cuda(), torch.from_numpy(pos).cuda()
    return q, k, v, torch.from_numpy(km).cuda(), seg, pos


def phase_ce_kernel(torch, sa, rng):
    """K1 (bf16) at the CE shapes against its plain version, window 0 and
    256: packed rows at T=256, B=128 (`mma_kernel<64, GENERAL>`), unpacked
    rows at T=1,024, B=32 and at T=2,048, B=16; kernel, plain, library (SDPA
    with the boolean mask causal ∧ same segment ∧ window ∧ key valid) and
    bound times. Returns the largest error and the times by cell."""
    out, worst = {}, 0.0
    for name, B, T, packed in (("packed_t256", 128, 256, True), ("t1024", 32, 1024, False),
                               ("t2048", 16, 2048, False)):
        q, k, v, km, seg, _ = ce_attention_inputs(torch, rng, B, T, packed)
        qh, kh, vh = (heads(t, 12) for t in (q, k, v))
        for window in (0, 256):
            def kernel():
                return sa.short_attention(q, k, v, km, None, 1.0, window, 12, False,
                                          segments=seg)

            def plain():
                return sa.short_attention_reference(q, k, v, km, None, scale=1.0,
                                                    window=window, H=12, use_alibi=False,
                                                    segments=seg)

            mask = sdpa_mask(torch, km, window)
            if seg is not None:
                mask = mask & (seg[:, :, None] == seg[:, None, :])[:, None]

            def library():
                return torch.nn.functional.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=mask, scale=1.0)

            got, want = kernel().float(), plain().float()
            assert torch.isfinite(got).all(), (name, window)
            err = (got - want).abs()
            assert (err - BF16_RTOL * want.abs()).max().item() <= BF16_ATOL, (name, window)
            worst = max(worst, err.max().item())
            del got, want, err
            p1, k1, k2, p2 = (cuda_ms(torch, f, iters=10) for f in (plain, kernel, kernel, plain))
            lib = cuda_ms(torch, library, iters=10)
            pairs = int(mask.sum().item())
            nbytes = 4 * q.numel() * 2 + km.numel() * 4 + (0 if seg is None else seg.numel() * 4)
            ops = 4 * 64 * 12 * pairs
            b_ms, b_by = bound(nbytes, ops, "bf16")
            key = name if window == 0 else f"{name}_w256"
            out[key] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": lib,
                        "bound_ms": b_ms, "bound_by": b_by}
            log(f"time K1 CE {name} B={B} T={T} H=12 Dh=64 bf16 window={window}"
                f"{' segments' if packed else ''}: kernel {out[key]['ms']:.4f} ms, plain "
                f"{out[key]['plain_ms']:.4f} ms, library (SDPA, boolean mask) {lib:.4f} ms, "
                f"bound {b_ms:.4f} ms ({b_by}: {nbytes} bytes, {ops} operations over "
                f"{pairs} (query, key) pairs) (runs: kernel {k1:.4f} {k2:.4f}, plain "
                f"{p1:.4f} {p2:.4f})")
            del mask
        del q, k, v, qh, kh, vh, km, seg
        torch.cuda.empty_cache()
    log(f"K1 at the CE shapes: max_abs_err {worst:.3e} against the plain version "
        f"(atol {BF16_ATOL}, rtol {BF16_RTOL})")
    return worst, out


def profile_ce(torch, ranker, pairs, label: str) -> dict:
    """One scorer dispatch (the pairs must fill exactly one) under
    torch.profiler: device time of K1, of the projection GEMMs, of the LM
    head (the kernels under `Decoder.logits`), of the log-softmax and
    gather (the other kernels under `logprobs._token_logprobs`) and of the
    rest, and the device's busy share of the wall time. Then the head's
    GEMM alone at this dispatch's rows, with the vocab as it is (50,257, an
    odd row stride) and padded to 50,304, beside its bound."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from sgpt_tpu_torch.ops import logprobs

    model, token_logprobs, logits = ranker.model, logprobs._token_logprobs, ranker.model.logits
    head_rows = []

    def head(h):
        head_rows.append(h.shape[:-1].numel())
        with record_function("ce_lm_head"):
            return logits(h)

    def scored(*a):
        with record_function("ce_head_logsoftmax"):
            return token_logprobs(*a)

    ranker.predict(pairs)
    torch.cuda.synchronize()
    model.logits, logprobs._token_logprobs = head, scored
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ranker.predict(pairs)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        del model.logits
        logprobs._token_logprobs = token_logprobs
    ranges = ("ce_lm_head", "ce_head_logsoftmax")
    # the ranges also show as device spans of their own (user annotations):
    # a family of their own, dropped, so that no kernel counts twice
    fam = device_ms(prof, {"K1": K1_KEYS, "GEMM": GEMM_KEYS, "ranges": ranges})
    del fam["ranges"]
    total = sum(fam.values())
    if total == 0:
        log(f"{label}: the profiler saw no device time (wall {wall_ms:.1f} ms)")
        return {"profile_wall_ms": wall_ms, "profile_kernel_ms": None}

    def range_kernels(name):
        """(kernel name, ms) of every kernel launched under the named ranges."""
        out = []

        def walk(e):
            out.extend((k.name, k.duration / 1e3) for k in e.kernels)
            for ch in e.cpu_children:
                walk(ch)

        for e in prof.events():
            if e.name == name:
                walk(e)
        return out

    head_k, scored_k = range_kernels("ce_lm_head"), range_kernels("ce_head_logsoftmax")
    head_ms = sum(ms for _, ms in head_k)
    head_gemm = sum(ms for n, ms in head_k if any(key in n.lower() for key in GEMM_KEYS))
    parts = {"K1": fam["K1"], "projection GEMMs": fam["GEMM"] - head_gemm, "LM head": head_ms,
             "log-softmax": sum(ms for _, ms in scored_k) - head_ms}
    parts["rest"] = total - sum(parts.values())
    shares = ", ".join(f"{k} {v:.2f} ms ({v / total:.3f})" for k, v in parts.items())
    names = sorted({n for n, _ in head_k})
    top = sorted(((ev.key, (getattr(ev, "self_device_time_total", None)
                            or getattr(ev, "self_cuda_time_total", 0.0)) / 1e3)
                  for ev in prof.key_averages()
                  if str(getattr(ev, "device_type", "")).endswith("CUDA")
                  and ev.key not in ranges),
                 key=lambda kv: -kv[1])[:6]
    log(f"{label}: {total:.2f} ms of kernels in {wall_ms:.2f} ms wall (busy share "
        f"{total / wall_ms:.3f}): {shares}; the head's kernels {names}; the six longest "
        "kernels: " + "; ".join(f"{n[:90]} {ms:.2f} ms" for n, ms in top))

    # the head's product alone at this dispatch's rows: vocab 50,257 and padded
    M, (V, D) = head_rows[-1], model.wte.shape
    h = torch.randn(M, D, device="cuda", dtype=model.wte.dtype)
    padded = torch.cat([model.wte, model.wte.new_zeros(-V % 64, D)])
    odd_ms = cuda_ms(torch, lambda: torch.nn.functional.linear(h, model.wte), iters=10)
    pad_ms = cuda_ms(torch, lambda: torch.nn.functional.linear(h, padded), iters=10)
    b_ms, b_by = bound(2 * (M * D + V * D + M * V), 2 * M * D * V, "bf16")
    log(f"{label}: LM head alone, ({M}, {D}) x ({V}, {D})^T bf16: {odd_ms:.4f} ms; with the "
        f"vocab padded to {padded.shape[0]}: {pad_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by})")
    del h, padded
    return {"profile_wall_ms": wall_ms, "profile_kernel_ms": total,
            **{f"profile_{k.split()[0].lower().replace('-', '_')}_ms": v
               for k, v in parts.items()},
            "head_rows": M, "head_ms": odd_ms, "head_padded_vocab_ms": pad_ms,
            "head_bound_ms": b_ms}


def phase_ce(torch, sa, model, tok, rng, card):
    """The cross-encoder slice (SGPT-CE) on the bf16 full-width GPT-Neo-125M
    of phase 4, max_length 2048 and batch_size 16 (sgptce's defaults):
    prompt G over the BEIR-like mix's BM25 top-100 (3,200 pairs), the short
    mix unpacked and at pack_t=256, prompt L on 256 short pairs. K1 must run
    in every layer of every dispatch. pairs/s and tokens/s on the host clock,
    tokenising included; one dispatch of each mix profiled. Returns the
    rates, the bf16 scores of the BEIR mix, the K1 launches and the pairs."""
    from sgpt_tpu_torch.ce_prompts import build_ranker
    from sgpt_tpu_torch.crossencoder import CrossEncoderRanker
    from sgpt_tpu_torch.retrieval_bm25 import BM25Retriever

    cfg = model.cfg
    corpus, queries, short = ce_mix(rng)
    t0 = time.perf_counter()
    first = BM25Retriever().search(corpus, queries, 100)
    bm25_s = time.perf_counter() - t0
    beir = [(queries[q], corpus[d]["text"]) for q, hits in first.items() for d in hits]
    assert len(beir) == 3200, len(beir)
    kw = dict(device="cuda", batch_size=16, max_length=2048)
    runs = {"beir": (CrossEncoderRanker(model, cfg, tok, **kw), beir),
            "short": (CrossEncoderRanker(model, cfg, tok, **kw), short),
            "short_packed": (CrossEncoderRanker(model, cfg, tok, pack_t=256, **kw), short),
            "yesno": (build_ranker("L", model, cfg, tok, **kw), short[:256])}
    shapes = []
    hook = model.register_forward_pre_hook(lambda m, args: shapes.append(tuple(args[0].shape)))
    out, scores, launches = {}, {}, 0
    try:
        for name, (ranker, pairs) in runs.items():
            ranker.predict(pairs)  # warm: matmul plans, the pinned-memory pool
            torch.cuda.synchronize()
            shapes.clear()
            sa.launches = 0
            t0 = time.perf_counter()
            got = ranker.predict(pairs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            k1, dispatches = sa.launches, len(shapes)
            assert k1 == cfg.num_layers * dispatches > 0, (name, k1, dispatches)
            got = np.asarray(got)
            assert got.shape == (len(pairs),) and np.isfinite(got).all() and (got < 0).all(), name
            launches += k1
            scores[name] = got
            tokens = ce_tokens(ranker, pairs) if name != "yesno" else None
            t0 = time.perf_counter()  # the host's share: tokenising, as score_pairs does
            tok.encode_batch([q for q, _ in pairs])
            tok.encode_batch([ranker.prompt_doc.format(d, q) for q, d in pairs])
            tok_s = time.perf_counter() - t0
            out[name] = {"pairs_per_s": len(pairs) / wall, "wall_s": wall, "tokens": tokens,
                         "tokens_per_s": tokens / wall if tokens else None,
                         "dispatches": dispatches, "k1_launches": k1, "tokenise_s": tok_s}
            log(f"ce {name}: {len(pairs)} pairs in {wall:.3f} s (tokenising them alone "
                f"{tok_s:.3f} s), {len(pairs) / wall:.1f} pairs/s"
                + (f", {tokens} tokens, {tokens / wall:.0f} tokens/s" if tokens
                   else "") + f"; {dispatches} dispatches, (rows, T) "
                f"{sorted(set(shapes))}; K1 launches {k1} = {cfg.num_layers} x {dispatches}; "
                f"bf16, max_length 2048, batch_size 16 ({card})")
        # one dispatch of each mix under the profiler (the warm-up and the
        # profiled run: two dispatches of one shape)
        order = np.argsort([-len(d.split()) for _, d in short], kind="stable")
        for name, pairs in (("beir", sorted(beir, key=lambda p: -len(p[1].split()))[:16]),
                            ("short", [short[i] for i in order[:256]]),
                            ("short_packed", short[:440])):
            shapes.clear()
            prof = profile_ce(torch, runs[name][0], pairs, f"ce profile, one {name} dispatch")
            assert len(shapes) == 2 and shapes[0] == shapes[1], (name, shapes)
            out[name]["profile"] = {"rows_t": list(shapes[0]), **prof}
    finally:
        hook.remove()
    diff = float(np.abs(scores["short"] - scores["short_packed"]).max())
    log(f"ce: bf16 short mix, packed against unpacked: max |diff| {diff:.4f}; BM25 for 32 "
        f"queries over 2,000 docs {bm25_s:.2f} s")
    return out, scores["beir"], launches, (corpus, queries, first, beir, short)


def phase_ce_parity(torch, sa, tok, beir, short, bf16_beir, card):
    """The same weights in fp32 ("highest"): card (K1) against CPU (K1's plain
    version) on 32 pairs of the BEIR-like mix spread over its lengths, packed
    against unpacked on the card on 64 short pairs (both within rtol 2e-5,
    atol 1e-4), and the bf16 scores of phase ce against the card's fp32
    ones: the Spearman correlation of each query's top-100 at least
    CE_SPEARMAN_FLOOR."""
    import copy

    from sgpt_tpu_torch.crossencoder import CrossEncoderRanker
    from sgpt_tpu_torch.evaluation import spearman
    from sgpt_tpu_torch.models import Decoder, gpt_neo

    cfg32 = gpt_neo("125m")
    cpu_model = Decoder(cfg32, device="cpu", generator=torch.Generator().manual_seed(SEED))
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    order = np.argsort([len(d.split()) for _, d in beir], kind="stable")
    pick = [beir[i] for i in order[:: len(beir) // 32][:32]]
    kw = dict(batch_size=2, max_length=2048)
    t0 = time.perf_counter()
    on_cpu = np.array(CrossEncoderRanker(cpu_model, cfg32, tok, device="cpu", **kw).predict(pick))
    cpu_s = time.perf_counter() - t0
    del cpu_model
    sa.launches = 0
    on_card = np.array(CrossEncoderRanker(gpu_model, cfg32, tok, device="cuda",
                                          **kw).predict(pick))
    assert sa.launches > 0
    err = np.abs(on_card - on_cpu)
    log(f"ce parity: fp32 card against fp32 CPU, 32 pairs of {min(len(d.split()) for _, d in pick)}"
        f"-{max(len(d.split()) for _, d in pick)} words: max |diff| {err.max():.3e}, max "
        f"|diff|/|score| {(err / np.abs(on_cpu)).max():.3e} (tolerance rtol {CE_RTOL}, atol "
        f"{CE_ATOL}; CPU took {cpu_s:.1f} s)")
    np.testing.assert_allclose(on_card, on_cpu, rtol=CE_RTOL, atol=CE_ATOL)

    kw = dict(device="cuda", batch_size=16, max_length=2048)
    unpacked = np.array(CrossEncoderRanker(gpu_model, cfg32, tok, **kw).predict(short[:64]))
    packed = np.array(CrossEncoderRanker(gpu_model, cfg32, tok, pack_t=256,
                                         **kw).predict(short[:64]))
    perr = float(np.abs(packed - unpacked).max())
    log(f"ce parity: fp32 on the card, 64 short pairs, pack_t=256 against unpacked: max "
        f"|diff| {perr:.3e} (tolerance rtol {CE_RTOL}, atol {CE_ATOL})")
    np.testing.assert_allclose(packed, unpacked, rtol=CE_RTOL, atol=CE_ATOL)

    fp32 = np.array(CrossEncoderRanker(gpu_model, cfg32, tok, **kw).predict(beir))
    rho = np.array([spearman(bf16_beir[i:i + 100], fp32[i:i + 100])
                    for i in range(0, len(beir), 100)])
    top1 = np.mean([np.argmax(bf16_beir[i:i + 100]) == np.argmax(fp32[i:i + 100])
                    for i in range(0, len(beir), 100)])
    log(f"ce parity: bf16 against fp32 on the card, 32 queries' top-100: Spearman min "
        f"{rho.min():.4f} mean {rho.mean():.4f} (floor {CE_SPEARMAN_FLOOR}), same first "
        f"document for {top1:.3f} of queries, max |score diff| "
        f"{np.abs(bf16_beir - fp32).max():.4f} ({card})")
    assert rho.min() >= CE_SPEARMAN_FLOOR, rho
    del gpu_model
    torch.cuda.empty_cache()
    return {"fp32_card_vs_cpu": float(err.max()), "fp32_packed_vs_unpacked": perr,
            "bf16_vs_fp32_spearman_min": float(rho.min()),
            "bf16_vs_fp32_spearman_mean": float(rho.mean()), "bf16_vs_fp32_top1": float(top1)}


def phase_ce_serve(torch, sa, mips, engine, ranker, corpus, queries):
    """`SearchService(kernel="pallas", ranker=...)` behind make_server on
    127.0.0.1 over the BEIR-like mix's 2,000 documents: POST /rerank from 8
    threads, 4 one-query requests each, first_k = k = 16 (K5's largest k:
    every candidate comes back with its ce_score). Each answer holds the
    direct `service.rerank`'s candidates, sorted by ce_score, with the same
    first-stage scores (within 1e-5) and ce_scores within CE_SERVE_TOL: a
    coalesced dispatch has other (rows, T, C) shapes, so its bf16 GEMMs may
    round differently."""
    import http.client
    import threading

    from sgpt_tpu_torch.serving import SearchService, make_server

    def post(addr, payload):
        conn = http.client.HTTPConnection(*addr, timeout=300)
        try:
            conn.request("POST", "/rerank", json.dumps(payload),
                         {"Content-Type": "application/json"})
            r = conn.getresponse()
            return r.status, json.loads(r.read().decode())
        finally:
            conn.close()

    service = SearchService(engine, index_kw={"kernel": "pallas"}, ranker=ranker)
    server = make_server(service, "127.0.0.1", 0, model_name="gpt-neo-125m")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        addr = server.server_address[:2]
        service.add_documents([corpus[i]["text"] for i in corpus], ids=list(corpus), build=True)
        service.warm_search(ks=(16,))
        qs = list(queries.values())
        service.rerank(qs[:2], k=16, first_k=16)  # warm
        lat, answers, errors = {}, {}, []

        def client(t):
            try:
                for j in range(4):
                    n = t * 4 + j
                    t0 = time.perf_counter()
                    status, body = post(addr, {"queries": [qs[n]], "k": 16, "first_k": 16})
                    lat[n] = time.perf_counter() - t0
                    assert status == 200, body
                    answers[n] = body["results"][0]
            except Exception as e:  # reported below
                errors.append(e)

        mips.launches = sa.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(t,)) for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        k5, k1 = mips.launches, sa.launches
        assert not errors, errors
        dispatches = service._r_batcher.dispatches
        worst, reordered = 0.0, 0
        for n, q in enumerate(qs):
            want = {h["id"]: h for h in service.rerank([q], k=16, first_k=16)[0]}
            got = answers[n]
            assert {h["id"] for h in got} == set(want), n
            ce = [h["ce_score"] for h in got]
            assert ce == sorted(ce, reverse=True), n
            for h in got:
                assert abs(h["score"] - want[h["id"]]["score"]) <= 1e-5, n
                worst = max(worst, abs(h["ce_score"] - want[h["id"]]["ce_score"]))
            reordered += [h["id"] for h in got] != list(want)
        ms = 1e3 * np.array([lat[n] for n in range(len(qs))])
        p50, p99 = float(np.median(ms)), float(np.percentile(ms, 99))
        qps = len(qs) / wall
        log(f"ce serve: {len(corpus)} documents; {len(qs)} POST /rerank (first_k 16) from 8 "
            f"threads: p50 {p50:.2f} ms, p99 {p99:.2f} ms, {qps:.2f} queries/s "
            f"({16 * qps:.1f} pairs/s), {dispatches} rerank dispatches in all; K5 launches "
            f"{k5}, K1 launches {k1}; answers hold the direct rerank's candidates, max "
            f"|ce_score diff| {worst:.3e} (tolerance {CE_SERVE_TOL}), {reordered} of "
            f"{len(qs)} orders differ")
        assert worst <= CE_SERVE_TOL and k5 > 0 and k1 > 0
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=10)
    return {"p50_ms": p50, "p99_ms": p99, "qps": qps, "max_ce_diff": worst}


def phase_ce_cli(corpus, card):
    """`cli.bm25_retriever` then `cli.sgptce --randominit --prompt G` (full-width
    GPT-Neo-125M, bf16) on a synthetic BEIR folder: the BEIR-like mix's first
    500 documents, 20 queries of 12 words drawn from documents, qrels to
    those documents. The result json holds bm25_ndcg and ce_ndcg."""
    import os
    import tempfile

    from sgpt_tpu_torch.cli import bm25_retriever, sgptce

    ids = list(corpus)[:500]
    rng = np.random.default_rng(SEED + 9)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "synth")
        os.makedirs(os.path.join(data, "qrels"))
        with open(os.path.join(data, "corpus.jsonl"), "w") as f:
            for i in ids:
                f.write(json.dumps({"_id": i, **corpus[i]}) + "\n")
        with open(os.path.join(data, "queries.jsonl"), "w") as f, \
                open(os.path.join(data, "qrels", "test.tsv"), "w") as g:
            g.write("query-id\tcorpus-id\tscore\n")
            for n in range(20):
                d = ids[n * 25]
                words = corpus[d]["text"].split()
                f.write(json.dumps({"_id": f"q{n}", "text": " ".join(
                    rng.choice(words, 12, replace=False))}) + "\n")
                g.write(f"q{n}\t{d}\t1\n")
        first, out = os.path.join(tmp, "bm25.json"), os.path.join(tmp, "ce.json")
        t0 = time.perf_counter()
        bm25 = bm25_retriever.main(bm25_retriever.parse_args([
            "--dataset", "synth", "--datadir", tmp, "--topk", "100", "--output", first]))
        sgptce.main(sgptce.parse_args([
            "--dataset", "synth", "--datadir", tmp, "--bm25results", first, "--randominit",
            "--prompt", "G", "--device", "cuda", "--output", out, "--scores-out", ""]))
        wall = time.perf_counter() - t0
        with open(out) as f:
            result = json.load(f)
    ndcg = result["ce_ndcg"]["NDCG@10"]
    assert result["prompt"] == "G" and result["bm25_ndcg"]["NDCG@10"] == bm25["NDCG@10"]
    assert all(0.0 <= v <= 1.0 for key in ("bm25_ndcg", "ce_ndcg") for v in result[key].values())
    log(f"ce cli: bm25_retriever then sgptce --prompt G on 500 docs, 20 queries (2,000 pairs) "
        f"in {wall:.2f} s: BM25 nDCG@10 {bm25['NDCG@10']:.5f}, CE nDCG@10 {ndcg:.5f} "
        f"(random weights) ({card})")
    return {"bm25_ndcg10": bm25["NDCG@10"], "ce_ndcg10": ndcg, "wall_s": wall}


def phase_beir(rng, card, extra=(), model="EleutherAI/gpt-neo-125M", n_docs=2000,
               n_queries=100):
    """The port's BEIR CLI end to end on a synthetic BEIR folder: 2,000
    documents, 100 queries copied from documents, qrels to those documents;
    full-width GPT-Neo-125M, random weights, SPECB, max_seq_len 300; `extra`
    flags (phase int8: --quantize int8); another `model` name and a smaller
    folder (phase encoders: bert-base-uncased)."""
    import os
    import tempfile

    from sgpt_tpu_torch.cli import beir_retriever

    corpus = synthetic_corpus(rng, n_docs)
    ids = list(corpus)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "synth")
        os.makedirs(os.path.join(data, "qrels"))
        with open(os.path.join(data, "corpus.jsonl"), "w") as f:
            for i in ids:
                f.write(json.dumps({"_id": i, **corpus[i]}) + "\n")
        with open(os.path.join(data, "queries.jsonl"), "w") as f, \
                open(os.path.join(data, "qrels", "test.tsv"), "w") as g:
            g.write("query-id\tcorpus-id\tscore\n")
            for n in range(n_queries):
                d = ids[n * (n_docs // n_queries)]
                f.write(json.dumps({"_id": f"q{n}", "text": corpus[d]["text"]}) + "\n")
                g.write(f"q{n}\t{d}\t1\n")
        t0 = time.perf_counter()
        os.chdir(tmp)
        try:
            ndcg = beir_retriever.main(beir_retriever.parse_args([
                "--modelname", model, "--dataset", "synth", "--datapath",
                tmp, "--randominit", "--specb", "--maxseqlen", "300", "--device", "cuda",
                "--batchsize", "64", *extra]))
            wall = time.perf_counter() - t0
            with open(f"results_{model.replace('/', '_')}_weightedmean_synth.json") as f:
                results = json.load(f)
            assert os.path.exists("beir_embeddings_ndcgs.json")
        finally:
            os.chdir(cwd)
    assert len(results) == n_queries and all(0 < len(r) <= 1000 for r in results.values())
    assert all(np.isfinite(v) for r in results.values() for v in r.values())
    assert 0.0 <= ndcg["NDCG@10"] <= 1.0
    log(f"beir {model}{' ' + ' '.join(extra) if extra else ''}: {n_docs} docs, {n_queries} "
        f"queries in {wall:.2f} s; nDCG@10 {ndcg['NDCG@10']:.5f} (random weights) ({card})")
    return ndcg["NDCG@10"]


FBWD_CASES = [  # name, B, T, H, Dh, block_kv, scale, window, alibi, a fully padded row
    ("main-global", 8, 2048, 12, 64, 256, 1.0, 0, False, False),
    ("main-local256", 8, 2048, 12, 64, 256, 1.0, 256, False, False),
    ("T128", 8, 128, 12, 64, 256, 1.0, 256, False, False),   # block_kv clamps to 128
    ("T256", 8, 256, 12, 64, 256, 1.0, 256, False, False),
    ("T512-bkv128", 8, 512, 12, 64, 128, 1.0, 256, False, False),
    ("T1024-global", 8, 1024, 12, 64, 256, 1.0, 0, False, False),
    ("scale", 8, 512, 12, 64, 256, 0.125, 0, False, False),
    ("alibi", 8, 1024, 12, 64, 256, 1.0, 256, True, False),
    ("Dh128-T2048", 2, 2048, 16, 128, 256, 1.0, 256, True, False),  # GPT-Neo 1.3B/2.7B heads
    ("Dh32-w64", 4, 384, 4, 32, 128, 0.25, 64, False, False),
    # GPT-J-6B's head size (`flash_bwd_dq_wide`, `flash_bwd_dkv_wide`) and
    # BLOOM-1b7's own slopes at the key index
    ("gptj-global", 4, 2048, 16, 256, 256, 1 / 16, 0, False, False),
    ("gptj-w256", 4, 2048, 16, 256, 256, 1 / 16, 256, False, True),
    ("gptj-T128", 4, 128, 16, 256, 128, 1 / 16, 0, False, True),
    ("gptj-T512-bkv128", 4, 512, 16, 256, 128, 1 / 16, 256, False, False),
    ("gptj-T1024-scale1", 4, 1024, 16, 256, 256, 1.0, 0, False, True),
    ("bloom1b7-T2048", 2, 2048, 16, 128, 256, 128 ** -0.5, 0, "bloom", True),
]

FBWD_TIMED = [  # cell, B, T, H, Dh, scale, window, alibi
    (0, 8, 2048, 12, 64, 1.0, 0, False),
    (256, 8, 2048, 12, 64, 1.0, 256, False),
    ("gptj", 4, 2048, 16, 256, 1 / 16, 0, False),  # the families' long-context training cells
    ("bloom1b7", 4, 2048, 16, 128, 128 ** -0.5, 0, "bloom"),
]


def phase_fbwd(torch, fa, rng):
    """K4a/K4b against `flash_attention_bwd_reference` from K3's residuals
    (out, lse), on the decoder's (B, T, H·Dh) projection views with a random
    output gradient (std 1) in the same layout; each case has a short row
    that a window leaves fully masked, some a fully padded batch row
    (`FBWD_CASES`: GPT-Neo's head sizes, GPT-J's 256 and BLOOM-1b7's own
    slopes). `hold_grads`: fp32 |Δ| ≤ 1e-5·max|ref| + 1e-5·|ref| (summation
    order only; BLOOM's slopes held to fp64 where it misses), bf16 scaled to
    each gradient and checked on a planted fault at GPT-J's shape. Fully
    masked rows' dq is 0 on both sides. Then the fp32 times (`FBWD_TIMED`:
    GPT-Neo's main shape global and window 256, the families' long-context
    cells): each kernel, the plain version (dq, dk and dv together), the
    library's SDPA backward of the same attention, and each kernel's bound
    from this run's pairs and bytes."""
    main_err, worst, readings = {"dq": 0.0, "dkv": 0.0}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        for name, B, T, H, Dh, block_kv, scale, window, alibi, dead in FBWD_CASES:
            (q, k, v, km, slopes), _ = case_inputs(torch, rng, B, T, H, Dh, dtype, alibi,
                                                   dead=dead)
            if alibi is True:
                slopes = slopes * 0.03  # BLOOM-sized slopes
            qh, kh, vh = (heads(t, H) for t in (q, k, v))
            g = heads(card_normal(torch, rng, (B, T, H * Dh), 1.0, dtype), H)
            kw = dict(scale=scale, window=window, block_kv=block_kv)
            out, lse = fa.flash_attention(qh, kh, vh, km, slopes, return_residuals=True, **kw)
            got = fa.flash_attention_bwd(qh, kh, vh, km, slopes, g, out, lse, **kw)
            torch.cuda.synchronize()
            want = fa.flash_attention_bwd_reference(qh, kh, vh, km, slopes, g, out, lse, **kw)
            dead_rows = lse == fa.NEG_INF
            errs, gate, reading = hold_grads(torch, f"fbwd {name}", got, want, dtype, fp64=(
                (lambda: k4_fp64(torch, (qh, kh, vh, g, out, km, slopes, lse,
                                         (g * out).sum(-1)), window, scale))
                if alibi == "bloom" and dtype == torch.float32 else None))
            assert all(t.stride() == qh.stride() for t in got), name
            assert (got[0][dead_rows] == 0).all() and (want[0][dead_rows] == 0).all(), name
            log(f"fbwd   {name:18s} {dt:8s} B={B} T={T} H={H} Dh={Dh} "
                f"block_kv={min(block_kv, T)} scale={scale:.4g} window={window}"
                f"{' alibi (BLOOM)' if alibi == 'bloom' else ''}: max_abs_err dq {errs[0]:.3e} "
                f"dk {errs[1]:.3e} dv {errs[2]:.3e} (held by {gate}), fully masked rows "
                f"{int(dead_rows.sum())}")
            worst[f"{name}_{dt}"] = max(errs)
            if reading:
                readings[name] = reading
            if name.startswith("main") and dtype == torch.float32:
                main_err["dq"] = max(main_err["dq"], errs[0])
                main_err["dkv"] = max(main_err["dkv"], errs[1], errs[2])
            if name == "gptj-global" and dtype == torch.bfloat16:
                faulty = got[1].clone()
                k0 = 2 * T // 3 // 64 * 64
                faulty[:, :, k0:k0 + 64] = 0  # one 64-key block of K4b's walk
                readings["planted fault"] = planted_fault(torch, f"fbwd {name}", faulty, want[1])
            del q, k, v, qh, kh, vh, g, out, lse, got, want
    log(f"fbwd   bf16 gate readings, largest over the cases: excess/RMS "
        f"{max(r[0] for k, r in readings.items() if k != 'planted fault'):.3e}, |Δ|/|ref| "
        f"{max(r[1] for k, r in readings.items() if k != 'planted fault'):.3e} (allowances "
        f"{GRAD_RMS_ATOL}, {GRAD_NORM_RTOL})")

    times = {}
    for cell, B, T, H, Dh, scale, window, alibi in FBWD_TIMED:
        (q, k, v, km, sl), _ = case_inputs(torch, rng, B, T, H, Dh, torch.float32, alibi)
        qh, kh, vh = (heads(t, H) for t in (q, k, v))
        g = heads(card_normal(torch, rng, (B, T, H * Dh), 1.0), H)
        kw = dict(scale=scale, window=window, block_kv=256)
        out, lse = fa.flash_attention(qh, kh, vh, km, sl, return_residuals=True, **kw)
        args = fa._bwd_args(qh, kh, vh, km, sl, g, out, lse, scale, window, 128, 256)

        def dq():
            fa._launch_dq(args)

        def dkv():  # reads the D that dq() wrote
            fa._launch_dkv(args)

        def plain():
            return fa.flash_attention_bwd_reference(qh, kh, vh, km, sl, g, out, lse, **kw)

        qs, ks, vs = (t.detach().contiguous().requires_grad_() for t in (qh, kh, vh))
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=library_mask(torch, km, window, sl), scale=scale)
        gs = g.contiguous()

        def library():  # the library's backward of the same attention: dq, dk and dv
            return torch.autograd.grad(lib_out, (qs, ks, vs), gs, retain_graph=True)

        p1 = cuda_ms(torch, plain, iters=3, warmup=1)
        a1, b1, a2, b2 = (cuda_ms(torch, f, iters=10, warmup=1) for f in (dq, dkv, dq, dkv))
        p2 = cuda_ms(torch, plain, iters=3, warmup=1)
        lib = cuda_ms(torch, library, iters=5, warmup=1)
        pairs = attention_pairs(torch, km, window)
        size = 4 * q.numel()  # bytes of one (B, T, H·Dh) fp32 tensor
        rows = 4 * B * H * T  # bytes of one (B, H, T) fp32 row vector
        # K4a reads q, k, v, g, out, lse and the mask, writes dq and D: 6·Dh a
        # pair; K4b reads q, k, v, g, lse, D and the mask, writes dk and dv:
        # 8·Dh a pair. Both in 3xTF32 (the CUDA cores' bound beside it)
        nbytes = 6 * size + 2 * rows + km.numel() * 4
        t = {"dq": (a1 + a2) / 2, "dkv": (b1 + b2) / 2, "plain": (p1 + p2) / 2, "library": lib,
             "pairs": pairs}
        for part, per_pair in (("dq", 6), ("dkv", 8)):
            t[f"bound_{part}"] = bound(nbytes, 3 * per_pair * Dh * H * pairs, "tf32")
            t[f"bound_{part}_cuda_cores"] = bound(nbytes, per_pair * Dh * H * pairs, "fp32")
        times[cell] = t
        log(f"time K4a/K4b {'' if isinstance(cell, int) else cell + ' '}B={B} T={T} H={H} "
            f"Dh={Dh} fp32 window={window}{' alibi (BLOOM)' if alibi == 'bloom' else ''}: K4a "
            f"{t['dq']:.4f} ms (3xTF32 bound {t['bound_dq'][0]:.4f} ms, {t['bound_dq'][1]}; "
            f"CUDA cores {t['bound_dq_cuda_cores'][0]:.4f}), K4b {t['dkv']:.4f} ms (3xTF32 "
            f"bound {t['bound_dkv'][0]:.4f} ms, {t['bound_dkv'][1]}; CUDA cores "
            f"{t['bound_dkv_cuda_cores'][0]:.4f}), together {t['dq'] + t['dkv']:.4f} ms; plain "
            f"(dq, dk, dv) {t['plain']:.4f} ms, library (SDPA backward"
            f"{', fp32 additive mask' if sl is not None else ', boolean mask'}) {lib:.4f} ms; "
            f"{pairs} pairs a head; {6 * Dh * H * pairs / (t['dq'] / 1e3) / 1e12:.1f} and "
            f"{8 * Dh * H * pairs / (t['dkv'] / 1e3) / 1e12:.1f} TFLOP/s (runs: K4a {a1:.4f} "
            f"{a2:.4f}, K4b {b1:.4f} {b2:.4f}, plain {p1:.4f} {p2:.4f})")
        del q, k, v, km, sl, qh, kh, vh, g, out, lse, args, qs, ks, vs, lib_out, gs
        torch.cuda.empty_cache()
    return main_err, worst, readings, times


def long_triplets(rng, n: int) -> list:
    """(query, positive, hard negative) with queries of 3-11 words and
    documents of 300-3,000 words: past ~2,046 words a document truncates at
    2,048 SPECB tokens."""
    words = ["".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"), rng.integers(2, 9)))
             for _ in range(20000)]

    def text(lo, hi):
        return " ".join(rng.choice(words, int(rng.integers(lo, hi))))

    return [(text(3, 12), text(300, 3001), text(300, 3001)) for _ in range(n)]


def phase_ltrain(torch, fa, sa, tok, card):
    """The long-context training slice: full-width GPT-Neo-125M with
    use_flash in fp32, TrainConfig(max_seq_len=2048, specb, freeze_nonbias,
    weightedmean, lr 2e-4, GradCache with chunks of 8), MNRL at scale 20,
    batches of 16 triplets, 4 steps on one batch at constant lr through
    `ContrastiveTrainer.fit`. Every tower pads to 2048, so every layer runs
    K3 in both GradCache passes and K4a/K4b in pass 2. The steps run at the
    CLI's matmul_precision "default" (TF32 products), one more profiled;
    then 3 steps at "highest" (strict fp32) for the rate, one more
    profiled, and GradCache against a direct step at "highest"."""
    import dataclasses

    from sgpt_tpu_torch.models import Decoder, gpt_neo
    from sgpt_tpu_torch.training import BIAS_NAMES, ContrastiveTrainer, TrainConfig

    rng = np.random.default_rng(SEED + 4)
    steps, B = 4, 16
    cfg = gpt_neo("125m", use_flash=True, matmul_precision="default")  # as build_model
    model = Decoder(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
    tc = TrainConfig(lr=2e-4, batch_size=B, max_seq_len=2048, specb=True, freeze_nonbias=True,
                     pooling="weightedmean", scheduler="constantlr", use_gradcache=True,
                     chunk_size=8)
    batch = long_triplets(rng, B)
    trainer = ContrastiveTrainer(model, cfg, tok, tc)
    _, n_trunc, _ = trainer.codec.encode_rows([d for t in batch for d in t[1:]])
    assert n_trunc > 0, "no document reached truncation"
    towers = trainer._prep_batch(batch)[0]   # dp row 0's towers: no mesh, the only row
    valid = int(sum(t["mask"].sum().item() for t in towers))
    padded = 3 * B * tc.max_seq_len
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    stamps = []
    tc.log_fn = lambda rec: stamps.append(time.perf_counter())  # float(loss) synchronises
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
    sa.launches = sa.bwd_launches = 0
    t0 = time.perf_counter()
    out = trainer.fit(lambda: iter([batch] * steps), steps_per_epoch=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"k3": fa.launches, "k4a": fa.bwd_dq_launches, "k4b": fa.bwd_dkv_launches,
              "k1": sa.launches, "k2": sa.bwd_launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [h["loss"] for h in out["history"]]
    chunks = B // tc.chunk_size
    log(f"ltrain: {steps} steps of {B} triplets at T=2048 in {wall:.2f} s, losses "
        f"{[round(x, 5) for x in losses]}; {n_trunc} of {2 * B} documents truncated, {valid} "
        f"valid of {padded} padded tokens a step; launches {counts}")
    assert counts["k3"] == cfg.num_layers * 3 * 2 * chunks * steps, counts
    assert counts["k4a"] == counts["k4b"] == cfg.num_layers * 3 * chunks * steps, counts
    assert counts["k1"] == counts["k2"] == 0, counts
    assert len(losses) == steps and all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    for name, p in model.named_parameters():
        moved = not torch.equal(p.detach(), before[name])
        assert moved == (name.rsplit(".", 1)[-1] in BIAS_NAMES), \
            f"{name}: {'moved' if moved else 'did not move'} under BitFit"
    ms_per_step = 1e3 * float(np.median(np.diff(stamps)))  # step 1 left out
    rates = {"ms_per_step": ms_per_step, "seq_per_s": 3 * B / (ms_per_step / 1e3),
             "tokens_per_s": valid / (ms_per_step / 1e3),
             "padded_tokens_per_s": padded / (ms_per_step / 1e3), "peak_gib": peak_gib}
    log(f"ltrain: {ms_per_step:.1f} ms/step, {rates['seq_per_s']:.2f} sequences/s, "
        f"{rates['tokens_per_s']:.0f} tokens/s ({rates['padded_tokens_per_s']:.0f} padded), "
        f"peak {peak_gib:.2f} GiB, fp32 at TF32 products, batch 16, max_seq_len 2048, GradCache chunk 8 "
        f"({card})")

    families = {"K3": ("flash_fwd_tf32",), "K3other": ("flash_fwd",),
                "K4a": ("flash_bwd_dq_tf32",), "K4aother": ("flash_bwd_dq",),
                "K4b": ("flash_bwd_dkv_tf32",), "K4bother": ("flash_bwd_dkv",),
                "GEMM": GEMM_KEYS}
    profile_out = profile_step(torch, trainer, batch, "ltrain profile, one step (TF32)", families)

    # 3 steps in strict fp32 ("highest") on the same model: 2 timed intervals
    strict = cfg.replace(matmul_precision="highest")
    model.cfg = strict
    stamps_strict = []
    ContrastiveTrainer(model, strict, tok, dataclasses.replace(
        tc, log_fn=lambda rec: stamps_strict.append(time.perf_counter()))).fit(
        lambda: iter([batch] * 3), steps_per_epoch=3)
    ms_highest = 1e3 * float(np.median(np.diff(stamps_strict)))
    rates.update({"ms_per_step_highest": ms_highest,
                  "seq_per_s_highest": 3 * B / (ms_highest / 1e3),
                  "tokens_per_s_highest": valid / (ms_highest / 1e3)})
    log(f"ltrain: {ms_highest:.1f} ms/step, {rates['seq_per_s_highest']:.2f} sequences/s, "
        f"{rates['tokens_per_s_highest']:.0f} tokens/s at matmul_precision \"highest\" (strict "
        f"fp32); TF32 takes {ms_per_step / ms_highest:.3f} of it")
    strict_trainer = ContrastiveTrainer(model, strict, tok, tc)
    strict_trainer._opt, strict_trainer._sched = strict_trainer._build_optimizer(1)
    prof_highest = profile_step(torch, strict_trainer, batch,
                                "ltrain profile, one step (strict fp32)", families)
    for pr in (profile_out, prof_highest):
        if pr["profile_kernel_ms"] is not None:  # fp32 K3, K4a and K4b: the tf32 kernels alone
            assert pr["profile_k3_ms"] > 0 == pr["profile_k3other_ms"], pr
            assert pr["profile_k4a_ms"] > 0 == pr["profile_k4aother_ms"], pr
            assert pr["profile_k4b_ms"] > 0 == pr["profile_k4bother_ms"], pr
    profile_out.update({k.replace("profile", "profile_highest", 1): v
                        for k, v in prof_highest.items()})

    # GradCache (chunks of 2) against one direct step on 4 triplets, same weights
    snap = {n: p.detach().clone() for n, p in model.state_dict().items()}
    four = dataclasses.replace(tc, batch_size=4, use_gradcache=False)
    direct = ContrastiveTrainer(model, strict, tok, four).fit(
        lambda: iter([batch[:4]]), steps_per_epoch=1)["history"][0]["loss"]
    model.load_state_dict(snap)
    gc = ContrastiveTrainer(model, strict, tok, dataclasses.replace(
        four, use_gradcache=True, chunk_size=2)).fit(
        lambda: iter([batch[:4]]), steps_per_epoch=1)["history"][0]["loss"]
    log(f"ltrain: GradCache (chunk 2) loss {gc:.7f}, direct {direct:.7f}, |diff| "
        f"{abs(gc - direct):.3e} (tolerance 1e-5 relative), 4 triplets at T=2048")
    assert abs(gc - direct) <= 1e-5 * abs(direct)
    del trainer, strict_trainer, model, towers
    torch.cuda.empty_cache()
    return {**counts, **rates, **profile_out, "losses": losses, "gc_vs_direct": abs(gc - direct)}


# ---------------------------------------------------------------------------
# GPT-J's and BLOOM's attention shapes (phases kernel, flash and ab) and the
# families slice (phase families)
# ---------------------------------------------------------------------------

FAMILY_K1_CASES = [  # name, B, T, H, Dh, window, alibi, rows: GPT-J (Dh 256) and BLOOM
    # rows: "pad" right-padded as the encode pads, "packed" CE segments, "ce"
    # the CE's unpacked dispatches (the ranker's full-ones key mask): the
    # length ladder's shapes, and the (rows, T) of three of the dispatches
    # `crossencoder.plan_dispatches` makes of the rerank benchmark's rows
    ("gptj-encode", 64, 300, 16, 256, 0, False, "pad"),
    ("gptj-ce-packed", 32, 256, 16, 256, 0, False, "packed"),
    ("gptj-w256", 4, 700, 16, 256, 256, False, "pad"),  # fully masked padded rows
    ("gptj-ce-t2048", 16, 2048, 16, 256, 0, False, "ce"),
    ("gptj-ce-t1024", 32, 1024, 16, 256, 0, False, "ce"),
    ("gptj-ce-t512", 64, 512, 16, 256, 0, False, "ce"),
    ("gptj-ce-t128", 256, 128, 16, 256, 0, False, "ce"),
    ("gptj-ce-t1440", 10, 1440, 16, 256, 0, False, "ce"),
    ("gptj-ce-t464", 21, 464, 16, 256, 0, False, "ce"),
    ("gptj-ce-t80", 57, 80, 16, 256, 0, False, "ce"),
    ("gptj-packed-t2048-alibi", 4, 2048, 16, 256, 0, True, "packed"),  # every K1 option at 256
    ("bloom1b7-encode", 64, 300, 16, 128, 0, True, "pad"),
    ("bloom1b7-ce-packed", 32, 256, 16, 128, 0, True, "packed"),
    ("bloom1b7-ce-t2048", 16, 2048, 16, 128, 0, True, "ce"),
    ("bloom1b7-ce-t1024", 32, 1024, 16, 128, 0, True, "ce"),
    ("bloom1b7-ce-t512", 64, 512, 16, 128, 0, True, "ce"),
    ("bloom1b7-ce-t128", 256, 128, 16, 128, 0, True, "ce"),
    ("bloom1b7-ce-t1440", 10, 1440, 16, 128, 0, True, "ce"),
    ("bloom7b1-encode", 16, 300, 32, 128, 0, True, "pad"),
    ("bloom7b1-w256", 4, 700, 32, 128, 256, True, "packed"),
]

FAMILY_FLASH_CASES = [  # name, B, T, H, Dh, block_kv, window, alibi
    ("gptj-long", 16, 2048, 16, 256, 256, 0, False),
    ("gptj-w256", 4, 1024, 16, 256, 128, 256, False),  # fully masked padded rows
    ("bloom1b7-long", 8, 2048, 16, 128, 256, 0, True),
    ("bloom7b1-w256", 4, 1024, 32, 128, 256, 256, True),
]


def family_inputs(torch, rng, B, T, H, Dh, dtype, rows: str):
    """K1's inputs at GPT-J's or BLOOM's heads: "packed" and "ce" rows as
    the CE builds them, packed or not (`ce_attention_inputs`), "pad" rows
    right-padded as `attention_inputs` pads them (one row short enough that
    a window leaves its tail fully masked). Returns (q, k, v, key_mask,
    segments or None, positions or None)."""
    if rows != "pad":
        return ce_attention_inputs(torch, rng, B, T, rows == "packed", H, Dh, dtype)
    (q, k, v, km, _), _ = attention_inputs(torch, rng, B, T, H, Dh, dtype)
    return q, k, v, km, None, None


def family_mask(torch, km, window, seg):
    """The (B, 1, T, T) boolean mask of causal ∧ [window] ∧ key valid ∧ [same segment]."""
    mask = sdpa_mask(torch, km, window)
    if seg is not None:
        mask = mask & (seg[:, :, None] == seg[:, None, :])[:, None]
    return mask


def hold(torch, name, got, want, dtype, fp64=None):
    """The kernel's output against its plain version's: bf16 within 2e-2 +
    1e-2·|ref|, fp32 within 1e-5 + 1e-5·|ref|; an fp32 case with BLOOM's
    slopes that misses the fp32 gate passes only if the kernel lies no
    further from an fp64 evaluation (`fp64()`) than twice the plain
    version does. Returns the max abs error and which gate held it."""
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all(), f"{name}: non-finite kernel output"
    err = (g - w).abs()
    atol, rtol = (BF16_ATOL, BF16_RTOL) if dtype == torch.bfloat16 else (FP32_ATOL, FP32_RTOL)
    if (err - rtol * w.abs()).max().item() <= atol:
        return err.max().item(), "gate"
    assert fp64 is not None, f"{name} {dtype}: exceeds tolerance ({err.max().item():.3e})"
    ref = fp64()
    k64 = (got.double() - ref).abs().max().item()
    p64 = (want.double() - ref).abs().max().item()
    assert k64 <= 2 * p64, f"{name}: |kernel - fp64| {k64:.3e} > 2 x |plain - fp64| {p64:.3e}"
    return err.max().item(), f"fp64 (kernel {k64:.3e}, plain {p64:.3e})"


def phase_kernel_families(torch, sa, rng):
    """K1 at GPT-J's and BLOOM's shapes against its plain version, bf16 and
    fp32: Dh 256 (bf16: `mma_kernel<256, …>`; fp32: `tf32_kernel_wide`) and
    BLOOM's real slopes (`alibi_slopes`, H = 16 and 32, Dh 128) with key
    padding, fully masked rows (window 256) and packed rows (ALiBi key
    positions restarting per segment, at Dh 256 up to T=2,048); then kernel,
    plain, library and bound times of the bf16 cells on the families' main
    paths and of fp32 at their training launches. Returns the largest bf16
    error and the times by cell."""
    from sgpt_tpu_torch.models.decoder import alibi_slopes

    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for name, B, T, H, Dh, window, alibi, rows in FAMILY_K1_CASES:
            q, k, v, km, seg, pos = family_inputs(torch, rng, B, T, H, Dh, dtype, rows)
            sl = alibi_slopes(H, "cuda") if alibi else None
            kpos = pos if alibi else None
            scale = Dh ** -0.5
            args = (q, k, v, km, sl)
            got = sa.short_attention(*args, scale, window, H, alibi, segments=seg,
                                     positions=kpos)
            want = sa.short_attention_reference(*args, scale=scale, window=window, H=H,
                                                use_alibi=alibi, segments=seg, positions=kpos)
            torch.cuda.synchronize()
            err, gate = hold(torch, f"kernel {name}", got, want, dtype, fp64=(
                (lambda: k1_fp64(torch, args, window, scale, H, seg, kpos))
                if alibi and dtype == torch.float32 else None))
            dead = int((~family_mask(torch, km, window, seg).any(-1)).sum().item()) * H
            log(f"kernel {name:18s} {str(dtype)[6:]:8s} B={B} T={T} H={H} Dh={Dh} "
                f"window={window}{' alibi' if alibi else ''} rows {rows}: "
                f"max_abs_err={err:.3e} (held by {gate}), fully masked rows {dead}")
            if dtype == torch.bfloat16:
                worst = max(worst, err)
            del q, k, v, km, seg, pos, got, want
    times = {}
    for name, B, T, H, Dh, alibi, packed, dt in (
            ("gptj", 64, 300, 16, 256, False, False, "bf16"),
            ("gptj_ce_packed", 128, 256, 16, 256, False, True, "bf16"),
            ("bloom1b7", 64, 300, 16, 128, True, False, "bf16"),
            ("bloom1b7_ce_packed", 128, 256, 16, 128, True, True, "bf16"),
            # fp32: GPT-J at the MS MARCO step's launch (B=4) and at phase ab's
            # B=16; BLOOM-1b7 at phase ab's B=32
            ("gptj_fp32_b4", 4, 300, 16, 256, False, False, "fp32"),
            ("gptj_fp32_b16", 16, 300, 16, 256, False, False, "fp32"),
            ("bloom1b7_fp32", 32, 300, 16, 128, True, False, "fp32")):
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        q, k, v, km, seg, pos = family_inputs(torch, rng, B, T, H, Dh, dtype,
                                              "packed" if packed else "pad")
        sl = alibi_slopes(H, "cuda") if alibi else None
        kpos = pos if alibi else None
        scale = Dh ** -0.5
        mask = family_mask(torch, km, 0, seg)
        qh, kh, vh = (heads(t, H) for t in (q, k, v))
        attn_mask = mask
        if alibi:  # the library's additive form of the same scores: slope·kpos, -inf masked
            kp = (kpos if kpos is not None else torch.arange(T, device="cuda").expand(B, T))
            attn_mask = torch.where(mask, sl[None, :, None, None] * kp[:, None, None, :].float(),
                                    float("-inf")).to(dtype)

        def kernel():
            return sa.short_attention(q, k, v, km, sl, scale, 0, H, alibi, segments=seg,
                                      positions=kpos)

        def plain():
            return sa.short_attention_reference(q, k, v, km, sl, scale=scale, window=0, H=H,
                                                use_alibi=alibi, segments=seg, positions=kpos)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(qh, kh, vh,
                                                                    attn_mask=attn_mask,
                                                                    scale=scale)

        p1, k1, k2, p2 = (cuda_ms(torch, f, iters=10) for f in (plain, kernel, kernel, plain))
        lib = cuda_ms(torch, library, iters=10)
        pairs = int(mask.sum().item())
        nbytes = (4 * q.numel() * q.element_size() + km.numel() * 4
                  + sum(t.numel() * 4 for t in (seg, kpos) if t is not None))
        ops = 4 * Dh * H * pairs
        # fp32: 3xTF32, three TF32 products for each fp32 one
        b_ms, b_by = bound(nbytes, 3 * ops, "tf32") if dt == "fp32" else bound(nbytes, ops, dt)
        times[name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": lib,
                       "bound_ms": b_ms, "bound_by": b_by}
        log(f"time K1 {name} B={B} T={T} H={H} Dh={Dh} {dt} window=0"
            f"{' alibi' if alibi else ''}{' packed' if packed else ''}: kernel "
            f"{times[name]['ms']:.4f} ms, plain {times[name]['plain_ms']:.4f} ms, library "
            f"(SDPA {dt}, {dt + ' additive' if alibi else 'boolean'} mask) {lib:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}: {nbytes} bytes, {'3 x ' if dt == 'fp32' else ''}{ops} "
            f"operations over {pairs} pairs) (runs: kernel {k1:.4f} {k2:.4f}, plain {p1:.4f} "
            f"{p2:.4f})")
        del q, k, v, qh, kh, vh, km, seg, pos, mask, attn_mask
        torch.cuda.empty_cache()
    return worst, times


def phase_flash_families(torch, fa, rng):
    """K3 at GPT-J's and BLOOM's long-context shapes against its plain
    version, output and lse, bf16 and fp32 (fp32 at B ≤ 4): Dh 256
    (`flash_fwd_bf16<256>`, `flash_fwd_tf32<256>`) and BLOOM's real slopes
    (H = 16 and 32, Dh 128), key padding and fully masked rows (window
    256); fp32 with BLOOM's slopes held to fp64 where it misses the fp32
    gate (see `hold`). Then kernel, plain, library and bound times of
    GPT-J's and BLOOM-1b7's long encode cell (bf16, B=16, T=2048) and of
    K3 fp32 at Dh 256 (B=4). Returns the largest bf16 error and the times."""
    from sgpt_tpu_torch.models.decoder import alibi_slopes

    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for name, B, T, H, Dh, block_kv, window, alibi in FAMILY_FLASH_CASES:
            if dtype == torch.float32:
                B = min(B, 4)
            (q, k, v, km, _), _ = attention_inputs(torch, rng, B, T, H, Dh, dtype)
            sl = alibi_slopes(H, "cuda") if alibi else None
            qh, kh, vh = (heads(t, H) for t in (q, k, v))
            kw = dict(scale=Dh ** -0.5, window=window, block_kv=block_kv)
            got, lse = fa.flash_attention(qh, kh, vh, km, sl, return_residuals=True, **kw)
            torch.cuda.synchronize()
            want, want_lse = fa.flash_attention_reference(qh, kh, vh, km, sl, **kw)
            assert got.dtype == dtype and got.stride() == qh.stride(), name

            def fp64():  # rows with a valid key: a fully masked row is not the formula's
                ref, valid = k3_fp64(torch, (qh, kh, vh, km), window, Dh ** -0.5, sl)
                return torch.where(valid, ref, want.double())

            err, gate = hold(torch, f"flash {name}", got, want, dtype,
                             fp64=fp64 if alibi and dtype == torch.float32 else None)
            dead = want_lse == fa.NEG_INF
            assert torch.equal(lse == fa.NEG_INF, dead), f"flash {name}: masked rows differ"
            lerr = (lse - want_lse).abs()[~dead]
            assert (lerr - 1e-5 * want_lse.abs()[~dead]).max().item() <= 1e-4, f"{name} lse"
            log(f"flash  {name:14s} {str(dtype)[6:]:8s} B={B} T={T} H={H} Dh={Dh} "
                f"block_kv={block_kv} window={window}{' alibi' if alibi else ''}: max_abs_err "
                f"{err:.3e} (held by {gate}), lse {lerr.max().item():.3e}, fully masked rows "
                f"{int(dead.sum())}")
            if dtype == torch.bfloat16:
                worst = max(worst, err)
            del q, k, v, qh, kh, vh, got, want, lse, want_lse
    times = {}
    for name, B, H, Dh, alibi, dt in (("gptj", 16, 16, 256, False, "bf16"),
                                      ("bloom1b7", 16, 16, 128, True, "bf16"),
                                      ("gptj_fp32", 4, 16, 256, False, "fp32"),
                                      ("bloom1b7_fp32", 4, 16, 128, True, "fp32")):
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        (q, k, v, km, _), _ = attention_inputs(torch, rng, B, 2048, H, Dh, dtype)
        sl = alibi_slopes(H, "cuda") if alibi else None
        qh, kh, vh = (heads(t, H) for t in (q, k, v))
        mask = sdpa_mask(torch, km, 0)
        attn_mask = mask
        if alibi:
            attn_mask = torch.where(mask, sl[None, :, None, None] * torch.arange(
                2048, device="cuda", dtype=torch.float32), float("-inf")).to(dtype)
        scale = Dh ** -0.5

        def kernel():
            return fa.flash_attention(qh, kh, vh, km, sl, scale=scale, block_kv=256)

        def plain():
            return fa.flash_attention_reference(qh, kh, vh, km, sl, scale=scale, block_kv=256)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(qh, kh, vh,
                                                                    attn_mask=attn_mask,
                                                                    scale=scale)

        p1, k1, k2, p2 = (cuda_ms(torch, f, iters=n, warmup=1)
                          for f, n in ((plain, 2), (kernel, 5), (kernel, 5), (plain, 2)))
        lib = cuda_ms(torch, library, iters=3, warmup=1)
        nbytes = 4 * q.numel() * q.element_size() + B * H * 2048 * 4 + km.numel() * 4
        pairs = attention_pairs(torch, km, 0)
        ops = 4 * Dh * H * pairs
        b = bound(nbytes, 3 * ops, "tf32") if dt == "fp32" else bound(nbytes, ops, dt)
        times[name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": lib,
                       "bound_ms": b[0], "bound_by": b[1]}
        log(f"time K3 {name} B={B} T=2048 H={H} Dh={Dh} {dt} window=0"
            f"{' alibi' if alibi else ''}: kernel {times[name]['ms']:.4f} ms, plain "
            f"{times[name]['plain_ms']:.4f} ms, library (SDPA {dt}) {lib:.4f} ms, bound "
            f"{b[0]:.4f} ms ({b[1]}: {nbytes} bytes, "
            + (f"3 x {ops} TF32" if dt == "fp32" else f"{ops}") + f" operations over {pairs} "
            f"pairs; {ops / (times[name]['ms'] / 1e3) / 1e12:.1f} TFLOP/s) (runs: kernel "
            f"{k1:.4f} {k2:.4f}, plain {p1:.4f} {p2:.4f})")
        del q, k, v, qh, kh, vh, mask, attn_mask
        torch.cuda.empty_cache()
    return worst, times


@contextlib.contextmanager
def plain_attention(sa, fa):
    """The decoder's attention through the kernels' plain versions, on the
    card: the kernel path's yardstick at full depth."""
    from sgpt_tpu_torch.models import decoder as dm

    saved = dm.short_attention, dm.flash_attention

    def short(q2, k2, v2, km, sl, scale, window, H, use_alibi, segments=None, positions=None,
              causal=True):
        assert causal, "the plain versions are causal, as the kernels"
        return sa.short_attention_reference(q2, k2, v2, km, sl, scale=scale, window=window,
                                            H=H, use_alibi=use_alibi, segments=segments,
                                            positions=positions)

    def flash(q, k, v, km, sl=None, causal=True, **kw):
        assert causal, "the plain versions are causal, as the kernels"
        return fa.flash_attention_reference(q, k, v, km, sl, **kw)[0]

    dm.short_attention, dm.flash_attention = short, flash
    try:
        yield
    finally:
        dm.short_attention, dm.flash_attention = saved


def hf_checkpoint(torch, model, family: str) -> tuple:
    """The model's weights as an HF checkpoint of its family: (state dict
    in HF names, `hf_loader.hf_state_dict`; config.json dict,
    `hf_export.hf_config`)."""
    from sgpt_tpu_torch.models.hf_export import hf_config
    from sgpt_tpu_torch.models.hf_loader import hf_state_dict

    sd = model.state_dict()
    return (hf_state_dict(sd, model.cfg, family),
            hf_config(model.cfg, family, tied="lm_head.w" not in sd))


def check_loader(torch, model, family, tok, texts):
    """A checkpoint directory written from `model`'s weights on the card, as
    one safetensors file (written by hand) and as a `.bin` (`torch.save`),
    reloaded by `hf_loader.load_pretrained` into a new Decoder on the card:
    the same embeddings, bit for bit. The directory goes under the
    git-ignored build/ and is removed after each format."""
    import shutil
    from pathlib import Path

    from sgpt_tpu_torch.encoder import EmbeddingEngine
    from sgpt_tpu_torch.models import Decoder
    from sgpt_tpu_torch.models.hf_loader import load_pretrained, save_safetensors

    kw = dict(specb=True, max_seq_len=300, batch_size=8, normalize_embeddings=True)
    want = EmbeddingEngine(model, model.cfg, tok, device="cuda", **kw).encode(texts)
    sd, config = hf_checkpoint(torch, model, family)
    out = {}
    path = Path(__file__).resolve().parent / "build" / "smoke_checkpoint"
    for fmt in ("safetensors", "bin"):
        shutil.rmtree(path, ignore_errors=True)
        path.mkdir(parents=True)
        (path / "config.json").write_text(json.dumps(config))
        t0 = time.perf_counter()
        if fmt == "safetensors":
            save_safetensors(sd, str(path / "model.safetensors"))
        else:
            torch.save({k: v.cpu() for k, v in sd.items()}, path / "pytorch_model.bin")
        size = sum(f.stat().st_size for f in path.iterdir())
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        weights, cfg = load_pretrained(str(path))
        load_s = time.perf_counter() - t0
        assert cfg.replace(intermediate_size=model.cfg.intermediate_size) == model.cfg, cfg
        reloaded = Decoder(model.cfg, device="cuda", weights=weights)
        got = EmbeddingEngine(reloaded, reloaded.cfg, tok, device="cuda", **kw).encode(texts)
        assert np.array_equal(got, want), f"{family} {fmt}: reloaded embeddings differ"
        out[fmt] = {"bytes": size, "write_s": write_s, "load_s": load_s}
        log(f"families {family} loader: {fmt} checkpoint of {size} bytes written in "
            f"{write_s:.1f} s, loaded in {load_s:.1f} s: the same embeddings bit for bit "
            f"on {len(texts)} texts")
        del weights, reloaded
    shutil.rmtree(path, ignore_errors=True)
    return out


def family_slice(torch, fa, sa, mips, family: str, card: str) -> dict:
    """One family at full width, bf16, random weights drawn on the card:
    GPT-J-6B (28 layers, D 4,096, Dh 256, vocab 50,400, its separate biased
    head) or BLOOM-1b7 (24 layers, D 2,048, Dh 128, ALiBi, vocab 250,880,
    tied head). The encode slice's 1,280 texts (docs and queries, T ≤ 300,
    batch 64; K1 = L × batches; one batch of 64 at T=300 profiled); their
    index (K5 at D) in which each text finds itself first; a long-context
    encode with use_flash over 112 documents (a batch of 16 at T=2048, 32 at
    1024, 64 at 512; batch_size 16: K3 = L × flash batches); the CE (prompt G, max_length 2048,
    batch_size 16) on 4 queries × BM25 top-100 of the BEIR-like mix (K1 = L
    × dispatches), for BLOOM also a short mix packed at pack_t 256 against
    unpacked. Held: the kernel path against the plain path on the card at
    full depth (cosines of 64 texts, 8 long documents; CE ranks by
    Spearman); card fp32 against CPU fp32 at full width with the depth cut
    to 2 layers (embeddings, CE scores) and, on the card, that model's
    packed CE rows against unpacked; the loader (`check_loader`) on that
    2-layer model."""
    import copy

    from sgpt_tpu_torch.crossencoder import CrossEncoderRanker
    from sgpt_tpu_torch.encoder import EmbeddingEngine
    from sgpt_tpu_torch.evaluation import spearman
    from sgpt_tpu_torch.index import DenseIndex
    from sgpt_tpu_torch.models import Decoder, bloom, gpt_j_6b
    from sgpt_tpu_torch.retrieval_bm25 import BM25Retriever
    from sgpt_tpu_torch.tokenization import SimpleTokenizer

    rng = np.random.default_rng(SEED + 11)
    head = ("w", "b") if family == "gptj" else ()
    base = gpt_j_6b() if family == "gptj" else bloom("1b7")
    cfg = base.replace(dtype=torch.bfloat16)
    L = cfg.num_layers
    phase(f"families {family}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Decoder(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(SEED),
                    lm_head=head)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    log(f"families {family}: {n_params} parameters drawn on the card in {init_s:.2f} s "
        f"(bf16, {torch.cuda.memory_allocated() / 2**30:.2f} GiB)")
    tok = SimpleTokenizer(cfg.vocab_size)
    out = {"params": n_params, "init_s": init_s}

    # encode: docs and queries, K1 in every layer of every batch
    engine = EmbeddingEngine(model, cfg, tok, device="cuda", specb=True, max_seq_len=300,
                             batch_size=64, normalize_embeddings=True)
    texts = synthetic_texts(rng)
    engine.warmup()
    torch.cuda.synchronize()
    shapes = []
    hook = model.register_forward_pre_hook(lambda m, a: shapes.append(tuple(a[0].shape)))
    sa.launches = fa.launches = 0
    t0 = time.perf_counter()
    docs = engine.encode(texts)
    torch.cuda.synchronize()
    doc_s = time.perf_counter() - t0
    queries = engine.encode(texts, is_query=True)
    hook.remove()
    k1 = sa.launches
    assert k1 == L * len(shapes) > 0 and fa.launches == 0, (k1, len(shapes))
    for name, emb in (("docs", docs), ("queries", queries)):
        assert emb.shape == (len(texts), cfg.hidden_size) and np.isfinite(emb).all(), name
        assert np.abs(np.linalg.norm(emb, axis=1) - 1).max() < 1e-2, name
    tokens = sum(len(r) for r in engine.codec.encode_rows(texts)[0])
    out.update(encode_emb_per_s=len(texts) / doc_s, encode_tokens_per_s=tokens / doc_s,
               encode_k1=k1, encode_batches=len(shapes))
    log(f"families {family} encode: {len(texts) / doc_s:.1f} emb/s ({tokens / doc_s:.0f} "
        f"tokens/s), {len(texts)} docs in {doc_s:.3f} s; docs + queries in {len(shapes)} "
        f"batches, K1 launches {k1} = {L} x {len(shapes)}; bf16, batch_size 64, max_seq_len "
        f"300 ({card})")
    longest = np.argsort([len(t) for t in texts], kind="stable")[-64:]
    out["encode_profile"] = prof = profile_batch(
        torch, engine, [texts[i] for i in longest],
        f"families {family} encode profile, one batch of 64 at T=300",
        {"K1 mma_kernel": ("mma_kernel",),
         "fp32 or CUDA-core K1": ("::scalar_kernel", "tf32_kernel"), "GEMM": GEMM_KEYS})
    if prof["profile_kernel_ms"] is not None:  # bf16 K1 on the tensor cores, by its name
        assert prof["profile_k1_ms"] > 0 and prof["profile_fp32_ms"] == 0, prof
    out["encode_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30

    # the kernel path against the plain path, bf16, full depth
    sub = [texts[i] for i in np.argsort([len(t) for t in texts])[:: len(texts) // 64][:64]]
    got = engine.encode(sub)
    with plain_attention(sa, fa):
        want = engine.encode(sub)
    cos = cosine(got, want)
    log(f"families {family}: kernel path against plain path on the card, bf16, {L} layers, "
        f"64 texts: cosine min {cos.min():.6f} mean {cos.mean():.6f} (tolerance min 0.99)")
    assert cos.min() > 0.99
    out["kernel_vs_plain_cos_min"] = float(cos.min())

    # index the documents (K5 at D): each text finds itself first
    mips.launches = 0
    index = DenseIndex(cfg.hidden_size, kernel="pallas", device="cuda")
    index.add(docs, ids=[f"t{i}" for i in range(len(texts))])
    index.build()
    _, hits = index.search_embeddings(docs, k=10)
    unique = {t: i for i, t in enumerate(texts) if texts.count(t) == 1}
    own = np.mean([hits[i][0] == f"t{i}" for i in unique.values()])
    log(f"families {family} search: index of {len(index)} texts at D={cfg.hidden_size} "
        f"(kernel=pallas): own text first for {own:.4f} of {len(unique)} distinct texts; "
        f"K5 launches {mips.launches}")
    assert own == 1.0 and mips.launches > 0
    out.update(search_own_first=float(own), k5_launches=mips.launches)
    del engine, index

    # long-context encode with use_flash
    phase(f"families {family} long")
    fcfg = cfg.replace(use_flash=True)
    flash_model = Decoder(fcfg, device="cuda", weights=model.state_dict())
    docs_all, _ = long_texts(np.random.default_rng(SEED + 2))
    lrows_len = [len(d.split()) for d in docs_all]
    order = np.argsort(lrows_len, kind="stable")
    # whole batches of each bucket (rows a batch at batch_size 16: 16 at 2048, 32 at
    # 1024, 64 at 512): the 16 longest (truncated), 32 of 511-1022 words, 64 of 300-510
    pick = list(order[-16:]) + list(order[160:192]) + list(order[:64])
    long_docs = [docs_all[i] for i in pick]
    lengine = EmbeddingEngine(flash_model, fcfg, tok, device="cuda", specb=True,
                              max_seq_len=2048, batch_size=16, normalize_embeddings=True)
    lengine.warmup([512, 1024, 2048])
    torch.cuda.synchronize()
    shapes = []
    hook = flash_model.register_forward_pre_hook(lambda m, a: shapes.append(tuple(a[0].shape)))
    sa.launches = fa.launches = 0
    t0 = time.perf_counter()
    lemb = lengine.encode(long_docs)
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t0
    hook.remove()
    flash_batches = sum(T % 128 == 0 for _, T in shapes)
    k3, k1_long = fa.launches, sa.launches
    ltokens = sum(len(r) for r in lengine.codec.encode_rows(long_docs)[0])
    log(f"families {family} long: {len(long_docs)} docs ({ltokens} tokens) in {long_s:.3f} s "
        f"({len(long_docs) / long_s:.1f} emb/s, {ltokens / long_s:.0f} tokens/s), shapes "
        f"{shapes}; K3 launches {k3} = {L} x {flash_batches}, K1 {k1_long} ({card})")
    assert k3 == L * flash_batches > 0 and k1_long == L * (len(shapes) - flash_batches)
    assert {512, 1024, 2048} <= {T for _, T in shapes}, shapes
    assert np.isfinite(lemb).all() and lemb.shape == (len(long_docs), cfg.hidden_size)
    few = long_docs[:4] + long_docs[16:18] + long_docs[-2:]
    got = lengine.encode(few)
    with plain_attention(sa, fa):
        want = lengine.encode(few)
    lcos = cosine(got, want)
    log(f"families {family} long: kernel path against plain path, 8 docs: cosine min "
        f"{lcos.min():.6f} (tolerance min 0.99)")
    assert lcos.min() > 0.99
    out.update(long_emb_per_s=len(long_docs) / long_s, long_tokens_per_s=ltokens / long_s,
               long_k3=k3, long_k1=k1_long, long_flash_batches=flash_batches,
               long_kernel_vs_plain_cos_min=float(lcos.min()))
    del lengine, flash_model
    torch.cuda.empty_cache()

    # the CE on 4 queries x BM25 top-100 of the BEIR-like mix
    phase(f"families {family} ce")
    corpus, qs, short = ce_mix(np.random.default_rng(SEED + 8))
    qs = {q: qs[q] for q in list(qs)[:4]}
    first = BM25Retriever().search(corpus, qs, 100)
    beir = [(qs[q], corpus[d]["text"]) for q, hits_ in first.items() for d in hits_]
    kw = dict(device="cuda", batch_size=16, max_length=2048)
    ranker = CrossEncoderRanker(model, cfg, tok, **kw)
    ranker.predict(beir[:16])  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    shapes = []
    hook = model.register_forward_pre_hook(lambda m, a: shapes.append(tuple(a[0].shape)))
    sa.launches = 0
    t0 = time.perf_counter()
    scores = np.asarray(ranker.predict(beir))
    torch.cuda.synchronize()
    ce_s = time.perf_counter() - t0
    hook.remove()
    k1_ce, ce_dispatches = sa.launches, len(shapes)
    assert k1_ce == L * ce_dispatches > 0, (k1_ce, ce_dispatches)
    assert np.isfinite(scores).all() and (scores < 0).all()
    ce_peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"families {family} ce: {len(beir)} pairs in {ce_s:.3f} s, {len(beir) / ce_s:.1f} "
        f"pairs/s, {ce_dispatches} dispatches {sorted(set(shapes))}, K1 launches {k1_ce} = "
        f"{L} x {ce_dispatches}; peak {ce_peak:.2f} GiB; bf16, max_length 2048, batch_size 16 "
        f"({card})")
    with plain_attention(sa, fa):
        plain_scores = np.asarray(ranker.predict(beir))
    rho = np.array([spearman(scores[i:i + 100], plain_scores[i:i + 100])
                    for i in range(0, len(beir), 100)])
    log(f"families {family} ce: kernel path against plain path, {len(qs)} queries' top-100: "
        f"Spearman min {rho.min():.4f} (floor {FAMILY_SPEARMAN_MIN}) mean {rho.mean():.4f} "
        f"(floor {CE_SPEARMAN_FLOOR}), max |score diff| "
        f"{np.abs(scores - plain_scores).max():.4f}")
    assert rho.min() >= FAMILY_SPEARMAN_MIN and rho.mean() >= CE_SPEARMAN_FLOOR, rho
    out.update(ce_pairs_per_s=len(beir) / ce_s, ce_k1=k1_ce, ce_dispatches=ce_dispatches,
               ce_peak_gib=ce_peak, ce_kernel_vs_plain_spearman_min=float(rho.min()))
    if family == "bloom":
        pairs = short[:1024]
        res = {}
        for name, pack in (("unpacked", None), ("packed", 256)):
            r = CrossEncoderRanker(model, cfg, tok, pack_t=pack, **kw)
            r.predict(pairs[:64])
            torch.cuda.synchronize()
            sa.launches = 0
            shapes = []
            hook = model.register_forward_pre_hook(lambda m, a: shapes.append(tuple(a[0].shape)))
            t0 = time.perf_counter()
            res[name] = np.asarray(r.predict(pairs))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            hook.remove()
            assert sa.launches == L * len(shapes) > 0
            out[f"ce_short_{name}_pairs_per_s"] = len(pairs) / wall
            out["ce_short_k1"] = out.get("ce_short_k1", 0) + sa.launches
            log(f"families bloom ce short mix {name}: {len(pairs)} pairs, "
                f"{len(pairs) / wall:.1f} pairs/s, {len(shapes)} dispatches "
                f"{sorted(set(shapes))}, K1 launches {sa.launches} ({card})")
        diff = float(np.abs(res["packed"] - res["unpacked"]).max())
        log(f"families bloom ce: bf16 packed against unpacked (dispatches of other shapes, "
            f"24 layers of bf16 roundings; held in fp32 below): max |diff| {diff:.4f}")
        out["ce_bf16_packed_vs_unpacked"] = diff
    if family == "gptj":
        del ranker
        out["int8"] = family_int8(torch, model, cfg, tok, texts, docs, doc_s, beir, scores,
                                  card)
    else:
        del ranker
    del model
    torch.cuda.empty_cache()

    # fp32 at full width, depth cut to 2 layers: card against CPU, and the loader
    phase(f"families {family} fp32")
    cfg32 = base.replace(num_layers=2)
    gpu_model = Decoder(cfg32, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(SEED), lm_head=head)
    cpu_model = copy.deepcopy(gpu_model).to("cpu")
    t0 = time.perf_counter()
    few_texts = [texts[i] for i in np.argsort([len(t) for t in texts])[:: len(texts) // 8][:8]]
    ekw = dict(specb=True, max_seq_len=300, batch_size=8, normalize_embeddings=True)
    on_cpu = EmbeddingEngine(cpu_model, cfg32, tok, device="cpu", **ekw).encode(few_texts)
    pick = beir[::100][:4] + beir[50::100][:4]
    ce_cpu = np.asarray(CrossEncoderRanker(cpu_model, cfg32, tok, device="cpu", batch_size=2,
                                           max_length=2048).predict(pick))
    cpu_s = time.perf_counter() - t0
    del cpu_model
    sa.launches = 0
    on_gpu = EmbeddingEngine(gpu_model, cfg32, tok, device="cuda", **ekw).encode(few_texts)
    ce_gpu = np.asarray(CrossEncoderRanker(gpu_model, cfg32, tok, device="cuda", batch_size=2,
                                           max_length=2048).predict(pick))
    assert sa.launches > 0
    err = float(np.abs(on_gpu - on_cpu).max())
    cerr = np.abs(ce_gpu - ce_cpu)
    log(f"families {family}: fp32 card against fp32 CPU, full width, 2 layers: embeddings of "
        f"8 texts max abs diff {err:.3e} (tolerance 1e-4); CE scores of 8 pairs max |diff| "
        f"{cerr.max():.3e} (rtol {CE_RTOL}, atol {CE_ATOL}); CPU took {cpu_s:.1f} s")
    assert err < 1e-4
    np.testing.assert_allclose(ce_gpu, ce_cpu, rtol=CE_RTOL, atol=CE_ATOL)
    # packed rows (segments; for BLOOM ALiBi key positions restarting in each)
    # against unpacked, fp32 on the card
    kw = dict(device="cuda", batch_size=16, max_length=2048)
    unpacked = np.asarray(CrossEncoderRanker(gpu_model, cfg32, tok, **kw).predict(short[:64]))
    packed = np.asarray(CrossEncoderRanker(gpu_model, cfg32, tok, pack_t=256,
                                           **kw).predict(short[:64]))
    perr = float(np.abs(packed - unpacked).max())
    log(f"families {family}: fp32 CE on the card, 64 short pairs, pack_t=256 against "
        f"unpacked: max |diff| {perr:.3e} (rtol {CE_RTOL}, atol {CE_ATOL})")
    np.testing.assert_allclose(packed, unpacked, rtol=CE_RTOL, atol=CE_ATOL)
    out.update(fp32_card_vs_cpu=err, ce_fp32_card_vs_cpu=float(cerr.max()),
               ce_fp32_packed_vs_unpacked=perr)
    out["loader"] = check_loader(torch, gpu_model, family, tok, few_texts)
    del gpu_model
    torch.cuda.empty_cache()
    return out


def family_int8(torch, model, cfg, tok, texts, docs, doc_s, pairs, scores, card) -> dict:
    """GPT-J-6B in int8: the encode slice (`int8_encode`), the CE with
    quantize="int8" on the same 4 queries × BM25 top-100 (pairs/s, K1 and
    `_int_mm` launches, Spearman against bf16 for each query), then
    `quantize_decoder_params(free_source=True)` on the bf16 model itself:
    its peak stays within the float total plus one fp32 slab of the widest
    projection (D × F)."""
    from sgpt_tpu_torch.crossencoder import CrossEncoderRanker
    from sgpt_tpu_torch.evaluation import spearman
    from sgpt_tpu_torch.ops import quant
    from sgpt_tpu_torch.ops import short_attention as sa

    phase("families gptj int8")
    out = int8_encode(torch, model, cfg, tok, texts, docs, doc_s, "families gptj", card)
    torch.cuda.empty_cache()
    ranker = CrossEncoderRanker(model, cfg, tok, device="cuda", batch_size=16, max_length=2048,
                                quantize="int8")
    ranker.predict(pairs[:16])  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    quant.launches = sa.launches = 0
    t0 = time.perf_counter()
    got = np.asarray(ranker.predict(pairs))
    torch.cuda.synchronize()
    ce_s = time.perf_counter() - t0
    launches, k1 = quant.launches, sa.launches
    assert np.isfinite(got).all() and (got < 0).all()
    assert launches == 6 * k1 > 0, (launches, k1)
    rho = np.array([spearman(got[i:i + 100], scores[i:i + 100])
                    for i in range(0, len(pairs), 100)])
    out.update(ce_pairs_per_s=len(pairs) / ce_s, ce_k1_launches=k1, ce_int_mm_launches=launches,
               ce_peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               ce_spearman_vs_bf16=rho.tolist(),
               ce_max_abs_diff_vs_bf16=float(np.abs(got - scores).max()))
    log(f"families gptj int8 ce: {len(pairs)} pairs in {ce_s:.3f} s, {len(pairs) / ce_s:.1f} "
        f"pairs/s, K1 launches {k1}, _int_mm {launches}; Spearman against bf16 per query "
        f"{', '.join(f'{r:.4f}' for r in rho)}; max |score diff| "
        f"{out['ce_max_abs_diff_vs_bf16']:.4f} ({card})")
    del ranker
    torch.cuda.empty_cache()
    slab = 4 * cfg.hidden_size * cfg.mlp_size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    quant.quantize_decoder_params(model, free_source=True)
    torch.cuda.synchronize()
    q_s = time.perf_counter() - t0
    peak, after = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
    out.update(free_source_base_gib=base / 2**30, free_source_peak_gib=peak / 2**30,
               free_source_after_gib=after / 2**30, free_source_s=q_s,
               free_source_slab_gib=slab / 2**30)
    log(f"families gptj int8: quantize_decoder_params(free_source=True) in {q_s:.2f} s: "
        f"{base / 2**30:.3f} GiB before, peak {peak / 2**30:.3f} GiB (bound: before + one fp32 "
        f"slab of {slab / 2**30:.3f} GiB), {after / 2**30:.3f} GiB after ({card})")
    assert quant.is_quantized_model(model) and after < base
    assert peak <= base + slab, (peak, base, slab)
    return out


def phase_families(torch, fa, sa, mips, card) -> dict:
    """GPT-J-6B, then BLOOM-1b7 (`family_slice`), each freed before the next."""
    return {family: family_slice(torch, fa, sa, mips, family, card)
            for family in ("gptj", "bloom")}


# ---------------------------------------------------------------------------
# The families' training slice (phase families train)
# ---------------------------------------------------------------------------

FAMILY_LONG_TRAIN = {"gptj": (8, 2), "bloom": (16, 4)}  # triplets, GradCache chunk


def bits_fingerprint(torch, p) -> int:
    """A fingerprint of an fp32 tensor's bits: the int64 sum of its values'
    int32 patterns (a frozen weight keeps it; cloning 24 GB to compare is
    not affordable)."""
    return int(p.detach().view(torch.int32).sum(dtype=torch.int64).item())


def train_cell(torch, fa, sa, model, cfg, tok, tc, batch, steps: int, label: str,
               families: dict, name_keys: tuple) -> dict:
    """`steps` steps of `ContrastiveTrainer.fit` on one repeated batch at
    constant lr (1 warm-up step, the rest timed); launch counts, losses, peak
    memory, ms/step and sequences/s; then one step under torch.profiler
    (`profile_step`)."""
    from sgpt_tpu_torch.training import ContrastiveTrainer

    trainer = ContrastiveTrainer(model, cfg, tok, tc)
    stamps = []
    tc.log_fn = lambda rec: stamps.append(time.perf_counter())  # float(loss) synchronises
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sa.launches = sa.bwd_launches = 0
    fa.launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
    t0 = time.perf_counter()
    out = trainer.fit(lambda: iter([batch] * steps), steps_per_epoch=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"k1": sa.launches, "k2": sa.bwd_launches, "k3": fa.launches,
              "k4a": fa.bwd_dq_launches, "k4b": fa.bwd_dkv_launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [h["loss"] for h in out["history"]]
    ms = 1e3 * float(np.median(np.diff(stamps)))
    towers = trainer._prep_batch(batch)[0]   # dp row 0's towers: no mesh, the only row
    valid = int(sum(t["mask"].sum().item() for t in towers))
    res = {"losses": losses, "wall_s": wall, "peak_gib": peak_gib, "ms_per_step": ms,
           "seq_per_s": 3 * len(batch) / (ms / 1e3), "tokens_per_s": valid / (ms / 1e3),
           **counts}
    log(f"{label}: {steps} steps in {wall:.2f} s, losses {[round(x, 5) for x in losses]}; "
        f"{ms:.1f} ms/step, {res['seq_per_s']:.2f} sequences/s, {res['tokens_per_s']:.0f} "
        f"valid tokens/s, peak {peak_gib:.2f} GiB; launches {counts}")
    return {**res, **profile_step(torch, trainer, batch, f"{label} profile, one step",
                                  families, name_keys)}


def family_train(torch, fa, sa, family: str, card: str) -> dict:
    """Training of one family at full width with fp32 weights drawn on the
    card (GPT-J-6B with its biased head, or BLOOM-1b7), through
    `ContrastiveTrainer.fit` at the CLI's matmul precision "default", SPECB,
    BitFit, MNRL, constant lr 2e-4, 1 warm-up and 2 timed steps on one
    repeated batch (its loss falls):
      (a) the MS MARCO configuration: 32 triplets, max_seq_len 300, GradCache
          chunk 4 (the paper's SGPT-5.8B setting): K1 = L × 3 towers × 2
          passes × 8 chunks a step, K2 = L × 3 × 8;
      (a2) GPT-J only, SGPT-5.8B-weightedmean-nli-bitfit's configuration:
          64 NLI triplets at max_seq_len 75 (`nli_batches`), GradCache chunk
          16 (1,200 tokens a chunk, as MS MARCO's 4 × 300), no SPECB: K1 =
          28 × 3 × 2 × 4, K2 = 28 × 3 × 4 a step; the profile names only the
          `_wide` instantiations;
      (b) long context with use_flash at max_seq_len 2048: 8 (GPT-J) or 16
          (BLOOM) triplets of 300-3,000-word documents, GradCache chunks of 2
          (GPT-J) or 4 (BLOOM): K3 = L × 3 × 2 × chunks, K4a = K4b = L × 3 ×
          chunks; the profile names only Dh-256 (GPT-J: K4's `_wide`) or
          Dh-128 (BLOOM) instantiations;
    both with only biases moving (frozen weights keep their bits), ms/step,
    sequences/s, peak memory and one profiled step; then (c) card against
    CPU at full width with the depth cut to 2 layers, at "highest": one step's
    loss and bias gradients on 2 triplets at T=300 (K1, K2) and with
    use_flash at T=512 (K3, K4a, K4b), and for GPT-J at NLI's T=75, gated as
    phase tparity."""
    import copy
    import dataclasses

    from sgpt_tpu_torch.models import Decoder, bloom, gpt_j_6b
    from sgpt_tpu_torch.tokenization import SimpleTokenizer
    from sgpt_tpu_torch.training import BIAS_NAMES, ContrastiveTrainer, TrainConfig

    rng = np.random.default_rng(SEED + 21)
    head = ("w", "b") if family == "gptj" else ()
    base = gpt_j_6b() if family == "gptj" else bloom("1b7")
    # use_flash: T=300 is no multiple of 128, so (a) takes K1/K2 as without it
    cfg = base.replace(use_flash=True, matmul_precision="default")
    L = cfg.num_layers
    phase(f"families train {family}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = Decoder(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(SEED),
                    lm_head=head)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    weights_gib = torch.cuda.memory_allocated() / 2**30
    log(f"families train {family}: {n_params} fp32 parameters drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s ({weights_gib:.2f} GiB)")
    tok = SimpleTokenizer(cfg.vocab_size)
    biases = {n: p.detach().clone() for n, p in model.named_parameters()
              if n.rsplit(".", 1)[-1] in BIAS_NAMES}
    frozen = {n: bits_fingerprint(torch, p) for n, p in model.named_parameters()
              if n not in biases}
    out = {"params": n_params, "weights_gib": weights_gib}
    short_keys = {"K1": K1_KEYS, "K2": ("tf32_rows", "tf32_cols", "rows_kernel", "cols_kernel"),
                  "GEMM": GEMM_KEYS}
    flash_keys = {"K3": ("flash_fwd",), "K4a": ("flash_bwd_dq",), "K4b": ("flash_bwd_dkv",),
                  "GEMM": GEMM_KEYS}
    steps = 3

    # (a) the MS MARCO configuration
    B, chunk = 32, 4
    tc = TrainConfig(lr=2e-4, batch_size=B, max_seq_len=300, specb=True, freeze_nonbias=True,
                     pooling="weightedmean", scheduler="constantlr", use_gradcache=True,
                     chunk_size=chunk)
    a = train_cell(torch, fa, sa, model, cfg, tok, tc, synthetic_triplets(rng, B), steps,
                   f"families train {family} msmarco (B={B}, T=300, GradCache chunk {chunk})",
                   short_keys, ("::scalar_kernel", "tf32_kernel", "mma_kernel", "rows_kernel",
                                "cols_kernel", "tf32_rows", "tf32_cols"))
    chunks = B // chunk
    assert (a["k1"], a["k2"]) == (L * 3 * 2 * chunks * steps, L * 3 * chunks * steps), a
    assert a["k3"] == a["k4a"] == a["k4b"] == 0, a
    assert all(np.isfinite(a["losses"])) and a["losses"][-1] < a["losses"][0], a["losses"]
    if a["profile_kernel_ms"] is not None:  # fp32 K1 and K2 on their 3xTF32 kernels, by name
        # the port's kernels (PyTorch's `compare_scalar_kernel` also holds a key)
        names = [n for n in a["kernel_names"] if "(anonymous namespace)::" in n]
        assert a["profile_k2_ms"] > 0 and a["profile_k1_ms"] > 0, a
        assert names and all("tf32_" in n for n in names), names
        assert all(("_wide" in n) == (cfg.head_size == 256) for n in names), names
    out["msmarco"] = a

    # (a2) GPT-J: the NLI configuration of SGPT-5.8B-weightedmean-nli-bitfit
    if family == "gptj":
        B, chunk = 64, 16
        nli_tc = dataclasses.replace(tc, batch_size=B, max_seq_len=NLI_T, specb=False,
                                     chunk_size=chunk, log_fn=None)
        batch = nli_batches(np.random.default_rng(SEED + 24), 200, B, 1)[0]
        n = train_cell(torch, fa, sa, model, cfg, tok, nli_tc, batch, steps,
                       f"families train {family} nli (B={B}, T={NLI_T}, GradCache chunk "
                       f"{chunk})", short_keys, ("::scalar_kernel", "tf32_kernel", "mma_kernel",
                                                 "rows_kernel", "cols_kernel", "tf32_rows",
                                                 "tf32_cols"))
        chunks = B // chunk
        assert (n["k1"], n["k2"]) == (L * 3 * 2 * chunks * steps, L * 3 * chunks * steps), n
        assert n["k3"] == n["k4a"] == n["k4b"] == 0, n
        assert all(np.isfinite(n["losses"])) and n["losses"][-1] < n["losses"][0], n["losses"]
        if n["profile_kernel_ms"] is not None:
            names = [x for x in n["kernel_names"] if "(anonymous namespace)::" in x]
            assert n["profile_k2_ms"] > 0 and n["profile_k1_ms"] > 0, n
            assert names and all("tf32_" in x and "_wide" in x for x in names), names
        out["nli"] = n

    # (b) long context with use_flash
    n_long, chunk = FAMILY_LONG_TRAIN[family]
    tc = dataclasses.replace(tc, batch_size=n_long, max_seq_len=2048, chunk_size=chunk,
                             log_fn=None)
    long_batch = long_triplets(np.random.default_rng(SEED + 22), n_long)
    b = train_cell(torch, fa, sa, model, cfg, tok, tc, long_batch, steps,
                   f"families train {family} long (B={n_long}, T=2048, use_flash, GradCache "
                   f"chunk {chunk})", flash_keys, ("flash_",))
    chunks = n_long // chunk
    assert b["k1"] == b["k2"] == 0, b
    assert b["k3"] == L * 3 * 2 * chunks * steps, b
    assert b["k4a"] == b["k4b"] == L * 3 * chunks * steps, b
    assert all(np.isfinite(b["losses"])) and b["losses"][-1] < b["losses"][0], b["losses"]
    if b["profile_kernel_ms"] is not None:
        width = str(cfg.head_size)
        assert b["kernel_names"] and all(width in n for n in b["kernel_names"]), b
        bwd = [n for n in b["kernel_names"] if "flash_bwd" in n]
        assert bwd and all(("_wide" in n) == (width == "256") for n in bwd), bwd
        assert b["profile_k4a_ms"] > 0 and b["profile_k4b_ms"] > 0, b
    out["long"] = b

    # only biases moved: every bias leaf changed, every other weight kept its bits
    for name, p in model.named_parameters():
        if name in biases:
            assert not torch.equal(p.detach(), biases[name]), f"{name} did not move"
        else:
            assert p.grad is None and bits_fingerprint(torch, p) == frozen[name], f"{name} moved"
    log(f"families train {family}: {len(biases)} bias leaves moved, {len(frozen)} frozen "
        f"leaves kept their bits ({card})")
    del model, biases
    torch.cuda.empty_cache()

    # (c) card against CPU, full width, 2 layers, "highest"
    phase(f"families train {family} parity")
    cfg2 = base.replace(num_layers=2, use_flash=True)
    gpu = Decoder(cfg2, device="cuda", generator=torch.Generator("cuda").manual_seed(SEED + 1),
                  lm_head=head)
    cpu = copy.deepcopy(gpu).to("cpu")
    batch = synthetic_triplets(rng, 2)
    parity = {}
    for T in ((NLI_T,) if family == "gptj" else ()) + (300, 512):
        tc = TrainConfig(lr=2e-4, batch_size=2, max_seq_len=T, specb=True, freeze_nonbias=True)
        res = []
        t0 = time.perf_counter()
        for net in (cpu, gpu):
            trainer = ContrastiveTrainer(net, cfg2, tok, tc)
            trainer._opt, trainer._sched = trainer._build_optimizer(1)
            trainer._opt.zero_grad(set_to_none=True)
            sa.launches = sa.bwd_launches = 0
            fa.launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
            loss = float(trainer._loss_and_grads(trainer._prep_batch(batch)))
            res.append((loss, {n: p.grad.cpu() for n, p in net.named_parameters()
                               if p.requires_grad}))
        counts = (sa.launches, sa.bwd_launches, fa.launches, fa.bwd_dq_launches,
                  fa.bwd_dkv_launches)
        flash = T % 128 == 0
        want = (0, 0, 6, 6, 6) if flash else (6, 6, 0, 0, 0)  # 2 layers × 3 towers
        assert counts == want, (T, counts, want)
        (loss_cpu, g_cpu), (loss_gpu, g_gpu) = res
        # BLOOM's key bias adds q·bk to a whole score row, which the softmax
        # does not see: its gradient is 0 and both sides hold rounding noise,
        # held to 1e-6 of the largest bias gradient instead of its own norm
        zero = [n for n in g_cpu if n.endswith("attn.bk")]
        scale = max(g.norm().item() for g in g_cpu.values())
        worst = max(((g_gpu[n] - g).abs().max() / g.norm().clamp_min(1e-12)).item()
                    for n, g in g_cpu.items() if n not in zero)
        noise = max([max(g_gpu[n].abs().max().item(), g_cpu[n].abs().max().item()) / scale
                     for n in zero], default=0.0)
        log(f"families train {family} parity T={T}{' use_flash' if flash else ''}: loss card "
            f"{loss_gpu:.7f} CPU {loss_cpu:.7f} (|diff| {abs(loss_gpu - loss_cpu):.3e}, "
            f"tolerance 1e-5 relative); {len(g_cpu) - len(zero)} bias gradients, worst "
            f"max|diff|/norm {worst:.3e} (tolerance 1e-4); {len(zero)} key-bias gradients "
            f"(exactly 0 in the formula) at most {noise:.3e} of the largest bias gradient's norm "
            f"on either side (tolerance 1e-6); K1, K2, K3, K4a, K4b launches on the card "
            f"{counts}; {time.perf_counter() - t0:.1f} s")
        assert abs(loss_gpu - loss_cpu) <= 1e-5 * abs(loss_cpu)
        assert worst <= 1e-4 and noise <= 1e-6
        parity[T] = {"loss_diff": abs(loss_gpu - loss_cpu), "grad_rel": worst,
                     "key_bias_noise": noise}
    out["parity"] = parity
    del gpu, cpu
    torch.cuda.empty_cache()
    return out


def phase_families_train(torch, fa, sa, card) -> dict:
    """GPT-J-6B, then BLOOM-1b7 (`family_train`), each freed before the next."""
    return {family: family_train(torch, fa, sa, family, card) for family in ("gptj", "bloom")}


# ---------------------------------------------------------------------------
# the symmetric-search slice of SGPT-BE: NLI training and USEB evaluation

NLI_T = 75  # training_nli_v2.py's max_seq_length: every tower of a step pads to it

NLI_CASES = [  # name, dtype, B, T, H, Dh, scale, window; each with a fully padded row
    ("neo-nli", "fp32", 64, NLI_T, 12, 64, 1.0, 0),         # GPT-Neo-125M's NLI towers
    ("neo-nli-w256", "fp32", 64, NLI_T, 12, 64, 1.0, 256),  # its local layers
    ("gptj-nli", "fp32", 16, NLI_T, 16, 256, 1 / 16, 0),    # GPT-J-6B's GradCache chunk
    ("useb-T16", "bf16", 512, 16, 12, 64, 1.0, 0),          # the USEB encode's short
    ("useb-T32", "bf16", 256, 32, 12, 64, 1.0, 256),        # buckets (batch 64 at 128)
    ("useb-T64", "bf16", 128, 64, 12, 64, 1.0, 0),
]
NLI_TIMED = ("neo-nli", "gptj-nli", "useb-T32")


def phase_nli_kernels(torch, sa, rng):
    """K1 and K2 at the symmetric slice's shapes against their plain
    versions (`NLI_CASES`): fp32 at T=75 (not a multiple of 16, and below one
    64-key tile of K2's cols pass) at GPT-Neo's Dh 64 (global and window 256)
    and GPT-J's Dh 256, K2 on a random output gradient; bf16 K1 at the USEB
    encode's short buckets (T 16, 32, 64); ~10 % key padding, a row short
    enough that a window leaves its tail fully masked, and batch row 1 fully
    padded (K2 gives it dq = 0). K1 held to its gate (bf16 2e-2 + 1e-2·|ref|,
    fp32 1e-5 + 1e-5·|ref|), K2 by `hold_grads`. Then the times of
    `NLI_TIMED` (`time_k1`, `time_k2`). Returns the largest error by kernel
    and the times."""
    errs, times = {"k1": 0.0, "k2": 0.0}, {}
    for name, dt, B, T, H, Dh, scale, window in NLI_CASES:
        dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dt]
        args, _ = case_inputs(torch, rng, B, T, H, Dh, dtype, False, dead=True)
        got = sa.short_attention(*args, scale, window, H, False)
        want = sa.short_attention_reference(*args, scale=scale, window=window, H=H,
                                            use_alibi=False)
        torch.cuda.synchronize()
        err, _ = hold(torch, f"kernel {name}", got, want, dtype)
        errs["k1"] = max(errs["k1"], err)
        line = (f"kernel {name:13s} {dt} B={B} T={T} H={H} Dh={Dh} window={window}, a fully "
                f"padded row: K1 max_abs_err {err:.3e}")
        if dtype == torch.float32:
            g = card_normal(torch, rng, (B, T, H * Dh), 1.0, dtype)
            kw = dict(scale=scale, window=window, H=H, use_alibi=False)
            got = sa.short_attention_bwd(*args, g, **kw)
            want = sa.short_attention_bwd_reference(*args, g, **kw)
            torch.cuda.synchronize()
            e2, gate, _ = hold_grads(torch, f"bwd {name}", got, want, dtype)
            assert (got[0][1] == 0).all(), f"bwd {name}: dq of a fully padded row"
            errs["k2"] = max(errs["k2"], *e2)
            line += f"; K2 max_abs_err dq {e2[0]:.3e} dk {e2[1]:.3e} dv {e2[2]:.3e} ({gate})"
        log(line)
        if name in NLI_TIMED:
            times[name] = {"k1": time_k1(torch, sa, f"{name} ", args, H, scale, window)}
            if dtype == torch.float32:
                times[name]["k2"] = time_k2(torch, sa, f"{name} ", args, g, H, scale, window)
        del args, got, want
        torch.cuda.empty_cache()
    return errs, times


def nli_rows(rng, n: int) -> list:
    """(split, premise, hypothesis, label) rows of a synthetic AllNLI.tsv:
    `n` premises of 8-40 words, each with 1-2 entailment, 1-2 contradiction
    hypotheses and one neutral one of 4-20 words."""
    words = ["".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"), rng.integers(2, 9)))
             for _ in range(5000)]

    def text(lo, hi):
        return " ".join(rng.choice(words, int(rng.integers(lo, hi))))

    rows = []
    for _ in range(n):
        premise = text(8, 41)
        for label, count in (("entailment", int(rng.integers(1, 3))),
                             ("contradiction", int(rng.integers(1, 3))), ("neutral", 1)):
            rows += [("train", premise, text(4, 21), label) for _ in range(count)]
    return rows


def write_nli(folder: str, rng, n_premises: int, n_sts: int) -> tuple:
    """AllNLI.tsv.gz (`nli_rows`) and an STS-B tsv of `n_sts` dev pairs of
    4-20 words with scores in [0, 5] under `folder`; their paths."""
    import gzip
    import os

    nli = os.path.join(folder, "AllNLI.tsv.gz")
    with gzip.open(nli, "wt") as f:
        f.write("split\tsentence1\tsentence2\tlabel\n")
        f.writelines("\t".join(r) + "\n" for r in nli_rows(rng, n_premises))
    sts = os.path.join(folder, "stsbenchmark.tsv.gz")
    pairs = nli_rows(rng, n_sts)[:n_sts]
    with gzip.open(sts, "wt") as f:
        f.write("split\tsentence1\tsentence2\tscore\n")
        f.writelines(f"dev\t{p}\t{h}\t{5 * rng.random():.3f}\n" for _, p, h, _ in pairs)
    return nli, sts


def nli_batches(rng, n_premises: int, batch: int, n_batches: int) -> list:
    """`n_batches` NoDuplicates batches of `batch` (anchor, entailment,
    contradiction) triplets built from `nli_rows` as the train_nli CLI does."""
    from sgpt_tpu_torch.data import NoDuplicatesBatcher, build_nli_triplets

    triplets = build_nli_triplets([r[1:] for r in nli_rows(rng, n_premises)], seed=SEED)
    out = [[ex.texts for ex in b] for b in NoDuplicatesBatcher(triplets, batch, seed=SEED)]
    assert len(out) >= n_batches, (len(out), n_batches)
    return out[:n_batches]


def grads_of(torch, trainer) -> dict:
    """The trainable leaves' gradients after `_loss_and_grads`: the model's
    (biases under BitFit) and the aux tensors', on the CPU."""
    from sgpt_tpu_torch.training.trainer import aux_leaves

    out = {n: p.grad.cpu() for n, p in trainer.model.named_parameters() if p.requires_grad}
    out.update({f"aux.{n}": t.grad.cpu() for n, t in aux_leaves(trainer.aux).items()})
    return out


def worst_grad(a: dict, b: dict) -> float:
    """max over leaves of max|a − b| / ‖b‖."""
    assert a.keys() == b.keys(), (sorted(a), sorted(b))
    return max(((a[n] - g).abs().max() / g.norm().clamp_min(1e-12)).item() for n, g in b.items())


def phase_nli(torch, sa, tok, card) -> dict:
    """NLI training, symmetric SGPT-BE (SGPT-125M-weightedmean-nli-bitfit's
    configuration), of full-width GPT-Neo-125M in fp32 at the CLI's matmul
    precision "default" (TF32 products): synthetic AllNLI (2,000 premises of
    8-40 words with entailment and contradiction hypotheses) →
    `build_nli_triplets` → `NoDuplicatesBatcher` of 64 → BitFit, MNRL,
    weightedmean, max_seq_len 75 (every tower pads to it: K1 and K2 at T=75):
      * 5 steps through `ContrastiveTrainer.fit` (warmuplinear, lr 2e-4),
        ms/step from the last 4, one step profiled (fp32 K1 and K2 on their
        Dh-64 3xTF32 kernels by name); then 2 steps each with the learnt
        mean, one post-pool GELU head and one pre-pool head (768 → 768, no
        bias under BitFit, as the CLI): K1 = K2 = 12 × 3 a step, only
        biases and the aux move;
      * a repeated batch at constant lr: the loss falls;
      * at "highest", with the learnt mean and a post-pool GELU head:
        GradCache (chunk 16) == the direct step (loss within 1e-5 relative,
        bias and aux gradients within 1e-4 of each leaf's norm), and the card
        == the CPU (4 triplets, the same gates);
      * `cli.train_nli` end to end (400 premises, 256 STS-B dev pairs
        evaluated every 10 % of the epoch, --learntmean --addxlinear 1
        --useact --freezenonbias): its best model, reloaded with
        `SGPTModel.load`, gives the exported model's embeddings bit for bit."""
    import copy
    import dataclasses
    import os
    import tempfile

    from sgpt_tpu_torch.cli import train_nli
    from sgpt_tpu_torch.model import SGPTModel
    from sgpt_tpu_torch.models import Decoder, gpt_neo
    from sgpt_tpu_torch.training import BIAS_NAMES, ContrastiveTrainer, TrainConfig
    from sgpt_tpu_torch.training.trainer import aux_leaves

    rng = np.random.default_rng(SEED + 31)
    steps, B = 5, 64
    batches = nli_batches(rng, 2000, B, steps + 6)
    cfg = gpt_neo("125m", matmul_precision="default")  # as cli.common.build_model
    model = Decoder(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
    L = cfg.num_layers
    tc = TrainConfig(lr=2e-4, batch_size=B, max_seq_len=NLI_T, freeze_nonbias=True,
                     pooling="weightedmean", scheduler="warmuplinear")
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if n.rsplit(".", 1)[-1] not in BIAS_NAMES}
    biases = {n: p.detach().clone() for n, p in model.named_parameters() if n not in frozen}

    stamps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tc.log_fn = lambda rec: stamps.append(time.perf_counter())  # float(loss) synchronises
    sa.launches = sa.bwd_launches = 0
    out = ContrastiveTrainer(model, cfg, tok, tc).fit(lambda: iter(batches[:steps]),
                                                       steps_per_epoch=steps)
    torch.cuda.synchronize()
    counts = {"k1": sa.launches, "k2": sa.bwd_launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [h["loss"] for h in out["history"]]
    ms = 1e3 * float(np.median(np.diff(stamps)))
    res = {"ms_per_step": ms, "seq_per_s": 3 * B / (ms / 1e3), "peak_gib": peak_gib,
           "losses": losses}
    log(f"nli: {steps} steps (B={B}, T={NLI_T}), losses {[round(x, 5) for x in losses]}; "
        f"{ms:.1f} ms/step, {res['seq_per_s']:.1f} sequences/s, peak {peak_gib:.2f} GiB, "
        f"fp32 at TF32 products (\"default\"); K1 {counts['k1']}, K2 {counts['k2']} launches "
        f"({card})")
    assert all(np.isfinite(losses)), losses
    assert counts == {"k1": L * 3 * steps, "k2": L * 3 * steps}, counts
    trainer = ContrastiveTrainer(model, cfg, tok, tc)
    trainer._opt, trainer._sched = trainer._build_optimizer(1)
    res.update(profile_step(
        torch, trainer, batches[0], "nli profile, one step (TF32)",
        {"K1": K1_KEYS, "K2": ("tf32_rows", "tf32_cols"),
         "K2scalar": ("rows_kernel", "cols_kernel"), "GEMM": GEMM_KEYS},
        ("::scalar_kernel", "tf32_kernel", "mma_kernel", "rows_kernel", "cols_kernel",
         "tf32_rows", "tf32_cols")))
    if res["profile_kernel_ms"] is not None:
        names = [n for n in res["kernel_names"] if "(anonymous namespace)::" in n]
        assert res["profile_k1_ms"] > 0 and res["profile_k2_ms"] > 0, res
        assert res["profile_k2scalar_ms"] == 0, res
        assert names and all("tf32_" in n and "_wide" not in n for n in names), names

    # 2 steps each with the learnt mean, a post-pool GELU head, a pre-pool head
    head = dict(in_features=cfg.hidden_size, out_features=cfg.hidden_size, bias=False)
    variants = {"learntmean": dict(pooling="learned_weightedmean"),
                "post-pool gelu head": dict(dense_heads=[{**head, "activation": "gelu"}]),
                "pre-pool head": dict(dense_heads=[{**head, "location": "pre_pool"}])}
    for i, (label, kw) in enumerate(variants.items()):
        vt = ContrastiveTrainer(model, cfg, tok, dataclasses.replace(tc, log_fn=None, **kw))
        start = {n: t.detach().clone() for n, t in aux_leaves(vt.aux).items()}
        sa.launches = sa.bwd_launches = 0
        vl = [h["loss"] for h in vt.fit(lambda: iter(batches[steps + 2 * i: steps + 2 * i + 2]),
                                        steps_per_epoch=2)["history"]]
        moved = [n for n, t in aux_leaves(vt.aux).items() if not torch.equal(t, start[n])]
        log(f"nli {label}: losses {[round(x, 5) for x in vl]}; aux leaves moved {moved}; K1 "
            f"{sa.launches}, K2 {sa.bwd_launches} launches")
        assert all(np.isfinite(vl)) and moved == list(start), (vl, moved)
        assert (sa.launches, sa.bwd_launches) == (L * 3 * 2,) * 2
        counts["k1"] += sa.launches
        counts["k2"] += sa.bwd_launches
    for name, p in model.named_parameters():
        if name in frozen:
            assert p.grad is None and torch.equal(p.detach(), frozen[name]), f"{name} moved"
        else:
            assert not torch.equal(p.detach(), biases[name]), f"{name} did not move"
    log(f"nli: {len(biases)} bias leaves moved, {len(frozen)} frozen leaves kept their bits")
    del frozen, biases

    # a repeated batch at constant lr: the loss falls
    const = dataclasses.replace(tc, scheduler="constantlr", log_fn=None)
    sa.launches = sa.bwd_launches = 0
    rep = [h["loss"] for h in ContrastiveTrainer(model, cfg, tok, const).fit(
        lambda: iter([batches[-1]] * 4), steps_per_epoch=4)["history"]]
    counts["k1"] += sa.launches
    counts["k2"] += sa.bwd_launches
    log(f"nli: one batch repeated at constant lr 2e-4: losses {[round(x, 5) for x in rep]}")
    assert rep[-1] < rep[0], rep

    # GradCache (chunk 16) == direct, and the card == the CPU, at "highest"
    strict = cfg.replace(matmul_precision="highest")
    model.cfg = strict
    aux_tc = dataclasses.replace(const, pooling="learned_weightedmean", dense_heads=[
        {**head, "activation": "gelu"}])

    def one_step(net, net_cfg, batch, **kw):
        trainer = ContrastiveTrainer(net, net_cfg, tok, dataclasses.replace(aux_tc, **kw))
        trainer._opt, trainer._sched = trainer._build_optimizer(1)
        trainer._opt.zero_grad(set_to_none=True)
        loss = float(trainer._loss_and_grads(trainer._prep_batch(batch)))
        return loss, grads_of(torch, trainer)

    direct = one_step(model, strict, batches[0])
    sa.launches = sa.bwd_launches = 0
    gc = one_step(model, strict, batches[0], use_gradcache=True, chunk_size=16)
    chunks = B // 16
    worst = worst_grad(gc[1], direct[1])
    log(f"nli: GradCache (chunk 16) loss {gc[0]:.7f}, direct {direct[0]:.7f}, |diff| "
        f"{abs(gc[0] - direct[0]):.3e} (tolerance 1e-5 relative); {len(direct[1])} bias and aux "
        f"gradients, worst max|diff|/norm {worst:.3e} (tolerance 1e-4); K1 {sa.launches}, K2 "
        f"{sa.bwd_launches} launches")
    assert abs(gc[0] - direct[0]) <= 1e-5 * abs(direct[0]) and worst <= 1e-4
    assert (sa.launches, sa.bwd_launches) == (2 * L * 3 * chunks, L * 3 * chunks)
    del model
    torch.cuda.empty_cache()
    cpu = Decoder(gpt_neo("125m"), device="cpu", generator=torch.Generator().manual_seed(SEED + 1))
    gpu = copy.deepcopy(cpu).to("cuda")
    small = batches[1][:4]
    on_cpu, on_gpu = one_step(cpu, cpu.cfg, small), one_step(gpu, gpu.cfg, small)
    worst = worst_grad(on_gpu[1], on_cpu[1])
    log(f"nli parity: loss card {on_gpu[0]:.7f} CPU {on_cpu[0]:.7f} (|diff| "
        f"{abs(on_gpu[0] - on_cpu[0]):.3e}, tolerance 1e-5 relative); {len(on_cpu[1])} bias "
        f"and aux gradients (learnt mean, a GELU head), worst max|diff|/norm {worst:.3e} "
        f"(tolerance 1e-4)")
    assert abs(on_gpu[0] - on_cpu[0]) <= 1e-5 * abs(on_cpu[0]) and worst <= 1e-4
    res["parity"] = {"loss_diff": abs(on_gpu[0] - on_cpu[0]), "grad_rel": worst}
    del cpu, gpu
    torch.cuda.empty_cache()

    # the CLI end to end; its best model reloads bit for bit
    texts = [r[2] for r in nli_rows(rng, 40)]
    with tempfile.TemporaryDirectory() as tmp:
        nli, sts = write_nli(tmp, rng, 400, 256)
        save = os.path.join(tmp, "out")
        t0 = time.perf_counter()
        sa.launches = sa.bwd_launches = 0
        cli = train_nli.main(train_nli.parse_args([
            "--model_name", "125m", "--randominit", "--nli_path", nli, "--stsb_path", sts,
            "--train_batch_size", str(B), "--lr", "2e-4", "--freezenonbias", "--learntmean",
            "--addxlinear", "1", "--useact", "--model_save_path", save, "--device", "cuda"]))
        wall = time.perf_counter() - t0
        counts["k1"] += sa.launches
        counts["k2"] += sa.bwd_launches
        evals = [h["eval_score"] for h in cli["history"] if "eval_score" in h]
        n_steps = sum("loss" in h for h in cli["history"])
        want = cli["model"].encode(texts)
        got = SGPTModel.load(os.path.join(save, "best_model"), device="cuda").encode(texts)
    log(f"nli cli: {n_steps} steps, {len(evals)} STS-B dev evaluations "
        f"{[round(x, 4) for x in evals]}, best {cli['best_score']:.4f} (random weights), "
        f"{wall:.1f} s; the reloaded best model's embeddings equal the exported model's: "
        f"{np.array_equal(got, want)}")
    assert n_steps > 0 and len(evals) == n_steps and all(np.isfinite(evals)), evals
    assert want.shape == (len(texts), cfg.hidden_size) and np.isfinite(want).all()
    assert np.array_equal(got, want), np.abs(got - want).max()
    res["cli"] = {"steps": n_steps, "evals": evals, "best_score": cli["best_score"]}
    return {**res, **counts}


USEB_RUNS = [("weightedmean", -1), ("weightedmean", 0), ("weightedmean", 4),
             ("weightedmean", 8), ("weightedmean", 12), ("meanmean", -1), ("lasttokenmean", -1)]
USEB_SCORE_TOL = 1.0  # |Δ main score| (×100) of the kernel path against the plain path, bf16


def write_useb(root: str, rng) -> int:
    """Synthetic folders of the four USEB tasks under `root`, in the formats
    of tests/test_useb.py's fixtures: AskUbuntu (2,000 questions of 4-14
    words, 100 queries × 20 BM25 candidates a split), CQADupStack (3 forums
    of 1,500 posts of 8-60 words, 50 duplicate queries each), TwitterPara
    (800 URL pairs and 800 PIT pairs of 5-25 words) and SciDocs (2,000 titles
    of 4-16 words, 30 queries × 5 documents in each of the 4 subtasks).
    Returns the number of texts."""
    import os

    words = ["".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"), rng.integers(2, 9)))
             for _ in range(5000)]

    def text(lo, hi):
        return " ".join(rng.choice(words, int(rng.integers(lo, hi))))

    def folder(name):
        path = os.path.join(root, name)
        os.makedirs(path)
        return path

    n_texts = 0
    d = folder("askubuntu")
    with open(os.path.join(d, "text_tokenized.txt"), "w") as f:
        f.writelines(f"q{i}\t{text(4, 15)}\t{text(10, 40)}\n" for i in range(2000))
    for fname in ("test.txt", "dev.txt"):
        with open(os.path.join(d, fname), "w") as f:
            for i in range(100):
                cands = rng.choice(np.arange(100, 2000), 20, replace=False)
                f.write(f"q{i}\t{' '.join(f'q{c}' for c in cands[:2])}\t"
                        f"{' '.join(f'q{c}' for c in cands)}\t"
                        f"{' '.join(f'{x:.3f}' for x in rng.random(20))}\n")
    n_texts += 2000
    d = folder("cqadupstack")
    corpus = {forum: {f"d{i}": text(8, 61) for i in range(1500)}
              for forum in ("android", "gis", "unix")}
    split = {s: {forum: {f"d{i}": [f"d{i + 1}", f"d{i + 2}"] for i in range(0, 1500, 30)}
                 for forum in corpus} for s in ("test", "valid")}
    with open(os.path.join(d, "corpus.json"), "w") as f:
        json.dump(corpus, f)
    with open(os.path.join(d, "retrieval_split.json"), "w") as f:
        json.dump(split, f)
    n_texts += 4500
    d = folder("twitterpara")
    with open(os.path.join(d, "Twitter_URL_Corpus_test.txt"), "w") as f:
        f.writelines(f"{text(5, 26)}\t{text(5, 26)}\t({rng.integers(0, 7)}, 6)\n"
                     for _ in range(800))
    with open(os.path.join(d, "test.data"), "w") as f:
        f.writelines(f"id\ttopic\t{text(5, 26)}\t{text(5, 26)}\t{rng.integers(0, 6)}\n"
                     for _ in range(800))
    n_texts += 3200
    d = folder("scidocs")
    data = {"corpus": {f"p{i}": {"title": text(4, 17)} for i in range(2000)}}
    for s in ("test", "valid"):
        data[s] = {task: {f"p{q}": {f"p{int(c)}": int(rng.integers(0, 2))
                                    for c in rng.choice(np.arange(100, 2000), 5, replace=False)}
                          for q in range(30)}
                   for task in ("cite", "cocite", "coview", "coread")}
    with open(os.path.join(d, "data.json"), "w") as f:
        json.dump(data, f)
    return n_texts + 2000


def phase_useb(torch, sa, fa, card) -> dict:
    """USEB evaluation (symmetric search) through `cli.useb_retriever` with
    full-width GPT-Neo-125M in bf16 (random weights from the CLI's seed,
    --maxseqlen 128, --batchsize 64) on synthetic folders of the four tasks
    (`write_useb`): `USEB_RUNS`, weightedmean at --layeridx -1 and the sweep
    0, 4, 8, 12, then meanmean and lasttokenmean (the all-layer stack). Each
    run: K1 = 12 × batches, main scores finite in [0, 100], emb/s. The
    kernel path against the plain path (`plain_attention`) on the same
    weights, weightedmean and meanmean: every embedding's cosine ≥ 0.99 (the
    parity phase's bf16 gate) and each task's main score within
    `USEB_SCORE_TOL`. fp32 card == fp32 CPU on 8 texts (max |Δ| ≤ 1e-4 of
    normalised embeddings, the parity phase's gate) for max, cls, meanmean,
    lasttokenmean and weightedmean at layer 6."""
    import copy
    import os
    import tempfile

    from sgpt_tpu_torch import encoder as enc_mod
    from sgpt_tpu_torch.cli import common, useb_retriever
    from sgpt_tpu_torch.encoder import EmbeddingEngine
    from sgpt_tpu_torch.evaluation import useb
    from sgpt_tpu_torch.models import Decoder, gpt_neo
    from sgpt_tpu_torch.tokenization import SimpleTokenizer

    rng = np.random.default_rng(SEED + 41)
    out = {"runs": {}, "k1": 0}
    shapes, spent = [], [0, 0.0]  # forward shapes; texts encoded, seconds in encode
    built = []

    def build(*a, **kw):
        model, cfg, tok = common.build_model(*a, **kw)
        model.register_forward_pre_hook(lambda m, args: shapes.append(tuple(args[0].shape)))
        built.append((model, cfg, tok))
        return model, cfg, tok

    encode = enc_mod.EmbeddingEngine.encode

    def timed(self, texts, **kw):
        t0 = time.perf_counter()
        emb = encode(self, texts, **kw)
        spent[0] += len(texts)
        spent[1] += time.perf_counter() - t0
        return emb

    with tempfile.TemporaryDirectory() as tmp:
        n_texts = write_useb(tmp, rng)
        useb_retriever.build_model = build
        enc_mod.EmbeddingEngine.encode = timed
        try:
            for method, layer in USEB_RUNS:
                shapes.clear()
                spent[:] = [0, 0.0]
                sa.launches = 0
                path = os.path.join(tmp, f"{method}_{layer}.json")
                useb_retriever.main(useb_retriever.parse_args([
                    "--modelname", "125m", "--randominit", "--datapath", tmp, "--method",
                    method, "--layeridx", str(layer), "--maxseqlen", "128", "--batchsize", "64",
                    "--output", path, "--device", "cuda"]))
                with open(path) as f:
                    result = json.load(f)
                L = built[-1][1].num_layers
                assert sa.launches == L * len(shapes) > 0, (sa.launches, len(shapes))
                mains = result["main"]
                assert set(mains) == {*useb.EVALUATORS, "avg"}, mains
                assert all(np.isfinite(v) and 0 <= v <= 100 for v in mains.values()), mains
                assert (result["method"], result["layeridx"]) == (method, layer)
                key = f"{method}_{layer}"
                out["runs"][key] = {"main": mains, "batches": len(shapes),
                                    "emb_per_s": spent[0] / spent[1]}
                out["k1"] += sa.launches
                log(f"useb {method} --layeridx {layer}: main {mains}; {spent[0]} texts in "
                    f"{len(shapes)} batches (buckets {sorted({t for _, t in shapes})}), "
                    f"{spent[0] / spent[1]:.1f} emb/s; K1 {sa.launches} launches ({card})")
        finally:
            useb_retriever.build_model = common.build_model
            enc_mod.EmbeddingEngine.encode = encode

        # the kernel path against the plain path, on the CLI's weights
        model, cfg, tok = built[0]
        del built[1:]
        torch.cuda.empty_cache()
        with open(os.path.join(tmp, "askubuntu", "text_tokenized.txt")) as f:
            sample = [line.split("\t")[1] for line in f][:512]
        out["plain"] = {}
        for method in ("weightedmean", "meanmean"):
            engine = EmbeddingEngine(model, cfg, tok, device="cuda", method=method,
                                     max_seq_len=128, batch_size=64)
            kern = engine.encode(sample)
            _, kern_main = useb.run({t: engine.encode for t in useb.EVALUATORS},
                                    data_eval_path=tmp)
            with plain_attention(sa, fa):
                plain = engine.encode(sample)
                _, plain_main = useb.run({t: engine.encode for t in useb.EVALUATORS},
                                         data_eval_path=tmp)
            cos = cosine(kern, plain)
            diff = max(abs(kern_main[t] - plain_main[t]) for t in plain_main)
            log(f"useb {method}: kernel path against plain path (bf16): {len(sample)} "
                f"embeddings, cosine min {cos.min():.6f} (gate 0.99); main scores kernel "
                f"{kern_main}, plain {plain_main}, max |diff| {diff:.2f} (tolerance "
                f"{USEB_SCORE_TOL})")
            assert cos.min() > 0.99 and diff <= USEB_SCORE_TOL
            out["plain"][method] = {"cos_min": float(cos.min()), "main_diff": diff}
    del model, built
    torch.cuda.empty_cache()

    # fp32 card == fp32 CPU for each new pooler and a layer index
    cpu = Decoder(gpt_neo("125m"), device="cpu", generator=torch.Generator().manual_seed(SEED))
    gpu = copy.deepcopy(cpu).to("cuda")
    tok = SimpleTokenizer(cpu.cfg.vocab_size)
    texts = sample[:8]
    out["fp32"] = {}
    for method, layer in (("max", -1), ("cls", -1), ("meanmean", -1), ("lasttokenmean", -1),
                          ("weightedmean", 6)):
        kw = dict(method=method, layeridx=layer, max_seq_len=128, batch_size=8,
                  normalize_embeddings=True)
        err = float(np.abs(EmbeddingEngine(gpu, gpu.cfg, tok, device="cuda", **kw).encode(texts)
                           - EmbeddingEngine(cpu, cpu.cfg, tok, device="cpu", **kw).encode(
                               texts)).max())
        out["fp32"][f"{method}_{layer}"] = err
        log(f"useb fp32 card vs CPU, {method} --layeridx {layer}, 8 texts: max abs diff "
            f"{err:.3e} (tolerance 1e-4)")
        assert err < 1e-4, (method, layer, err)
    del cpu, gpu
    out["n_texts"] = n_texts
    return out


# ---------------------------------------------------------------------------
# int8 inference (phase int8) and the IVF index (phase ivf)
# ---------------------------------------------------------------------------

INT8_SHAPES = [(4096, 4096), (4096, 16384), (16384, 4096)]  # GPT-J's projections: D → F
INT8_ROWS = 64 * 300   # an encode batch of 64 rows at T=300
INT8_COS_MIN = 0.99    # int8 against bf16 embeddings, each text (cosine)


def time_int8_project(torch, quant, M: int, D: int, F: int, gen) -> dict:
    """`int8_project` on (M, D) bf16 activations and an (F, D) weight: the
    int32 accumulators of `torch._int_mm` against the plain version's (fp64
    on the card) and the outputs against the plain path's, both exactly;
    the time of each piece (the activation quantize pass, `_int_mm`, the
    rescale) beside `F.linear` in bf16 and the bound (bytes over the memory
    rate, or 2·M·D·F operations over the dense int8 peak)."""
    import torch.nn.functional as Fn

    x = (torch.randn((M, D), generator=gen, device="cuda")).to(torch.bfloat16)
    w = (0.02 * torch.randn((F, D), generator=gen, device="cuda")).to(torch.bfloat16)
    qw = quant.quantize_weight(w)
    qx, sx = quant.quantize_activations(x)
    acc = quant.int8_matmul(qx, qw["q"])
    want = quant.int8_matmul_reference(qx, qw["q"])
    assert torch.equal(acc, want), f"int8 {M}x{D}x{F}: _int_mm differs from the plain version"
    got = quant.int8_project(x, qw)
    plain = (want.float() * sx * qw["s"].reshape(1, -1)).to(torch.bfloat16)
    assert torch.equal(got, plain), f"int8 {M}x{D}x{F}: output differs from the plain path"
    del want, plain
    s_row = qw["s"].reshape(1, -1)
    ms = {"quantize_ms": cuda_ms(torch, lambda: quant.quantize_activations(x)),
          "int_mm_ms": cuda_ms(torch, lambda: quant.int8_matmul(qx, qw["q"])),
          "rescale_ms": cuda_ms(torch, lambda: (acc.float() * sx * s_row).to(torch.bfloat16)),
          "ms": cuda_ms(torch, lambda: quant.int8_project(x, qw)),
          "plain_ms": cuda_ms(torch, lambda: quant.int8_matmul_reference(qx, qw["q"]), iters=3),
          "library_ms": cuda_ms(torch, lambda: Fn.linear(x, w))}
    nbytes = 2 * M * D + F * D + 4 * F + 2 * M * F   # x bf16, W int8, scales, y bf16
    ms["bound_ms"], ms["bound_by"] = bound(nbytes, 2.0 * M * D * F, "int8")
    return ms


def int8_encode(torch, model, cfg, tok, texts, bf16_docs, bf16_s, label, card) -> dict:
    """The encode slice again with `EmbeddingEngine(quantize="int8")`: emb/s,
    peak memory, one batch of 64 at T=300 profiled, the cosine of each int8
    embedding to its bf16 one, and the overlap of the two top-10 lists of a
    search of the texts as queries over the texts (K5)."""
    from sgpt_tpu_torch.encoder import EmbeddingEngine
    from sgpt_tpu_torch.index import DenseIndex
    from sgpt_tpu_torch.ops import quant
    from sgpt_tpu_torch.ops import short_attention as sa

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = EmbeddingEngine(model, cfg, tok, device="cuda", specb=True, max_seq_len=300,
                             batch_size=64, normalize_embeddings=True, quantize="int8")
    engine.warmup()
    torch.cuda.synchronize()
    quant.launches = sa.launches = 0
    t0 = time.perf_counter()
    docs = engine.encode(texts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, k1 = quant.launches, sa.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    projections = 4 + 2
    batches = launches // (projections * cfg.num_layers)
    assert launches == projections * cfg.num_layers * batches > 0, launches
    assert k1 == cfg.num_layers * batches, (k1, batches)
    assert docs.shape == bf16_docs.shape and np.isfinite(docs).all()
    cos = cosine(docs, bf16_docs)
    longest = np.argsort([len(t) for t in texts], kind="stable")[-64:]
    prof = profile_batch(torch, engine, [texts[i] for i in longest],
                         f"{label} int8 encode profile, one batch of 64 at T=300",
                         {"K1": K1_KEYS, "GEMM": GEMM_KEYS})
    del engine
    lists = []
    for emb in (bf16_docs, docs):   # the texts as queries over the texts
        index = DenseIndex(cfg.hidden_size, kernel="pallas", device="cuda")
        index.add(emb, ids=[str(i) for i in range(len(emb))])
        index.build()
        lists.append(index.search_embeddings(emb, k=10)[1])
    overlap = float(np.mean([len(set(a) & set(b)) / 10 for a, b in zip(*lists)]))
    out = {"emb_per_s": len(texts) / wall, "bf16_emb_per_s": len(texts) / bf16_s,
           "peak_gib": peak, "cos_mean": float(cos.mean()), "cos_min": float(cos.min()),
           "top10_overlap": overlap, "int_mm_launches": launches, "k1_launches": k1, **prof}
    log(f"{label} int8 encode: {out['emb_per_s']:.1f} emb/s (bf16 {out['bf16_emb_per_s']:.1f}), "
        f"peak {peak:.2f} GiB, _int_mm launches {launches} = {projections} x {cfg.num_layers} "
        f"x {batches} batches, K1 {k1}; cosine to bf16 mean "
        f"{cos.mean():.6f} min {cos.min():.6f} (floor {INT8_COS_MIN}); top-10 overlap with "
        f"bf16 {overlap:.4f} ({card})")
    assert cos.min() >= INT8_COS_MIN, cos.min()
    return out


def phase_int8(torch, model, cfg, tok, texts, docs, doc_s, gen, card) -> dict:
    """int8_project at GPT-J's shapes (exact against the plain version, times
    beside F.linear and the bound); GPT-Neo-125M's encode with
    quantize="int8" against bf16; `cli.beir_retriever --quantize int8`."""
    from sgpt_tpu_torch.ops import quant

    shapes = {}
    for D, F in INT8_SHAPES:
        t = time_int8_project(torch, quant, INT8_ROWS, D, F, gen)
        shapes[f"{D}x{F}"] = t
        log(f"int8_project M={INT8_ROWS} {D}->{F}: equal to the plain version (int32 and "
            f"output); {t['ms']:.4f} ms = quantize {t['quantize_ms']:.4f} + _int_mm "
            f"{t['int_mm_ms']:.4f} + rescale {t['rescale_ms']:.4f}; F.linear bf16 "
            f"{t['library_ms']:.4f} ms; plain (fp64) {t['plain_ms']:.4f} ms; bound "
            f"{t['bound_ms']:.4f} ms by {t['bound_by']} ({card})")
    out = {"int8_project": shapes}
    short = time_int8_project(torch, quant, 5, 768, 3072, gen)   # padded to 17 rows
    log(f"int8_project M=5 768->3072 (padded to 17 rows): equal; {short['ms']:.4f} ms")
    out["neo"] = int8_encode(torch, model, cfg, tok, texts, docs, doc_s, "neo", card)
    out["beir_int8_ndcg10"] = phase_beir(np.random.default_rng(SEED + 14), card,
                                         ["--quantize", "int8"])
    return out


IVF_CENTERS, IVF_SPREAD = 4096, 0.75
IVF_NPROBES = (8, 32, 64)


def ivf_corpus(torch, gen, n: int, d: int, nq: int):
    """A Gaussian mixture drawn on the card: IVF_CENTERS unit centres, noise of
    norm ~IVF_SPREAD (σ = spread/√d), rows normalised; nq queries are
    documents of the first chunk plus N(0, 0.02²) noise. Yields fp32 host
    chunks of 2^20 rows and keeps the normalised rows in bf16 on the card
    (the exact oracle's corpus)."""
    mu = torch.randn((IVF_CENTERS, d), generator=gen, device="cuda")
    mu /= mu.norm(dim=1, keepdim=True)
    rows = torch.empty((n, d), dtype=torch.bfloat16, device="cuda")
    chunks, queries = [], None
    for s in range(0, n, 1 << 20):
        m = min(1 << 20, n - s)
        a = torch.randint(0, IVF_CENTERS, (m,), generator=gen, device="cuda")
        x = mu[a] + (IVF_SPREAD / d ** 0.5) * torch.randn((m, d), generator=gen, device="cuda")
        x /= x.norm(dim=1, keepdim=True)
        if queries is None:
            pick = torch.randint(0, m, (nq,), generator=gen, device="cuda")
            queries = x[pick] + 0.02 * torch.randn((nq, d), generator=gen, device="cuda")
        rows[s:s + m] = x.to(torch.bfloat16)
        chunks.append(x.cpu().numpy())
        del x, a
    return rows, chunks, queries.cpu().numpy()


def p50_ms(fn, reps: int) -> float:
    fn()
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        lat.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(lat))


def phase_ivf(torch, mips, gen, corpus, card) -> dict:
    """The IVF index at NQ's corpus size, int8 storage, auto-K: build
    seconds, K, overflow share; recall@10 against K5's exact top-10 of the
    same rows (bf16) and against the exact scan of the index's own int8
    rows, and p50 of search_embeddings at Q=1 and Q=64 for each nprobe,
    beside K5's exact search; a save/load round trip bit for bit;
    then `cli.serve --index ivf --quantize int8 --quantize-index int8` over
    HTTP on the serve phase's corpus."""
    import os
    import tempfile

    from sgpt_tpu_torch.index import DenseIndex
    from sgpt_tpu_torch.index_ivf import IVFIndex
    from sgpt_tpu_torch.ops.pooling import normalize

    d, nq = 768, 64
    t0 = time.perf_counter()
    rows, chunks, q = ivf_corpus(torch, gen, NQ_ROWS, d, nq)
    gen_s = time.perf_counter() - t0
    index = IVFIndex(d, quantize="int8", device="cuda")
    t0 = time.perf_counter()
    for s, c in enumerate(chunks):
        index.add(c, ids=[str(i) for i in range(s << 20, (s << 20) + len(c))])
    add_s = time.perf_counter() - t0
    del chunks
    t0 = time.perf_counter()
    index.build()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    K, ov = index.selected_k, index._overflow_count / len(index)
    c_pad = int(index._blocks.shape[1])
    log(f"ivf: {NQ_ROWS} x {d} mixture rows ({IVF_CENTERS} centres, spread {IVF_SPREAD}) drawn "
        f"in {gen_s:.1f} s; add (host: normalise, int8) {add_s:.1f} s; build {build_s:.1f} s: "
        f"auto K {K}, C_pad {c_pad}, overflow {index._overflow_count} rows "
        f"({100 * ov:.2f} %) ({card})")
    assert len(index) == NQ_ROWS and K >= 8
    qd = normalize(torch.from_numpy(q).to("cuda", torch.bfloat16))
    mips.launches = 0
    exact_ids = mips.mips_topk(qd, rows, NQ_ROWS, 10)[1].cpu().numpy()
    # the exact scan of the index's own int8 rows (block-max, the exact index's scan)
    int8_rows, int8_scales = index._rebuild_host_rows()
    exact8 = DenseIndex(d, quantize="int8", device="cuda")
    exact8._chunks, exact8._scale_chunks = [int8_rows], [int8_scales]
    exact8._ids, exact8._count = list(index._ids), NQ_ROWS
    exact8.build()
    del int8_rows, int8_scales
    exact8_ids = exact8.search_embeddings(q, k=10)[1]
    del exact8
    k5_ms = {1: p50_ms(lambda: mips.mips_topk(qd[:1], rows, NQ_ROWS, 10)[1].cpu(), 10),
             nq: p50_ms(lambda: mips.mips_topk(qd, rows, NQ_ROWS, 10)[1].cpu(), 10)}
    oracle_launches = mips.launches
    out = {"build_s": build_s, "add_s": add_s, "k": K, "c_pad": c_pad, "overflow_share": ov,
           "k5_exact_ms_q1": k5_ms[1], "k5_exact_ms_q64": k5_ms[nq],
           "oracle_k5_launches": oracle_launches}
    for nprobe in IVF_NPROBES:
        _, hits = index.search_embeddings(q, k=10, nprobe=nprobe)
        recall = float(np.mean([len({int(i) for i in h} & set(e.tolist())) / 10
                                for h, e in zip(hits, exact_ids)]))
        recall8 = float(np.mean([len(set(h) & set(e)) / 10 for h, e in zip(hits, exact8_ids)]))
        ms1 = p50_ms(lambda: index.search_embeddings(q[:1], k=10, nprobe=nprobe), 20)
        ms64 = p50_ms(lambda: index.search_embeddings(q, k=10, nprobe=nprobe), 10)
        out[f"nprobe{nprobe}"] = {"recall10": recall, "recall10_int8_exact": recall8,
                                  "p50_ms_q1": ms1, "p50_ms_q64": ms64}
        log(f"ivf nprobe {nprobe}: recall@10 {recall:.4f} against K5's exact top-10 of the bf16 "
            f"rows, {recall8:.4f} against the exact scan of the index's own int8 rows; "
            f"search_embeddings p50 {ms1:.3f} ms at Q=1, {ms64:.3f} ms at Q=64 (host clock); "
            f"K5 exact {k5_ms[1]:.3f} / {k5_ms[nq]:.3f} ms ({card})")
    assert out["nprobe32"]["recall10"] >= 0.9, out["nprobe32"]
    del rows
    with tempfile.TemporaryDirectory(dir="build") as tmp:
        t0 = time.perf_counter()
        index.save(os.path.join(tmp, "ivf.npz"))
        again = IVFIndex.load(os.path.join(tmp, "ivf.npz"), device="cuda")
        rt_s = time.perf_counter() - t0
        a_v, a_i = index.search_embeddings(q, k=10)
        b_v, b_i = again.search_embeddings(q, k=10)
        assert a_i == b_i and all(np.array_equal(x, y) for x, y in zip(a_v, b_v)), \
            "ivf: the save/load round trip changed the results"
        del again
    log(f"ivf: save + load of the index in {rt_s:.1f} s; the same top-10 lists and scores "
        f"bit for bit at Q=64")
    out["save_load_s"] = rt_s
    del index
    torch.cuda.empty_cache()
    out["serve"] = phase_ivf_serve(torch, corpus, card)
    return out


def phase_ivf_serve(torch, corpus, card) -> dict:
    """`cli.serve --index ivf --quantize int8 --quantize-index int8` (full-width
    GPT-Neo-125M, random weights) on the serve phase's 4,096 documents
    (--corpus), POST /search from 8 threads: p50, p99; the answers equal a
    direct search_embeddings of the same queries."""
    import http.client
    import os
    import tempfile
    import threading

    from sgpt_tpu_torch.cli import serve as serve_cli
    from sgpt_tpu_torch.index_ivf import IVFIndex
    from sgpt_tpu_torch.ops import quant
    from sgpt_tpu_torch.ops import short_attention as sa

    def post(addr, path, payload):
        conn = http.client.HTTPConnection(*addr, timeout=120)
        try:
            conn.request("POST", path, json.dumps(payload), {"Content-Type": "application/json"})
            r = conn.getresponse()
            return r.status, json.loads(r.read().decode())
        finally:
            conn.close()

    ids = list(corpus)
    with tempfile.TemporaryDirectory(dir="build") as tmp:
        path = os.path.join(tmp, "corpus.jsonl")
        with open(path, "w") as f:
            for i in ids:
                f.write(json.dumps({"_id": i, **corpus[i]}) + "\n")
        t0 = time.perf_counter()
        server, service = serve_cli.build_server(serve_cli.parse_args([
            "--modelname", "125m", "--randominit", "--device", "cuda", "--port", "0",
            "--index", "ivf", "--quantize", "int8", "--quantize-index", "int8",
            "--corpus", path]))
        start_s = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        index = service.index
        assert isinstance(index, IVFIndex) and index.quantize == "int8"
        assert quant.is_quantized_model(service.engine.model)
        addr = server.server_address[:2]
        texts = [(corpus[i]["title"] + " " + corpus[i]["text"]).strip() for i in ids]
        queries = [" ".join(t.split()[:8]) for t in texts[::len(texts) // 64]][:64]
        lat, answers, errors = {}, {}, []

        def client(t):
            try:
                for j in range(8):
                    n = t * 8 + j
                    t1 = time.perf_counter()
                    status, body = post(addr, "/search", {"queries": [queries[n]], "k": 10})
                    lat[n] = time.perf_counter() - t1
                    assert status == 200, body
                    answers[n] = body["results"][0]
            except Exception as e:  # reported below
                errors.append(e)

        quant.launches = sa.launches = 0
        threads = [threading.Thread(target=client, args=(t,)) for t in range(8)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        assert not errors, errors
        launches, k1 = quant.launches, sa.launches
        vals, want = index.search_embeddings(service.engine.encode(queries, is_query=True), k=10)
        for n in range(len(queries)):
            assert [h["id"] for h in answers[n]] == want[n], n
            np.testing.assert_allclose([h["score"] for h in answers[n]], vals[n], rtol=0,
                                       atol=1e-6)
        ms = 1e3 * np.array([lat[n] for n in range(len(queries))])
        out = {"p50_ms": float(np.median(ms)), "p99_ms": float(np.percentile(ms, 99)),
               "qps": len(queries) / wall, "start_s": start_s, "k": index.selected_k,
               "int_mm_launches": launches, "k1_launches": k1}
        log(f"ivf serve: --index ivf --quantize int8 --quantize-index int8, {len(ids)} docs "
            f"(auto K {index.selected_k}, nprobe {index.nprobe}), started in {start_s:.1f} s; "
            f"{len(queries)} POST /search from 8 threads: p50 {out['p50_ms']:.2f} ms, p99 "
            f"{out['p99_ms']:.2f} ms, {out['qps']:.1f} queries/s; _int_mm launches {launches}, "
            f"K1 {k1}; answers equal a direct search_embeddings ({card})")
        assert launches > 0 and k1 > 0
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=10)
    return out


# ---------------------------------------------------------------------------
# The serving meshes: a (dp, tp) mesh of one card named twice, so that every
# shard's kernels launch; it checks a mesh's results and measures its
# per-shard overhead, not its scaling across cards.

MESH_DEVICES = ["cuda:0", "cuda:0"]
MESH_SHAPES = [(2, 1), (1, 2), (2, 2)]
MESH_COS_MIN = 0.999      # a mesh's bf16 embeddings against the meshless engine's, per row
MESH_SPEARMAN_MIN = 0.99  # a mesh's bf16 CE scores against the meshless ranker's
MESH_GPTJ_TEXTS = 256     # GPT-J-6B's tp=2 encode (cut from the slice's 1,280 for time)
MESH_CE_PAIRS = 512       # the short mix's pairs reranked on each mesh (cut from 3,200)


def counted(obj, name: str) -> list:
    """Count the calls of obj.name (an instance's method) in a list's
    length: the dispatches a mesh path makes."""
    calls, fn = [], getattr(obj, name)

    def wrapper(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)
    setattr(obj, name, wrapper)
    return calls


def phase_mesh(torch, sa, model, cfg, tok, texts, docs, doc_s, corpus, kernel_times,
               card) -> dict:
    """The serving paths on meshes of the one card named twice (dp 2, tp 2,
    dp 2 × tp 2): GPT-Neo-125M's encode of the slice's texts held to the
    meshless engine's (cosine per row), K1 = L × dp × tp × batches; K1 at
    the tp shard's shape (H 6) against its plain version, timed beside the
    H 12 launch; GPT-J-6B at tp 2 (H/tp 8, Dh 256) against its meshless
    encode; a DenseIndex and an IVFIndex on dp 2 over the search documents
    (exact: the meshless scan's top-10; IVF at nprobe = K: the same); the
    CE on dp 2 and tp 2 (Spearman against the meshless ranker, K1 = L × dp
    × tp × dispatches); `cli.serve --device cuda:0,cuda:0 --dp 2` answering
    /search and /rerank as its service does directly."""
    import http.client
    import os
    import tempfile
    import threading

    from sgpt_tpu_torch.cli import serve as serve_cli
    from sgpt_tpu_torch.crossencoder import CrossEncoderRanker
    from sgpt_tpu_torch.encoder import EmbeddingEngine
    from sgpt_tpu_torch.evaluation import spearman
    from sgpt_tpu_torch.index import DenseIndex
    from sgpt_tpu_torch.index_ivf import IVFIndex
    from sgpt_tpu_torch.models import Decoder, gpt_j_6b
    from sgpt_tpu_torch.parallel import RowShards, ShardedDecoder, make_mesh

    L = cfg.num_layers
    out = {"launches": {}}
    kw = dict(specb=True, max_seq_len=300, batch_size=64, normalize_embeddings=True)

    # GPT-Neo-125M: the slice's encode on each mesh shape
    for dp, tp in MESH_SHAPES:
        mesh = make_mesh(dp=dp, tp=tp, devices=MESH_DEVICES[:1] * (dp * tp))
        engine = EmbeddingEngine(model, cfg, tok, mesh=mesh, **kw)
        engine.encode(texts[:64])   # warm the shapes' matmul plans
        batches = counted(engine, "_embed")
        torch.cuda.synchronize()
        sa.launches = 0
        t0 = time.perf_counter()
        got = engine.encode(texts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k1 = sa.launches
        cos = cosine(got, docs)
        key = f"neo_dp{dp}_tp{tp}"
        out[key] = {"emb_per_s": len(texts) / wall, "vs_meshless": doc_s / wall,
                    "cos_min": float(cos.min()), "batches": len(batches)}
        out["launches"][key] = k1
        log(f"mesh GPT-Neo-125M dp={dp} tp={tp} ({' '.join(MESH_DEVICES[:1] * dp * tp)}): "
            f"{len(texts)} texts in {wall:.3f} s, {len(texts) / wall:.1f} emb/s "
            f"({doc_s / wall:.3f} x meshless); {len(batches)} batches, K1 launches {k1} = "
            f"{L} x {dp} x {tp} x {len(batches)}; cosine to the meshless rows min "
            f"{cos.min():.6f} ({card})")
        assert isinstance(engine.model, ShardedDecoder) and len(engine.model.groups) == dp
        assert k1 == L * dp * tp * len(batches) > 0, (key, k1, len(batches))
        assert np.isfinite(got).all() and cos.min() >= MESH_COS_MIN, (key, cos.min())
        del engine

    # K1 at a tp shard's heads (H 6 of 12) against its plain version
    args, _ = attention_inputs(torch, np.random.default_rng(SEED + 40), 64, 300, 6, 64,
                               torch.bfloat16)
    g = sa.short_attention(*args, 1.0, 0, 6, False).float()
    w = sa.short_attention_reference(*args, scale=1.0, window=0, H=6, use_alibi=False).float()
    err = (g - w).abs()
    assert (err - BF16_RTOL * w.abs()).max().item() <= BF16_ATOL, "K1 at the tp shard's shape"
    out["k1_tp_shard"] = {"max_abs_err": err.max().item(),
                          **time_k1(torch, sa, "tp shard ", args, 6, 1.0, 0)}
    h12 = kernel_times[0][0]
    log(f"mesh K1 tp shard B=64 T=300 H=6 Dh=64 bf16: max_abs_err {err.max().item():.3e}; "
        f"{out['k1_tp_shard']['ms']:.4f} ms beside {h12:.4f} ms at H=12 "
        f"({out['k1_tp_shard']['ms'] / h12:.3f} x) ({card})")
    del args, g, w, err

    # GPT-J-6B at tp 2: the width the JAX decoder shards K1 for
    gcfg = gpt_j_6b().replace(dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    gptj = Decoder(gcfg, device="cuda", generator=torch.Generator("cuda").manual_seed(SEED),
                   lm_head=("w", "b"))
    gtok = type(tok)(gcfg.vocab_size)
    sub = texts[:: len(texts) // MESH_GPTJ_TEXTS][:MESH_GPTJ_TEXTS]
    rates = {}
    for name, mesh in (("meshless", None), ("tp2", make_mesh(dp=1, tp=2,
                                                                devices=MESH_DEVICES))):
        engine = EmbeddingEngine(gptj, gcfg, gtok, mesh=mesh,
                                 device=None if mesh is not None else "cuda", **kw)
        engine.encode(sub[:64])
        batches = counted(engine, "_embed")
        torch.cuda.synchronize()
        sa.launches = 0
        t0 = time.perf_counter()
        rates[name] = (engine.encode(sub), time.perf_counter() - t0, sa.launches, len(batches))
        del engine
        torch.cuda.empty_cache()
    (ref, ref_s, _, _), (got, got_s, k1, nb) = rates["meshless"], rates["tp2"]
    cos = cosine(got, ref)
    out["gptj_tp2"] = {"emb_per_s": len(sub) / got_s, "meshless_emb_per_s": len(sub) / ref_s,
                       "vs_meshless": ref_s / got_s, "cos_min": float(cos.min()),
                       "batches": nb, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    out["launches"]["gptj_tp2"] = k1
    log(f"mesh GPT-J-6B tp=2 (H/tp 8, Dh 256): {len(sub)} texts at {len(sub) / got_s:.1f} "
        f"emb/s against {len(sub) / ref_s:.1f} meshless ({ref_s / got_s:.3f} x); K1 "
        f"launches {k1} = {gcfg.num_layers} x 2 x {nb}; cosine min {cos.min():.6f} ({card})")
    assert k1 == gcfg.num_layers * 2 * nb > 0 and cos.min() >= MESH_COS_MIN, (k1, cos.min())
    del gptj, rates, ref, got
    torch.cuda.empty_cache()

    # search on dp 2: the exact scan and the IVF index over the search documents
    ids = list(corpus)
    flat_engine = EmbeddingEngine(model, cfg, tok, device="cuda", **kw)
    demb = flat_engine.encode_corpus([corpus[i] for i in ids])
    qemb = flat_engine.encode([(corpus[i]["title"] + " " + corpus[i]["text"]).strip()
                               for i in ids[:256]], is_query=True)
    mesh = make_mesh(dp=2, tp=1, devices=MESH_DEVICES)
    flat = DenseIndex(cfg.hidden_size, device="cuda")
    sharded = DenseIndex(cfg.hidden_size, mesh=mesh)
    for idx in (flat, sharded):
        idx.add(demb, ids=ids)
        idx.build()
    assert isinstance(sharded._corpus, RowShards) and len(sharded._corpus.pieces) == 2
    (fv, fi), (sv, si) = flat.search_embeddings(qemb, k=10), sharded.search_embeddings(qemb, k=10)
    err = max(float(np.abs(a - b).max()) for a, b in zip(fv, sv))
    differ = sum(a != b for a, b in zip(fi, si))
    for n in range(len(fi)):   # a differing id sits on a near-tie: its own score is the same
        if fi[n] != si[n]:
            np.testing.assert_allclose(rescore(torch, flat, qemb[n], si[n]), fv[n], atol=1e-5,
                                       rtol=0, err_msg=f"query {n}")
    assert err <= 1e-5, err
    # IVF: at nprobe = K the sharded probe is exact, the meshless index's
    # answer on the same layout; below K it probes each row block's own best
    # clusters. The same layout: the meshless index's, loaded onto the mesh.
    # Two builds may lay the rows out differently (k-means sums with atomics
    # on the card), and a row's score depends on where it lies, as in JAX:
    # the probe scores it against the query rounded to the stored dtype, the
    # overflow scan against the fp32 query. The mesh's own build is logged
    # beside.
    ivfs = [IVFIndex(cfg.hidden_size, n_clusters=32, device="cuda"),
            IVFIndex(cfg.hidden_size, n_clusters=32, mesh=mesh)]
    for idx in ivfs:
        idx.add(demb, ids=ids)
        idx.build()
    with tempfile.TemporaryDirectory() as d:
        ivfs[0].save(os.path.join(d, "ivf.npz"))
        loaded = IVFIndex.load(os.path.join(d, "ivf.npz"), mesh=mesh)
    (wv, wi), (iv, ii), (bv, bi) = (idx.search_embeddings(qemb, k=10, nprobe=32)
                                    for idx in (ivfs[0], loaded, ivfs[1]))
    ivf_err = max(float(np.abs(a - b).max()) for a, b in zip(wv, iv))
    ivf_differ = sum(a != b for a, b in zip(wi, ii))
    build_err = max(float(np.abs(a - b).max()) for a, b in zip(wv, bv))
    build_differ = sum(a != b for a, b in zip(wi, bi))
    recall8 = [np.mean([len(set(a) & set(b)) / 10 for a, b in
                        zip(wi, idx.search_embeddings(qemb, k=10, nprobe=8)[1])])
               for idx in ivfs]
    out["search"] = {"dense_max_abs_err": err, "dense_lists_differ": differ,
                     "ivf_nprobe_k_max_abs_err": ivf_err, "ivf_nprobe_k_lists_differ": ivf_differ,
                     "ivf_own_build_nprobe_k_max_abs_err": build_err,
                     "ivf_own_build_nprobe_k_lists_differ": build_differ,
                     "ivf_own_build_overflow": [i._overflow_count for i in ivfs],
                     "ivf_recall10_nprobe8": float(recall8[1]),
                     "ivf_recall10_nprobe8_meshless": float(recall8[0])}
    log(f"mesh search dp=2 over {len(ids)} documents, {len(qemb)} queries: DenseIndex max "
        f"|score diff| {err:.3e} to the meshless scan ({differ} lists differ on a near-tie); "
        f"IVFIndex (K 32, overflow {loaded._overflow_count}) on the meshless layout at nprobe "
        f"32 max |diff| {ivf_err:.3e} to the meshless IVF ({ivf_differ} lists differ); the "
        f"mesh's own build (overflow {ivfs[1]._overflow_count}) max |diff| {build_err:.3e} "
        f"({build_differ} lists differ); recall@10 at nprobe 8 {recall8[1]:.4f} (4 clusters a "
        f"row block), meshless {recall8[0]:.4f} ({card})")
    assert isinstance(loaded._centroids, RowShards)
    assert ivf_err <= 1e-5 and ivf_differ == 0, (ivf_err, ivf_differ)
    del flat, sharded, ivfs, loaded, flat_engine

    # the CE on dp 2 and on tp 2, the short mix
    short = ce_mix(np.random.default_rng(SEED + 8))[2][:MESH_CE_PAIRS]
    rkw = dict(batch_size=16, max_length=2048)
    flat_ranker = CrossEncoderRanker(model, cfg, tok, device="cuda", **rkw)
    flat_ranker.predict(short[:32])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = np.asarray(flat_ranker.predict(short))
    flat_wall = time.perf_counter() - t0
    out["ce_meshless_pairs_per_s"] = len(short) / flat_wall
    for dp, tp in ((2, 1), (1, 2)):
        ranker = CrossEncoderRanker(model, cfg, tok,
                                    mesh=make_mesh(dp=dp, tp=tp, devices=MESH_DEVICES), **rkw)
        ranker.predict(short[:32])
        dispatches = counted(ranker, "_dispatch")
        torch.cuda.synchronize()
        sa.launches = 0
        t0 = time.perf_counter()
        got = np.asarray(ranker.predict(short))
        wall = time.perf_counter() - t0
        k1 = sa.launches
        rho = spearman(got, want)
        key = f"ce_dp{dp}_tp{tp}"
        out[key] = {"pairs_per_s": len(short) / wall, "vs_meshless": flat_wall / wall,
                    "spearman": float(rho),
                    "max_abs_diff": float(np.abs(got - want).max()),
                    "dispatches": len(dispatches)}
        out["launches"][key] = k1
        log(f"mesh ce dp={dp} tp={tp}: {len(short)} short pairs, {len(short) / wall:.1f} "
            f"pairs/s ({flat_wall / wall:.3f} x meshless); Spearman to the meshless scores {rho:.6f}, max |diff| "
            f"{out[key]['max_abs_diff']:.4f}; K1 launches {k1} = {L} x {dp} x {tp} x "
            f"{len(dispatches)} ({card})")
        assert np.isfinite(got).all() and rho >= MESH_SPEARMAN_MIN, (key, rho)
        assert k1 == L * dp * tp * len(dispatches) > 0, (key, k1)
        del ranker

    # cli.serve on the mesh: /search and /rerank over HTTP
    def post(addr, path, payload):
        conn = http.client.HTTPConnection(*addr, timeout=120)
        try:
            conn.request("POST", path, json.dumps(payload), {"Content-Type": "application/json"})
            r = conn.getresponse()
            return r.status, json.loads(r.read().decode())
        finally:
            conn.close()

    serve_ids = ids[:1024]
    with tempfile.TemporaryDirectory(dir="build") as tmp:
        path = os.path.join(tmp, "corpus.jsonl")
        with open(path, "w") as f:
            for i in serve_ids:
                f.write(json.dumps({"_id": i, **corpus[i]}) + "\n")
        t0 = time.perf_counter()
        server, service = serve_cli.build_server(serve_cli.parse_args([
            "--modelname", "125m", "--randominit", "--device", ",".join(MESH_DEVICES),
            "--dp", "2", "--port", "0", "--rerank", "--corpus", path]))
        start_s = time.perf_counter() - t0
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        assert isinstance(service.engine.model, ShardedDecoder)
        assert isinstance(service.index._corpus, RowShards) and service.ranker.mesh is not None
        addr = server.server_address[:2]
        queries = [" ".join(corpus[i]["text"].split()[:8]) for i in serve_ids[::128]]
        sa.launches = 0
        status, body = post(addr, "/search", {"queries": queries, "k": 5})
        assert status == 200, body
        status2, body2 = post(addr, "/rerank", {"queries": queries[:2], "k": 3, "first_k": 10})
        assert status2 == 200, body2
        k1 = sa.launches
        want_s = service.search(queries, k=5)
        assert [[h["id"] for h in r] for r in body["results"]] == \
            [[h["id"] for h in r] for r in want_s]
        want_r = service.rerank(queries[:2], k=3, first_k=10)
        assert [[h["id"] for h in r] for r in body2["results"]] == \
            [[h["id"] for h in r] for r in want_r]
        out["serve"] = {"start_s": start_s, "docs": len(serve_ids)}
        out["launches"]["serve"] = k1
        log(f"mesh serve --device {','.join(MESH_DEVICES)} --dp 2 --rerank: {len(serve_ids)} "
            f"documents indexed at start ({start_s:.1f} s, warm-up included); POST /search "
            f"({len(queries)} queries) and POST /rerank (2 queries, first_k 10) answer what the "
            f"service answers directly; K1 launches {k1} ({card})")
        assert k1 > 0
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=10)
    out["k1_launches"] = sum(out["launches"].values())
    return out


# ---------------------------------------------------------------------------
# Training under a mesh (dp x tp) and sequence parallelism (ring attention),
# on the one card named 2 and 4 times.

MTRAIN_B, MTRAIN_STEPS = 32, 3      # the MS MARCO CLI's batch; parity steps at "highest"
MTRAIN_RATE_STEPS = 4               # steps at "default" for the rate (the first is set-up)
MTRAIN_LOSS_RTOL = 2e-4             # tests/test_trainer_mesh.py
MTRAIN_PARAM_RTOL, MTRAIN_PARAM_ATOL = 3e-3, 2e-5
SP_N, SP_T = 2, 2048                # the sp mesh (cuda:0 twice) and the long documents' T
SP_DOCS, SP_PAIRS, SP_TSDAE = 64, 4, 4
SP_COS_MIN, SP_LOSS_ATOL, SP_PARAM_ATOL = 0.9999, 1e-4, 2e-4  # tests/test_sequence_parallel.py


def mesh_fit(torch, sa, fa, model, cfg, tok, tc, batches, mesh) -> dict:
    """`ContrastiveTrainer(mesh=mesh).fit` (meshless with mesh=None) from
    `model`'s weights (a mesh trainer shards a copy; the meshless one trains
    a copy): losses, the unsharded parameters, the launches, the wall time
    of each step, and whether every copy of a leaf is bit-equal after."""
    import copy

    from sgpt_tpu_torch.training import ContrastiveTrainer

    stamps = []
    tc = copy.copy(tc)
    tc.log_fn = lambda rec: stamps.append(time.perf_counter())  # float(loss) synchronises
    trainer = ContrastiveTrainer(copy.deepcopy(model) if mesh is None else model, cfg, tok, tc,
                                 mesh=mesh)
    torch.cuda.synchronize()
    sa.launches = sa.bwd_launches = fa.launches = fa.bwd_dq_launches = fa.bwd_dkv_launches = 0
    t0 = time.perf_counter()
    out = trainer.fit(lambda: iter(batches), steps_per_epoch=len(batches))
    torch.cuda.synchronize()
    equal = all(torch.equal(g[0], c) for g in trainer._groups for c in g[1:])
    return {"losses": [h["loss"] for h in out["history"]], "params": out["params"],
            "k1": sa.launches, "k2": sa.bwd_launches, "k3": fa.launches,
            "k4a": fa.bwd_dq_launches, "k4b": fa.bwd_dkv_launches,
            "steps_s": list(np.diff([t0] + stamps)), "copies_equal": equal,
            "copies": sum(len(g) for g in trainer._groups), "leaves": len(trainer._groups)}


def hold_fit(label: str, got: dict, want: dict, card: str) -> dict:
    """A mesh fit against the meshless one: losses within rtol 2e-4,
    parameters within rtol 3e-3, atol 2e-5 (JAX's tolerances), every copy
    of a leaf bit-equal."""
    loss_err = float(np.max(np.abs(np.subtract(got["losses"], want["losses"]))
                            / np.abs(want["losses"])))
    worst = 0.0
    for name, w in want["params"].items():
        g = got["params"][name].float().cpu()
        w = w.float().cpu()
        excess = (g - w).abs() - MTRAIN_PARAM_RTOL * w.abs()
        worst = max(worst, float(excess.max()))
    log(f"{label}: losses {[round(x, 6) for x in got['losses']]} against meshless "
        f"{[round(x, 6) for x in want['losses']]} (max rel {loss_err:.3e}, gate "
        f"{MTRAIN_LOSS_RTOL}); parameters: max |diff| - rtol·|ref| {worst:.3e} (gate atol "
        f"{MTRAIN_PARAM_ATOL}); {got['leaves']} trainable leaves in {got['copies']} copies, "
        f"bit-equal {got['copies_equal']}; launches K1 {got['k1']} K2 {got['k2']} K3 "
        f"{got['k3']} K4a {got['k4a']} K4b {got['k4b']} ({card})")
    assert loss_err <= MTRAIN_LOSS_RTOL, (label, loss_err)
    assert worst <= MTRAIN_PARAM_ATOL, (label, worst)
    assert got["copies_equal"], f"{label}: copies of a leaf differ after the fit"
    return {"loss_max_rel_err": loss_err, "param_max_excess": worst}


def phase_mesh_train(torch, sa, fa, tok, card) -> dict:
    """Training under a (dp, tp) mesh of the one card named 2 or 4 times
    (every shard's K1/K2/K3/K4 launches; correctness and per-shard overhead,
    not scaling): full-width GPT-Neo-125M, the MS MARCO CLI's configuration
    (32 triplets, T=300, SPECB, BitFit, weightedmean, warmuplinear, fp32).
    At "highest", 3 steps on each mesh (dp, tp) = (2, 1), (1, 2), (2, 2)
    and GradCache (chunks of 8) at (2, 2), each held to the meshless run
    from the same weights; K1 = L × dp × tp × 3 towers × steps (GradCache: ×
    chunks and × 2 passes), K2 the same in the backward. At "default" (the
    CLI's TF32) ms/step of each mesh beside the meshless one. Then the long
    context configuration (T=2048, use_flash, GradCache chunks of 8, 16
    triplets) at dp=2 for one step against meshless: K3, K4a and K4b per dp
    row."""
    import dataclasses

    from sgpt_tpu_torch.models import Decoder, gpt_neo
    from sgpt_tpu_torch.parallel import make_mesh
    from sgpt_tpu_torch.training import TrainConfig

    rng = np.random.default_rng(SEED + 50)
    cfg = gpt_neo("125m")   # "highest": the parity runs
    model = Decoder(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
    L = cfg.num_layers
    tc = TrainConfig(lr=2e-4, batch_size=MTRAIN_B, max_seq_len=300, specb=True,
                     freeze_nonbias=True, pooling="weightedmean", scheduler="warmuplinear")
    triplets = synthetic_triplets(rng, MTRAIN_B * MTRAIN_STEPS)
    batches = [triplets[i * MTRAIN_B:(i + 1) * MTRAIN_B] for i in range(MTRAIN_STEPS)]
    out = {"launches": {}}

    def mesh_of(dp, tp):
        return make_mesh(dp=dp, tp=tp, devices=MESH_DEVICES[:1] * (dp * tp))

    want = mesh_fit(torch, sa, fa, model, cfg, tok, tc, batches, None)
    for dp, tp in MESH_SHAPES:
        got = mesh_fit(torch, sa, fa, model, cfg, tok, tc, batches, mesh_of(dp, tp))
        key = f"dp{dp}_tp{tp}"
        out[key] = hold_fit(f"mesh train {key} parity ({MTRAIN_STEPS} steps, \"highest\")",
                            got, want, card)
        n = L * dp * tp * 3 * MTRAIN_STEPS
        assert got["k1"] == got["k2"] == n, (key, got["k1"], got["k2"], n)
        out["launches"][key] = {"k1": got["k1"], "k2": got["k2"]}
    gc = dataclasses.replace(tc, use_gradcache=True, chunk_size=8)
    chunks = MTRAIN_B // 8
    want = mesh_fit(torch, sa, fa, model, cfg, tok, gc, batches, None)
    got = mesh_fit(torch, sa, fa, model, cfg, tok, gc, batches, mesh_of(2, 2))
    out["gradcache_dp2_tp2"] = hold_fit("mesh train dp2_tp2 GradCache chunk 8 parity", got,
                                        want, card)
    n = L * 2 * 2 * 3 * chunks * MTRAIN_STEPS
    assert (got["k1"], got["k2"]) == (2 * n, n), (got["k1"], got["k2"], n)
    out["launches"]["gradcache_dp2_tp2"] = {"k1": got["k1"], "k2": got["k2"]}

    # the rate at the CLI's "default" (TF32 products): ms/step beside meshless
    fast = cfg.replace(matmul_precision="default")
    model.cfg = fast
    rate_batches = (batches * 2)[:MTRAIN_RATE_STEPS]
    rates = {}
    for key, mesh in [("meshless", None)] + [(f"dp{dp}_tp{tp}", mesh_of(dp, tp))
                                             for dp, tp in MESH_SHAPES]:
        r = mesh_fit(torch, sa, fa, model, fast, tok, tc, rate_batches, mesh)
        rates[key] = 1e3 * float(np.median(r["steps_s"][1:]))
        if mesh is not None:
            out["launches"][key]["k1"] += r["k1"]
            out["launches"][key]["k2"] += r["k2"]
    for key, ms in rates.items():
        out.setdefault(key, {})["ms_per_step"] = ms
        out[key]["vs_meshless"] = rates["meshless"] / ms
    log("mesh train rate (\"default\", TF32; batch 32, T=300, BitFit): " + ", ".join(
        f"{k} {ms:.1f} ms/step ({rates['meshless'] / ms:.3f} x meshless)"
        for k, ms in rates.items()) + f" ({card})")
    model.cfg = cfg
    del model
    torch.cuda.empty_cache()

    # long context at dp=2: K3, K4a, K4b per dp row
    lcfg = gpt_neo("125m", use_flash=True)
    lmodel = Decoder(lcfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
    ltc = TrainConfig(lr=2e-4, batch_size=16, max_seq_len=SP_T, specb=True,
                      freeze_nonbias=True, pooling="weightedmean", scheduler="constantlr",
                      use_gradcache=True, chunk_size=8)
    lbatch = [long_triplets(rng, 16)]
    want = mesh_fit(torch, sa, fa, lmodel, lcfg, tok, ltc, lbatch, None)
    torch.cuda.reset_peak_memory_stats()
    got = mesh_fit(torch, sa, fa, lmodel, lcfg, tok, ltc, lbatch, mesh_of(2, 1))
    out["long_dp2"] = hold_fit("mesh train long context dp=2 (T=2048, use_flash, GradCache "
                               "chunk 8, 1 step)", got, want, card)
    n = L * 2 * 3 * 2   # layers × dp rows × towers × chunks
    assert (got["k3"], got["k4a"], got["k4b"], got["k1"], got["k2"]) == (2 * n, n, n, 0, 0), got
    out["long_dp2"].update(ms=1e3 * got["steps_s"][0], meshless_ms=1e3 * want["steps_s"][0],
                           peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    out["launches"]["long_dp2"] = {k: got[k] for k in ("k3", "k4a", "k4b")}
    del lmodel
    torch.cuda.empty_cache()
    for k in ("k1", "k2", "k3", "k4a", "k4b"):
        out[k] = sum(v.get(k, 0) for v in out["launches"].values())
    return out


def phase_sp(torch, tok, card) -> dict:
    """Sequence parallelism over a mesh of `cuda:0` named twice (ring
    attention: T=2048 as two shards of 1,024; no attention kernel runs),
    full-width GPT-Neo-125M with use_flash, fp32 at "highest", against the
    meshless flash paths (K3, K4a/K4b): the engine's encode of 64 long
    documents (cosine per row ≥ 0.9999), one contrastive step on 4 pairs at
    a constant lr (loss within 1e-4, parameters within atol 2e-4, and moved
    by more than twice that) and one TSDAE step on 4
    sentences (loss within 1e-4), each path's time and peak memory."""
    import copy

    from sgpt_tpu_torch.encoder import EmbeddingEngine
    from sgpt_tpu_torch.models import Decoder, gpt_neo
    from sgpt_tpu_torch.ops import flash_attention as fa
    from sgpt_tpu_torch.ops import short_attention as sa
    from sgpt_tpu_torch.parallel import make_mesh
    from sgpt_tpu_torch.training import ContrastiveTrainer, TrainConfig, TSDAETrainer

    rng = np.random.default_rng(SEED + 51)
    cfg = gpt_neo("125m", use_flash=True)
    model = Decoder(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
    sp = make_mesh(dp=SP_N, tp=1, devices=MESH_DEVICES[:1] * SP_N)
    docs = [d for t in long_triplets(rng, SP_DOCS // 2) for d in t[1:]]
    out = {}

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sa.launches = sa.bwd_launches = fa.launches = fa.bwd_dq_launches = 0
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2**30, (
            sa.launches + sa.bwd_launches, fa.launches + fa.bwd_dq_launches)

    kw = dict(max_seq_len=SP_T, batch_size=8, normalize_embeddings=True)
    (flat, flat_s, flat_gib, flat_k), (ring, ring_s, ring_gib, ring_k) = (
        timed(lambda: EmbeddingEngine(model, cfg, tok, device=MESH_DEVICES[0], **kw).encode(docs)),
        timed(lambda: EmbeddingEngine(model, cfg, tok, sp_mesh=sp, **kw).encode(docs)))
    cos = cosine(ring, flat)
    out["encode"] = {"cos_min": float(cos.min()), "s": ring_s, "meshless_s": flat_s,
                     "peak_gib": ring_gib, "meshless_peak_gib": flat_gib}
    log(f"sp encode {len(docs)} documents (T up to {SP_T}, sp={SP_N}): cosine to the meshless "
        f"flash rows min {cos.min():.7f} (gate {SP_COS_MIN}); {ring_s:.2f} s, peak "
        f"{ring_gib:.2f} GiB against meshless {flat_s:.2f} s, {flat_gib:.2f} GiB; kernel "
        f"launches sp {ring_k}, meshless (K1+K2, K3+K4a) {flat_k} ({card})")
    assert np.isfinite(ring).all() and cos.min() >= SP_COS_MIN, cos.min()
    assert ring_k == (0, 0) and flat_k[1] > 0, (ring_k, flat_k)

    batch = [(t[0], t[1]) for t in long_triplets(rng, SP_PAIRS)]
    # a constant lr: the default warmup's first step has lr 0 and would move
    # no parameter, leaving the ring's backward unchecked
    tc = TrainConfig(batch_size=SP_PAIRS, max_seq_len=SP_T, lr=1e-3, epochs=1,
                     scheduler="constantlr")
    fits = {}
    for key, mesh in (("meshless", None), ("sp", sp)):
        trainer = ContrastiveTrainer(copy.deepcopy(model), cfg, tok, tc, sp_mesh=mesh)
        res, s, gib, k = timed(lambda: trainer.fit(lambda: iter([batch]), steps_per_epoch=1))
        fits[key] = (res["history"][0]["loss"], res["params"], s, gib, k)
        del trainer
    (wl, wp, ws, wg, wk), (gl, gp, gs, gg, gk) = fits["meshless"], fits["sp"]
    diffs = {n: float((gp[n] - w).abs().max()) for n, w in wp.items()}
    worst_leaf = max(diffs, key=diffs.get)
    worst = diffs[worst_leaf]
    near = sum(int(((gp[n] - w).abs() > SP_PARAM_ATOL / 2).sum()) for n, w in wp.items())
    start = model.state_dict()
    moved = max(float((w - start[n]).abs().max()) for n, w in wp.items())
    out["train"] = {"loss_abs_err": abs(gl - wl), "param_max_abs_err": worst,
                    "param_worst_leaf": worst_leaf, "params_over_half_gate": near,
                    "param_max_move": moved, "s": gs, "meshless_s": ws, "peak_gib": gg,
                    "meshless_peak_gib": wg}
    log(f"sp train step ({SP_PAIRS} pairs, T={SP_T}, full fine-tuning, constant lr 1e-3): "
        f"loss {gl:.7f} against meshless flash {wl:.7f} (|diff| {abs(gl - wl):.3e}, gate "
        f"{SP_LOSS_ATOL}); parameters max |diff| {worst:.3e} (gate {SP_PARAM_ATOL}) in "
        f"{worst_leaf}, {near} elements over half the gate; the step moved them up to "
        f"{moved:.3e} (gate > {2 * SP_PARAM_ATOL}); {gs:.2f} s, peak "
        f"{gg:.2f} GiB against {ws:.2f} s, {wg:.2f} GiB; launches sp {gk}, meshless {wk} "
        f"({card})")
    assert abs(gl - wl) <= SP_LOSS_ATOL and worst <= SP_PARAM_ATOL, (gl, wl, worst)
    assert moved > 2 * SP_PARAM_ATOL, moved   # the gate above held a step that moved
    assert gk == (0, 0), gk
    del fits, wp, gp

    pairs = [(" ".join(d.split()[::2]), d) for d in docs[:SP_TSDAE]]
    losses = {}
    for key, mesh in (("meshless", None), ("sp", sp)):
        trainer = TSDAETrainer(copy.deepcopy(model), cfg, tok, max_seq_len=SP_T, lr=1e-3,
                               sp_mesh=mesh)
        batch = trainer.prep_batch(pairs)
        losses[key] = timed(lambda: float(trainer.step(batch)))
        del trainer, batch
    (wl, ws, wg, wk), (gl, gs, gg, gk) = losses["meshless"], losses["sp"]
    out["tsdae"] = {"loss_abs_err": abs(gl - wl), "s": gs, "meshless_s": ws, "peak_gib": gg,
                    "meshless_peak_gib": wg}
    log(f"sp tsdae step ({SP_TSDAE} sentences, T={SP_T}; the decoder pads to "
        f"{(SP_T - 1 + SP_N - 1) // SP_N * SP_N + 1}): loss {gl:.7f} against meshless {wl:.7f} "
        f"(|diff| {abs(gl - wl):.3e}, gate {SP_LOSS_ATOL}); {gs:.2f} s, peak {gg:.2f} GiB "
        f"against {ws:.2f} s, {wg:.2f} GiB; launches sp {gk}, meshless {wk} ({card})")
    assert abs(gl - wl) <= SP_LOSS_ATOL and gk == (0, 0), (gl, wl, gk)
    del model
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The training-objectives slice: TSDAE pretraining and the trainable
# cross-encoder (K1 and K2 fp32 at their shapes), and the search utilities.

TSDAE_T = 75  # train_tsdae's --max_seq_length: the encoder's T; the decoder reads T - 1
TSDAE_CASES = [  # name, B, T, window, all-ones key mask; fp32, H 12, Dh 64 (GPT-Neo-125M)
    ("tsdae-enc", 8, TSDAE_T, 0, False),         # the encoder, on the noisy sentences
    ("tsdae-enc-w256", 8, TSDAE_T, 256, False),  # its local layers
    ("tsdae-dec", 8, TSDAE_T - 1, 0, True),      # the tied decoder: tgt[:, :-1], no mask
    ("tsdae-dec-w256", 8, TSDAE_T - 1, 256, True),
    ("ce-train", 32, 512, 0, False),             # the CE's pair rows at max_length 512
    ("ce-train-w256", 32, 512, 256, False),
    ("ce-default", 2, 2048, 0, False),           # and at the class default 2,048
    ("ce-default-w256", 2, 2048, 256, False),
]
TSDAE_TIMED = ("tsdae-enc", "tsdae-dec", "ce-train", "ce-default")
HEAD_KEYS = ("aten::mm", "aten::addmm")  # the ops whose kernels an LM head's GEMMs are


def phase_tsdae_kernels(torch, sa, rng):
    """K1 and K2 fp32 at the shapes the TSDAE and trainable-CE steps give
    them (`TSDAE_CASES`: T=75 for the encoder, T=74 with an all-ones key mask
    for the decoder, the CE's pair rows at T=512 and 2,048; global and window
    256, GPT-Neo's two layer kinds) against their plain versions: K1 within
    1e-5 + 1e-5·|ref|, K2 by `hold_grads`, on a random output gradient.
    Then the times of `TSDAE_TIMED` (`time_k1`, `time_k2`: kernel, plain,
    SDPA and its backward, bound). Returns the largest error by kernel and
    the times."""
    errs, times = {"k1": 0.0, "k2": 0.0}, {}
    for name, B, T, window, ones in TSDAE_CASES:
        args, _ = case_inputs(torch, rng, B, T, 12, 64, torch.float32, False)
        if ones:
            args[3].fill_(1)
        got = sa.short_attention(*args, 1.0, window, 12, False)
        want = sa.short_attention_reference(*args, scale=1.0, window=window, H=12,
                                            use_alibi=False)
        torch.cuda.synchronize()
        err, _ = hold(torch, f"kernel {name}", got, want, torch.float32)
        g = card_normal(torch, rng, (B, T, 12 * 64), 1.0)
        kw = dict(scale=1.0, window=window, H=12, use_alibi=False)
        got2 = sa.short_attention_bwd(*args, g, **kw)
        want2 = sa.short_attention_bwd_reference(*args, g, **kw)
        torch.cuda.synchronize()
        e2, gate, _ = hold_grads(torch, f"bwd {name}", got2, want2, torch.float32)
        errs["k1"] = max(errs["k1"], err)
        errs["k2"] = max(errs["k2"], *e2)
        log(f"kernel {name:15s} fp32 B={B} T={T} H=12 Dh=64 window={window}"
            f"{', all-ones key mask' if ones else ''}: K1 max_abs_err {err:.3e}; K2 max_abs_err "
            f"dq {e2[0]:.3e} dk {e2[1]:.3e} dv {e2[2]:.3e} ({gate})")
        if name in TSDAE_TIMED:
            times[name] = {"k1": time_k1(torch, sa, f"{name} ", args, 12, 1.0, window),
                           "k2": time_k2(torch, sa, f"{name} ", args, g, 12, 1.0, window)}
        del args, got, want, g, got2, want2
        torch.cuda.empty_cache()
    return errs, times


def profile_train_step(torch, step, label: str, head_dim=None) -> dict:
    """Two training steps (`step()`, which ends on the loss) under
    torch.profiler. The first records device activity alone: device time of
    K1, K2, the GEMMs and the rest, the six longest kernels, and the
    device's busy share of the wall time (host op events would slow the
    step). The second adds the host ops with their shapes, to split off the
    LM head (the GEMM ops, forward and backward, with an operand of
    `head_dim` columns: the vocab) and the log-softmax (forward and
    backward) by the op that launched each kernel."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(step())
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    fam = device_ms(prof, {"K1": K1_KEYS, "K2": ("tf32_rows", "tf32_cols", "rows_kernel",
                                                 "cols_kernel"), "GEMM": GEMM_KEYS})
    total = sum(fam.values())
    if total == 0:
        log(f"{label}: the profiler saw no device time (wall {wall_ms:.1f} ms)")
        return {"profile_wall_ms": wall_ms, "profile_kernel_ms": None}
    top = sorted(((ev.key, (getattr(ev, "self_device_time_total", None)
                            or getattr(ev, "self_cuda_time_total", 0.0)) / 1e3)
                  for ev in prof.key_averages()
                  if str(getattr(ev, "device_type", "")).endswith("CUDA")),
                 key=lambda kv: -kv[1])[:6]
    parts = {"K1": fam["K1"], "K2": fam["K2"], "projection GEMMs": fam["GEMM"]}
    if head_dim:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as ops:
            float(step())
            torch.cuda.synchronize()
        head = gemm_in_head = soft = 0.0
        for e in ops.events():
            kernels = [(k.name, k.duration / 1e3) for k in e.kernels]
            if e.name in HEAD_KEYS and any(head_dim in sh for sh in e.input_shapes if sh):
                head += sum(ms for _, ms in kernels)
                gemm_in_head += sum(ms for n, ms in kernels
                                    if any(key in n.lower() for key in GEMM_KEYS))
            elif "log_softmax" in e.name:
                soft += sum(ms for _, ms in kernels)
        parts["projection GEMMs"] -= gemm_in_head
        parts.update({"LM head": head, "log-softmax": soft})
    parts["rest"] = total - sum(parts.values())
    shares = ", ".join(f"{k} {v:.2f} ms ({v / total:.3f})" for k, v in parts.items())
    log(f"{label}: {total:.2f} ms of kernels in {wall_ms:.2f} ms wall (busy share "
        f"{total / wall_ms:.3f}): {shares}; the six longest kernels: "
        + "; ".join(f"{n[:80]} {ms:.2f} ms" for n, ms in top))
    return {"profile_wall_ms": wall_ms, "profile_kernel_ms": total,
            "busy_share": total / wall_ms, "top_kernels": top,
            **{f"profile_{k.split()[0].lower().replace('-', '_')}_ms": v
               for k, v in parts.items()}}


def synthetic_sentences(rng, n: int, lo: int = 6, hi: int = 40) -> list:
    """`n` sentences of lo to hi - 1 random words (some truncate at T=75)."""
    words = ["".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"), rng.integers(2, 9)))
             for _ in range(5000)]
    return [" ".join(rng.choice(words, int(rng.integers(lo, hi)))) for _ in range(n)]


def run_tsdae_cli(torch, folder: str, sentences: list, extra: list, log_fn=None,
                  snapshot: bool = False):
    """`cli.train_tsdae` at its defaults (batch 8, T=75, del_ratio 0.6,
    weightedmean) on a file of `sentences`, full-width GPT-Neo-125M from
    --randominit on the card: (the CLI's result, the model as built, with
    `snapshot` a copy of its state before training)."""
    import os

    from sgpt_tpu_torch.cli import common, train_tsdae

    path = os.path.join(folder, "sentences.txt")
    with open(path, "w") as f:
        f.write("\n".join(sentences) + "\n")
    built = {}

    def build(*a, **kw):
        built["out"] = common.build_model(*a, **kw)
        if snapshot:
            built["before"] = {n: t.clone() for n, t in built["out"][0].state_dict().items()}
        return built["out"]

    train_tsdae.build_model = build
    try:
        res = train_tsdae.main(train_tsdae.parse_args([
            "--model_name", "125m", "--randominit", "--sentences_path", path,
            "--model_save_path", os.path.join(folder, "out"), "--device", "cuda",
            "--seed", str(SEED), *extra]), log_fn=log_fn)
    finally:
        train_tsdae.build_model = common.build_model
    return res, built["out"][0], built.get("before")


def phase_tsdae(torch, sa, card) -> dict:
    """TSDAE pretraining of full-width GPT-Neo-125M (fp32 at the CLI's
    "default", TF32 products) through `cli.train_tsdae` at its defaults
    (batch 8, --max_seq_length 75, --del_ratio 0.6, weightedmean, lr 3e-5)
    on 56 synthetic sentences of 6-39 words:
      * 7 steps, ms/step over the last 6 (the first warms up), sentences/s,
        peak memory; K1 = K2 = 12 × 2 a step (the encoder at T=75, the tied
        decoder at T=74 with an all-ones key mask); two steps profiled
        (`profile_train_step`): K1, K2, the projection GEMMs, the LM head at
        vocab 50,257 (forward and backward), the log-softmax and the rest;
      * 2 steps with --freezenonbias: only biases and the projections move;
      * at 2 layers and "highest", the card's loss and gradients (every
        parameter and both projections) equal the CPU's (loss within 1e-5
        relative, each gradient within 1e-4 of its norm);
      * the trained model through `save_hf_checkpoint` and
        `hf_loader.load_pretrained` gives the trained model's embeddings
        of 64 sentences bit for bit; seconds to write and to load."""
    import copy
    import shutil
    import tempfile
    from pathlib import Path

    from sgpt_tpu_torch.data import DenoisingBatcher
    from sgpt_tpu_torch.encoder import EmbeddingEngine
    from sgpt_tpu_torch.models import Decoder, gpt_neo
    from sgpt_tpu_torch.models.hf_export import save_hf_checkpoint
    from sgpt_tpu_torch.models.hf_loader import load_pretrained
    from sgpt_tpu_torch.models.precision import matmul_precision
    from sgpt_tpu_torch.tokenization import SimpleTokenizer
    from sgpt_tpu_torch.training import BIAS_NAMES, TSDAETrainer, init_tsdae_params, tsdae_loss

    rng = np.random.default_rng(SEED + 40)
    steps, B = 7, 8
    sentences = synthetic_sentences(rng, steps * B)
    out = {}
    sa.launches = sa.bwd_launches = 0  # every launch of the phase counts in the kernels line
    with tempfile.TemporaryDirectory() as tmp:
        stamps = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res, model, _ = run_tsdae_cli(torch, tmp, sentences, [],
                                      log_fn=lambda r: stamps.append(time.perf_counter()))
        torch.cuda.synchronize()
        cli_launches = (sa.launches, sa.bwd_launches)
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = [h["loss"] for h in res["history"]]
        ms = 1e3 * float(np.median(np.diff(stamps)))
        L = model.cfg.num_layers
        out.update(ms_per_step=ms, sentences_per_s=B / (ms / 1e3), peak_gib=peak, losses=losses)
        log(f"tsdae: {steps} steps (B={B}, T={TSDAE_T}), losses {[round(x, 4) for x in losses]}; "
            f"{ms:.1f} ms/step (median of the last {steps - 1}), {B / (ms / 1e3):.1f} "
            f"sentences/s, peak {peak:.2f} GiB, fp32 at TF32 products (\"default\"); K1 "
            f"{cli_launches[0]}, K2 {cli_launches[1]} launches ({card})")
        assert len(losses) == steps and all(np.isfinite(losses)), losses
        assert cli_launches == (2 * L * steps,) * 2, cli_launches
        trainer = res["trainer"]
        batch = trainer.prep_batch(next(iter(DenoisingBatcher(sentences, B, seed=SEED + 1))))
        out.update(profile_train_step(torch, lambda: trainer.step(batch),
                                      "tsdae profile, one step (TF32)",
                                      head_dim=model.cfg.vocab_size))

        # the trained model exported to an HF checkpoint and reloaded
        tok = SimpleTokenizer(model.cfg.vocab_size)
        texts = synthetic_sentences(rng, 64)
        kw = dict(max_seq_len=TSDAE_T, batch_size=64)
        want = EmbeddingEngine(model, model.cfg, tok, device="cuda", **kw).encode(texts)
        path = Path(__file__).resolve().parent / "build" / "smoke_tsdae_hf"
        shutil.rmtree(path, ignore_errors=True)
        t0 = time.perf_counter()
        save_hf_checkpoint(str(path), model, model.cfg, "neo")
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        weights, cfg = load_pretrained(str(path))
        load_s = time.perf_counter() - t0
        assert cfg.replace(intermediate_size=None, matmul_precision=model.cfg.matmul_precision
                           ) == model.cfg.replace(intermediate_size=None), cfg
        reloaded = Decoder(model.cfg, device="cuda", weights=weights)
        got = EmbeddingEngine(reloaded, model.cfg, tok, device="cuda", **kw).encode(texts)
        shutil.rmtree(path, ignore_errors=True)
        log(f"tsdae export: save_hf_checkpoint {write_s:.2f} s, load_pretrained {load_s:.2f} s; "
            f"the reloaded model's embeddings of {len(texts)} sentences equal the trained "
            f"model's bit for bit: {np.array_equal(got, want)}")
        assert want.shape == (len(texts), model.cfg.hidden_size) and np.isfinite(want).all()
        assert np.array_equal(got, want), np.abs(got - want).max()
        out["export"] = {"write_s": write_s, "load_s": load_s}
        del res, trainer, model, reloaded, weights
        torch.cuda.empty_cache()

        # 2 steps with --freezenonbias: only the biases and the projections move
        res, model, before = run_tsdae_cli(torch, tmp, sentences[:2 * B], ["--freezenonbias"],
                                           snapshot=True)
        init = init_tsdae_params(model.cfg, torch.Generator().manual_seed(SEED), "cuda")
        moved = sorted(n for n, t in model.state_dict().items() if not torch.equal(t, before[n]))
        biases = sorted(n for n in before if n.rsplit(".", 1)[-1] in BIAS_NAMES)
        cp_moved = [k for k, t in res["trainer"].tsdae.items() if not torch.equal(t, init[k])]
        log(f"tsdae --freezenonbias: losses {[round(h['loss'], 4) for h in res['history']]}; "
            f"{len(moved)} of {len(before)} leaves moved, all {len(biases)} biases among "
            f"them: {moved == biases}; projections moved {cp_moved}")
        assert moved == biases and cp_moved == ["w", "b"], (moved, cp_moved)
        del res, model, before
        torch.cuda.empty_cache()

    # card == CPU at 2 layers, "highest": the loss and every gradient
    cfg2 = gpt_neo("125m").replace(num_layers=2)
    cpu = Decoder(cfg2, device="cpu", generator=torch.Generator().manual_seed(SEED + 41))
    gpu = copy.deepcopy(cpu).to("cuda")
    pairs = [ex.texts for ex in next(iter(DenoisingBatcher(sentences, B, seed=SEED + 2)))]
    tok = SimpleTokenizer(cfg2.vocab_size)

    def loss_and_grads(net):
        tr = TSDAETrainer(net, cfg2, tok, seed=SEED)
        with matmul_precision("highest"):
            loss = tsdae_loss(net, tr.tsdae, *tr.prep_batch(pairs))
            loss.backward()
        grads = {n: p.grad.cpu() for n, p in net.named_parameters()}
        grads.update({f"tsdae.{k}": t.grad.cpu() for k, t in tr.tsdae.items()})
        return float(loss.detach()), grads

    on_cpu = loss_and_grads(cpu)
    on_gpu = loss_and_grads(gpu)
    worst = worst_grad(on_gpu[1], on_cpu[1])
    log(f"tsdae parity (2 layers, \"highest\"): loss card {on_gpu[0]:.7f} CPU {on_cpu[0]:.7f} "
        f"(|diff| {abs(on_gpu[0] - on_cpu[0]):.3e}, tolerance 1e-5 relative); "
        f"{len(on_cpu[1])} gradients, worst max|diff|/norm {worst:.3e} (tolerance 1e-4)")
    assert abs(on_gpu[0] - on_cpu[0]) <= 1e-5 * abs(on_cpu[0]) and worst <= 1e-4
    out["parity"] = {"loss_diff": abs(on_gpu[0] - on_cpu[0]), "grad_rel": worst}
    out["k1"], out["k2"] = sa.launches, sa.bwd_launches
    del cpu, gpu
    torch.cuda.empty_cache()
    return out


def ce_train_samples(rng, n: int) -> list:
    """`n` labelled (query, passage) pairs as the MS MARCO cross-encoder
    recipe trains on: queries of 3-11 words, passages of 20-399 words (some
    truncate at 512 tokens), labels 1 or 0 in turn."""
    from sgpt_tpu_torch.data import InputExample

    q = synthetic_sentences(rng, n, 3, 12)
    p = synthetic_sentences(rng, n, 20, 400)
    return [InputExample(texts=(a, b), label=float(i % 2)) for i, (a, b) in enumerate(zip(q, p))]


def phase_ce_train(torch, sa, card) -> dict:
    """The trainable cross-encoder (num_labels 1) on full-width
    GPT-Neo-125M, fp32 at "default" (TF32 products), with the ST MS MARCO
    cross-encoder recipe's batch 32 and max_length 512 (every row pads to
    it) and lr 7e-6:
      * 1 warm-up and 5 timed steps (tokenize, forward, backward, clip,
        AdamW, as `fit` runs them): ms/step, pairs/s, peak memory; K1 = K2 =
        12 a step; one step profiled (K1, K2, GEMMs, the rest; its six
        longest kernels);
      * one `fit` step at the class defaults (batch 16, max_length 2,048):
        its time and peak memory;
      * at 2 layers and "highest", `predict` on the card equals the CPU's
        within 1e-5 on 32 pairs, and `CECorrelationEvaluator`'s score is
        the same (unless two of the CPU's scores lie closer together than
        the two sides differ, where their ranks may swap)."""
    import copy

    from sgpt_tpu_torch.cross_encoder_trainable import (CECorrelationEvaluator,
                                                        CrossEncoderTrainable)
    from sgpt_tpu_torch.models import Decoder, gpt_neo
    from sgpt_tpu_torch.tokenization import SimpleTokenizer

    rng = np.random.default_rng(SEED + 50)
    B, steps = 32, 5
    samples = ce_train_samples(rng, B * (steps + 1))
    cfg = gpt_neo("125m", matmul_precision="default")
    model = Decoder(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
    tok = SimpleTokenizer(cfg.vocab_size)
    L = cfg.num_layers
    ce = CrossEncoderTrainable(model, cfg, tok, num_labels=1, max_length=512, batch_size=B,
                               seed=SEED)
    opt, sched = ce._build_optimizer(steps + 1, 7e-6, 0.1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sa.launches = sa.bwd_launches = 0  # every launch of the phase counts in the kernels line
    losses = [float(ce._step(opt, sched, *ce._prep(samples[:B])))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(1, steps + 1):
        losses.append(float(ce._step(opt, sched, *ce._prep(samples[s * B:(s + 1) * B]))))
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / steps
    peak = torch.cuda.max_memory_allocated() / 2**30
    timed = (sa.launches, sa.bwd_launches)
    out = {"ms_per_step": ms, "pairs_per_s": B / (ms / 1e3), "peak_gib": peak, "losses": losses}
    log(f"ce train: {steps + 1} steps (B={B}, T=512), losses {[round(x, 4) for x in losses]}; "
        f"{ms:.1f} ms/step over the last {steps}, {B / (ms / 1e3):.1f} pairs/s, peak "
        f"{peak:.2f} GiB, fp32 at TF32 products (\"default\"); K1 {timed[0]}, K2 "
        f"{timed[1]} launches ({card})")
    assert all(np.isfinite(losses)), losses
    assert timed == (L * (steps + 1),) * 2, timed
    ids, mask, labels = ce._prep(samples[:B])
    out.update(profile_train_step(torch, lambda: ce._step(opt, sched, ids, mask, labels),
                                  "ce train profile, one step at T=512 (TF32)"))
    del opt, sched, ids, mask, labels
    torch.cuda.empty_cache()

    # one step at the class defaults: batch 16, max_length 2,048
    big = CrossEncoderTrainable(model, cfg, tok, seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = (sa.launches, sa.bwd_launches)
    t0 = time.perf_counter()
    h = big.fit(samples[:big.batch_size], lr=7e-6)
    torch.cuda.synchronize()
    out["default"] = {"step_s": time.perf_counter() - t0,
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "batch_size": big.batch_size, "max_length": big.max_length}
    launched = (sa.launches - before[0], sa.bwd_launches - before[1])
    log(f"ce train at the class defaults (batch {big.batch_size}, max_length "
        f"{big.max_length}): one fit step {out['default']['step_s']:.2f} s with its optimizer's "
        f"set-up, loss {h[0]['loss']:.4f}, peak {out['default']['peak_gib']:.2f} GiB; K1 "
        f"{launched[0]}, K2 {launched[1]} launches ({card})")
    assert launched == (L, L) and np.isfinite(h[0]["loss"])
    del model, ce, big
    torch.cuda.empty_cache()

    # card == CPU at 2 layers, "highest": predict and an evaluator
    cfg2 = gpt_neo("125m").replace(num_layers=2)
    cpu = Decoder(cfg2, device="cpu", generator=torch.Generator().manual_seed(SEED + 51))
    gpu = copy.deepcopy(cpu).to("cuda")
    pairs = [ex.texts for ex in ce_train_samples(rng, 32)]
    gold = rng.random(32).tolist()
    kw = dict(max_length=512, batch_size=B, seed=SEED)
    ce_cpu, ce_gpu = (CrossEncoderTrainable(m, cfg2, tok, **kw) for m in (cpu, gpu))
    got, want = ce_gpu.predict(pairs), ce_cpu.predict(pairs)
    evaluator = CECorrelationEvaluator(pairs, gold)
    scores = (evaluator(ce_gpu), evaluator(ce_cpu))
    err = float(np.abs(got - want).max())
    gap = float(np.diff(np.sort(want)).min())
    log(f"ce train parity (2 layers, \"highest\"): predict card vs CPU max |diff| {err:.3e} "
        f"(tolerance 1e-5; the CPU's closest two scores {gap:.3e} apart); "
        f"CECorrelationEvaluator card {scores[0]:.6f} CPU {scores[1]:.6f}")
    # Spearman ranks: two CPU scores closer than the two sides' difference
    # may swap places, and only then may the scores differ
    assert got.shape == (32,) and err <= 1e-5 and (scores[0] == scores[1] or gap <= 2 * err)
    out["parity"] = {"predict_err": err, "evaluator": scores[0]}
    out["k1"], out["k2"] = sa.launches, sa.bwd_launches
    return out


def phase_search_utils(torch, docs, queries, card) -> dict:
    """`ops.search_utils` on the card over the encode slice's embeddings:
    `semantic_search` of 64 queries over the 1,280 documents (top 10) equals
    the exact top-10 of an fp64 evaluation on the host (ids in every slot
    but a near-tie within 1e-5, scores within 1e-5); the pairs of
    `paraphrase_mining_embeddings` carry their fp64 cosines within 1e-5,
    best first, and the communities of `community_detection` hold only
    members within 1e-5 of the threshold of their first element, each
    document in one community at most. (Against the CPU's calls the card's
    lists may order near-ties otherwise: summation order.)"""
    from sgpt_tpu_torch.ops import search_utils as su

    q = queries[:64]
    su.semantic_search(q, docs, top_k=10, device="cuda")
    t0 = time.perf_counter()
    hits = su.semantic_search(q, docs, top_k=10, device="cuda")
    ms = 1e3 * (time.perf_counter() - t0)

    def unit(x):
        x = x.astype(np.float64)
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    exact = unit(q) @ unit(docs).T
    want = np.argsort(-exact, axis=1, kind="stable")[:, :10]
    got = np.array([[h["corpus_id"] for h in row] for row in hits])
    vals = np.array([[h["score"] for h in row] for row in hits])
    rows = np.arange(len(q))[:, None]
    err = float(np.abs(vals - exact[rows, want]).max())
    off = got != want
    tie_ok = bool((np.abs(exact[rows, got] - exact[rows, want])[off] <= 1e-5).all())

    cos = unit(docs) @ unit(docs).T
    mined = su.paraphrase_mining_embeddings(docs, top_k=5, device="cuda")
    scores = np.array([sc for sc, _, _ in mined])
    pairs = np.array([(a, b) for _, a, b in mined])
    mined_ok = bool(len(mined) and (pairs[:, 0] < pairs[:, 1]).all()
                    and np.abs(scores - cos[pairs[:, 0], pairs[:, 1]]).max() <= 1e-5
                    and (np.diff(scores) <= 0).all())
    comm = su.community_detection(docs, threshold=0.9, min_community_size=2, device="cuda")
    members = [m for c in comm for m in c]
    comm_ok = (len(members) == len(set(members))
               and all(len(c) >= 2 and (cos[c[0], c] >= 0.9 - 1e-5).all() for c in comm))
    log(f"search utils: semantic_search of {len(q)} queries over {len(docs)} documents "
        f"(top 10) in {ms:.2f} ms; max |score - fp64| {err:.3e} (tolerance 1e-5), "
        f"{int(off.sum())} slots off the exact order, all near-ties: {tie_ok}; paraphrase "
        f"mining {len(mined)} pairs, fp64 cosines and order hold: {mined_ok}; "
        f"{len(comm)} communities ({len(members)} documents) within the threshold: {comm_ok} "
        f"({card})")
    assert err <= 1e-5 and tie_ok and mined_ok and comm_ok
    return {"ms": ms, "max_abs_err": err, "near_tie_slots": int(off.sum()),
            "paraphrase_pairs": len(mined), "communities": len(comm)}


ENC_DOCS = 1024     # documents of the encoder families' bulk encode
ENC_T = 256         # their max_seq_len
CLIP_ITEMS = 256    # texts, and as many images, in CLIP's mixed batch
CLIP_BATCH = 32     # CLIPEncoder's batch_size: K1 runs 12 × ceil(256 / 32) times


def encoder_docs(rng, n: int) -> list:
    """n documents of 10-400 words: every length bucket up to 256 tokens,
    and a tail truncated at 256."""
    words = ["".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"), rng.integers(2, 9)))
             for _ in range(5000)]
    return [" ".join(rng.choice(words, int(m))) for m in rng.integers(10, 400, n)]


def plain_attention_share(torch, engine, texts) -> dict:
    """One encode batch of `texts` (one bucket), timed with CUDA events
    around the forward and pooling (`_embed`) and around
    each call of the decoder's plain attention: the attention's share of
    the batch's device time (its events enclose the scores, the bias and
    mask add, the softmax and P·V)."""
    from sgpt_tpu_torch.models import decoder as dec

    rows, _, _ = engine.codec.encode_rows(texts)
    T = max(len(r) for r in rows)
    enc = engine.codec.pad_rows(rows, pad_to=T)
    ids, mask = enc.input_ids, enc.attention_mask
    engine._embed(ids, mask)
    orig, marks = dec.plain_attention, []

    def timed(*a, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = orig(*a, **kw)
        end.record()
        marks.append((start, end))
        return out

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    dec.plain_attention = timed
    try:
        torch.cuda.synchronize()
        start.record()
        engine._embed(ids, mask)
        end.record()
        torch.cuda.synchronize()
    finally:
        dec.plain_attention = orig
    attn_ms = sum(a.elapsed_time(b) for a, b in marks)
    total_ms = start.elapsed_time(end)
    assert len(marks) == engine.cfg.num_layers, (len(marks), engine.cfg.num_layers)
    return {"rows": len(rows), "T": T, "batch_ms": total_ms, "attention_ms": attn_ms,
            "attention_share": attn_ms / total_ms}


def encoder_family(torch, sa, mips, name: str, cfg16, cfg32, docs, card, rng) -> dict:
    """One encoder family at full width (BERT-base or T5-base): the bf16
    bulk encode of `docs` through `EmbeddingEngine(method="mean")` with no
    launch of K1 or K3 (bidirectional attention takes the plain path), the
    plain attention's share of one T=256 batch, fp32 card against fp32 CPU
    on one batch of 8 (phase parity's gate, 1e-4) and bf16 card against fp32
    CPU cosines (≥ 0.99); BERT's token types change the output, and K5 over
    BERT's embeddings is held to its plain version; T5's relative bias on
    the card equals the CPU's bit for bit at T=256."""
    from sgpt_tpu_torch.encoder import EmbeddingEngine
    from sgpt_tpu_torch.index import DenseIndex
    from sgpt_tpu_torch.models import Decoder
    from sgpt_tpu_torch.models.decoder import t5_relative_bias
    from sgpt_tpu_torch.ops import flash_attention as fa
    from sgpt_tpu_torch.ops.pooling import normalize
    from sgpt_tpu_torch.tokenization import SimpleTokenizer

    tok = SimpleTokenizer(cfg16.vocab_size)
    model = Decoder(cfg16, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(SEED))
    engine = EmbeddingEngine(model, cfg16, tok, device="cuda", method="mean", max_seq_len=ENC_T,
                             batch_size=64, normalize_embeddings=True)
    engine.warmup()
    torch.cuda.synchronize()
    sa.launches = fa.launches = 0
    t0 = time.perf_counter()
    emb = engine.encode(docs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1, k3 = sa.launches, fa.launches
    rows, n_trunc, _ = engine.codec.encode_rows(docs)
    tokens = sum(len(r) for r in rows)
    assert emb.shape == (len(docs), cfg16.hidden_size) and np.isfinite(emb).all(), name
    assert np.abs(np.linalg.norm(emb, axis=1) - 1).max() < 1e-2, name
    assert k1 == k3 == 0, f"{name}: bidirectional layers reached K1 ({k1}) or K3 ({k3})"
    out = {"emb_per_s": len(docs) / wall, "tokens_per_s": tokens / wall, "wall_s": wall,
           "truncated": n_trunc}
    longest = np.argsort([len(r) for r in rows], kind="stable")[-64:]
    share = plain_attention_share(torch, engine, [docs[i] for i in longest])
    out.update({f"batch_{k}": v for k, v in share.items()})
    log(f"encoders {name}: {len(docs)} docs in {wall:.3f} s, {out['emb_per_s']:.1f} emb/s "
        f"({out['tokens_per_s']:.0f} tokens/s), {n_trunc} truncated at {ENC_T}; bf16, mean "
        f"pooling, batch_size 64; K1 {k1}, K3 {k3}; one batch of {share['rows']} at "
        f"T={share['T']}: {share['batch_ms']:.3f} ms, plain attention {share['attention_ms']:.3f} "
        f"ms ({share['attention_share']:.3f}) ({card})")

    # fp32 card (strict fp32) against fp32 CPU on one batch; bf16 card cosines
    small = [docs[i] for i in longest[-8:]]
    cpu32 = Decoder(cfg32, device="cpu", generator=torch.Generator().manual_seed(SEED))
    gpu32 = Decoder(cfg32, device="cuda", weights=cpu32.state_dict())
    gpu16 = Decoder(cfg16, device="cuda", weights=cpu32.state_dict())
    kw = dict(method="mean", max_seq_len=128, batch_size=8, normalize_embeddings=True)
    on_cpu = EmbeddingEngine(cpu32, cfg32, tok, device="cpu", **kw).encode(small)
    on_gpu = EmbeddingEngine(gpu32, cfg32, tok, device="cuda", **kw).encode(small)
    on_gpu16 = EmbeddingEngine(gpu16, cfg16, tok, device="cuda", **kw).encode(small)
    err32 = float(np.abs(on_gpu - on_cpu).max())
    cos16 = cosine(on_gpu16, on_cpu)
    log(f"encoders {name} parity, one batch of 8 at T=128: fp32 card vs fp32 CPU max abs diff "
        f"{err32:.3e} (tolerance 1e-4); bf16 card vs fp32 CPU cosine min {cos16.min():.6f} "
        f"(tolerance 0.99)")
    assert err32 < 1e-4, (name, err32)
    assert cos16.min() > 0.99, (name, cos16.min())
    out.update(fp32_card_vs_cpu=err32, bf16_cos_min=float(cos16.min()))
    enc = engine.codec.pad_rows(engine.codec.encode_rows(small)[0], pad_to=128)
    ids = torch.from_numpy(enc.input_ids).cuda()
    mask = torch.from_numpy(enc.attention_mask).cuda()
    if cfg32.token_type_vocab:
        with torch.inference_mode():
            base = gpu32(ids, mask)
            ones = gpu32(ids, mask, token_type_ids=torch.ones_like(ids))
        moved = float((ones - base).abs().max())
        log(f"encoders {name}: token_type_ids of ones move the states by {moved:.3e}")
        assert moved > 1e-3, moved
    if cfg32.relative_attention:
        args = (256, cfg32.relative_attention_buckets, cfg32.relative_attention_max_distance,
                True)
        with torch.inference_mode():
            card_bias = t5_relative_bias(gpu32.rel_bias, *args)
            cpu_bias = t5_relative_bias(cpu32.rel_bias, *args)
        assert torch.equal(card_bias.cpu(), cpu_bias), f"{name}: relative bias differs"
        log(f"encoders {name}: relative bias at T=256 equals the CPU's bit for bit")
    del cpu32, gpu32, gpu16
    if name == "bert-base":
        index = DenseIndex(cfg16.hidden_size, kernel="pallas", device="cuda")
        index.add(emb, ids=[f"d{i}" for i in range(len(docs))])
        index.build()
        mips.launches = 0
        _, hits = index.search_embeddings(emb[:64], k=10)
        out["k5_launches"] = mips.launches
        assert mips.launches == 1, mips.launches
        own = float(np.mean([row[0] == f"d{n}" for n, row in enumerate(hits)]))
        q = normalize(torch.from_numpy(emb[:64]).to("cuda", torch.bfloat16))
        got = mips.mips_topk(q, index._corpus, index._built_count, 10)
        want = mips.mips_topk_reference(q, index._corpus, index._built_count, 10)
        k5_err, ties = check_topk(torch, q, index._corpus, got, want, "K5 over BERT embeddings")
        log(f"encoders {name}: K5 over the {len(docs)} embeddings, Q=64 k=10: 1 launch, "
            f"max_abs_err {k5_err:.3e} against its plain version ({ties} near-tie slots); own "
            f"document first for {own:.4f} of queries")
        out.update(k5_max_abs_err=k5_err, own_first=own)
    del model, engine
    torch.cuda.empty_cache()
    return out


def bert_train(torch, sa, rng, card) -> dict:
    """3 `ContrastiveTrainer.fit` steps of BitFit MNRL on full-width
    BERT-base in fp32 at the CLI's "default" (TF32 products): batch 32,
    max_seq_len 128, mean pooling, constant lr; only biases move, no K1 or
    K2 launch; ms/step over the last two steps."""
    from sgpt_tpu_torch.models import Decoder, bert
    from sgpt_tpu_torch.tokenization import SimpleTokenizer
    from sgpt_tpu_torch.training import BIAS_NAMES, ContrastiveTrainer, TrainConfig

    steps, B = 3, 32
    cfg = bert("base", matmul_precision="default")
    model = Decoder(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(SEED))
    stamps = []
    tc = TrainConfig(lr=2e-4, batch_size=B, max_seq_len=128, freeze_nonbias=True,
                     pooling="mean", scheduler="constantlr",
                     log_fn=lambda rec: stamps.append(time.perf_counter()))
    triplets = synthetic_triplets(rng, B * steps)
    batches = [triplets[i * B:(i + 1) * B] for i in range(steps)]
    frozen = {n: bits_fingerprint(torch, p) for n, p in model.named_parameters()
              if n.rsplit(".", 1)[-1] not in BIAS_NAMES}
    biases = {n: p.detach().clone() for n, p in model.named_parameters() if n not in frozen}
    trainer = ContrastiveTrainer(model, cfg, SimpleTokenizer(cfg.vocab_size), tc)
    sa.launches = sa.bwd_launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = trainer.fit(lambda: iter(batches), steps_per_epoch=steps)
    torch.cuda.synchronize()
    losses = [h["loss"] for h in out["history"]]
    ms = 1e3 * float(np.median(np.diff(stamps)))
    moved = sum(not torch.equal(p.detach(), biases[n]) for n, p in model.named_parameters()
                if n in biases)
    still = all(bits_fingerprint(torch, p) == frozen[n] for n, p in model.named_parameters()
                if n in frozen)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"encoders bert-base train: {steps} steps, losses {[round(x, 5) for x in losses]}; "
        f"{ms:.1f} ms/step ({3 * B / (ms / 1e3):.1f} sequences/s), peak {peak:.2f} GiB; "
        f"{moved} of {len(biases)} bias leaves moved, frozen leaves unchanged: {still}; K1 "
        f"{sa.launches}, K2 {sa.bwd_launches}; fp32 at TF32 products (\"default\"), batch 32, "
        f"max_seq_len 128, BitFit ({card})")
    assert len(losses) == steps and all(np.isfinite(losses)), losses
    assert still and moved > 0, (still, moved)
    assert sa.launches == sa.bwd_launches == 0
    del model, trainer
    torch.cuda.empty_cache()
    return {"ms_per_step": ms, "seq_per_s": 3 * B / (ms / 1e3), "peak_gib": peak,
            "losses": losses}


def clip_items(rng, n: int) -> tuple:
    """n texts of 1-100 words (some past CLIP's 77 tokens) and n uint8 images
    (224 × 224, and 256 × 320 and 300 × 240, which resize), interleaved;
    images 5 and 17 are one image (one image batch holds both). Returns the
    items and the two positions of the repeated image."""
    words = ["".join(rng.choice(list("abcdefghijklmnopqrstuvwxyz"), rng.integers(2, 9)))
             for _ in range(3000)]
    texts = [" ".join(rng.choice(words, int(m))) for m in rng.integers(1, 100, n)]
    sizes = [(224, 224), (256, 320), (300, 240)]
    images = [rng.integers(0, 256, (*sizes[i % 3], 3), dtype=np.uint8) for i in range(n)]
    images[17] = images[5]
    items = [x for pair in zip(texts, images) for x in pair]
    return items, (2 * 5 + 1, 2 * 17 + 1)


def clip_phase(torch, sa, rng, card) -> dict:
    """CLIP ViT-B/32 at full width, random weights from the seed, bf16:
    `CLIPEncoder` on 256 texts and 256 images, mixed, in input order: K1
    (the causal text tower) 12 × text batches, the same image the same
    embedding, items/s; fp32 card against fp32 CPU on 8 texts and 8 images
    (1e-4); then K1 at the text tower's shape (B=32, T=77, H=8, Dh=64, bf16,
    padded rows) against its plain version, timed beside SDPA and its
    bound."""
    import dataclasses

    from sgpt_tpu_torch.models.clip import CLIP, CLIPEncoder, clip_vit_b_32
    from sgpt_tpu_torch.tokenization import SimpleTokenizer

    cfg32 = clip_vit_b_32()
    cfg16 = dataclasses.replace(
        cfg32, text=cfg32.text.replace(dtype=torch.bfloat16, matmul_precision="default"),
        vision=cfg32.vision.replace(dtype=torch.bfloat16, matmul_precision="default"))
    tok = SimpleTokenizer(cfg32.text.vocab_size)
    cpu32 = CLIP(cfg32, device="cpu", generator=torch.Generator().manual_seed(SEED))
    model = CLIP(cfg16, device="cuda", weights=cpu32.state_dict())
    items, (a, b) = clip_items(rng, CLIP_ITEMS)
    enc = CLIPEncoder(model, cfg16, tok, normalize_embeddings=True, batch_size=CLIP_BATCH)
    enc.encode(items[:2 * CLIP_BATCH])
    torch.cuda.synchronize()
    sa.launches = 0
    t0 = time.perf_counter()
    emb = enc.encode(items)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = sa.launches
    text_batches = -(-CLIP_ITEMS // CLIP_BATCH)
    log(f"encoders clip-vit-b-32: {CLIP_ITEMS} texts + {CLIP_ITEMS} images (uint8, resized on "
        f"the host) in {wall:.3f} s, {2 * CLIP_ITEMS / wall:.1f} items/s; bf16, batch_size "
        f"{CLIP_BATCH}; K1 launches {k1} (12 x {text_batches} text batches) ({card})")
    assert emb.shape == (2 * CLIP_ITEMS, cfg16.projection_dim) and np.isfinite(emb).all()
    assert k1 == cfg16.text.num_layers * text_batches, (k1, text_batches)
    assert np.array_equal(emb[a], emb[b]), "the same image gave two embeddings"
    assert np.abs(np.linalg.norm(emb, axis=1) - 1).max() < 1e-3
    sub = items[:16]
    on_cpu = CLIPEncoder(cpu32, cfg32, tok, normalize_embeddings=True).encode(sub)
    card32 = CLIP(cfg32, device="cuda", weights=cpu32.state_dict())
    on_gpu = CLIPEncoder(card32, cfg32, tok, normalize_embeddings=True).encode(sub)
    err32 = float(np.abs(on_gpu - on_cpu).max())
    log(f"encoders clip-vit-b-32 parity, 8 texts + 8 images: fp32 card vs fp32 CPU max abs "
        f"diff {err32:.3e} (tolerance 1e-4)")
    assert err32 < 1e-4, err32
    del cpu32, card32, model, enc
    torch.cuda.empty_cache()

    args, _ = attention_inputs(torch, rng, 32, 77, 8, 64, torch.bfloat16)
    got = sa.short_attention(*args, 0.125, 0, 8, False)
    want = sa.short_attention_reference(*args, scale=0.125, window=0, H=8, use_alibi=False)
    torch.cuda.synchronize()
    k1_err, gate = hold(torch, "kernel clip-text", got, want, torch.bfloat16)
    log(f"kernel clip-text bf16 B=32 T=77 H=8 Dh=64 window=0, padded rows: K1 max_abs_err "
        f"{k1_err:.3e} ({gate})")
    times = time_k1(torch, sa, "clip-text ", args, 8, 0.125, 0)
    return {"items_per_s": 2 * CLIP_ITEMS / wall, "wall_s": wall, "k1_launches": k1,
            "text_batches": text_batches, "fp32_card_vs_cpu": err32, "k1_max_abs_err": k1_err,
            "k1_times": times}


def modules_phase(torch, rng, card) -> dict:
    """`modules.py` on the card against the CPU, fp32: the CNN (kernel sizes
    1, 3, 5, 256 channels) and the 2-layer bidirectional LSTM (hidden 128,
    ragged lengths) over (32, 64, 300) token embeddings, within 1e-4."""
    from sgpt_tpu_torch import modules

    x = torch.from_numpy(rng.standard_normal((32, 64, 300)).astype(np.float32))
    lengths = torch.from_numpy(rng.integers(1, 65, 32).astype(np.int32))
    cnn = modules.init_cnn(torch.Generator().manual_seed(SEED), 300)
    lstm = modules.init_lstm(torch.Generator().manual_seed(SEED), 300, 128, num_layers=2)
    errs = {}
    for name, fn, params, extra in (("cnn", modules.cnn_forward, cnn, ()),
                                    ("lstm", modules.lstm_forward, lstm, (lengths,))):
        want = fn(params, x, *extra)
        got = fn(modules.params_to(params, "cuda"), x.cuda(),
                 *[t.cuda() for t in extra]).cpu()
        errs[name] = float((got - want).abs().max())
        assert got.shape == want.shape and errs[name] < 1e-4, (name, errs[name])
    log(f"encoders modules: CNN (1, 3, 5) x 256 and biLSTM 2 x 128 over (32, 64, 300), card vs "
        f"CPU fp32 max abs diff {errs['cnn']:.3e} / {errs['lstm']:.3e} (tolerance 1e-4) ({card})")
    return errs


def phase_encoders(torch, sa, mips, card) -> dict:
    """The encoder families at full width (`encoder_family`: BERT-base, T5-base
    v1.0 and v1.1), BERT's training steps (`bert_train`), CLIP ViT-B/32
    (`clip_phase`), the BEIR CLI with `--modelname bert-base-uncased
    --randominit` (its retriever scans with blockmax, as the JAX CLI's:
    K5 is held on BERT's embeddings above) and `modules.py` (`modules_phase`)."""
    from sgpt_tpu_torch.models import bert, t5

    rng = np.random.default_rng(SEED + 40)
    docs = encoder_docs(rng, ENC_DOCS)
    out = {}
    for name, cfg in (("bert-base", bert("base")), ("t5-base", t5("base")),
                      ("t5-v1_1-base", t5("base").replace(mlp_activation="gated_gelu"))):
        # bf16 at the CLI's "default" (`build_model`): the plain attention's
        # fp32 scores of bf16 operands on TF32 tensor cores, exact products
        cfg16 = cfg.replace(dtype=torch.bfloat16, matmul_precision="default")
        out[name] = encoder_family(torch, sa, mips, name, cfg16, cfg, docs, card, rng)
    out["bert_train"] = bert_train(torch, sa, rng, card)
    out["clip"] = clip_phase(torch, sa, rng, card)
    out["beir_bert_ndcg10"] = phase_beir(rng, card, model="bert-base-uncased", n_docs=1000,
                                         n_queries=50)
    out["modules"] = modules_phase(torch, rng, card)
    return out


def ptxas_lines(log_text: str, *names: str) -> dict:
    """Registers and spills that ptxas reported for the kernels whose mangled
    names hold each of `names` (e.g. "mma_kernelILi256ELb0"), from build.log."""
    out = {}
    lines = log_text.splitlines()
    for name in names:
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and name in line:
                regs = spill = None
                for nxt in lines[i + 1:i + 8]:
                    if "spill stores" in nxt and spill is None:
                        spill = nxt.strip()
                    if "Used" in nxt and "registers" in nxt:
                        regs = nxt.strip().split("ptxas info    : ")[-1]
                        break
                out[name] = {"registers": regs, "spills": spill}
                break
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description="Smoke test of the port on one CUDA card.")
    ap.add_argument("--parent", default=None,
                    help="another checkout of this repo (e.g. the parent commit unpacked "
                         "into build/parent): its kernels are built too and timed against "
                         "this tree's in one A/B phase")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke runs "
              "only on a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from sgpt_tpu_torch.crossencoder import CrossEncoderRanker
    from sgpt_tpu_torch.encoder import EmbeddingEngine
    from sgpt_tpu_torch.models import Decoder, gpt_neo
    from sgpt_tpu_torch.ops import _build, mips
    from sgpt_tpu_torch.ops import flash_attention as fa
    from sgpt_tpu_torch.ops import short_attention as sa
    from sgpt_tpu_torch.tokenization import SimpleTokenizer

    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; card: {card}")

    # 1. build (and the parent checkout's kernels beside, in parallel)
    t0 = time.perf_counter()
    parent, parent_mips = parent_ops(args.parent) if args.parent else (None, None)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        parent_built = pool.submit(parent.build) if parent else None
        lib_path = _build.build()
        if parent_built:
            log(f"build: parent kernels -> {parent_built.result()}")
    _build.library()
    build_s = time.perf_counter() - t0
    log(f"build: {build_s:.2f} s -> {lib_path.relative_to(_build.PKG.parent)}")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas: " + line.strip())

    # 2. K1, 3. K2, 12. K3 and 14. K4a/K4b against their plain versions
    rng = np.random.default_rng(SEED)
    phase("kernel")
    main_err, times = phase_kernel(torch, sa, rng)
    phase("kernel families")
    fam_err, fam_times = phase_kernel_families(torch, sa, np.random.default_rng(SEED + 12))
    phase("bwd")
    bwd_err, bwd_worst, bwd_readings, bwd_times = phase_bwd_kernel(torch, sa, rng)
    phase("flash")
    flash_err, flash_times = phase_flash(torch, fa, np.random.default_rng(SEED + 3))
    phase("flash families")
    fam_flash_err, fam_flash_times = phase_flash_families(torch, fa,
                                                          np.random.default_rng(SEED + 13))
    phase("fbwd")
    fbwd_err, fbwd_worst, fbwd_readings, fbwd_times = phase_fbwd(
        torch, fa, np.random.default_rng(SEED + 5))
    phase("kernel nli")
    nli_err, nli_times = phase_nli_kernels(torch, sa, np.random.default_rng(SEED + 30))
    phase("kernel tsdae")
    tsdae_err, tsdae_times = phase_tsdae_kernels(torch, sa, np.random.default_rng(SEED + 32))
    ab = {}
    if parent:
        phase("ab")
        ab = phase_ab(torch, sa, fa, mips, parent.library(), _build.library(), parent_mips)

    # 4. the slice: full-width GPT-Neo-125M bulk encode through the engine
    phase("slice")
    cfg = gpt_neo("125m", dtype=torch.bfloat16)
    model = Decoder(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
    tok = SimpleTokenizer(cfg.vocab_size)
    engine = EmbeddingEngine(model, cfg, tok, device="cuda", specb=True, max_seq_len=300,
                             batch_size=64, normalize_embeddings=True)
    texts = synthetic_texts(rng)
    _, n_trunc, _ = engine.codec.encode_rows(texts)
    assert n_trunc > 0, "no text reached truncation"
    engine.warmup()
    torch.cuda.synchronize()

    shapes = []
    hook = model.register_forward_pre_hook(lambda m, args: shapes.append(tuple(args[0].shape)))
    sa.launches = 0
    t0 = time.perf_counter()
    docs = engine.encode(texts)
    torch.cuda.synchronize()
    doc_s = time.perf_counter() - t0
    n_doc_batches = len(shapes)
    queries = engine.encode(texts, is_query=True)
    main_launches = sa.launches
    hook.remove()
    n_batches = len(shapes)
    buckets = sorted({T for _, T in shapes})
    log(f"slice: {len(texts)} docs + {len(texts)} queries in {n_batches} batches, buckets {buckets}, "
        f"{n_trunc} docs truncated; K1 launches {main_launches}")
    assert main_launches == cfg.num_layers * n_batches > 0, \
        f"K1 launched {main_launches} times for {n_batches} batches of {cfg.num_layers} layers"
    assert {16, 32, 64, 128, 256, 300} <= set(buckets), buckets
    for name, emb in (("docs", docs), ("queries", queries)):
        assert emb.shape == (len(texts), cfg.hidden_size) and emb.dtype == np.float32, (name, emb.shape)
        assert np.isfinite(emb).all(), name
        norms = np.linalg.norm(emb, axis=1)
        assert np.abs(norms - 1).max() < 1e-2, (name, norms.min(), norms.max())
    assert np.abs(docs - queries).max() > 1e-3, "SPECB brackets did not change the embedding"
    perm = np.random.default_rng(SEED + 1).permutation(len(texts))
    shuffled = engine.encode([texts[i] for i in perm])
    cos = cosine(shuffled, docs[perm])
    log(f"shuffled input: min cosine to the unshuffled rows {cos.min():.6f}, "
        f"max abs diff {np.abs(shuffled - docs[perm]).max():.3e}")
    assert cos.min() > 0.999
    emb_per_s = len(texts) / doc_s
    tokens = sum(len(r) for r in engine.codec.encode_rows(texts)[0])
    log(f"encode: {emb_per_s:.1f} emb/s ({tokens / doc_s:.0f} tokens/s), "
        f"{len(texts)} docs in {doc_s:.3f} s, bf16, batch_size 64, max_seq_len 300 ({card})")
    longest = np.argsort([len(t) for t in texts], kind="stable")[-64:]
    encode_profile = profile_batch(torch, engine, [texts[i] for i in longest],
                                   "encode profile, one batch of 64 at T=300",
                                   {"K1 short": K1_KEYS, "GEMM": GEMM_KEYS})

    # 4b. the encode pipeline: depth 2 and dispatch chains against depth 1
    phase("pipeline")
    pipeline = phase_pipeline(torch, sa, model, cfg, tok, texts, docs, card, args.parent)

    # 5. card (kernel) against CPU (plain path) on the same weights
    phase("parity")
    idx = np.argsort([len(t) for t in texts])[:: len(texts) // 32][:32]
    small = [texts[i] for i in idx]
    cfg32 = gpt_neo("125m")
    cpu_model = Decoder(cfg32, device="cpu", generator=torch.Generator().manual_seed(SEED))
    gpu_model = copy.deepcopy(cpu_model)
    kw = dict(specb=True, max_seq_len=300, batch_size=8, normalize_embeddings=True)
    on_cpu = EmbeddingEngine(cpu_model, cfg32, tok, device="cpu", **kw).encode(small)
    sa.launches = 0
    on_gpu = EmbeddingEngine(gpu_model, cfg32, tok, device="cuda", **kw).encode(small)
    assert sa.launches > 0
    err32 = np.abs(on_gpu - on_cpu).max()
    cos16 = cosine(docs[idx], on_cpu)
    log(f"parity fp32 card vs fp32 CPU, 32 texts: max abs diff {err32:.3e} (tolerance 1e-4)")
    log(f"parity bf16 card vs fp32 CPU, 32 texts: cosine min {cos16.min():.6f} "
        f"mean {cos16.mean():.6f} (tolerance min 0.99)")
    assert err32 < 1e-4
    assert cos16.min() > 0.99

    # 6. K5 against its plain version; 7. the search slice; 8. serving
    del cpu_model, gpu_model
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    phase("mips")
    k5 = phase_mips(torch, mips, gen)
    corpus = synthetic_corpus(rng, 4096)
    phase("search")
    search = phase_search(torch, mips, sa, engine, corpus, gen)
    phase("search utils")
    search_utils = phase_search_utils(torch, docs, queries, card)
    phase("serve")
    serve = phase_serve(torch, mips, engine, corpus)

    # the serving meshes: dp and tp on the one card named twice
    phase("mesh")
    mesh = phase_mesh(torch, sa, model, cfg, tok, texts, docs, doc_s, corpus, times, card)

    # int8 inference, and the IVF index
    phase("int8")
    int8 = phase_int8(torch, model, cfg, tok, texts, docs, doc_s, gen, card)
    phase("ivf")
    ivf = phase_ivf(torch, mips, gen, corpus, card)

    # 13. the long-context slice (flash engine), on the weights of phase 4
    phase("long")
    long = phase_long(torch, fa, sa, mips, model, tok, np.random.default_rng(SEED + 2), card)

    # 16. the cross-encoder slice, on the weights of phase 4
    phase("ce")
    ce_err, ce_times = phase_ce_kernel(torch, sa, np.random.default_rng(SEED + 7))
    ce, ce_bf16, ce_launches, (ce_corpus, ce_queries, _, ce_beir, ce_short) = phase_ce(
        torch, sa, model, tok, np.random.default_rng(SEED + 8), card)
    ce_parity = phase_ce_parity(torch, sa, tok, ce_beir, ce_short, ce_bf16, card)
    ce_serve = phase_ce_serve(torch, sa, mips, engine, CrossEncoderRanker(
        model, cfg, tok, device="cuda", batch_size=16, max_length=2048), ce_corpus, ce_queries)
    ce_cli = phase_ce_cli(ce_corpus, card)

    # 9. the train slice, and 10. its card-against-CPU parity
    del model, engine
    torch.cuda.empty_cache()
    phase("train")
    train = phase_train(torch, sa, rng, tok)
    phase("tparity")
    phase_train_parity(torch, fa, rng, tok)

    # 19. NLI training (symmetric SGPT-BE)
    phase("nli")
    nli = phase_nli(torch, sa, tok, card)

    # the training objectives beyond MNRL: TSDAE and the trainable cross-encoder
    phase("tsdae")
    tsdae = phase_tsdae(torch, sa, card)
    phase("ce train")
    ce_train = phase_ce_train(torch, sa, card)

    # 15. the long-context training slice
    phase("ltrain")
    ltrain = phase_ltrain(torch, fa, sa, tok, card)

    # 30. training under a mesh, 31. sequence parallelism (ring attention)
    phase("mesh train")
    mesh_train = phase_mesh_train(torch, sa, fa, tok, card)
    phase("sp")
    seqpar = phase_sp(torch, tok, card)

    # 11. the BEIR CLI
    phase("beir")
    ndcg10 = phase_beir(rng, card)

    # 20. USEB evaluation through its CLI
    phase("useb")
    useb_res = phase_useb(torch, sa, fa, card)

    # 28. the encoder families, CLIP and the word-level modules
    phase("encoders")
    encoders = phase_encoders(torch, sa, mips, card)

    # 17. GPT-J-6B and BLOOM-1b7 at full width
    phase("families")
    families = phase_families(torch, fa, sa, mips, card)
    phase("families train")
    fam_train = phase_families_train(torch, fa, sa, card)
    phase("report")

    # 16. report
    log(f"train: {train['ms_per_step']:.1f} ms/step, {train['seq_per_s']:.1f} seq/s "
        f"(96 sequences per step), peak {train['peak_gib']:.2f} GiB, fp32 at TF32 products "
        f"(\"default\"); strict fp32 (\"highest\") {train['ms_per_step_highest']:.1f} ms/step, "
        f"{train['seq_per_s_highest']:.1f} seq/s; batch 32, max_seq_len 300 ({card})")
    log(f"long: {long['emb_per_s']:.1f} emb/s, {long['tokens_per_s']:.0f} tokens/s, bf16, "
        f"max_seq_len 2048, use_flash ({card})")
    log(f"ce: {ce['beir']['pairs_per_s']:.1f} pairs/s ({ce['beir']['tokens_per_s']:.0f} "
        f"tokens/s) on the BEIR-like mix's BM25 top-100, short mix "
        f"{ce['short']['pairs_per_s']:.1f} pairs/s unpacked, "
        f"{ce['short_packed']['pairs_per_s']:.1f} at pack_t=256; /rerank p50 "
        f"{ce_serve['p50_ms']:.2f} ms, p99 {ce_serve['p99_ms']:.2f} ms; bf16, max_length 2048, "
        f"batch_size 16 ({card})")
    log(f"pipeline: depth 2 chain 8 {pipeline['depth2_chain8']['emb_per_s']:.1f} emb/s, "
        f"depth 1 chain 1 {pipeline['depth1_chain1']['emb_per_s']:.1f} emb/s "
        f"({pipeline['speedup']:.3f} x); busy share "
        f"{pipeline['depth2_chain8']['busy_share']} / {pipeline['depth1_chain1']['busy_share']}; "
        f"bf16, batch_size 64, max_seq_len 300 ({card})")
    log(f"ltrain: {ltrain['ms_per_step']:.1f} ms/step, {ltrain['seq_per_s']:.2f} seq/s, "
        f"{ltrain['tokens_per_s']:.0f} tokens/s, peak {ltrain['peak_gib']:.2f} GiB, fp32 at "
        f"TF32 products (\"default\"); strict fp32 (\"highest\") "
        f"{ltrain['ms_per_step_highest']:.1f} ms/step, {ltrain['seq_per_s_highest']:.2f} seq/s; "
        f"batch 16, max_seq_len 2048, use_flash, GradCache chunk 8 ({card})")

    for shape, t in int8["int8_project"].items():
        log(f"int8_project M={INT8_ROWS} {shape}: {t['ms']:.4f} ms (quantize "
            f"{t['quantize_ms']:.4f}, _int_mm {t['int_mm_ms']:.4f}, rescale "
            f"{t['rescale_ms']:.4f}); F.linear bf16 {t['library_ms']:.4f} ms; bound "
            f"{t['bound_ms']:.4f} ms ({card})")
    fam_int8 = families["gptj"]["int8"]
    for label, r in (("GPT-Neo-125M", int8["neo"]), ("GPT-J-6B", fam_int8)):
        log(f"int8 encode {label}: {r['emb_per_s']:.1f} emb/s against bf16 "
            f"{r['bf16_emb_per_s']:.1f}; cosine mean {r['cos_mean']:.6f} min {r['cos_min']:.6f}; "
            f"top-10 overlap {r['top10_overlap']:.4f}; peak {r['peak_gib']:.2f} GiB ({card})")
    log(f"int8 ce GPT-J-6B: {fam_int8['ce_pairs_per_s']:.1f} pairs/s against bf16 "
        f"{families['gptj']['ce_pairs_per_s']:.1f}; Spearman per query "
        f"{fam_int8['ce_spearman_vs_bf16']} ({card})")
    for nprobe in IVF_NPROBES:
        r = ivf[f"nprobe{nprobe}"]
        log(f"ivf NQ-size int8, K {ivf['k']}, nprobe {nprobe}: recall@10 {r['recall10']:.4f}, "
            f"p50 {r['p50_ms_q1']:.3f} ms at Q=1, {r['p50_ms_q64']:.3f} ms at Q=64; K5 exact "
            f"{ivf['k5_exact_ms_q1']:.3f} / {ivf['k5_exact_ms_q64']:.3f} ms ({card})")
    log(f"ivf serve: /search p50 {ivf['serve']['p50_ms']:.2f} ms, p99 "
        f"{ivf['serve']['p99_ms']:.2f} ms ({card})")
    log("mesh (one card named twice): GPT-Neo-125M encode "
        + ", ".join(f"dp={k[6]} tp={k[10]} {mesh[k]['emb_per_s']:.1f} emb/s "
                    f"({mesh[k]['vs_meshless']:.3f} x)" for k in mesh if k.startswith("neo_"))
        + f"; GPT-J-6B tp=2 {mesh['gptj_tp2']['emb_per_s']:.1f} emb/s "
        f"({mesh['gptj_tp2']['vs_meshless']:.3f} x meshless); K1 at H=6 "
        f"{mesh['k1_tp_shard']['ms']:.4f} ms; CE dp=2 {mesh['ce_dp2_tp1']['pairs_per_s']:.1f}, "
        f"tp=2 {mesh['ce_dp1_tp2']['pairs_per_s']:.1f} pairs/s ({card})")
    log("mesh train (one card named 2 or 4 times, \"default\"): " + ", ".join(
        f"{k} {v['ms_per_step']:.1f} ms/step ({v['vs_meshless']:.3f} x meshless)"
        for k, v in mesh_train.items() if isinstance(v, dict) and "ms_per_step" in v)
        + f"; long context dp=2 one step {mesh_train['long_dp2']['ms']:.1f} ms (meshless "
        f"{mesh_train['long_dp2']['meshless_ms']:.1f}) ({card})")
    log(f"sp (ring attention, T={SP_T} over {SP_N} shards, fp32): encode "
        f"{seqpar['encode']['s']:.2f} s / {seqpar['encode']['peak_gib']:.2f} GiB, train step "
        f"{seqpar['train']['s']:.2f} s / {seqpar['train']['peak_gib']:.2f} GiB, TSDAE step "
        f"{seqpar['tsdae']['s']:.2f} s / {seqpar['tsdae']['peak_gib']:.2f} GiB ({card})")
    int8_k1 = (int8["neo"]["k1_launches"] + fam_int8["k1_launches"]
               + fam_int8["ce_k1_launches"] + ivf["serve"]["k1_launches"])

    def parent_ms(cell):  # the parent build's time in the A/B phase (--parent), else None
        return ab[cell]["parent_ms"] if cell in ab else None

    for name in ("bert-base", "t5-base", "t5-v1_1-base"):
        e = encoders[name]
        log(f"encoders {name}: {e['emb_per_s']:.1f} emb/s ({e['tokens_per_s']:.0f} tokens/s), "
            f"plain attention {e['batch_attention_share']:.3f} of a batch of "
            f"{e['batch_rows']} at T={e['batch_T']}; bf16, max_seq_len {ENC_T}, full width "
            f"({card})")
    log(f"encoders bert-base train: {encoders['bert_train']['ms_per_step']:.1f} ms/step; "
        f"clip-vit-b-32: {encoders['clip']['items_per_s']:.1f} items/s, K1 "
        f"{encoders['clip']['k1_times']['ms']:.4f} ms at B=32 T=77 H=8 Dh=64 bf16 ({card})")
    for family, f in families.items():
        log(f"families {family}: encode {f['encode_emb_per_s']:.1f} emb/s, long "
            f"{f['long_emb_per_s']:.2f} emb/s, ce {f['ce_pairs_per_s']:.1f} pairs/s; bf16, "
            f"full width ({card})")
    fam_k1 = sum(f["encode_k1"] + f["long_k1"] + f["ce_k1"] + f.get("ce_short_k1", 0)
                 for f in families.values())
    log(f"nli: {nli['ms_per_step']:.1f} ms/step, {nli['seq_per_s']:.1f} sequences/s "
        f"(192 sequences of T={NLI_T} a step), peak {nli['peak_gib']:.2f} GiB, fp32 at TF32 "
        f"products (\"default\"); GPT-Neo-125M, batch 64, BitFit ({card})")
    log(f"tsdae: {tsdae['ms_per_step']:.1f} ms/step, {tsdae['sentences_per_s']:.1f} "
        f"sentences/s, peak {tsdae['peak_gib']:.2f} GiB, fp32 at TF32 products (\"default\"); "
        f"GPT-Neo-125M, batch 8, T={TSDAE_T} ({card})")
    log(f"ce train: {ce_train['ms_per_step']:.1f} ms/step, {ce_train['pairs_per_s']:.1f} pairs/s, "
        f"peak {ce_train['peak_gib']:.2f} GiB at batch 32, max_length 512; one step at batch 16, "
        f"max_length 2048 {ce_train['default']['step_s']:.2f} s, peak "
        f"{ce_train['default']['peak_gib']:.2f} GiB; fp32 at TF32 products (\"default\") "
        f"({card})")
    log("useb: " + ", ".join(f"{k} {r['emb_per_s']:.1f} emb/s" for k, r in useb_res["runs"].items())
        + f"; bf16, max_seq_len 128, batch_size 64 ({card})")
    for family, f in fam_train.items():
        for cell in [c for c in ("msmarco", "nli", "long") if c in f]:
            c = f[cell]
            log(f"families train {family} {cell}: {c['ms_per_step']:.1f} ms/step, "
                f"{c['seq_per_s']:.2f} sequences/s, {c['tokens_per_s']:.0f} valid tokens/s, "
                f"peak {c['peak_gib']:.2f} GiB; fp32 at TF32 products (\"default\"), full width "
                f"({card})")
    train_launches = {k: sum(f[cell][k] for f in fam_train.values()
                             for cell in ("msmarco", "nli", "long") if cell in f)
                      for k in ("k1", "k2", "k3", "k4a", "k4b")}
    build_log = (lib_path.parent / "build.log").read_text()
    templates = ptxas_lines(build_log, "mma_kernelILi256ELb0", "mma_kernelILi256ELb1",
                            "tf32_kernel_wideILb0", "tf32_kernel_wideILb1",
                            "tf32_rows_wideILb0", "tf32_rows_wideILb1", "tf32_cols_wideILb0",
                            "tf32_cols_wideILb1", "flash_fwd_bf16ILi256", "flash_fwd_tf32ILi256",
                            "flash_bwd_dq_wideIfLi256", "flash_bwd_dkv_wideIfLi256",
                            "flash_bwd_dq_wideI13__nv_bfloat16Li256",
                            "flash_bwd_dkv_wideI13__nv_bfloat16Li256")
    for name in templates:
        if "wide" in name:
            log(f"ptxas {name}: {templates[name]}")

    log(card)
    print(json.dumps({"kernels": [{
        "name": "short_attention_fwd", "route": "cuda",
        "source": "sgpt_tpu_torch/csrc/short_attention.cu",
        "replaces": "sgpt_tpu/ops/pallas/short_attention.py:74",
        "launches": (main_launches + train["fwd_launches"] + long["k1_launches"] + ce_launches
                     + fam_k1 + train_launches["k1"] + nli["k1"] + useb_res["k1"] + int8_k1
                     + tsdae["k1"] + ce_train["k1"] + encoders["clip"]["k1_launches"]
                     + mesh["k1_launches"] + mesh_train["k1"] + pipeline["k1_launches"]),
        "launches_pipeline": pipeline["k1_launches"], "pipeline": pipeline,
        "launches_mesh": mesh["launches"], "launches_mesh_train": mesh_train["k1"],
        "mesh_train": {k: v for k, v in mesh_train.items() if k not in ("k1", "k2", "k3",
                                                                        "k4a", "k4b")},
        "mesh": {k: v for k, v in mesh.items() if k not in ("launches", "k1_tp_shard")},
        **{f"{k}_tp_shard": v for k, v in mesh["k1_tp_shard"].items()},
        "launches_clip_text": encoders["clip"]["k1_launches"],
        "max_abs_err_clip_text": encoders["clip"]["k1_max_abs_err"],
        **{f"{k}_clip_text": v for k, v in encoders["clip"]["k1_times"].items()},
        "encoders": {k: v for k, v in encoders.items() if k != "clip"},
        "clip": {k: v for k, v in encoders["clip"].items() if k != "k1_times"},
        "launches_tsdae": tsdae["k1"], "launches_ce_train": ce_train["k1"],
        "max_abs_err_tsdae": tsdae_err["k1"],
        **{f"{k}_{cell}": v for cell, t in tsdae_times.items() for k, v in t["k1"].items()},
        "tsdae": {k: v for k, v in tsdae.items() if k not in ("k1", "k2")},
        "ce_train": {k: v for k, v in ce_train.items() if k not in ("k1", "k2")},
        "search_utils": search_utils,
        "launches_int8": int8_k1, "int8": int8,
        "launches_encode": main_launches, "launches_train": train["fwd_launches"],
        "launches_nli": nli["k1"], "launches_useb": useb_res["k1"],
        "launches_families_train_gptj_nli": fam_train["gptj"]["nli"]["k1"],
        "max_abs_err_nli": nli_err["k1"],
        **{f"{k}_{cell}": v for cell, t in nli_times.items() for k, v in t["k1"].items()},
        "nli": {k: v for k, v in nli.items() if k not in ("k1", "k2")}, "useb": useb_res,
        "launches_long": long["k1_launches"], "launches_ce": ce_launches,
        "launches_families": fam_k1, "launches_families_train": train_launches["k1"],
        "templates": {"mma_kernel<256, false>": templates.get("mma_kernelILi256ELb0"),
                      "mma_kernel<256, true>": templates.get("mma_kernelILi256ELb1"),
                      "tf32_kernel_wide<false>": templates.get("tf32_kernel_wideILb0"),
                      "tf32_kernel_wide<true>": templates.get("tf32_kernel_wideILb1")},
        "max_abs_err_families": fam_err,
        **{f"{k}_{cell}": v for cell, t in fam_times.items() for k, v in t.items()},
        "parent_ms_gptj": parent_ms("K1 bf16 GPT-J B=64 T=300 H=16 Dh=256"),
        "parent_ms_gptj_fp32_b4": parent_ms("K1 fp32 GPT-J B=4 T=300 H=16 Dh=256"),
        "parent_ms_gptj_fp32_b16": parent_ms("K1 fp32 GPT-J B=16 T=300 H=16 Dh=256"),
        "ab_ms_gptj_fp32_b4": (ab.get("K1 fp32 GPT-J B=4 T=300 H=16 Dh=256") or {}).get("ms"),
        "ab_ms_gptj_fp32_b16": (ab.get("K1 fp32 GPT-J B=16 T=300 H=16 Dh=256") or {}).get("ms"),
        "parent_ms_bloom1b7": parent_ms("K1 bf16 BLOOM-1b7 B=64 T=300 H=16 Dh=128 alibi"),
        "parent_ms_bloom1b7_ce_packed": parent_ms(
            "K1 bf16 BLOOM-1b7 CE packed B=128 T=256 H=16 Dh=128 alibi"),
        "families": families,
        "max_abs_err": main_err, "max_abs_err_ce": ce_err,
        "ms": times[0][0], "plain_ms": times[0][1], "library_ms": times[0][2],
        "bound_ms": times[0][3], "bound_by": times[0][4],
        "ms_local256": times[256][0], "plain_ms_local256": times[256][1],
        "library_ms_local256": times[256][2], "bound_ms_local256": times[256][3],
        "ms_fp32_b32": times["fp32"][0], "plain_ms_fp32_b32": times["fp32"][1],
        "library_ms_fp32_b32": times["fp32"][2], "bound_ms_fp32_b32": times["fp32"][3],
        "bound_by_fp32_b32": times["fp32"][4],
        "ms_fp32_b32_w256": times["fp32_w256"][0], "plain_ms_fp32_b32_w256": times["fp32_w256"][1],
        "library_ms_fp32_b32_w256": times["fp32_w256"][2],
        "bound_ms_fp32_b32_w256": times["fp32_w256"][3],
        "parent_ms_fp32_b32_w256": parent_ms("K1 fp32 B=32 T=300 window=256"),
        "parent_ms": parent_ms("K1 bf16 B=64 T=300 window=0"),
        "parent_ms_local256": parent_ms("K1 bf16 B=64 T=300 window=256"),
        "parent_ms_fp32_b32": parent_ms("K1 fp32 B=32 T=300 window=0"),
        **{f"{k}_ce_{cell}": v for cell, t in ce_times.items() for k, v in t.items()},
        **{f"ce_{k}_{mix}": ce[mix][k] for mix in ce for k in ("pairs_per_s", "tokens_per_s",
                                                                  "dispatches")},
        "ce_profile": {mix: ce[mix]["profile"] for mix in ce if "profile" in ce[mix]},
        "ce_parity": ce_parity, "ce_rerank_p50_ms": ce_serve["p50_ms"],
        "ce_rerank_p99_ms": ce_serve["p99_ms"], "ce_rerank_qps": ce_serve["qps"],
        "ce_cli": ce_cli,
        "build_s": build_s, "encode_emb_per_s": emb_per_s, "encode_profile": encode_profile}, {
        "name": "short_attention_bwd", "route": "cuda",
        "source": "sgpt_tpu_torch/csrc/short_attention_bwd.cu",
        "replaces": "sgpt_tpu/ops/pallas/short_attention.py:106",
        "launches": (train["bwd_launches"] + train_launches["k2"] + nli["k2"] + tsdae["k2"]
                     + ce_train["k2"] + mesh_train["k2"]),
        "launches_mesh_train": mesh_train["k2"],
        "launches_tsdae": tsdae["k2"], "launches_ce_train": ce_train["k2"],
        "max_abs_err_tsdae": tsdae_err["k2"],
        **{f"{k}_{cell}": v for cell, t in tsdae_times.items() for k, v in t["k2"].items()},
        "launches_train": train["bwd_launches"], "launches_families_train": train_launches["k2"],
        "launches_nli": nli["k2"],
        "launches_families_train_gptj_nli": fam_train["gptj"]["nli"]["k2"],
        "max_abs_err_nli": nli_err["k2"],
        **{f"{k}_{cell}": v for cell, t in nli_times.items() if "k2" in t
           for k, v in t["k2"].items()},
        "max_abs_err": bwd_err, "max_abs_err_cases": bwd_worst,
        "bf16_gate_readings": bwd_readings,
        **{k: bwd_times[("fp32", 0)][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                  "bound_by")},
        **{(f"{k}_{cell[0]}_w{cell[1]}" if isinstance(cell, tuple) else f"{k}_{cell}"): v
           for cell, t in bwd_times.items() for k, v in t.items()},
        "templates": {f"tf32_{p}_wide<{g}>": templates.get(f"tf32_{p}_wideILb{int(g == 'true')}")
                      for p in ("rows", "cols") for g in ("false", "true")},
        "parent_ms": parent_ms("K2 fp32 B=32 T=300 window=0"),
        "parent_ms_fp32_w256": parent_ms("K2 fp32 B=32 T=300 window=256"),
        "parent_ms_gptj_b32": parent_ms("K2 fp32 GPT-J B=32 T=300 H=16 Dh=256"),
        "parent_ms_gptj_b4": parent_ms("K2 fp32 GPT-J B=4 T=300 H=16 Dh=256"),
        "parent_ms_bf16_w0": parent_ms("K2 bf16 B=32 T=300 window=0"),
        "train_ms_per_step": train["ms_per_step"], "train_seq_per_s": train["seq_per_s"],
        "train_ms_per_step_highest": train["ms_per_step_highest"],
        "train_seq_per_s_highest": train["seq_per_s_highest"],
        "train_peak_gib": train["peak_gib"],
        "train_profile": {k: v for k, v in train.items() if k.startswith("profile")},
        "families_train": fam_train}, {
        "name": "mips_topk", "route": "cuda", "source": "sgpt_tpu_torch/csrc/mips.cu",
        "replaces": "sgpt_tpu/ops/pallas/mips.py:44",
        "launches": (search["k5_launches"] + serve["k5_launches"]
                     + sum(f["k5_launches"] for f in families.values())
                     + ivf["oracle_k5_launches"] + encoders["bert-base"]["k5_launches"]),
        "launches_encoders_bert": encoders["bert-base"]["k5_launches"],
        "launches_ivf_oracle": ivf["oracle_k5_launches"], "ivf": ivf,
        "launches_search": search["k5_launches"], "launches_serve": serve["k5_launches"],
        "launches_families": {k: f["k5_launches"] for k, f in families.items()},
        "max_abs_err": k5["max_abs_err"], "ms": k5["ms"], "plain_ms": k5["plain_ms"],
        "library_ms": k5["library_ms"], "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
        "shape": f"Q=64 N={NQ_ROWS} D=768 bf16 k=10", "query_block": k5["query_block"],
        "bytes_per_search": k5["bytes_per_search"], "gb_per_s": k5["gb_per_s"],
        "by_q": k5["by_q"], "fp32_q64_n2p20": k5["fp32_q64_n2p20"],
        **{f"parent_ms_q{Q}": parent_ms(f"K5 bf16 Q={Q} N={NQ_ROWS} D=768 k=10")
           for Q in (64, 1, 8, 16, 1024)},
        "search_lists_equal": search["lists_equal"], "search_own_first": search["own_first"],
        "search_ms_per_dispatch": search["ms_per_dispatch"],
        "search_ms_per_dispatch_2p20": search["ms_per_dispatch_2p20"],
        "serve_p50_ms": serve["p50_ms"], "serve_p99_ms": serve["p99_ms"],
        "serve_qps": serve["qps"], "beir_ndcg10": ndcg10}, {
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "sgpt_tpu_torch/csrc/flash_attention.cu",
        "replaces": "sgpt_tpu/ops/pallas/flash_attention.py:32",
        "launches": (long["k3_launches"] + ltrain["k3"]
                     + sum(f["long_k3"] for f in families.values()) + train_launches["k3"]
                     + mesh_train["k3"]),
        "launches_mesh_train": mesh_train["k3"], "sp": seqpar,
        "launches_long_encode": long["k3_launches"], "launches_long_train": ltrain["k3"],
        "launches_families_train": train_launches["k3"],
        "launches_families": {k: f["long_k3"] for k, f in families.items()},
        "templates": {"flash_fwd_bf16<256>": templates.get("flash_fwd_bf16ILi256"),
                      "flash_fwd_tf32<256>": templates.get("flash_fwd_tf32ILi256")},
        "max_abs_err": flash_err, "max_abs_err_families": fam_flash_err,
        **{f"{k}_{cell}": v for cell, t in fam_flash_times.items() for k, v in t.items()},
        "parent_ms_bloom1b7": parent_ms("K3 bf16 BLOOM-1b7 B=16 T=2048 H=16 Dh=128 alibi"),
        "ms": flash_times[0][0], "plain_ms": flash_times[0][1],
        "library_ms": flash_times[0][2], "bound_ms": flash_times[0][3],
        "bound_by": flash_times[0][4], "shape": "B=64 T=2048 H=12 Dh=64 bf16",
        "ms_local256": flash_times[256][0], "plain_ms_local256": flash_times[256][1],
        "library_ms_local256": flash_times[256][2], "bound_ms_local256": flash_times[256][3],
        "bound_by_local256": flash_times[256][4],
        **{f"{key}_fp32_b8_w{w}": flash_times[("fp32", w)][i] for w in (0, 256)
           for i, key in enumerate(("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                    "bound_ms_cuda_cores", "fp64_err", "plain_fp64_err"))},
        "parent_ms": parent_ms("K3 bf16 B=64 T=2048 window=0"),
        "parent_ms_local256": parent_ms("K3 bf16 B=64 T=2048 window=256"),
        "parent_ms_fp32_b8": parent_ms("K3 fp32 B=8 T=2048 window=0"),
        "parent_ms_fp32_b8_w256": parent_ms("K3 fp32 B=8 T=2048 window=256"),
        "long_emb_per_s": long["emb_per_s"],
        "long_tokens_per_s": long["tokens_per_s"], "long_batches": long["batches"],
        "long_flash_batches": long["flash_batches"],
        "long_flash_vs_plain_cos_min": long["flash_vs_plain_cos_min"],
        "long_fp32_card_vs_cpu": long["fp32_err"],
        "long_profile": {k: v for k, v in long.items() if k.startswith("profile")}}, *[{
        "name": f"flash_attention_bwd_{part}", "route": "cuda",
        "source": "sgpt_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": f"sgpt_tpu/ops/pallas/flash_attention.py:{line}",
        "launches": ltrain[key] + train_launches[key] + mesh_train[key],
        "launches_long_train": ltrain[key], "launches_mesh_train": mesh_train[key],
        "launches_families_train": train_launches[key], "max_abs_err": fbwd_err[part],
        "max_abs_err_cases": fbwd_worst, "bf16_gate_readings": fbwd_readings,
        "template_fp32_dh256": templates.get(f"flash_bwd_{part}_wideIfLi256"),
        "template_bf16_dh256": templates.get(f"flash_bwd_{part}_wideI13__nv_bfloat16Li256"),
        **{f"{k}_{cell}": v for cell, t in fbwd_times.items() if isinstance(cell, str)
           for k, v in (
            ("ms", t[part]), ("plain_ms", t["plain"]), ("library_ms", t["library"]),
            ("bound_ms", t[f"bound_{part}"][0]), ("bound_by", t[f"bound_{part}"][1]),
            ("bound_ms_cuda_cores", t[f"bound_{part}_cuda_cores"][0]))},
        "ms": fbwd_times[0][part], "plain_ms": fbwd_times[0]["plain"],
        "library_ms": fbwd_times[0]["library"], "bound_ms": fbwd_times[0][f"bound_{part}"][0],
        "bound_by": fbwd_times[0][f"bound_{part}"][1], "shape": "B=8 T=2048 H=12 Dh=64 fp32",
        "plain_and_library_compute": "dq, dk and dv together",
        "parent_ms": parent_ms(f"K4{key[-1]} fp32 B=8 T=2048 window=0"),
        "parent_ms_local256": parent_ms(f"K4{key[-1]} fp32 B=8 T=2048 window=256"),
        "ms_local256": fbwd_times[256][part], "plain_ms_local256": fbwd_times[256]["plain"],
        "library_ms_local256": fbwd_times[256]["library"],
        "bound_ms_local256": fbwd_times[256][f"bound_{part}"][0],
        "bound_by_local256": fbwd_times[256][f"bound_{part}"][1],
        "bound_ms_cuda_cores": fbwd_times[0][f"bound_{part}_cuda_cores"][0],
        "bound_ms_cuda_cores_local256": fbwd_times[256][f"bound_{part}_cuda_cores"][0],
        "ltrain": {k: v for k, v in ltrain.items() if k not in ("k1", "k2")}}
        for part, key, line in (("dq", "k4a", 231), ("dkv", "k4b", 276))]]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
