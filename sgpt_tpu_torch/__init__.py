"""sgpt_tpu_torch — SGPT's bulk encode, contrastive training (asymmetric and symmetric), search, cross-encoder rerank and serving in PyTorch, with CUDA kernels for Hopper.

A port of `sgpt_tpu` (JAX) that grows beside it. Module names mirror the JAX
package so each counterpart is easy to find:

    models.config        DecoderConfig with a torch dtype; GPT-Neo, GPT-J-6B
                         and BLOOM presets
    models.params        random init and conversion of a JAX parameter tree
                         and of the JAX trainer's aux (learnt weights, heads)
    models.decoder       GPT-Neo / GPT-J / BLOOM forward (nn.Module, layers
                         in a ModuleList)
    models.hf_loader     local HF checkpoints (safetensors, .bin, sharded)
    ops.short_attention  fused short-T attention: CUDA forward and backward
                         kernels, their plain versions, the autograd function
    ops.mips             streaming exact MIPS top-k: CUDA kernel, plain version
    ops.topk             merge / chunked / block-max exact top-k (plain torch)
    ops.pooling          every pooler of the JAX package (single-layer, all-layer,
                         learnt weights), normalize
    ops.similarity       dot / cosine scores in fp32
    encoder              EmbeddingEngine: tokenize, bucket, forward, [layer
                         selection], [dense heads], pool
    model                SGPTModel / AsymModel: the embedding pipeline, save/load
    index                DenseIndex (exact; pending adds, tombstones, int8,
                         save/load in the JAX format), index_corpus
    retrieval            DenseRetriever: BEIR-shaped exact search
    serving              MicroBatcher, SearchService, the HTTP server
    crossencoder         SGPT-CE: CrossEncoderRanker, YesNoRanker, rerank
    ops.logprobs         continuation log-prob scorers over the LM head
    losses               MNRL (MultipleNegativesRankingLoss)
    training             ContrastiveTrainer (learnt mean, dense heads,
                         export_model), BitFit, schedules, GradCache, checkpoints
    cli.train_msmarco    the MS MARCO training command line
    cli.train_nli        the NLI (symmetric search) training command line
    cli.useb_retriever   USEB evaluation command line
    cli.beir_retriever   BEIR evaluation command line
    cli.serve            the HTTP search and rerank server command line
    cli.sgptce           cross-encoder rerank and evaluation command line
    cli.bm25_retriever   BM25 first-stage command line

    ops.flash_attention  causal flash attention forward (long context):
                         CUDA kernel, plain version, autograd function
    tokenization         the port's copies of the host modules it needs:
    data                 tokenizers and SPECB, MS MARCO and NLI triplets,
    evaluation           readers and batchers, the native jsonl reader,
                         retrieval metrics, BEIR, STS, USEB and the other
                         evaluators
    baselines            IO, the BEIR dataset download; and the
    ce_prompts           CE prompt registry and the BM25 index
    retrieval_bm25

The package imports torch, and never jax nor anything of the JAX package:
the host code it shares with `sgpt_tpu` is copied, not imported.
"""

__version__ = "0.1.0"
