"""sgpt_tpu_torch — SGPT's bulk encode, contrastive training (asymmetric and symmetric), search, cross-encoder rerank and serving in PyTorch, with CUDA kernels for Hopper; the sentence-transformers encoder backbones (BERT, T5, CLIP) and word-level modules beside.

A port of `sgpt_tpu` (JAX) that grows beside it. Module names mirror the JAX
package so each counterpart is easy to find:

    models.config        DecoderConfig with a torch dtype; GPT-Neo, GPT-J-6B,
                         BLOOM, BERT and T5 (encoder) presets
    models.params        random init and conversion of a JAX parameter tree
                         and of the JAX trainer's aux (learnt weights, heads)
    models.decoder       GPT-Neo / GPT-J / BLOOM / BERT / T5 forward
                         (nn.Module, layers in a ModuleList); bidirectional
                         and relative-bias attention in plain PyTorch
    models.clip          the CLIP dual tower (text, ViT), CLIPEncoder
    models.hf_loader     local HF checkpoints (safetensors, .bin, sharded)
                         of the GPT families, BERT and T5
    models.hf_export     the decoder's weights under HF names, config.json
    ops.short_attention  fused short-T attention: CUDA forward and backward
                         kernels, their plain versions, the autograd function
    ops.mips             streaming exact MIPS top-k: CUDA kernel, plain version
    ops.topk             merge / chunked / block-max exact top-k (plain torch)
    ops.pooling          every pooler of the JAX package (single-layer, all-layer,
                         learnt weights), normalize
    ops.similarity       dot / cosine scores in fp32
    ops.search_utils     semantic search, paraphrase mining, community
                         detection over embeddings
    ops.quant            int8 inference: per-channel int8 weights, per-token
                         int8 activations, torch._int_mm on the card
    encoder              EmbeddingEngine: tokenize, bucket, forward, [layer
                         selection], [dense heads], pool; pinned copies,
                         dispatch chains and a depth-2 fetch pipeline
    model                SGPTModel / AsymModel: the embedding pipeline, save/load
    index                DenseIndex (exact; pending adds, tombstones, int8,
                         save/load in the JAX format), index_corpus
    index_ivf            IVFIndex (balanced IVF, auto-K, overflow slab, int8,
                         save/load in the JAX format)
    retrieval            DenseRetriever: BEIR-shaped exact search
    serving              MicroBatcher, SearchService, the HTTP server
    crossencoder         SGPT-CE: CrossEncoderRanker, YesNoRanker, rerank
    ops.logprobs         continuation log-prob scorers over the LM head
    cross_encoder_trainable  the trainable cross-encoder and its evaluators
    modules              word-level ST modules: tokenizers, word embeddings,
                         BoW, CNN, LSTM, embedding dropout
    losses               MNRL (also over a mesh's dp rows) and the other
                         sentence-transformers losses
    training             ContrastiveTrainer (learnt mean, dense heads,
                         export_model; dp × tp meshes, sequence
                         parallelism), TSDAETrainer, BitFit, schedules,
                         GradCache, checkpoints
    parallel             single-controller (dp, tp) meshes, Megatron
                         sharding and unsharding, collectives
    ops.ring_attention   ring attention over a mesh's dp devices (sp_mesh)
    cli.train_msmarco    the MS MARCO training command line
    cli.train_nli        the NLI (symmetric search) training command line
    cli.train_tsdae      TSDAE pretraining command line
    cli.useb_retriever   USEB evaluation command line
    cli.beir_retriever   BEIR evaluation command line
    cli.serve            the HTTP search and rerank server command line
    cli.sgptce           cross-encoder rerank and evaluation command line
    cli.bm25_retriever   BM25 first-stage command line
    cli.bioasq_convert   BioASQ → BEIR conversion command line

    ops.flash_attention  causal flash attention forward (long context):
                         CUDA kernel, plain version, autograd function
    tokenization         the port's copies of the host modules it needs:
    data                 tokenizers and SPECB, MS MARCO, NLI and BioASQ data,
    evaluation           readers and batchers, the native jsonl reader,
                         retrieval metrics, BEIR, STS, USEB and the other
                         evaluators
    baselines            the remote-API baselines: the OpenAI embeddings
                         client and retriever, the search-endpoint scoring,
                         the BEIR and USEB dataset downloads; and the
    ce_prompts           CE prompt registry and the BM25 index
    retrieval_bm25
    utils                host utilities: the thread-pool DataFrame map and
                         text helpers of the baselines, Timer, span (the
                         program's profiler ranges), profile_trace
                         (torch.profiler's Chrome trace of every thread),
                         the optional wandb logger

The package imports torch, and never jax nor anything of the JAX package:
the host code it shares with `sgpt_tpu` is copied, not imported.
"""

__version__ = "0.1.0"
