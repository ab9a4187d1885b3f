"""sgpt_tpu_torch — SGPT's bulk encode and contrastive training in PyTorch, with CUDA kernels for Hopper.

A port of `sgpt_tpu` (JAX) that grows beside it. Module names mirror the JAX
package so each counterpart is easy to find:

    models.config        DecoderConfig with a torch dtype, GPT-Neo presets
    models.params        random init and conversion of a JAX parameter tree
    models.decoder       GPT-Neo forward (nn.Module, layers in a ModuleList)
    ops.short_attention  fused short-T attention: CUDA forward and backward
                         kernels, their plain versions, the autograd function
    ops.pooling          weighted-mean / mean / last-token pooling, normalize
    ops.similarity       dot / cosine scores in fp32
    encoder              EmbeddingEngine: tokenize, bucket, forward, pool
    losses               MNRL (MultipleNegativesRankingLoss)
    training             ContrastiveTrainer, BitFit, schedules, GradCache,
                         checkpoints
    cli.train_msmarco    the MS MARCO training command line

The package imports torch and never jax. Host code that imports no JAX
(`sgpt_tpu.tokenization`, `sgpt_tpu.data`, `sgpt_tpu.evaluation`) is
imported from the reference, not copied.
"""

__version__ = "0.1.0"
