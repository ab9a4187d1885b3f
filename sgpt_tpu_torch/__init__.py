"""sgpt_tpu_torch — the SGPT bulk-encode path in PyTorch, with CUDA kernels for Hopper.

A port of `sgpt_tpu` (JAX) that grows beside it. Module names mirror the JAX
package so each counterpart is easy to find:

    models.config        DecoderConfig with a torch dtype, GPT-Neo presets
    models.params        random init and conversion of a JAX parameter tree
    models.decoder       GPT-Neo forward (nn.Module, layers in a ModuleList)
    ops.short_attention  fused short-T attention: CUDA kernel + plain version
    ops.pooling          weighted-mean / mean / last-token pooling, normalize
    encoder              EmbeddingEngine: tokenize, bucket, forward, pool

The package imports torch and never jax. Host code that imports no JAX
(`sgpt_tpu.tokenization`) is imported from the reference, not copied.
"""

__version__ = "0.1.0"
