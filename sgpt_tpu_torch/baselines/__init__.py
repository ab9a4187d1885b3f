"""The remote-API baselines (counterpart of `sgpt_tpu/baselines`): the
OpenAI embeddings retriever and client, the search-endpoint scoring replica,
and the BEIR and USEB dataset downloads."""
from .openai_embeddings import OpenAIRetriever
from .openai_search import construct_context, get_score, openai_search
from .openai_client import (OpenAIEmbedClient, fetch_beir_dataset,
                            fetch_useb_data)

__all__ = ["OpenAIRetriever", "construct_context", "get_score", "openai_search",
           "OpenAIEmbedClient", "fetch_beir_dataset", "fetch_useb_data"]
