"""The port's copy of what `beir_retriever --download` needs from
`sgpt_tpu/baselines/openai_client.py`."""
from .openai_client import fetch_beir_dataset

__all__ = ["fetch_beir_dataset"]
