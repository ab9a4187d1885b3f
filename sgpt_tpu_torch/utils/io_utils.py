"""Text/list cleaning helpers for the API baseline path
(ref: biencoder/beir/io_utils/plugin_io_utils.py:14-129).

The port's own copy of `sgpt_tpu/utils/io_utils.py`, with the same
behaviour: the port imports nothing of the JAX package."""
from __future__ import annotations

from typing import List, Sequence, Union


def clean_empty_list(sequence):
    """'' for empty/None lists; pass everything else through."""
    if isinstance(sequence, list):
        return sequence if sequence else ""
    return sequence if sequence is not None else ""


def unique_list(sequence: Sequence) -> List:
    """Order-preserving dedupe."""
    seen = set()
    out = []
    for item in sequence:
        if item not in seen:
            seen.add(item)
            out.append(item)
    return out


def truncate_text_list(text_list: Sequence[str], num_characters: int = 140) -> List[str]:
    """Truncate each text, appending an ellipsis when cut."""
    out = []
    for t in text_list:
        t = str(t)
        out.append(t[:num_characters] + " (...)" if len(t) > num_characters else t)
    return out


def generate_unique(name: str, existing_names: Sequence[str], prefix: str = "") -> str:
    """Column name not colliding with existing ones (prefix_name, _2, _3 ...)."""
    base = f"{prefix}_{name}" if prefix else name
    if base not in existing_names:
        return base
    i = 2
    while f"{base}_{i}" in existing_names:
        i += 1
    return f"{base}_{i}"
