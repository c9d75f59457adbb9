"""Text conditioning. Only the zero-embedding encoder the GEN3C CLI uses
by default (the prompt encoder disabled) is ported; the T5-11B encoder
waits for its checkpoint."""

from __future__ import annotations

from typing import List, Union

import numpy as np


class DummyT5TextEncoder:
    """Zero embeddings, (n_prompts, 512, 1024)."""

    def __init__(self, max_length: int = 512, embed_dim: int = 1024):
        self.max_length = max_length
        self.embed_dim = embed_dim

    def encode_prompts(self, prompts: Union[str, List[str]], max_length=None):
        if isinstance(prompts, str):
            prompts = [prompts]
        n = max_length or self.max_length
        emb = np.zeros((len(prompts), n, self.embed_dim), np.float32)
        mask = np.zeros((len(prompts), n), np.int64)
        return emb, mask
