"""Serving engine: batched greedy decoding in admission waves (counterpart of
``repro.serving.engine``).

The paper's κ-batching generalised to LM serving: up to ``batch_size``
requests share one wave; their prompts are left-padded with token 0 (no pad
mask, as in the reference), prefill fills the cache, and decode advances all
slots in lock-step, one ``decode_step`` per token, argmax on the first
maximum.  Prefill gets ``{"tokens"}`` only, as in the reference: a vlm is
served text-only, and whisper's prefill raises ``KeyError: 'frames'``
(the reference's ``engine.py:59`` against ``decode.py:107``; copied).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.models.transformer import ModelApi


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int = 16
    out_tokens: Optional[List[int]] = None


class ServingEngine:
    """Greedy-decode engine with static batch slots (padded prompts)."""

    def __init__(self, api: ModelApi, params, batch_size: int, max_len: int):
        self.api = api
        self.params = params
        self.batch = batch_size
        self.max_len = max_len

    def serve(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Process all requests in waves of ``batch_size`` (paper §5.1's
        personalization vertices in waves of κ)."""
        results: Dict[int, List[int]] = {}
        queue = list(requests)
        while queue:
            wave, queue = queue[: self.batch], queue[self.batch:]
            results.update(self._serve_wave(wave))
        return results

    def _serve_wave(self, wave: List[Request]) -> Dict[int, List[int]]:
        b = self.batch
        plen = max(len(r.prompt) for r in wave)
        toks = np.zeros((b, plen), np.int32)
        for i, r in enumerate(wave):
            toks[i, plen - len(r.prompt):] = r.prompt  # left-pad
        cache = self.api.init_cache(b, self.max_len)
        logits, cache = self.api.prefill(self.params, {"tokens": toks}, cache)
        out = {r.uid: [] for r in wave}
        cur = logits.argmax(-1)[:, None]
        max_new = max(r.max_new_tokens for r in wave)
        for t in range(max_new):
            host = cur[:, 0].tolist()
            for i, r in enumerate(wave):
                if t < r.max_new_tokens:
                    out[r.uid].append(host[i])
            logits, cache = self.api.decode_step(self.params, cur, plen + t, cache)
            cur = logits.argmax(-1)[:, None]
        return out
