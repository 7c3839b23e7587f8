"""Step functions for serving (PyTorch port of ``repro/launch/steps.py``'s
prefill and serve steps).  Training steps come with the training slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import registry as R
from repro_torch.models.config import ArchConfig


def make_prefill_step(cfg: ArchConfig, *, moe_dispatch: str = "einsum",
                      cache_len: Optional[int] = None, device=None):
    """(params, batch) -> (last_logits, cache)."""
    def prefill_step(params, batch):
        return R.prefill(params, cfg, batch, cache_len=cache_len,
                         moe_dispatch=moe_dispatch, device=device)
    return prefill_step


def make_serve_step(cfg: ArchConfig, *, moe_dispatch: str = "einsum",
                    device=None):
    """One decode step: (params, tokens, pos, cache) ->
    (next_tokens, logits, cache), greedy (argmax) as in the reference."""
    def serve_step(params, tokens, pos, cache):
        logits, cache = R.decode_step(params, cfg, tokens, pos, cache,
                                      moe_dispatch=moe_dispatch,
                                      device=device)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return nxt, logits, cache
    return serve_step
