"""Modality-frontend stubs (a copy of ``repro/data/frontends.py``, kept in
the port so that it imports nothing of the JAX package; the same seed gives
the same arrays).  The audio and vision configs specify the transformer
backbone only: these give it precomputed frame and patch embeddings.

Deterministic low-rank gaussians: cheap to generate at any size, and they
give the backbone non-degenerate inputs (distinct per position, correlated
channels).
"""
from __future__ import annotations

import numpy as np


def _lowrank(rng, n, dim, rank=16):
    a = rng.standard_normal((n, rank)).astype(np.float32)
    b = rng.standard_normal((rank, dim)).astype(np.float32) / np.sqrt(rank)
    return a @ b


def audio_frames(batch: int, n_frames: int, dim: int, *, seed: int = 0
                 ) -> np.ndarray:
    """Precomputed conv-frontend frame embeddings: (B, n_frames, dim)."""
    out = np.stack([_lowrank(np.random.default_rng((seed, 1, b)),
                             n_frames, dim) for b in range(batch)])
    return out.astype(np.float32)


def vision_patches(batch: int, n_patches: int, dim: int, *, seed: int = 0
                   ) -> np.ndarray:
    """Precomputed ViT patch embeddings: (B, n_patches, dim)."""
    out = np.stack([_lowrank(np.random.default_rng((seed, 2, b)),
                             n_patches, dim) for b in range(batch)])
    return out.astype(np.float32)
