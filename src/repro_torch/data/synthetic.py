"""Deterministic synthetic corpus + document packing (a copy of
``repro/data/synthetic.py`` for text models, kept in the port so that it
imports nothing of the JAX package; the same seed gives the same batches).

Zipfian unigram tokens with per-document Markov drift give a corpus that is
(a) reproducible from a seed, (b) compressible enough that training loss
visibly decreases within a few hundred steps.

The pipeline is host-side numpy (a CPU input pipeline feeding the card),
sharded per host, with packing into fixed ``seq_len`` rows using EOS
separators.  Audio and vision inputs come with their slices of the port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from repro_torch.models.config import ArchConfig, ShapeSpec

EOS = 0


@dataclass
class SyntheticCorpus:
    vocab_size: int
    seed: int = 0
    zipf_a: float = 1.2
    mean_doc_len: int = 512

    def documents(self, start_doc: int = 0) -> Iterator[np.ndarray]:
        """Infinite stream of variable-length documents; resumable by index."""
        i = start_doc
        while True:
            yield self.document(i)
            i += 1

    def document(self, idx: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, idx))
        n = max(8, int(rng.lognormal(np.log(self.mean_doc_len), 0.6)))
        # zipf over vocab (rejection-free: clip) + markov drift for structure
        base = rng.zipf(self.zipf_a, size=n)
        toks = (base % (self.vocab_size - 1)) + 1          # reserve 0 for EOS
        drift = rng.integers(0, self.vocab_size // 4 + 1)
        toks = ((toks + drift) % (self.vocab_size - 1)) + 1
        # inject copy structure: every other 16-token span repeats previous
        if n >= 64:
            toks[n // 2: n // 2 + 16] = toks[:16]
        return toks.astype(np.int32)


def pack_documents(doc_iter: Iterator[np.ndarray], seq_len: int,
                   rows: int) -> np.ndarray:
    """Greedy packing of documents into (rows, seq_len+1) with EOS joints."""
    out = np.zeros((rows, seq_len + 1), np.int32)
    buf = np.zeros((0,), np.int32)
    for r in range(rows):
        while buf.shape[0] < seq_len + 1:
            doc = next(doc_iter)
            buf = np.concatenate([buf, doc, np.array([EOS], np.int32)])
        out[r] = buf[: seq_len + 1]
        buf = buf[seq_len + 1:]
    return out


def batch_for(cfg: ArchConfig, shape: ShapeSpec, *, seed: int = 0,
              host_id: int = 0, n_hosts: int = 1,
              step: int = 0) -> Dict[str, np.ndarray]:
    """One deterministic global batch (host's shard) for (arch, shape)."""
    if cfg.modality != "text":
        raise NotImplementedError(
            f"{cfg.name}: {cfg.modality} batches come with the port's "
            f"{cfg.modality} slice")
    B = shape.global_batch // n_hosts
    S = shape.seq_len
    corpus = SyntheticCorpus(cfg.vocab_size, seed=seed)
    start = (step * shape.global_batch + host_id * B) * 4  # doc stride
    packed = pack_documents(corpus.documents(start), S, B)
    return {"tokens": packed[:, :-1], "labels": packed[:, 1:]}


def make_batch_iter(cfg: ArchConfig, shape: ShapeSpec, *, seed: int = 0,
                    host_id: int = 0, n_hosts: int = 1, start_step: int = 0):
    """Resumable infinite batch iterator (checkpoint stores the step)."""
    step = start_step
    while True:
        yield batch_for(cfg, shape, seed=seed, host_id=host_id,
                        n_hosts=n_hosts, step=step)
        step += 1
