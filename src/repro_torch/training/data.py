"""Deterministic, stateless data pipeline (the JAX package's
``repro.training.data``, copied: numpy only, so the two packages draw the
same batches).

``batch_at(step)`` is a pure function of (seed, step) via counter-based RNG
(Philox), so checkpoint/restart and elastic re-sharding recover the *exact*
token stream with no pipeline state beyond the step counter — the data-side
half of the fault-tolerance contract.  The arrays are numpy; the train
launcher moves them onto its device.

Real deployments swap `_materialize` for a deterministic tokenized-shard
reader keyed the same way ((seed, step, host_slice) -> examples).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticTokenPipeline"]


@dataclasses.dataclass(frozen=True)
class SyntheticTokenPipeline:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    # optional stub-modality inputs
    vis_tokens: int = 0
    enc_len: int = 0
    d_model: int = 0

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.Generator(np.random.Philox(key=self.seed, counter=step))

    def batch_at(self, step: int, *, host_slice: slice | None = None) -> dict:
        """Global (or host-sliced) batch for `step`; identical across restarts."""
        rng = self._rng(step)
        tokens = rng.integers(0, self.vocab, size=(self.global_batch, self.seq_len), dtype=np.int32)
        batch = {"tokens": tokens}
        if self.vis_tokens:
            batch["vis_emb"] = rng.normal(0, 0.1, size=(self.global_batch, self.vis_tokens, self.d_model)).astype(np.float32)
        if self.enc_len:
            batch["enc_emb"] = rng.normal(0, 0.1, size=(self.global_batch, self.enc_len, self.d_model)).astype(np.float32)
        if host_slice is not None:
            batch = {k: v[host_slice] for k, v in batch.items()}
        return batch
