"""Data pipeline: sharded synthetic token stream with replica-aware,
carbon-aware shard sourcing (the paper's space-shifting lever applied to
the input pipeline).

Every fetch picks the greenest replica of the dataset at fetch time and
records the transfer. Determinism: shard -> seed -> tokens, so restores
resume mid-epoch exactly (the loop checkpoints the cursor). The tokens
come from numpy's ``default_rng`` exactly as in the reference's
``data/pipeline.py``, so the port's batches are bit-equal to the
reference's; they are handed over as int32 tensors on ``device``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.cluster.topology import Cluster
from repro_torch.core.scheduler.space_shift import best_source


@dataclasses.dataclass
class ShardFetchRecord:
    shard: int
    source_site: str
    dest_site: str
    ci: float
    bytes: int
    t: float


@dataclasses.dataclass
class PipelineState:
    shard_cursor: int = 0
    step_in_shard: int = 0

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class TokenPipeline:
    """Synthetic LM token stream (structured enough that loss decreases:
    tokens follow a periodic + Markov mixture, so there is signal)."""

    def __init__(self, *, vocab_size: int, seq_len: int, batch: int,
                 dataset: str = "tokens-v1", seed: int = 0,
                 cluster: Optional[Cluster] = None,
                 consumer_site: str = "site_or",
                 steps_per_shard: int = 64,
                 shard_bytes: int = 1 << 28,
                 device: Union[str, torch.device] = "cpu"):
        self.vocab = vocab_size
        self.seq_len = seq_len
        self.batch = batch
        self.dataset = dataset
        self.seed = seed
        self.cluster = cluster
        self.consumer_site = consumer_site
        self.steps_per_shard = steps_per_shard
        self.shard_bytes = shard_bytes
        self.device = torch.device(device)
        self.state = PipelineState()
        self.fetches: List[ShardFetchRecord] = []

    # --- carbon-aware shard sourcing (space shifting) ---
    def _fetch_shard(self, shard: int, t: float) -> None:
        if self.cluster is None:
            return
        replicas = self.cluster.replicas_of(self.dataset)
        if not replicas:
            return
        if self.consumer_site in replicas:
            choice_site, ci = self.consumer_site, 0.0
        else:
            sc = best_source(replicas, self.consumer_site, t)
            choice_site, ci = sc.source, sc.expected_ci
        self.fetches.append(ShardFetchRecord(
            shard=shard, source_site=choice_site,
            dest_site=self.consumer_site, ci=ci, bytes=self.shard_bytes,
            t=t))

    # --- token synthesis ---
    def _tokens(self, shard: int, step: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + shard) * 65_537 + step)
        B, S, V = self.batch, self.seq_len, self.vocab
        base = rng.integers(0, V, size=(B, 1), dtype=np.int32)
        drift = rng.integers(1, 7, size=(B, 1), dtype=np.int32)
        pos = np.arange(S + 1, dtype=np.int32)[None, :]
        seq = (base + drift * pos) % V
        noise_mask = rng.random((B, S + 1)) < 0.1
        noise = rng.integers(0, V, size=(B, S + 1), dtype=np.int32)
        seq = np.where(noise_mask, noise, seq).astype(np.int32)
        return seq[:, :-1], seq[:, 1:]

    def next_batch(self, t: float = 0.0) -> Dict[str, torch.Tensor]:
        st = self.state
        if st.step_in_shard == 0:
            self._fetch_shard(st.shard_cursor, t)
        tokens, targets = self._tokens(st.shard_cursor, st.step_in_shard)
        st.step_in_shard += 1
        if st.step_in_shard >= self.steps_per_shard:
            st.shard_cursor += 1
            st.step_in_shard = 0
        return {"tokens": torch.from_numpy(tokens).to(self.device),
                "targets": torch.from_numpy(targets).to(self.device)}

    # --- checkpointable cursor ---
    def snapshot(self) -> Dict[str, int]:
        return self.state.as_dict()

    def restore(self, snap: Dict[str, int]) -> None:
        self.state = PipelineState(**snap)
