"""Copy of ``repro.data.tokens`` for the PyTorch port (held equal to it by
tests/test_torch_streaming.py).

Deterministic, resumable, host-shardable synthetic token pipeline.

Production data loading concerns implemented here:
* **Determinism**: batch ``i`` is a pure function of (seed, i) — restart at
  any step reproduces the exact token stream (required for bitwise resume).
* **Resumability**: the iterator state is a single integer (next batch idx),
  checkpointed alongside the model.
* **Host sharding**: each host materializes only its slice of the global
  batch (``host_id / n_hosts``).
* **Structure**: tokens follow an order-k Markov chain over a power-law
  unigram prior (zipf), so a language model has learnable structure and the
  training loss decreases — a pure-noise stream would not separate broken
  training from working training.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TokenPipeline"]


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    next_index: int = 0          # checkpointable cursor

    def __post_init__(self):
        assert self.global_batch % self.n_hosts == 0
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        # zipf unigram prior
        self._prior = 1.0 / np.arange(1, v + 1) ** 1.1
        self._prior /= self._prior.sum()
        # a sparse deterministic bigram kernel: each token prefers a few
        # successors (mixture with the prior keeps entropy reasonable)
        self._succ = rng.integers(0, v, size=(v, 4))

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.n_hosts

    def batch_at(self, index: int) -> np.ndarray:
        """The (local_batch, seq_len) int32 tokens of global batch ``index``."""
        out = np.empty((self.local_batch, self.seq_len), np.int32)
        for row in range(self.local_batch):
            global_row = self.host_id * self.local_batch + row
            rng = np.random.default_rng(
                (self.seed, index, global_row))
            toks = np.empty(self.seq_len, np.int32)
            toks[0] = rng.choice(self.vocab_size, p=self._prior)
            # vectorized Markov walk: pre-draw choices and mixture flags
            mix = rng.random(self.seq_len) < 0.75
            pick = rng.integers(0, 4, size=self.seq_len)
            fallback = rng.choice(self.vocab_size, size=self.seq_len,
                                  p=self._prior)
            for t in range(1, self.seq_len):
                toks[t] = self._succ[toks[t - 1], pick[t]] if mix[t] \
                    else fallback[t]
            out[row] = toks
        return out

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        batch = self.batch_at(self.next_index)
        self.next_index += 1
        return batch

    # -- checkpoint integration ---------------------------------------------
    def state_dict(self) -> dict:
        return {"next_index": self.next_index, "seed": self.seed}

    def load_state_dict(self, state: dict) -> None:
        assert state["seed"] == self.seed, "data seed mismatch on resume"
        self.next_index = int(state["next_index"])
