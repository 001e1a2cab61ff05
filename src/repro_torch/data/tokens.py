"""Synthetic LM token pipeline: deterministic, host-sharded, learnable.

Sequences follow a noisy affine-recurrence over the vocab
(``x_{t+1} = (a x_t + b) mod V`` with per-sequence (a, b) from a small pool
and epsilon token noise), so a model must learn transition structure — loss
decreases measurably within a few hundred steps on a ~10-100M model (the
end-to-end example's acceptance check).

``ShardedTokenStream`` carves the global batch by (host_id, n_hosts) and is
deterministic in (seed, step): any host can recompute any step — this is the
data-side story for elastic restarts and straggler reassignment
(``reassign_shards``).

Port of ``src/repro/data/tokens.py``, copied as is (numpy only): the
same tokens for the same ``(seed, step)``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List

import numpy as np

_POOL = [(5, 3), (7, 11), (13, 1), (17, 29)]


def synthetic_tokens(seed: int, step: int, batch: int, seq: int,
                     vocab: int, noise: float = 0.05) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    ab = rng.integers(0, len(_POOL), size=batch)
    a = np.array([_POOL[i][0] for i in ab])[:, None]
    b = np.array([_POOL[i][1] for i in ab])[:, None]
    x0 = rng.integers(0, vocab, size=(batch, 1))
    toks = np.empty((batch, seq), dtype=np.int32)
    toks[:, :1] = x0
    for t in range(1, seq):
        toks[:, t:t + 1] = (a * toks[:, t - 1:t] + b) % vocab
    flip = rng.random((batch, seq)) < noise
    toks[flip] = rng.integers(0, vocab, size=int(flip.sum()))
    return toks


@dataclasses.dataclass
class ShardedTokenStream:
    vocab: int
    global_batch: int
    seq: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    step: int = 0

    def __post_init__(self):
        assert self.global_batch % self.n_hosts == 0

    @property
    def local_batch(self) -> int:
        return self.global_batch // self.n_hosts

    def batch_at(self, step: int, host_id=None) -> Dict[str, np.ndarray]:
        host_id = self.host_id if host_id is None else host_id
        full = synthetic_tokens(self.seed, step, self.global_batch,
                                self.seq, self.vocab)
        lo = host_id * self.local_batch
        return {"tokens": full[lo:lo + self.local_batch]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(self.step)
            self.step += 1


def reassign_shards(n_hosts: int, failed: List[int]) -> Dict[int, List[int]]:
    """Deterministic straggler/failure reassignment: each failed host's batch
    shard goes to the surviving host with the fewest extra shards (stable
    round-robin) — every survivor computes the same mapping with no
    coordination."""
    alive = [h for h in range(n_hosts) if h not in set(failed)]
    if not alive:
        raise RuntimeError("no survivors")
    mapping = {h: [h] for h in alive}
    for i, f in enumerate(sorted(failed)):
        owner = alive[i % len(alive)]
        mapping[owner].append(f)
    return mapping
