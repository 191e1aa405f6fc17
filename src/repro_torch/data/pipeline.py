"""Deterministic synthetic token pipeline with host sharding + prefetch:
the port's own copy of the JAX package's ``data/pipeline.py`` (numpy only;
its batches are byte for byte the JAX package's).

Production shape: each host owns a disjoint slice of the global batch
(``host_id/num_hosts``), the stream is a pure function of (seed, step) so a
restarted/re-meshed job regenerates exactly the batches it would have seen
(elastic restart needs no data checkpoint beyond the step counter).

The generator is a mixture of Zipfian unigrams and a repeated-ngram process,
so the LM loss actually *decreases* during the example runs (pure uniform
noise would pin loss at log V).  A background thread keeps a bounded
prefetch queue — backpressure-free: a slow consumer never blocks generation
beyond ``depth`` (straggler isolation on the input side).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np

__all__ = ["Batch", "SyntheticLM", "make_loader"]


@dataclasses.dataclass
class Batch:
    tokens: np.ndarray            # (B, S) int32
    labels: np.ndarray            # (B, S) int32 (next-token, -1 = masked)
    step: int
    extras: Optional[dict] = None   # modality stubs (enc_embed / patches)


class SyntheticLM:
    def __init__(self, vocab: int, seq_len: int, global_batch: int, *,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1,
                 family: str = "dense", d_model: int = 0, prefix_len: int = 0):
        assert global_batch % num_hosts == 0
        self.vocab = vocab
        self.seq = seq_len
        self.local_batch = global_batch // num_hosts
        self.seed = seed
        self.host_id = host_id
        self.family = family
        self.d_model = d_model
        self.prefix_len = prefix_len
        # fixed zipf table
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        self.probs = (1.0 / ranks ** 1.1)
        self.probs /= self.probs.sum()

    def batch(self, step: int) -> Batch:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        B, S = self.local_batch, self.seq
        toks = rng.choice(self.vocab, size=(B, S), p=self.probs).astype(np.int32)
        # inject learnable structure: repeat a random earlier span
        for b in range(B):
            if S >= 32:
                w = int(rng.integers(8, min(17, S // 4 + 1)))
                src = int(rng.integers(0, S - 2 * w))
                dst = int(rng.integers(src + w, S - w + 1))
                toks[b, dst : dst + w] = toks[b, src : src + w]
        labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)], 1)
        extras = {}
        if self.family == "audio":
            extras["enc_embed"] = rng.standard_normal(
                (B, S, self.d_model), dtype=np.float32)
        if self.family == "vlm":
            extras["patches"] = rng.standard_normal(
                (B, self.prefix_len, self.d_model), dtype=np.float32)
        return Batch(toks, labels, step, extras or None)


def make_loader(ds: SyntheticLM, start_step: int = 0, *,
                depth: int = 2) -> Iterator[Batch]:
    """Prefetching iterator; deterministic resume from ``start_step``."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            try:
                q.put(ds.batch(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    class _Iter:
        def __iter__(self):
            return self

        def __next__(self):
            return q.get()

        def close(self):
            stop.set()

    return _Iter()
