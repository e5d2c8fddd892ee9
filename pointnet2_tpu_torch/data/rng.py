"""Thread-local sampling RNG.

An own copy of ``pointnet2_tpu/data/rng.py``: the port imports nothing of the
JAX package.

The batch producer (``data/pipeline.py``) runs ``num_workers`` *threads* all
calling ``SemanticDataset.sample_batch_in_all_files``. ``np.random.RandomState``
is not thread-safe: concurrent ``shuffle``/``randint`` on one shared instance
can corrupt its Mersenne-Twister state or duplicate draws. The reference
avoided this by re-seeding per worker *process* (train.py:123); the
thread-pool equivalent here is one independent RandomState per worker
*thread*, derived from a single ``np.random.SeedSequence`` so streams are
statistically independent (and each stream individually reproducible).

Determinism contract: with a fixed seed and a SINGLE sampling thread, the
batch stream is bit-reproducible across runs (the first ``get()`` always
receives the first spawned child stream). With multiple threads, each
thread's own stream is reproducible, but which thread produces which batch —
and therefore the interleaved stream order — depends on scheduling.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np


class ThreadLocalRNG:
    """One ``np.random.RandomState`` per calling thread.

    Children are spawned from a ``SeedSequence`` in first-call order, under a
    lock; each thread then owns its RandomState exclusively.
    """

    def __init__(self, seed: Optional[int] = None):
        self._seed_seq = np.random.SeedSequence(seed)
        self._lock = threading.Lock()
        self._local = threading.local()

    def get(self) -> np.random.RandomState:
        rng = getattr(self._local, "rng", None)
        if rng is None:
            with self._lock:
                child = self._seed_seq.spawn(1)[0]
            # RandomState over a PCG64 bit generator: legacy-API compatible
            # (shuffle/randint/choice) but seeded from the spawned stream.
            rng = np.random.RandomState(np.random.PCG64(child))
            self._local.rng = rng
        return rng


def resolve_rng(rng) -> np.random.RandomState:
    """A RandomState from either a RandomState or a ThreadLocalRNG."""
    return rng.get() if isinstance(rng, ThreadLocalRNG) else rng
