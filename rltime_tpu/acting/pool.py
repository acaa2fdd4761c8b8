"""Async acting: a background rollout thread feeding the learner.

The reference's "actor pool" is N actor subprocesses streaming
transitions to the learner through queues, with periodic weight
refresh (SURVEY.md §2 "Actor pool / async acting"). Device-side
equivalent: ONE background thread drives the vectorized env engine
(numpy/C++ lanes release the GIL; the jitted act step dispatches
async), handing fixed-shape chunks to the learner thread through a
bounded queue. Weight publication is a params swap picked up at the
next chunk boundary — same staleness semantics as the reference's
periodic refresh.

Backpressure: the queue holds at most `max_queue` chunks; the actor
blocks when the learner falls behind, so off-policy staleness is
bounded by max_queue * chunk_len steps.

The synchronous path (Trainer calling Actor.rollout inline) remains
the default — it is deterministic and matches the fixed-seed numerics
bar; async acting trades exact reproducibility for throughput,
exactly like the reference's async mode.
"""
from __future__ import annotations

import queue
import threading
from typing import Optional

from rltime_tpu.acting.actor import Actor


class AsyncActorPool:
    """Runs an Actor on a background thread; learner pulls chunks."""

    def __init__(self, actor: Actor, initial_params,
                 max_queue: int = 2):
        import jax
        import jax.numpy as jnp
        self._copy = lambda p: jax.tree.map(jnp.copy, p)
        self.actor = actor
        # The learner DONATES its train state every update; the actor
        # thread must hold its own copy or its buffers get deleted
        # mid-flight.
        self._params = self._copy(initial_params)
        self._queue: queue.Queue = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._exc: Optional[BaseException] = None
        self._thread.start()

    # -- learner side --------------------------------------------------
    def get_chunk(self, timeout: float = 300.0):
        """Next transition chunk (blocks until the actor produced one)."""
        if self._exc is not None:
            raise RuntimeError("actor thread died") from self._exc
        chunk, info = self._queue.get(timeout=timeout)
        return chunk, info

    def set_params(self, params):
        """Publish fresh weights (picked up at the next chunk).

        Copies: the learner's buffers are donation-recycled."""
        fresh = self._copy(params)
        with self._lock:
            self._params = fresh

    @property
    def env_steps(self) -> int:
        return self.actor.env_steps

    def episode_stats(self, clear: bool = True):
        return self.actor.episode_stats(clear)

    def close(self):
        self._stop.set()
        # drain so the producer unblocks
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10)

    # -- actor thread --------------------------------------------------
    def _run(self):
        try:
            while not self._stop.is_set():
                with self._lock:
                    params = self._params
                chunk, info = self.actor.rollout(params)
                while not self._stop.is_set():
                    try:
                        self._queue.put((chunk, info), timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced on the learner side
            self._exc = e
