"""VecEnv: the host-plane lockstep environment protocol.

Vectorized replacement for the reference's subprocess vec-env
(SURVEY.md §1 L6, §2 "Env vectorization"). Key differences:

  * the protocol is BATCH-ONLY and fixed-shape: `step` takes (E,)
    actions and returns (E, ...) arrays every call — envs auto-reset
    internally so there is never a ragged "done" path (precondition
    for jit-friendly downstream processing);
  * `terminated` (true episode end — no bootstrap) and `truncated`
    (time-limit — bootstrap allowed) are separate, fixing the
    classic gym `done` conflation;
  * the observation returned on a `done` step is the FIRST observation
    of the next episode (auto-reset semantics); the terminal
    observation is not surfaced — our n-step machinery never
    bootstraps across `terminated` and never samples windows crossing
    `truncated` boundaries with stale obs (see history/replay.py).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    """Shapes the device side needs to allocate replay/model buffers."""
    obs_shape: Tuple[int, ...]
    obs_dtype: Any
    num_actions: int


class VecEnv:
    """Lockstep vectorized environment (batch of E independent envs)."""

    num_envs: int
    spec: EnvSpec

    def reset(self, seed: int = 0) -> np.ndarray:
        """Reset all envs. Returns obs (E, *obs_shape)."""
        raise NotImplementedError

    def step(self, actions: np.ndarray):
        """Step all envs in lockstep.

        Returns (obs, reward, terminated, truncated):
          obs (E, *obs_shape) — next obs, or first obs of the new
            episode for envs that finished (auto-reset);
          reward (E,) float32;
          terminated (E,) bool; truncated (E,) bool.
        """
        raise NotImplementedError

    def close(self):
        pass
