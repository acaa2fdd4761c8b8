"""Device-resident environments: dynamics as jitted jnp, zero host I/O.

The host->device hop is the acting path's wall (even on PCIe it caps
fast envs). For envs whose dynamics are pure math, the device-resident
move is to run them ON the accelerator: `lax.scan` the whole
act->step->record loop and only scalars (episode stats) ever reach the
host. This is the "vectorized envs thousands-wide" capability
(SURVEY.md §0 item 1) executed at its logical extreme: lanes are free
up to VMEM/HBM limits, and acting throughput is compute-bound, not
transfer-bound.

DeviceCartPole reproduces gymnasium CartPole-v1 exactly (same Euler
integration and constants as envs/cartpole.py — cross-checked in
tests/test_device_env.py) with auto-reset and time-limit truncation.
State is a pytree; `step` is shape-polymorphic over the lane count.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

GRAVITY = 9.8
MASSCART = 1.0
MASSPOLE = 0.1
TOTAL_MASS = MASSCART + MASSPOLE
LENGTH = 0.5
POLEMASS_LENGTH = MASSPOLE * LENGTH
FORCE_MAG = 10.0
TAU = 0.02
THETA_THRESHOLD = 12 * 2 * jnp.pi / 360
X_THRESHOLD = 2.4


class DeviceCartPoleState(NamedTuple):
    s: jnp.ndarray       # (E, 4) physics state
    steps: jnp.ndarray   # (E,) int32 steps since reset
    key: jnp.ndarray     # PRNG for reset sampling


class DeviceCartPole:
    """Pure-function CartPole batch; all methods jit-safe."""

    num_actions = 2
    obs_shape = (4,)
    obs_dtype = jnp.float32

    def __init__(self, time_limit: int = 500):
        self.time_limit = time_limit

    def reset(self, key, num_envs: int) -> DeviceCartPoleState:
        key, sub = jax.random.split(key)
        s = jax.random.uniform(sub, (num_envs, 4), jnp.float32,
                               minval=-0.05, maxval=0.05)
        return DeviceCartPoleState(
            s=s,
            steps=jnp.zeros((num_envs,), jnp.int32),
            key=key)

    def observe(self, state: DeviceCartPoleState) -> jnp.ndarray:
        """Observation view of the state (no copy; used inside jit)."""
        return state.s

    def step(self, state: DeviceCartPoleState, actions: jnp.ndarray):
        """(state, obs (E,4), reward (E,), term (E,), trunc (E,))."""
        x, x_dot, th, th_dot = (state.s[:, 0], state.s[:, 1],
                                state.s[:, 2], state.s[:, 3])
        force = jnp.where(actions == 1, FORCE_MAG, -FORCE_MAG)
        cos, sin = jnp.cos(th), jnp.sin(th)
        temp = (force + POLEMASS_LENGTH * th_dot ** 2 * sin) / TOTAL_MASS
        th_acc = (GRAVITY * sin - cos * temp) / (
            LENGTH * (4.0 / 3.0 - MASSPOLE * cos ** 2 / TOTAL_MASS))
        x_acc = temp - POLEMASS_LENGTH * th_acc * cos / TOTAL_MASS
        x = x + TAU * x_dot
        x_dot = x_dot + TAU * x_acc
        th = th + TAU * th_dot
        th_dot = th_dot + TAU * th_acc
        s = jnp.stack([x, x_dot, th, th_dot], axis=1)
        steps = state.steps + 1

        terminated = ((jnp.abs(x) > X_THRESHOLD)
                      | (jnp.abs(th) > THETA_THRESHOLD))
        truncated = (~terminated) & (steps >= self.time_limit)
        done = terminated | truncated
        reward = jnp.ones_like(x, jnp.float32)

        # auto-reset finished lanes
        key, sub = jax.random.split(state.key)
        fresh = jax.random.uniform(sub, s.shape, s.dtype,
                                   minval=-0.05, maxval=0.05)
        s = jnp.where(done[:, None], fresh, s)
        steps = jnp.where(done, 0, steps)
        new_state = DeviceCartPoleState(s=s, steps=steps, key=key)
        return new_state, reward, terminated, truncated


DEVICE_ENVS = {"cartpole": DeviceCartPole}


def make_device_env(name: str, **kwargs):
    try:
        return DEVICE_ENVS[name](**kwargs)
    except KeyError:
        raise KeyError(f"unknown device env {name!r}; "
                       f"available: {sorted(DEVICE_ENVS)}") from None


def _register_handles():
    """Config-registry handles: {"type": "cartpole_device", ...}."""
    import numpy as np
    from rltime_tpu.config.registry import register
    from rltime_tpu.envs.base import EnvSpec

    @register("cartpole_device")
    class CartPoleDeviceHandle:
        is_device = True

        def __init__(self, num_envs: int, time_limit: int = 500,
                     seed: int = 0):
            del seed  # keying comes from the actor's PRNG stream
            self.num_envs = num_envs
            self.inner = DeviceCartPole(time_limit)
            self.spec = EnvSpec((4,), np.float32, 2)

        def close(self):
            pass

    return CartPoleDeviceHandle


_register_handles()
