"""MinAtar-style device-resident games: image-obs RL fully on-chip.

The reference validates its CNN/PER/distributional stack on ALE Atari
(SURVEY.md §0 items 1, 4); ALE is a host C++ emulator and unavailable
in this sandbox. These envs provide the same *validation capability*
the device-resident way: miniaturized Atari games (the published MinAtar
suite dynamics — Young & Tian 2019, arXiv:1903.03176) re-implemented
as pure vectorized jnp, so the image-observation pipeline (CNN torso,
frame window gather, PER, IQN/R2D2) trains end-to-end with ZERO host
involvement — dynamics, acting, replay, and learning all inside one
jitted program (same fused path as envs/device.py DeviceCartPole).

Observations are (10, 10, C) binary planes, uint8 NHWC. There is no
frame stack; a "trail" channel encodes ball motion (one-step memory),
matching MinAtar. Sticky actions (p=0.1 default) match the MinAtar
evaluation protocol. A configurable time-limit truncation is a
framework addition (MinAtar itself never truncates) so lockstep lanes
cannot wedge in infinite episodes; it is reported via `truncated`, so
targets bootstrap correctly across it.

Breakout dynamics follow the published game exactly (paddle row 9,
ball dir in {up-left, up-right, down-right, down-left}, 3 brick rows
that refill when cleared, strike flag preventing double-scoring,
paddle edge-hit sideways deflection); tests/test_minatar.py checks the
vectorized step against an independent scalar numpy model on long
random action sequences.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# direction index -> (dx, dy); 0: up-left, 1: up-right, 2: down-right,
# 3: down-left (MinAtar breakout encoding)
_DX = jnp.array([-1, 1, 1, -1], jnp.int32)
_DY = jnp.array([-1, -1, 1, 1], jnp.int32)
_REFLECT_Y = jnp.array([3, 2, 1, 0], jnp.int32)   # bounce off top/paddle
_REFLECT_X = jnp.array([1, 0, 3, 2], jnp.int32)   # bounce off side walls
_SIDE_HIT = jnp.array([2, 3, 0, 1], jnp.int32)    # paddle edge deflection


class BreakoutState(NamedTuple):
    ball_y: jnp.ndarray     # (E,) int32
    ball_x: jnp.ndarray     # (E,) int32
    ball_dir: jnp.ndarray   # (E,) int32 in [0, 4)
    pos: jnp.ndarray        # (E,) int32 paddle x
    last_y: jnp.ndarray     # (E,) int32 previous ball cell (trail)
    last_x: jnp.ndarray     # (E,) int32
    brick_map: jnp.ndarray  # (E, 10, 10) bool
    strike: jnp.ndarray     # (E,) bool — brick hit on previous move
    last_action: jnp.ndarray  # (E,) int32 for sticky actions
    steps: jnp.ndarray      # (E,) int32 steps since reset
    key: jnp.ndarray


def _breakout_fresh(side: jnp.ndarray) -> dict:
    """Initial lane state given per-lane ball side (bool, (E,))."""
    import numpy as np
    E = side.shape[0]
    brick = jnp.zeros((E, 10, 10), jnp.bool_).at[:, 1:4, :].set(True)

    def zi(v=0):
        # DISTINCT numpy-backed buffer per leaf: identical jnp
        # constants may share one buffer, which breaks donation
        # (CLAUDE.md conventions). Inside jit this is a baked constant.
        return jnp.asarray(np.full((E,), v, np.int32))

    return dict(
        ball_y=zi(3),
        ball_x=jnp.where(side, 9, 0).astype(jnp.int32),
        ball_dir=jnp.where(side, 3, 2).astype(jnp.int32),
        pos=zi(4),
        last_y=zi(3),
        last_x=jnp.where(side, 9, 0).astype(jnp.int32),
        brick_map=brick,
        strike=jnp.zeros((E,), jnp.bool_),
        last_action=zi(),
        steps=zi(),
    )


class DeviceBreakout:
    """Vectorized MinAtar Breakout; all methods jit-safe.

    Actions: 0 = no-op, 1 = left, 2 = right (the game's minimal set).
    """

    num_actions = 3
    obs_shape = (10, 10, 4)
    obs_dtype = jnp.uint8

    def __init__(self, sticky_prob: float = 0.1, time_limit: int = 2000):
        self.sticky_prob = sticky_prob
        self.time_limit = time_limit

    def reset(self, key, num_envs: int) -> BreakoutState:
        key, sub = jax.random.split(key)
        side = jax.random.bernoulli(sub, 0.5, (num_envs,))
        return BreakoutState(key=key, **_breakout_fresh(side))

    def observe(self, state: BreakoutState) -> jnp.ndarray:
        """(E, 10, 10, 4) uint8: paddle, ball, trail, bricks planes."""
        E = state.pos.shape[0]
        lanes = jnp.arange(E)
        obs = jnp.zeros((E, 10, 10, 4), jnp.uint8)
        obs = obs.at[:, :, :, 3].set(state.brick_map.astype(jnp.uint8))
        obs = obs.at[lanes, 9, state.pos, 0].set(1)
        obs = obs.at[lanes, state.ball_y, state.ball_x, 1].set(1)
        obs = obs.at[lanes, state.last_y, state.last_x, 2].set(1)
        return obs

    def step(self, state: BreakoutState, actions: jnp.ndarray):
        """(state, reward (E,), terminated (E,), truncated (E,))."""
        E = actions.shape[0]
        lanes = jnp.arange(E)
        key, k_sticky, k_reset = jax.random.split(state.key, 3)

        a = actions.astype(jnp.int32)
        if self.sticky_prob > 0:
            stick = jax.random.bernoulli(k_sticky, self.sticky_prob, (E,))
            a = jnp.where(stick, state.last_action, a)
        pos = jnp.clip(state.pos - (a == 1) + (a == 2), 0, 9)

        # ball move
        last_y, last_x = state.ball_y, state.ball_x
        d = state.ball_dir
        new_x = state.ball_x + _DX[d]
        new_y = state.ball_y + _DY[d]
        # side-wall bounce (x first, matching the scalar game's order)
        hit_wall = (new_x < 0) | (new_x > 9)
        new_x = jnp.clip(new_x, 0, 9)
        d = jnp.where(hit_wall, _REFLECT_X[d], d)

        # mutually exclusive y outcomes (if/elif chain in the game)
        at_top = new_y < 0
        yc = jnp.clip(new_y, 0, 9)
        in_brick = (~at_top) & state.brick_map[lanes, yc, new_x]
        at_bottom = (~at_top) & (~in_brick) & (new_y == 9)

        # top bounce
        # brick: score + clear + revert y only on a FRESH strike; an
        # already-striking ball passes through (published behavior)
        fresh_strike = in_brick & (~state.strike)
        reward = fresh_strike.astype(jnp.float32)
        clear = fresh_strike[:, None, None] & (
            (jnp.arange(10)[None, :, None] == yc[:, None, None])
            & (jnp.arange(10)[None, None, :] == new_x[:, None, None]))
        brick_map = state.brick_map & (~clear)
        # bottom: refill if board cleared, then paddle checks
        empty = ~jnp.any(brick_map, axis=(1, 2))
        refill = (at_bottom & empty)[:, None, None] & (
            (jnp.arange(10) >= 1) & (jnp.arange(10) <= 3))[None, :, None]
        brick_map = brick_map | refill
        caught_flat = at_bottom & (state.ball_x == pos)   # full bounce
        caught_edge = at_bottom & (~caught_flat) & (new_x == pos)
        terminated = at_bottom & ~caught_flat & ~caught_edge

        bounce_y = at_top | fresh_strike | caught_flat
        new_d = jnp.where(bounce_y, _REFLECT_Y[d],
                          jnp.where(caught_edge, _SIDE_HIT[d], d))
        new_y = jnp.where(at_top, 0,
                          jnp.where(fresh_strike | caught_flat
                                    | caught_edge, last_y, new_y))
        strike = in_brick

        steps = state.steps + 1
        truncated = (~terminated) & (steps >= self.time_limit)
        done = terminated | truncated

        # auto-reset finished lanes
        side = jax.random.bernoulli(k_reset, 0.5, (E,))
        fresh = _breakout_fresh(side)
        cur = dict(ball_y=new_y, ball_x=new_x, ball_dir=new_d, pos=pos,
                   last_y=last_y, last_x=last_x, brick_map=brick_map,
                   strike=strike, last_action=a, steps=steps)

        def pick(f, c):
            m = done.reshape((E,) + (1,) * (c.ndim - 1))
            return jnp.where(m, f, c)

        new_state = BreakoutState(
            key=key, **{k: pick(fresh[k], cur[k]) for k in cur})
        return new_state, reward, terminated, truncated


from rltime_tpu.envs.minatar_games import (  # noqa: E402
    DeviceAsterix, DeviceFreeway, DeviceSpaceInvaders,
)
from rltime_tpu.envs.minatar_seaquest import DeviceSeaquest  # noqa: E402

MINATAR_ENVS = {
    "breakout": DeviceBreakout,
    "asterix": DeviceAsterix,
    "freeway": DeviceFreeway,
    "space_invaders": DeviceSpaceInvaders,
    "seaquest": DeviceSeaquest,
}


def _register_handles():
    """Config-registry handles: {"type": "minatar_breakout", ...}.

    Extra config keys (e.g. `ramping`, `time_limit`) pass through to
    the game constructor."""
    import numpy as np
    from rltime_tpu.config.registry import register
    from rltime_tpu.envs.base import EnvSpec

    def make_handle(game: str, cls):
        @register(f"minatar_{game}")
        class MinAtarHandle:
            is_device = True

            def __init__(self, num_envs: int, seed: int = 0, **kwargs):
                del seed  # keying comes from the actor's PRNG stream
                self.num_envs = num_envs
                self.inner = cls(**kwargs)
                self.spec = EnvSpec(tuple(cls.obs_shape), np.uint8,
                                    cls.num_actions)

            def close(self):
                pass

        return MinAtarHandle

    for game, cls in MINATAR_ENVS.items():
        make_handle(game, cls)


_register_handles()
