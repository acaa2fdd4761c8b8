"""Host Atari-shaped engine throughput proof (SURVEY.md §7 hard part
3).

The host env engine has to keep a learner fed; this tool measures, on
the machine it runs on:

  1. native engine, raw: the C++ Atari-shaped lane pool
     (stepper.cpp AtariPool — synthetic lanes in-sandbox, real ALE
     when headers are present; identical machinery either way)
     stepped with scripted actions — the engine ceiling;
  2. native engine through the ACTING path: Actor + frame-stack 4 +
     jitted policy forward on the CPU backend, so the number is the
     host's own — wrapper+policy overhead included;
  3. python wrapper engine (envs/atari.py AtariVecEnv over a scripted
     FakeALE): the pure-Python per-lane wrapper chain, for comparison
     with the reference's architecture.

Prints one JSON line per measurement. steps/s/core is the portable
number: hosts differ in core count, and ALE lanes parallelize
embarrassingly.
"""
import json
import os
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # noqa: E402

import numpy as np  # noqa: E402


def bench_native_raw(num_envs=64, num_threads=2, steps=400):
    from rltime_tpu.envs.native.bindings import (
        NativeAtariVecEnv, atari_backend)
    env = NativeAtariVecEnv(num_envs=num_envs, seed=0,
                            num_threads=num_threads)
    rng = np.random.default_rng(0)
    acts = rng.integers(0, env.spec.num_actions,
                        (steps, num_envs)).astype(np.int32)
    env.reset()
    for t in range(20):          # warm caches/threads
        env.step(acts[0])
    t0 = time.perf_counter()
    for t in range(steps):
        env.step(acts[t])
    dt = time.perf_counter() - t0
    env.close()
    return dict(metric="native_atari_engine_steps_per_s",
                backend=atari_backend(), num_envs=num_envs,
                num_threads=num_threads,
                value=round(steps * num_envs / dt, 1))


def bench_acting_path(num_envs=64, steps=300):
    """Actor.rollout over the native Atari-shaped env: frame-stack 4,
    eps-greedy policy forward (Nature-CNN) on the CPU backend."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from rltime_tpu.acting.actor import Actor
    from rltime_tpu.envs.native.bindings import NativeAtariVecEnv
    from rltime_tpu.exploration.epsilon import EpsilonGreedy
    from rltime_tpu.models.policy import (
        ModelConfig, init_params)
    import jax.numpy as jnp

    env = NativeAtariVecEnv(num_envs=num_envs, seed=0)
    cfg = ModelConfig(num_actions=env.spec.num_actions,
                      torso="nature_cnn", head="dueling")
    params = init_params(cfg, jax.random.key(0),
                         jnp.zeros((1, 4, 84, 84), jnp.uint8))
    actor = Actor(env, cfg, 4, EpsilonGreedy(eps_start=0.1,
                                             eps_end=0.1),
                  jax.random.key(1), chunk_len=16)
    actor.rollout(params)        # compile + warm
    n0 = actor.env_steps
    t0 = time.perf_counter()
    while actor.env_steps - n0 < steps * num_envs:
        actor.rollout(params)
    dt = time.perf_counter() - t0
    done = actor.env_steps - n0
    env.close()
    return dict(metric="host_acting_path_steps_per_s",
                num_envs=num_envs, policy="nature_cnn+dueling(cpu)",
                value=round(done / dt, 1))


def bench_python_wrapper(num_envs=16, steps=200):
    """envs/atari.py AtariVecEnv over a scripted FakeALE — the
    per-lane Python wrapper chain's own ceiling."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__),
                                    "..", "tests"))
    from test_atari_stub import FakeALE
    import rltime_tpu.envs.atari as mod
    fake = types.ModuleType("ale_py")
    fake.ALEInterface = FakeALE
    fake.roms = types.SimpleNamespace(pong="pong")
    sys.modules["ale_py"] = fake
    mod._HAS_ALE = True

    def _lane_ctor(rom, seed, *a, **k):
        return FakeALE()

    # route _AtariLane's `from ale_py import ALEInterface, roms`
    env = mod.AtariVecEnv(num_envs=num_envs, rom="pong", seed=0)
    rng = np.random.default_rng(0)
    env.reset()
    t0 = time.perf_counter()
    for t in range(steps):
        env.step(rng.integers(0, env.spec.num_actions, num_envs))
    dt = time.perf_counter() - t0
    return dict(metric="python_fakeale_wrapper_steps_per_s",
                num_envs=num_envs,
                value=round(steps * num_envs / dt, 1))


def main():
    from rltime_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    for fn in (lambda: bench_native_raw(64, 1),
               lambda: bench_native_raw(64, 2),
               lambda: bench_native_raw(256, 2),
               bench_python_wrapper,
               bench_acting_path):
        try:
            r = fn()
        except Exception as e:  # pragma: no cover
            r = dict(error=f"{type(e).__name__}: {e}")
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
