"""A/B the PER backends (ops/sum_tree vs ops/dense_tree) on the GPU.

Times the FULL update step (K=4 fused) and the isolated sample +
priority-update cycle for both ReplayConfig.sampler values, same
shapes as bench.py. One-off measurement tool.
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def sync(x):
    return float(np.asarray(x).reshape(-1)[0])


def main():
    import jax
    import jax.numpy as jnp
    from rltime_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    from rltime_tpu.history.replay import (
        ReplayConfig, replay_init, replay_insert,
        replay_sample_indices, replay_update_priorities)
    from rltime_tpu.models.policy import ModelConfig
    from rltime_tpu.training.learner import (
        AlgoConfig, make_train_state, make_update_step,
        make_multi_update_step)

    E, T, L, F, n = 64, 1024, 32, 4, 3
    fields = {"obs": ((84, 84), jnp.uint8),
              "action": ((), jnp.int32),
              "reward": ((), jnp.float32),
              "terminated": ((), jnp.bool_),
              "done": ((), jnp.bool_)}
    rng = np.random.default_rng(0)
    ck = dict(obs=rng.integers(0, 255, size=(E, L, 84, 84),
                               dtype=np.uint8),
              action=rng.integers(0, 6, size=(E, L)).astype(np.int32),
              reward=rng.normal(size=(E, L)).astype(np.float32),
              terminated=(rng.random((E, L)) < 0.02),
              done=(rng.random((E, L)) < 0.02))
    mcfg = ModelConfig(num_actions=6, torso="nature_cnn",
                       head="dueling", compute_dtype="bfloat16")
    acfg = AlgoConfig(algo="dqn", batch_size=256, n_step=n,
                      double_q=True, lr=1e-4, target_update_freq=500)
    key = jax.random.key(7)

    for sampler in ("dense", "tree"):
        rcfg = ReplayConfig(num_envs=E, steps_per_env=T, horizon=n,
                            chunk_len=L, lookback=F - 1,
                            prioritized=True, sampler=sampler)
        rstate = replay_init(rcfg, fields)
        for k in range(8):
            rstate = replay_insert(rcfg, rstate, ck)

        # isolated: sample + priority write-back, fused x16
        def cyc(rs, k):
            def body(c, _):
                rs, k = c
                k, sk = jax.random.split(k)
                idx = replay_sample_indices(rcfg, rs, sk, 256, 0.4)
                rs = replay_update_priorities(
                    rcfg, rs, idx["leaf"], idx["weight"] + 0.5)
                return (rs, k), idx["env"][0]
            (rs, k), out = jax.lax.scan(body, (rs, k), None, length=16)
            return rs, k, out[-1]
        cyc = jax.jit(cyc, donate_argnums=(0,))
        rstate, key, o = cyc(rstate, key)
        sync(o)
        t0 = time.perf_counter()
        for _ in range(5):
            rstate, key, o = cyc(rstate, key)
        sync(o)
        dt = time.perf_counter() - t0
        print(f"[{sampler}] sample+prio x16 fused: "
              f"{dt / 5 / 16 * 1e3:.3f} ms/cycle", flush=True)

        # isolated: insert, fused x8
        cks = {k2: jnp.asarray(np.stack([v] * 8)) for k2, v in ck.items()}
        def ins8(rs, cks):
            def body(rs, c):
                return replay_insert(rcfg, rs, c), c["reward"][0, 0]
            rs, out = jax.lax.scan(body, rs, cks)
            return rs, out[-1]
        ins8 = jax.jit(ins8, donate_argnums=(0,))
        rstate, o = ins8(rstate, cks)
        sync(o)
        t0 = time.perf_counter()
        for _ in range(5):
            rstate, o = ins8(rstate, cks)
        sync(o)
        dt = time.perf_counter() - t0
        print(f"[{sampler}] insert x8 fused: "
              f"{dt / 5 / 8 * 1e3:.3f} ms/insert", flush=True)

        # full update K=4
        ts = make_train_state(mcfg, acfg, jax.random.key(0),
                              jnp.zeros((1, F, 84, 84), jnp.uint8))
        upd = make_multi_update_step(
            make_update_step(mcfg, acfg, rcfg, F, False), 4)
        upd = jax.jit(upd, donate_argnums=(0, 1))
        beta = jnp.float32(0.4)
        for _ in range(2):
            ts, rstate, m = upd(ts, rstate, beta)
        sync(m["loss"])
        t0 = time.perf_counter()
        for _ in range(10):
            ts, rstate, m = upd(ts, rstate, beta)
        sync(m["loss"])
        dt = time.perf_counter() - t0
        print(f"[{sampler}] full update K=4: "
              f"{dt / 40 * 1e3:.3f} ms/upd", flush=True)


if __name__ == "__main__":
    main()
