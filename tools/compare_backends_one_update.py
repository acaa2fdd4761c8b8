"""Quantify CPU-vs-GPU divergence of ONE identical learner update.

Companion to tools/compare_transcripts.py (SURVEY.md §7 hard part 4):
the transcript diff flags WHERE runs diverge; this isolates HOW MUCH a
single update diverges with bit-identical inputs. Runs in one process:
the same jitted update function executes once on the CPU device and
once on the GPU (inputs committed per backend), then per-sample |TD|,
Q(s, a) and the resulting param deltas are compared. chip_smoke.py's
reference phase does the same at the Atari bench shapes.

    python tools/compare_backends_one_update.py [--precision highest]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--precision", default=None,
                   choices=[None, "default", "high", "highest"])
    args = p.parse_args(argv)
    if args.precision and args.precision != "default":
        jax.config.update("jax_default_matmul_precision",
                          args.precision)
    from rltime_tpu.utils.compile_cache import enable_compile_cache
    from rltime_tpu.utils.device_info import require_gpu
    enable_compile_cache()
    require_gpu()

    from rltime_tpu.history.replay import (
        ReplayConfig, replay_init, replay_insert)
    from rltime_tpu.models.policy import ModelConfig
    from rltime_tpu.training.learner import (
        AlgoConfig, make_train_state, make_update_step)
    import dataclasses

    # cartpole_dqn shapes (configs/cartpole_dqn.json)
    rcfg = ReplayConfig(num_envs=32, steps_per_env=256, horizon=1,
                        chunk_len=16, prioritized=False)
    mcfg = ModelConfig(num_actions=2, torso="mlp",
                       mlp_hidden=(128, 128), head="linear")
    acfg = AlgoConfig(algo="dqn", batch_size=128, n_step=1,
                      double_q=True, lr=5e-4, debug_outputs=True)
    fields = {"obs": ((4,), jnp.float32), "action": ((), jnp.int32),
              "reward": ((), jnp.float32),
              "terminated": ((), jnp.bool_), "done": ((), jnp.bool_)}
    rstate = replay_init(rcfg, fields)
    rng = np.random.default_rng(0)
    for k in range(4):
        chunk = dict(
            obs=rng.normal(size=(32, 16, 4)).astype(np.float32),
            action=rng.integers(0, 2, (32, 16)).astype(np.int32),
            reward=rng.normal(size=(32, 16)).astype(np.float32),
            terminated=(rng.random((32, 16)) < 0.05),
            done=(rng.random((32, 16)) < 0.05))
        rstate = replay_insert(rcfg, rstate, chunk)
    tstate = make_train_state(mcfg, acfg, jax.random.key(0),
                              jnp.zeros((1, 4)))
    upd = jax.jit(make_update_step(mcfg, acfg, rcfg, 1, True))

    outs = {}
    for name, dev in (("cpu", jax.devices("cpu")[0]),
                      ("gpu", jax.devices()[0])):
        ts = jax.device_put(tstate, dev)
        rs = jax.device_put(rstate, dev)
        nt, _, m = upd(ts, rs, jax.device_put(jnp.float32(0.4), dev))
        outs[name] = dict(
            td=np.asarray(m["debug_td"]),
            q=np.asarray(m["debug_q"]),
            leaf=np.asarray(m["debug_leaf"]),
            action=np.asarray(m["debug_action"]),
            loss=float(m["loss"]),
            params=[np.asarray(x) for x in
                    jax.tree.leaves(jax.device_get(nt.params))])
    a, b = outs["cpu"], outs["gpu"]
    same_leaves = bool(np.array_equal(a["leaf"], b["leaf"]))
    same_actions = bool(np.array_equal(a["action"], b["action"]))
    td_max = float(np.abs(a["td"] - b["td"]).max())
    q_max = float(np.abs(a["q"] - b["q"]).max())
    loss_diff = abs(a["loss"] - b["loss"])
    p_max = max(float(np.abs(x - y).max())
                for x, y in zip(a["params"], b["params"]))
    print(f"backends: cpu vs {jax.devices()[0].platform}"
          f" (matmul precision={args.precision or 'default'})")
    print(f"sampled leaves identical:  {same_leaves}")
    print(f"sampled actions identical: {same_actions}")
    print(f"max |TD_cpu - TD_gpu|:     {td_max:.3e}")
    print(f"max |Q_cpu - Q_gpu|:       {q_max:.3e}")
    print(f"|loss_cpu - loss_gpu|:     {loss_diff:.3e}")
    print(f"max param delta after 1 update: {p_max:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
