"""Worker process for the true multi-process Ape-X test
(tests/test_multiprocess.py). Runs as one of N jax.distributed
processes on the CPU backend with gloo cross-process collectives —
the real DCN-path code (jax.distributed.initialize,
make_array_from_process_local_data inserts, shard_map psum across
process boundaries) from SURVEY.md §5.8, exercised without a pod.

Usage: python _mp_apex_worker.py <process_id> <num_processes> <port> \
           <devices_per_proc> <out_json> <result_dir>
"""
import json
import os
import sys


def main():
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = sys.argv[3]
    n_dev = int(sys.argv[4])
    out_path = sys.argv[5]
    result_dir = sys.argv[6]

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={n_dev}").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.config.update("jax_default_matmul_precision", "highest")
    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc
    assert len(jax.devices()) == nproc * n_dev

    import numpy as np
    from rltime_tpu.parallel.apex import ApexTrainer

    cfg = {
        "seed": 0,
        "env": {"type": "counting_env", "num_envs": 2,
                "episode_len": 7},
        "frame_stack": 1,
        "model": {"torso": "mlp", "mlp_hidden": [16], "head": "linear"},
        "replay": {"steps_per_env": 128, "prioritized": True},
        "algo": {"algo": "dqn", "batch_size": 4, "n_step": 2,
                 "lr": 1e-3, "target_update_freq": 10},
        "exploration": {"type": "epsilon_greedy", "mode": "ladder"},
        "train": {"total_env_steps": 1600, "warmup_env_steps": 400,
                  "chunk_len": 8, "updates_per_chunk": 1,
                  # small enough to exercise the r5 GLOBAL
                  # best-checkpoint path (pooled-stats allgather +
                  # collective sidecar save) under gloo
                  "log_interval": 512, "track_best": True,
                  "best_min_episodes": 1,
                  "checkpoint_interval": 10**9,
                  "checkpoint_replay": True},
    }
    t = ApexTrainer(cfg, result_dir).train()
    # the lead's checkpoint write must be complete (and visible on the
    # shared dir) before any process starts the resume phase
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices("checkpoint_written")

    def checksum_of(state):
        leaves = jax.tree.leaves(jax.device_get(state.params))
        return float(sum(np.abs(np.asarray(l)).sum() for l in leaves))

    checksum = checksum_of(t.train_state)
    # train() pops stats at log intervals now (global best path):
    # cumulative count = popped-during-train + still-fresh
    rets, _ = t.actor.episode_stats()
    num_episodes = t.episodes_seen + len(rets)
    saved_key = np.asarray(jax.random.key_data(t.actor.state.key))
    saved_tree = np.asarray(jax.device_get(
        ApexTrainer._local_block(t.replay_state.tree)))

    # Deterministic resume (SURVEY.md §5.4 on the distributed path):
    # two fresh trainers restoring the same checkpoint — actor PRNG +
    # local replay shards + learner — must evolve IDENTICALLY.
    cfg2 = json.loads(json.dumps(cfg))
    cfg2["train"]["resume"] = True
    cfg2["train"]["total_env_steps"] = 10**9
    resumed = []
    for _ in range(2):
        r = ApexTrainer(cfg2, result_dir)
        assert r.actor.env_steps == t.actor.env_steps
        np.testing.assert_array_equal(
            np.asarray(jax.random.key_data(r.actor.state.key)),
            saved_key)
        np.testing.assert_array_equal(
            np.asarray(jax.device_get(
                ApexTrainer._local_block(r.replay_state.tree))),
            saved_tree)
        for _ in range(3):
            r.train_chunk()
        resumed.append(checksum_of(r.train_state))

    with open(out_path, "w") as f:
        json.dump({
            "process_id": pid,
            "global_devices": len(jax.devices()),
            "local_devices": jax.local_device_count(),
            "updates_done": t.updates_done,
            "global_env_steps": t.global_env_steps,
            "param_checksum": checksum,
            "num_episodes": num_episodes,
            "resumed_checksum_a": resumed[0],
            "resumed_checksum_b": resumed[1],
        }, f)
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
