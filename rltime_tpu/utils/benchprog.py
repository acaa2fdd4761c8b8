"""The driver-bench learner superstep, ONE definition shared by
bench.py, tools/profile_bench.py and tools/dump_superstep_hlo.py.

Round-2 advice: the HLO-dump tool had drifted to an older Python-
unrolled S=4 program while bench.py moved to a lax.scan S=16 shape —
copy/relayout attribution from the dump no longer matched what the
driver measured. Everything now builds through `build()` below.

The program: the steady-state jitted update cycle of the Atari
double/dueling n-step PER config (BASELINE.json config #2 shapes) —
sum-tree sample -> frame-stack window gather -> Nature-CNN fwd/bwd ->
Adam -> priority write-back — S x (1 chunk insert + K updates) scanned
into ONE XLA program. The chunk loop is a lax.scan with the replay
state in the carry: XLA keeps the ring update IN PLACE across
iterations (check with tools/dump_superstep_hlo.py), so any entry+exit
copy of the 462 MB obs ring at the loop boundary amortizes over S
chunks instead of being paid per chunk. Compile time is O(1) in S
because it's a scan, not an unroll.
"""
from __future__ import annotations

import types

import numpy as np

# Canonical bench shapes (BASELINE.json config #2 scaled to one chip).
E, T, L, F, N_STEP = 64, 1024, 32, 4, 3
# Fixed sample ratio: batch*K = 1024 transitions per chunk, the
# config-#2 recipe's 0.5 samples/insert. Batch and S were chosen on
# other hardware; re-sweeping them on the GPU is an open ROADMAP item.
BATCH = 1024
S = 64          # chunks (supersteps) per dispatch
K = 1           # learner updates per chunk


def build(warm_chunks: int = 8, seed: int = 0, batch: int = BATCH,
          k: int = K, channels_last: bool = False,
          space_to_depth: bool = False, unroll: int = 1,
          pipelined: bool = False, supersteps: int = S,
          algo: str = "dqn", num_envs: int = E, chunk_len: int = L,
          compute_dtype: str = "bfloat16", **algo_overrides):
    """Construct the bench program. Returns a namespace with:
    superstep (jitted), tstate, rstate, stacked(base)->device chunks,
    and the static shape constants.

    `batch`/`k`/`algo_overrides` parameterize MFU experiments:
    transitions consumed per chunk stays batch*k, so tx/s numbers are
    comparable at fixed sample ratio. `channels_last`/`space_to_depth`
    (model) plus algo.gather_barrier and `unroll` (chunk-scan unroll
    for XLA software pipelining) are the gather-plane candidates
    still to be A/B'd on the GPU (ROADMAP design debt 2)."""
    E_, L_ = num_envs, chunk_len
    import jax
    import jax.numpy as jnp

    from rltime_tpu.history.replay import (
        ReplayConfig, replay_init, replay_insert)
    from rltime_tpu.models.policy import ModelConfig
    from rltime_tpu.training.learner import (
        AlgoConfig, make_train_state, make_update_step,
        make_insert_and_update_step,
        make_pipelined_insert_and_update_step)

    # IQN / R2D2 legs: config-#3/#4-shaped
    # learner programs so quantile-regression and sequence-unroll
    # throughput are on the perf record too (tools/bench_algo_legs.py).
    head = "dueling"
    lstm = 0
    if algo == "iqn":
        head = "iqn"
        algo_overrides.setdefault("num_tau", 64)
        algo_overrides.setdefault("num_tau_prime", 64)
    elif algo == "r2d2":
        lstm = 512
        algo_overrides.setdefault("burn_in", 40)
        algo_overrides.setdefault("seq_len", 80)
        algo_overrides.setdefault("eta", 0.9)
    mcfg = ModelConfig(num_actions=6, torso="nature_cnn",
                      head=head, lstm_size=lstm,
                      compute_dtype=compute_dtype,
                      channels_last=channels_last,
                      space_to_depth=space_to_depth)
    if algo == "dqn":
        algo_overrides.setdefault("batched_next_forward", True)
    acfg = AlgoConfig(algo=algo, batch_size=batch, n_step=N_STEP,
                      double_q=True, lr=1e-4, target_update_freq=500,
                      **algo_overrides)
    if algo == "r2d2":
        from rltime_tpu.training.r2d2 import r2d2_horizon
        horizon = r2d2_horizon(acfg)
    else:
        horizon = N_STEP
    rcfg = ReplayConfig(num_envs=E_, steps_per_env=T, horizon=horizon,
                        chunk_len=L_, lookback=F - 1, prioritized=True)
    fields = {"obs": ((84, 84), jnp.uint8),
              "action": ((), jnp.int32),
              "reward": ((), jnp.float32),
              "terminated": ((), jnp.bool_),
              "done": ((), jnp.bool_)}
    if algo == "r2d2":
        fields["rnn_c"] = ((512,), jnp.float32)
        fields["rnn_h"] = ((512,), jnp.float32)
    rstate = replay_init(rcfg, fields)
    rng = np.random.default_rng(seed)

    def chunk(i):
        del i  # draws advance `rng`; arg kept for call-site clarity
        out = dict(
            obs=rng.integers(0, 255, size=(E_, L_, 84, 84),
                             dtype=np.uint8),
            action=rng.integers(0, 6, size=(E_, L_)).astype(np.int32),
            reward=rng.normal(size=(E_, L_)).astype(np.float32),
            terminated=(rng.random((E_, L_)) < 0.02),
            done=(rng.random((E_, L_)) < 0.02))
        if algo == "r2d2":
            out["rnn_c"] = rng.normal(
                size=(E_, L_, 512)).astype(np.float32)
            out["rnn_h"] = rng.normal(
                size=(E_, L_, 512)).astype(np.float32)
        return out

    # NB: loop variable must NOT be named `k` — it would shadow the
    # `k` (updates per chunk) parameter (caught round 4: the warmup
    # loop left k=7 and every "K" variant silently ran 7 updates).
    for w in range(warm_chunks):
        rstate = replay_insert(rcfg, rstate, chunk(w))

    ex_obs = (jnp.zeros((1, 84, 84, F), jnp.uint8) if channels_last
              else jnp.zeros((1, F, 84, 84), jnp.uint8))
    tstate = make_train_state(mcfg, acfg, jax.random.key(0), ex_obs)
    if algo == "r2d2":
        from rltime_tpu.training.r2d2 import make_r2d2_update_step
        update = make_r2d2_update_step(mcfg, acfg, rcfg, F, False)
        assert not pipelined, "pipelined is an FF-learner experiment"
    else:
        update = make_update_step(mcfg, acfg, rcfg, F, False)
    if pipelined:
        prime, insert_update_p = make_pipelined_insert_and_update_step(
            rcfg, update, k)

        def superstep(tstate, rstate, beta, chunks):
            # re-primed per dispatch (one extra sample+gather per
            # dispatch — noise at S=32) so the call signature stays
            # identical to the non-pipelined program
            tstate, pending = prime(tstate, rstate, beta)

            def body(carry, ck):
                ts, rs, pend = carry
                ts, rs, pend, m = insert_update_p(ts, rs, pend, ck,
                                                  beta)
                return (ts, rs, pend), m
            (tstate, rstate, _), ms = jax.lax.scan(
                body, (tstate, rstate, pending), chunks,
                unroll=unroll)
            return tstate, rstate, jax.tree.map(lambda x: x[-1], ms)
    else:
        insert_update = make_insert_and_update_step(rcfg, update, k)

        def superstep(tstate, rstate, beta, chunks):
            def body(carry, ck):
                ts, rs = carry
                ts, rs, m = insert_update(ts, rs, ck, beta)
                return (ts, rs), m
            (tstate, rstate), ms = jax.lax.scan(body, (tstate, rstate),
                                                chunks, unroll=unroll)
            return tstate, rstate, jax.tree.map(lambda x: x[-1], ms)

    jitted = jax.jit(superstep, donate_argnums=(0, 1))

    def stacked(base):
        out = [chunk(base + i) for i in range(supersteps)]
        return {k: jnp.asarray(np.stack([c[k] for c in out]))
                for k in out[0]}

    return types.SimpleNamespace(
        superstep=jitted, tstate=tstate, rstate=rstate,
        stacked=stacked, chunk=chunk, E=E_, T=T, L=L_, F=F,
        n_step=N_STEP, batch=batch, S=supersteps, K=k,
        # transitions CONSUMED per update (R2D2 consumes whole
        # training windows per sampled sequence)
        tx_per_update=batch * (acfg.seq_len if algo == "r2d2" else 1),
        rcfg=rcfg, mcfg=mcfg, acfg=acfg)
