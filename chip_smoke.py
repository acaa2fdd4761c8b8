"""Smoke run of rltime_tpu's main paths on NVIDIA GPUs, through the
entry points a user calls, at full model width, with random weights
made from fixed seeds.

    python chip_smoke.py          # one GPU: the five phases below
    python chip_smoke.py --four   # four GPUs: the sharded paths only

Default phases (one GPU; CUDA_VISIBLE_DEVICES is narrowed to its first
entry, so a many-GPU host still runs a one-GPU program):

  device       the card (nvidia-smi name and power limit), JAX platform,
               device_kind and memory limit; fails unless JAX runs on a
               GPU.
  learner      utils/benchprog.build(): the Atari learner superstep
               (Nature CNN in bf16, batch 1024, 64x1024 uint8 ring, S=64
               chunks per dispatch, double/dueling n=3 PER), 3
               dispatches; loss finite; transitions/s.
  reference    one DQN, IQN and R2D2 update in float32 on the GPU under
               matmul precision "highest" and on the CPU with identical
               inputs: sampled indices equal; Q, |TD| and loss within
               atol=rtol=1e-4; the gradient and the parameter delta
               within per-leg bounds of their norms (DELTA_RTOL). The
               production bf16 DQN update on the GPU agrees with that
               f32 reference per element within rtol=2e-2.
  train_fused  rltime_tpu.train.main on the minatar_breakout_dqn preset
               (fused trainer, 256 envs, L=32/u=64/S=4), ~4 training
               dispatches; scalars and a checkpoint written; then
               rltime_tpu.eval.main loads it and plays 2 episodes.
  train_host   rltime_tpu.train.main on pong_dqn with the C++ synthetic
               Atari lanes (env.type=atari_native): host envs -> H2D ->
               act step -> 64x4096 uint8 ring -> bf16 Nature-CNN updates.

--four runs only the multi-GPU path and its comparison, in one process:
the sharded FF-DQN update at full Nature-CNN width on a ('data', 4)
GPU mesh against the same update on a 4-device CPU mesh (phase-3
tolerances), the fused MinAtar superstep for a few dispatches, params
bit-identical across the 4 devices, and all-reduce-only collectives in
the compiled programs (utils/hlo_census).

Each phase prints one line: what ran, shapes, rate, device memory in
use after it and the process's peak so far, and matmul precision. The last line of stdout is the JSON result
{"ok": true, "device": {"platform", "kind", "count"}}, printed only
when every phase passed. The exit code is non-zero without a GPU or
when any phase failed.
"""
import argparse
import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time
import traceback

# f32 GPU vs CPU, same math in another summation order. Q, |TD| and
# loss must agree to 1e-4: TF32 or bf16 leaking into a `highest` run
# would miss that by an order of magnitude.
ATOL = RTOL = 1e-4
# Per leg: (parameter delta, gradient), each relative to its norm.
# Adam's first step moves each weight by lr*g/(|g|+eps), about +-lr
# whatever |g|, so a weight whose gradient is within rounding noise of
# 0 can move the other way on the other backend; the parameter delta
# therefore differs more than the gradient. R2D2 backpropagates
# through a 123-step LSTM unroll, which amplifies rounding by another
# order of magnitude. Measured on H100 80GB HBM3 cards: parameter
# delta 7.9e-4 / 1.4e-3 / 7.8e-3 and gradient 3.5e-5 / 1.2e-5 / 5.4e-4
# for DQN / IQN / R2D2. Each bound leaves its leg 3.5x-25x headroom.
DELTA_RTOL = {"dqn": (5e-3, 3e-4), "iqn": (5e-3, 3e-4),
              "r2d2": (3e-2, 3e-3)}
# bf16 production update vs the f32 reference, per element. A bf16
# dot product's rounding error scales with its operands (sum |w x|),
# not with its result, and at random init Q is a sum of nearly
# cancelling terms (some |Q| are 1e-4 of the batch's largest), so an
# element near 0 carries the same absolute error as the largest one:
# each element is held to BF16_RTOL * (|ref| + max|ref| over the
# batch). The loss is a scalar and gets rtol alone.
BF16_RTOL = 2e-2


def _narrow_devices(four: bool) -> None:
    """Before JAX starts: one GPU unless --four; four CPU devices for
    the --four reference mesh."""
    if four:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=4").strip()
    else:
        os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get(
            "CUDA_VISIBLE_DEVICES", "0").split(",")[0]


def _memory() -> str:
    """Device memory in use now, and the process's high-water mark so
    far (the allocator keeps one peak per process, not per phase)."""
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return (f"mem_in_use={stats.get('bytes_in_use', 0) / 2**30:.2f}GiB "
            f"process_peak_mem="
            f"{stats.get('peak_bytes_in_use', 0) / 2**30:.2f}GiB")


def _precision() -> str:
    import jax
    return str(jax.config.jax_default_matmul_precision or "default")


class Phases:
    """Runs phases in order, prints one line each, records failures."""

    def __init__(self):
        self.failed = []

    def run(self, name, fn):
        t0 = time.perf_counter()
        try:
            info = fn()
        except Exception as e:  # report, go on, fail at the end
            traceback.print_exc()
            self.failed.append(name)
            print(f"[{name}] FAILED {type(e).__name__}: {e}", flush=True)
            return
        print(f"[{name}] ok {info} {_memory()} "
              f"wall={time.perf_counter() - t0:.1f}s", flush=True)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _rel(a, b) -> float:
    """||a - b|| / ||b|| over flattened arrays."""
    import numpy as np
    a = np.concatenate([np.ravel(x) for x in a]).astype(np.float64)
    b = np.concatenate([np.ravel(x) for x in b]).astype(np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _max_err(a, b, atol, rtol):
    """(max |a-b|, all within atol + rtol*|b|)."""
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.abs(a - b)
    return float(err.max()), bool(np.all(err <= atol + rtol * np.abs(b)))


def _bf16_worst(a, b, scaled: bool):
    """(max |a-b|, worst |a-b| / (BF16_RTOL * (|b| + max|b|))); the
    max|b| term only when `scaled`."""
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.abs(a - b)
    bound = BF16_RTOL * (np.abs(b) + (np.abs(b).max() if scaled else 0))
    return float(err.max()), float((err / bound).max())


def _adam_mu(opt_state):
    """Adam's first moment, (1 - b1) * clipped gradient after step 1."""
    import jax
    states = [s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu")]
    return jax.tree.leaves(states[0].mu)


# ---------------------------------------------------------------- phases

def phase_device():
    from rltime_tpu.utils import device_info
    dev = device_info.require_gpu()
    import jax
    for card in device_info.nvidia_smi_cards():
        print(card, flush=True)
    limit = (jax.devices()[0].memory_stats() or {}).get("bytes_limit", 0)
    print(f"[device] ok platform={dev['platform']} kind={dev['kind']} "
          f"count={dev['count']} bytes_limit={limit / 2**30:.2f}GiB",
          flush=True)
    return dev


def phase_learner():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from rltime_tpu.utils import benchprog

    p = benchprog.build()
    beta = jnp.float32(0.4)
    ts, rs, m = p.superstep(p.tstate, p.rstate, beta, p.stacked(50))
    jax.block_until_ready(m)
    chunks = [p.stacked(100 + p.S * i) for i in range(2)]
    jax.block_until_ready(chunks)
    t0 = time.perf_counter()
    for c in chunks:
        ts, rs, m = p.superstep(ts, rs, beta, c)
    loss = float(m["loss"])
    dt = time.perf_counter() - t0
    _check(np.isfinite(loss), f"loss {loss}")
    ring = rs.storage["obs"]
    rate = len(chunks) * p.S * p.K * p.batch / dt
    return (f"nature_cnn dueling compute=bfloat16 batch={p.batch} "
            f"ring={ring.shape} {ring.dtype} ({ring.nbytes / 1e6:.0f}MB) "
            f"S={p.S} K={p.K} n={p.n_step} PER dispatches=3 "
            f"loss={loss:.6f} rate={rate:.1f}tx/s "
            f"precision={_precision()}")


def _one_update(p, mcfg, dev, precision):
    """One jitted update of benchprog program `p` with model `mcfg` on
    `dev`; host copies of its debug outputs and new state."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from rltime_tpu.training.learner import make_update_step
    from rltime_tpu.training.r2d2 import make_r2d2_update_step

    make = (make_r2d2_update_step if p.acfg.algo == "r2d2"
            else make_update_step)
    upd = jax.jit(make(mcfg, p.acfg, p.rcfg, p.F, False))
    ts = jax.device_put(p.tstate, dev)
    rs = jax.device_put(p.rstate, dev)
    with jax.default_matmul_precision(precision):
        nt, _, m = upd(ts, rs, jax.device_put(jnp.float32(0.4), dev))
    m = jax.device_get(m)
    return dict(
        leaf=np.asarray(m["debug_leaf"]), q=np.asarray(m["debug_q"]),
        td=np.asarray(m["debug_td"]), loss=float(m["loss"]),
        params=jax.tree.leaves(jax.device_get(nt.params)),
        mu=[np.asarray(x) for x in _adam_mu(jax.device_get(nt.opt_state))])


def phase_reference():
    import jax
    import numpy as np
    from rltime_tpu.utils import benchprog

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    legs = [("dqn", dict(algo="dqn")),
            ("iqn", dict(algo="iqn", batch=256)),
            ("r2d2", dict(algo="r2d2", batch=32))]
    out = []
    for name, kw in legs:
        p = benchprog.build(compute_dtype="float32", debug_outputs=True,
                            **kw)
        p0 = [np.asarray(x) for x in jax.tree.leaves(
            jax.device_get(p.tstate.params))]
        g = _one_update(p, p.mcfg, gpu, "highest")
        c = _one_update(p, p.mcfg, cpu, "highest")
        same = bool(np.array_equal(g["leaf"], c["leaf"]))
        q_err, q_ok = _max_err(g["q"], c["q"], ATOL, RTOL)
        td_err, td_ok = _max_err(g["td"], c["td"], ATOL, RTOL)
        l_err, l_ok = _max_err(g["loss"], c["loss"], ATOL, RTOL)
        d_rel = _rel([x - y for x, y in zip(g["params"], p0)],
                     [x - y for x, y in zip(c["params"], p0)])
        mu_rel = _rel(g["mu"], c["mu"])
        d_tol, g_tol = DELTA_RTOL[name]
        line = (f"{name}: batch={p.batch} leaves_equal={same} "
                f"max|dQ|={q_err:.3e} max|dTD|={td_err:.3e} "
                f"|dloss|={l_err:.3e} (atol=rtol={ATOL}) "
                f"param_delta_rel={d_rel:.3e} (<= {d_tol}) "
                f"grad_rel={mu_rel:.3e} (<= {g_tol})")
        print(f"  reference {line}", flush=True)
        _check(same and q_ok and td_ok and l_ok
               and d_rel <= d_tol and mu_rel <= g_tol, line)
        out.append(f"{name}=pass")
        if name == "dqn":
            bf = _one_update(p, dataclasses.replace(
                p.mcfg, compute_dtype="bfloat16"), gpu, "default")
            _check(np.array_equal(bf["leaf"], c["leaf"]),
                   "bf16 update sampled other indices")
            qe, qw = _bf16_worst(bf["q"], c["q"], True)
            te, tw = _bf16_worst(bf["td"], c["td"], True)
            le, lw = _bf16_worst(bf["loss"], c["loss"], False)
            line = (f"dqn bf16 vs f32 reference, per element "
                    f"(rtol={BF16_RTOL}, atol=rtol*max|ref|): "
                    f"max|dQ|={qe:.3e} max|Q|={abs(c['q']).max():.3e} "
                    f"max|dTD|={te:.3e} max|TD|={abs(c['td']).max():.3e} "
                    f"|dloss|={le:.3e} loss={c['loss']:.6f}; "
                    f"worst err/bound q={qw:.3f} td={tw:.3f} "
                    f"loss={lw:.3f} (<= 1); norm-relative "
                    f"q={_rel([bf['q']], [c['q']]):.3e} "
                    f"td={_rel([bf['td']], [c['td']]):.3e}")
            print(f"  reference {line}", flush=True)
            _check(max(qw, tw, lw) <= 1, line)
            out.append("dqn_bf16=pass")
        del p
    return (" ".join(out) + " f32 legs: GPU precision=highest vs CPU; "
            "bf16 leg: GPU precision=default")


def _capture(fn, log_path):
    """Run fn() with its stdout in `log_path`; print the log's tail if
    it raises."""
    with open(log_path, "w") as log:
        try:
            with contextlib.redirect_stdout(log):
                return fn()
        except Exception:
            log.flush()
            with open(log_path) as f:
                sys.stdout.write("".join(f.readlines()[-40:]))
            raise


def _shapes(cfg) -> str:
    """The run's shape settings, as its config states them."""
    tr, r = cfg["train"], cfg["replay"]
    return (f"envs={cfg['env']['num_envs']} "
            f"ring={cfg['env']['num_envs']}x{r['steps_per_env']} "
            f"batch={cfg['algo']['batch_size']} L={tr['chunk_len']} "
            f"u={tr['updates_per_chunk']} "
            f"S={tr.get('supersteps_per_dispatch', 1)}")


def _config(result_dir):
    with open(os.path.join(result_dir, "config.json")) as f:
        return json.load(f)


def _scalars(result_dir):
    with open(os.path.join(result_dir, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def phase_train_fused(tmp):
    import numpy as np
    from rltime_tpu import eval as eval_cli
    from rltime_tpu import train
    from rltime_tpu.training import checkpoint as ckpt_lib

    rd = os.path.join(tmp, "fused")
    os.makedirs(rd)
    # warmup runs one-chunk act+insert dispatches (L=32 x 256 envs =
    # 8192 env steps); a training dispatch is S=4 chunks = 32768 env
    # steps, so about four of them follow
    argv = ["minatar_breakout_dqn", "--result-dir", rd,
            "--train.warmup_env_steps=32768",
            "--train.total_env_steps=163840",
            "--train.log_interval=32768"]
    rc = _capture(lambda: train.main(argv), os.path.join(tmp, "fused.log"))
    _check(rc == 0, f"train.main returned {rc}")
    rows = _scalars(rd)
    step = ckpt_lib.latest_step(rd)
    _check(bool(rows) and step is not None, "no scalars or checkpoint")
    last = rows[-1]
    _check(last["updates"] > 0 and np.isfinite(last["train/loss"]),
           f"last scalars {last}")

    buf = os.path.join(tmp, "eval.log")
    rc = _capture(lambda: eval_cli.main([rd, "--episodes", "2"]), buf)
    with open(buf) as f:
        report = json.loads(f.read().strip().splitlines()[-1])
    _check(rc == 0 and report["episodes"] == 2
           and np.isfinite(report["return_mean"]), f"eval {report}")
    return (f"minatar_breakout_dqn fused {_shapes(_config(rd))} "
            f"env_steps={last['env_steps']} "
            f"updates={last['updates']} loss={last['train/loss']:.5f} "
            f"rate={last.get('steps_per_s', float('nan')):.1f}env-steps/s "
            f"checkpoint={step} eval_episodes={report['episodes']} "
            f"eval_return_mean={report['return_mean']:.2f} "
            f"precision={_precision()} (minatar torso float32)")


def phase_train_host(tmp):
    import numpy as np
    from rltime_tpu import train

    rd = os.path.join(tmp, "host")
    os.makedirs(rd)
    # one chunk = 64 envs x L=32 = 2048 env steps
    argv = ["pong_dqn", "--env.type=atari_native", "--result-dir", rd,
            "--train.warmup_env_steps=4096",
            "--train.total_env_steps=10240",
            "--train.log_interval=2048"]
    rc = _capture(lambda: train.main(argv), os.path.join(tmp, "host.log"))
    _check(rc == 0, f"train.main returned {rc}")
    last = _scalars(rd)[-1]
    _check(last["updates"] > 0 and np.isfinite(last["train/loss"]),
           f"last scalars {last}")
    return (f"pong_dqn atari_native(synthetic lanes) "
            f"{_shapes(_config(rd))} frame_stack=4 84x84 u8 "
            f"env_steps={last['env_steps']} updates={last['updates']} "
            f"loss={last['train/loss']:.5f} "
            f"rate={last.get('steps_per_s', float('nan')):.1f}env-steps/s "
            f"precision={_precision()} (nature_cnn bfloat16)")


# ------------------------------------------------------------ --four

def _sharded_update(devices, ts_host, chunks, precision):
    """Leg 1 of __graft_entry__.dryrun_multichip at full Nature-CNN
    width on a ('data', len(devices)) mesh: sharded inserts, then two
    shard_map'd PER updates with pmean'd gradients."""
    import jax
    import jax.numpy as jnp
    from rltime_tpu.parallel.mesh import (
        make_global_array, make_mesh, make_sharded_insert,
        make_sharded_update_step, replicate_global, shard_chunk,
        sharded_replay_init)
    from jax.sharding import PartitionSpec as P

    rcfg, mcfg, acfg, fields = _four_cfgs()
    mesh = make_mesh(devices)
    rs = sharded_replay_init(rcfg, mesh.shape["data"], fields, mesh)
    insert = make_sharded_insert(rcfg, mesh, rs)
    for c in chunks:
        rs = insert(rs, shard_chunk(c, mesh))
    ts = replicate_global(ts_host, mesh)
    with jax.default_matmul_precision(precision):
        upd = make_sharded_update_step(mcfg, acfg, rcfg, 4, False, mesh,
                                       rs)
        beta = make_global_array(jnp.float32(0.4), mesh, P())
        hlo = upd.lower(ts, rs, beta).compile().as_text()
        ts, rs, m1 = upd(ts, rs, beta)
        ts, rs, m2 = upd(ts, rs, beta)
    return ts, [jax.device_get(m1), jax.device_get(m2)], hlo


def _four_cfgs():
    import jax.numpy as jnp
    from rltime_tpu.history.replay import ReplayConfig
    from rltime_tpu.models.policy import ModelConfig
    from rltime_tpu.training.learner import AlgoConfig
    rcfg = ReplayConfig(num_envs=16, steps_per_env=256, horizon=3,
                        chunk_len=32, lookback=3, prioritized=True)
    mcfg = ModelConfig(num_actions=6, torso="nature_cnn", head="dueling",
                       compute_dtype="float32")
    acfg = AlgoConfig(algo="dqn", batch_size=64, n_step=3, double_q=True,
                      lr=1e-4, target_update_freq=500)
    fields = {"obs": ((84, 84), jnp.uint8), "action": ((), jnp.int32),
              "reward": ((), jnp.float32),
              "terminated": ((), jnp.bool_), "done": ((), jnp.bool_)}
    return rcfg, mcfg, acfg, fields


def _replicas_identical(tree) -> bool:
    import jax
    import numpy as np
    for leaf in jax.tree.leaves(tree):
        shards = [np.asarray(s.data) for s in leaf.addressable_shards]
        if not all(np.array_equal(shards[0], s) for s in shards[1:]):
            return False
    return True


def _all_reduce_only(hlo):
    from rltime_tpu.utils.hlo_census import collective_census, summarize
    ents = collective_census(hlo)
    ops = {e["op"] for e in ents}
    _check(bool(ents) and ops <= {"all-reduce"}, summarize(ents))
    return len(ents)


def phase_four_sharded():
    import jax
    import numpy as np
    from rltime_tpu.training.learner import make_train_state

    gpus, cpus = jax.devices(), jax.devices("cpu")[:4]
    _check(len(gpus) == 4 and len(cpus) == 4,
           f"need 4 GPUs and 4 CPU devices, have {len(gpus)}/{len(cpus)}")
    rcfg, mcfg, acfg, _ = _four_cfgs()
    ts_host = jax.device_get(make_train_state(
        mcfg, acfg, jax.random.key(0),
        np.zeros((1, 4, 84, 84), np.uint8)))
    rng = np.random.default_rng(0)
    E, L = 4 * rcfg.num_envs, rcfg.chunk_len
    chunks = [dict(obs=rng.integers(0, 255, (E, L, 84, 84), np.uint8),
                   action=rng.integers(0, 6, (E, L)).astype(np.int32),
                   reward=rng.normal(size=(E, L)).astype(np.float32),
                   terminated=rng.random((E, L)) < 0.02,
                   done=rng.random((E, L)) < 0.02) for _ in range(4)]
    g_ts, g_m, hlo = _sharded_update(gpus, ts_host, chunks, "highest")
    c_ts, c_m, _ = _sharded_update(cpus, ts_host, chunks, "highest")
    n_coll = _all_reduce_only(hlo)
    _check(_replicas_identical(g_ts.params), "GPU replicas differ")
    errs = []
    for k in ("loss", "q", "td_abs"):
        for gm, cm in zip(g_m, c_m):
            e, ok = _max_err(gm[k], cm[k], ATOL, RTOL)
            errs.append(e)
            _check(ok, f"{k}: gpu {gm[k]} cpu {cm[k]}")
    p0 = jax.tree.leaves(ts_host.params)
    d_rel = _rel(
        [np.asarray(x) - y for x, y in
         zip(jax.tree.leaves(jax.device_get(g_ts.params)), p0)],
        [np.asarray(x) - y for x, y in
         zip(jax.tree.leaves(jax.device_get(c_ts.params)), p0)])
    d_tol = DELTA_RTOL["dqn"][0]
    _check(d_rel <= d_tol, f"param_delta_rel {d_rel}")
    return (f"sharded dqn nature_cnn f32 mesh=('data',4) "
            f"batch=4x{acfg.batch_size} ring=4x{rcfg.num_envs}x"
            f"{rcfg.steps_per_env}x84x84 u8 updates=2 max_metric_err="
            f"{max(errs):.3e} (atol=rtol={ATOL}) param_delta_rel="
            f"{d_rel:.3e} (<= {d_tol}) replicas_identical=True "
            f"collectives={n_coll} all-reduce only "
            f"precision=highest")


def phase_four_fused(tmp):
    import jax
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from rltime_tpu.config.config import load_config
    from rltime_tpu.parallel.fused import FusedApexTrainer
    from rltime_tpu.parallel.mesh import make_global_array, make_mesh

    cfg = load_config("minatar_breakout_dqn")
    cfg["train"].update(warmup_env_steps=0, log_interval=10**9)
    t = FusedApexTrainer(cfg, os.path.join(tmp, "four_fused"),
                         mesh=make_mesh(jax.devices()[:4]))
    S, L = t.supersteps, t.loop_cfg.chunk_len
    eps = make_global_array(t._eps(S * L).reshape(S, L, t.e_global),
                            t.mesh, P(None, None, "data"))
    beta = make_global_array(np.full((S,), 0.4, np.float32), t.mesh, P())
    n_coll = _all_reduce_only(t._super.lower(
        t.train_state, t.actor_state, t.replay_state, eps,
        beta).compile().as_text())
    m = t.superstep()
    jax.block_until_ready(m)
    s0, t0 = t.env_steps, time.perf_counter()
    for _ in range(3):
        m = t.superstep()
    loss = float(m["loss"])
    rate = (t.env_steps - s0) / (time.perf_counter() - t0)
    _check(np.isfinite(loss), f"loss {loss}")
    _check(_replicas_identical(t.train_state.params),
           "GPU replicas differ")
    return (f"fused minatar_breakout_dqn mesh=('data',4) "
            f"{_shapes(cfg)} dispatches=4 updates={t.updates_done} "
            f"loss={loss:.5f} rate={rate:.1f}env-steps/s "
            f"replicas_identical=True collectives={n_coll} all-reduce "
            f"only precision={_precision()}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="four GPUs: sharded update vs a CPU mesh, fused "
                         "superstep; no other phase")
    args = ap.parse_args(argv)
    _narrow_devices(args.four)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    from rltime_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    dev = phase_device()

    phases = Phases()
    with tempfile.TemporaryDirectory() as tmp:
        if args.four:
            phases.run("four_sharded", phase_four_sharded)
            phases.run("four_fused", lambda: phase_four_fused(tmp))
        else:
            phases.run("learner", phase_learner)
            phases.run("reference", phase_reference)
            phases.run("train_fused", lambda: phase_train_fused(tmp))
            phases.run("train_host", lambda: phase_train_host(tmp))
    if phases.failed:
        print(f"failed phases: {', '.join(phases.failed)}", flush=True)
        return 1
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
