"""Eval CLI (SURVEY.md §3.4): load a result dir's checkpoint, run the
greedy policy (eps ~= 0.001), report mean/median episode scores.

    python -m rltime_tpu.eval <result_dir> [--episodes N] [--cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def evaluate(result_dir: str, episodes: int = 10, eps: float = 1e-3,
             seed: int = 1234, max_steps: int = 200_000,
             record_path: str = "", best: bool = False):

    import jax
    import numpy as np

    from rltime_tpu.config.config import build
    from rltime_tpu.acting.actor import Actor
    from rltime_tpu.training import checkpoint as ckpt_lib
    from rltime_tpu.training.trainer import _mk_model_cfg

    with open(os.path.join(result_dir, "config.json")) as f:
        cfg = json.load(f)

    env_cfg = dict(cfg["env"])
    env_cfg["num_envs"] = min(int(env_cfg.get("num_envs", 1)), episodes)
    env = build(env_cfg, seed=seed)
    model_cfg = _mk_model_cfg(cfg.get("model", {}), env.spec.num_actions)

    class _FixedEps:
        def __init__(self, e):
            self.e = e

        def epsilons(self, n, step):
            return np.full((n,), self.e, np.float32)

    if getattr(env, "is_device", False):
        from rltime_tpu.acting.device_actor import DeviceActor
        actor = DeviceActor(env.inner, env.num_envs, model_cfg,
                            _FixedEps(eps), jax.random.key(seed),
                            chunk_len=64)
    else:
        actor = Actor(env, model_cfg, int(cfg.get("frame_stack", 1)),
                      _FixedEps(eps), jax.random.key(seed),
                      chunk_len=64)

    step = None
    if best:
        # best-scoring checkpoint (train.track_best); falls back to
        # the latest when no best was recorded
        b = ckpt_lib.best_step(result_dir)
        step = b["step"] if b else None
    restored = ckpt_lib.restore(result_dir, step)
    # without an example, restore returns plain nested dicts, which
    # is the model's param tree as-is
    params = restored["train_state"]["params"]

    frames = [] if record_path else None
    steps = 0
    # FIRST-completed semantics: pop completions chronologically each
    # chunk and report exactly the first `episodes` finished — extra
    # episodes that complete inside the final chunk are dropped, so
    # the parity measurement covers the requested count only.
    all_rets: list = []
    while len(all_rets) < episodes and steps < max_steps:
        chunk, _ = actor.rollout(params, num_steps=64)
        r, _l = actor.episode_stats()
        all_rets.extend(r)
        if frames is not None and len(env.spec.obs_shape) >= 2:
            # record lane 0's raw obs stream (SURVEY.md §3.4
            # render/record of a saved policy, headless variant).
            frames.append(np.asarray(chunk["obs"][0]))
        steps += 64 * env.num_envs
    if frames is not None and frames:
        video = np.concatenate(frames, axis=0)
        np.savez_compressed(record_path, frames=video)
        try:
            import cv2
            vpath = record_path.rsplit(".", 1)[0] + ".mp4"
            h, w = video.shape[1:3]
            wr = cv2.VideoWriter(vpath,
                                 cv2.VideoWriter_fourcc(*"mp4v"),
                                 30, (w, h), isColor=False)
            for f in video:
                wr.write(f.astype(np.uint8))
            wr.release()
        except Exception:
            pass  # npz always written; mp4 best-effort
    rets = all_rets[:episodes]
    report = dict(
        episodes=len(rets),
        return_mean=float(np.mean(rets)) if rets else float("nan"),
        return_median=float(np.median(rets)) if rets else float("nan"),
        return_min=float(np.min(rets)) if rets else float("nan"),
        return_max=float(np.max(rets)) if rets else float("nan"),
        checkpoint_step=restored["step"],
    )
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("result_dir")
    parser.add_argument("--episodes", type=int, default=10)
    parser.add_argument("--eps", type=float, default=1e-3)
    parser.add_argument("--record", default="",
                        help="path.npz: record lane-0 obs frames "
                             "(+ best-effort .mp4) for image envs")
    parser.add_argument("--best", action="store_true",
                        help="evaluate the best-scoring checkpoint "
                             "(train.track_best) instead of the last")
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from rltime_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    report = evaluate(args.result_dir, args.episodes, args.eps,
                      record_path=args.record, best=args.best)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
