"""Diff two exact-numerics transcripts (SURVEY.md §7 hard part 4).

The cross-BACKEND leg of the exactness bar ([BJ] "exact Q-update
numerics under fixed seed"): run the same fixed-seed config once per
backend with --train.record_transcript=true, then:

    python tools/compare_transcripts.py A/transcript.jsonl \
        B/transcript.jsonl

Reports MATCH, or the first divergent record: its env_steps, which
fields differ (actions digest / sampled sum-tree leaves / |TD|
digest), and — for leaves, which are stored raw — the first mismatch
positions. Exit code 0 on match, 1 on divergence, 2 on shape mismatch.

Typical drive (CartPole DQN, CPU then GPU):

    python -m rltime_tpu.train cartpole_dqn --cpu \
        --train.record_transcript=true --train.total_env_steps=20000 \
        --result-dir results/tx_cpu
    python -m rltime_tpu.train cartpole_dqn \
        --train.record_transcript=true --train.total_env_steps=20000 \
        --result-dir results/tx_gpu
    python tools/compare_transcripts.py results/tx_cpu/transcript.jsonl \
        results/tx_gpu/transcript.jsonl
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # noqa: E402

from rltime_tpu.utils.transcript import Transcript  # noqa: E402


def compare(path_a: str, path_b: str, verbose: bool = True) -> int:
    a = Transcript.load(path_a).records
    b = Transcript.load(path_b).records
    if len(a) != len(b):
        if verbose:
            print(f"RECORD-COUNT MISMATCH: {len(a)} vs {len(b)} "
                  f"records ({path_a} vs {path_b})")
        return 2
    n_match = 0
    for i, (ra, rb) in enumerate(zip(a, b)):
        if ra == rb:
            n_match += 1
            continue
        if verbose:
            print(f"FIRST DIVERGENCE at record {i} "
                  f"(env_steps={ra['env_steps']}):")
            for field in ("env_steps", "actions", "td"):
                if ra.get(field) != rb.get(field):
                    print(f"  {field}: {ra.get(field)} != "
                          f"{rb.get(field)}")
            la, lb = ra.get("leaves"), rb.get("leaves")
            if la != lb and la is not None and lb is not None:
                bad = [j for j, (x, y) in enumerate(zip(la, lb))
                       if x != y][:8]
                print(f"  leaves: {len([1 for x, y in zip(la, lb) if x != y])}"
                      f"/{len(la)} differ; first positions {bad}")
                for j in bad[:4]:
                    print(f"    leaf[{j}]: {la[j]} != {lb[j]}")
            print(f"  ({n_match} records matched before divergence)")
        return 1
    if verbose:
        print(f"MATCH: {n_match} records byte-identical "
              f"(digest rounding decimals=5)")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("transcript_a")
    p.add_argument("transcript_b")
    args = p.parse_args(argv)
    return compare(args.transcript_a, args.transcript_b)


if __name__ == "__main__":
    sys.exit(main())
