"""Trace bench.py's learner superstep on the GPU; print device time per
HLO op, the device busy share, and the time of the replay gather.

The program is built by the same rltime_tpu/utils/benchprog.py
definition bench.py runs, so the attribution is for what the benchmark
measures. The gather time is the summed device time of every op whose
computation contains an HLO `gather`, found in the compiled HLO text;
the obs-row gather is the one whose gather yields uint8 rows (the
frame-stack window reads of the 84x84 replay ring).

    python tools/profile_bench.py [--out DIR] [--dispatches N]

Writes the trace (perfetto JSON) and summary.txt under DIR.
"""
import argparse
import glob
import gzip
import json
import os
import re
import shutil
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

def gather_fusions(hlo_text: str):
    """(all, obs): trace names of the ops that contain an HLO `gather`,
    and of those whose gather yields uint8 rows (the frame-window reads
    of the obs ring). A fusion is named after its instruction, with
    '.' written as '_' in the trace."""
    comp, gathers = None, {}
    for line in hlo_text.splitlines():
        if line and not line[0].isspace() and line.rstrip().endswith("{"):
            head = line.split()
            comp = (head[1] if head[0] == "ENTRY" else head[0]).lstrip("%")
        m = re.search(r"=\s*(\w+)\[[^\]]*\]\S*\s+gather\(", line)
        if m and comp is not None:
            gathers.setdefault(comp, set()).add(m.group(1))
    every, obs = set(), set()
    for line in hlo_text.splitlines():
        m = re.match(r"\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*calls=%?([\w.\-]+)",
                     line)
        if m and m.group(2) in gathers:
            name = m.group(1).replace(".", "_")
            every.add(name)
            if "u8" in gathers[m.group(2)]:
                obs.add(name)
    return every, obs


def _union_us(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def summarize(trace_path: str, gather_ops, obs_ops, dispatches: int):
    with gzip.open(trace_path, "rt") as f:
        events = json.load(f)
    events = events.get("traceEvents", events)
    pname, tname = {}, {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pname[e["pid"]] = e["args"].get("name", "")
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            tname[(e["pid"], e["tid"])] = e["args"].get("name", "")
    dev = {p for p, n in pname.items() if "/device:GPU" in n}
    lines, per_thread = [], defaultdict(lambda: [0, 0.0])
    agg, cnt, intervals = defaultdict(float), defaultdict(int), []
    t_lo, t_hi = float("inf"), 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("pid") not in dev:
            continue
        th = tname.get((e["pid"], e["tid"]), "")
        dur, ts = float(e.get("dur", 0.0)), float(e["ts"])
        per_thread[(pname[e["pid"]], th)][0] += 1
        per_thread[(pname[e["pid"]], th)][1] += dur
        agg[e["name"]] += dur
        cnt[e["name"]] += 1
        intervals.append((ts, ts + dur))
        t_lo, t_hi = min(t_lo, ts), max(t_hi, ts + dur)
    for (p, th), (n, us) in sorted(per_thread.items()):
        lines.append(f"thread {p} / {th}: {n} events {us / 1e3:.3f} ms")
    busy = _union_us(intervals)
    window = max(t_hi - t_lo, 1e-9)
    total = sum(agg.values())
    g_us = sum(us for n, us in agg.items() if n in gather_ops)
    o_us = sum(us for n, us in agg.items() if n in obs_ops)
    o_n = sum(c for n, c in cnt.items() if n in obs_ops)
    lines.append(
        f"device op time {total / 1e3:.3f} ms over {dispatches} "
        f"dispatches; busy {busy / 1e3:.3f} ms of a "
        f"{window / 1e3:.3f} ms window (idle share "
        f"{1 - busy / window:.4f})")
    lines.append(
        f"ops containing a gather: {g_us / 1e3:.3f} ms "
        f"({g_us / max(total, 1e-9):.4f} of op time, "
        f"{len(gather_ops)} ops in the HLO); uint8 obs-row gather: "
        f"{o_us / 1e3:.3f} ms in {o_n} events "
        f"({o_us / max(total, 1e-9):.4f} of op time, "
        f"{o_us / max(o_n, 1):.1f} us per event)")
    for name, us in sorted(agg.items(), key=lambda kv: -kv[1])[:40]:
        mark = (" [obs gather]" if name in obs_ops else
                " [gather]" if name in gather_ops else "")
        lines.append(f"{us / 1e3:9.3f} ms  x{cnt[name]:<6d} {name[:90]}{mark}")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="profile_bench")
    ap.add_argument("--dispatches", type=int, default=2)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from rltime_tpu.utils import benchprog, device_info
    from rltime_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dev = device_info.require_gpu()
    cards = device_info.nvidia_smi_cards()
    p = benchprog.build()
    beta = jnp.float32(0.4)
    warm = p.stacked(20)
    hlo = p.superstep.lower(p.tstate, p.rstate, beta,
                            warm).compile().as_text()
    gather_ops, obs_ops = gather_fusions(hlo)
    tstate, rstate, m = p.superstep(p.tstate, p.rstate, beta, warm)
    jax.block_until_ready(m)

    shutil.rmtree(args.out, ignore_errors=True)
    os.makedirs(args.out)
    chunks = [p.stacked(100 + p.S * i) for i in range(args.dispatches)]
    jax.block_until_ready(chunks)
    t0 = time.perf_counter()
    with jax.profiler.trace(args.out, create_perfetto_trace=True):
        for c in chunks:
            tstate, rstate, m = p.superstep(tstate, rstate, beta, c)
        jax.block_until_ready(m)
    wall = time.perf_counter() - t0
    path = glob.glob(os.path.join(args.out, "**", "perfetto_trace.json.gz"),
                     recursive=True)[0]
    lines = [f"{', '.join(cards)} | {dev}",
             f"program: benchprog.build() batch={p.batch} S={p.S} K={p.K} "
             f"ring={p.E}x{p.T}x84x84 u8; traced wall {wall:.3f} s "
             f"for {args.dispatches} dispatches "
             f"({args.dispatches * p.S * p.K} updates)"]
    lines += summarize(path, gather_ops, obs_ops, args.dispatches)
    text = "\n".join(lines)
    print(text)
    with open(os.path.join(args.out, "summary.txt"), "w") as f:
        f.write(text + "\n")


if __name__ == "__main__":
    main()
