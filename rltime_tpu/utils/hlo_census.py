"""Collective census of compiled HLO (SURVEY.md §5.8; VERDICT r4 #3).

The fused SPMD superstep's scaling claim rests on a structural
property: the ONLY data crossing the interconnect per superstep is the
replicated-plane traffic — K gradient pmeans (params-sized), scalar
metric pmeans, and the t/max_priority pmaxes. The whole sample/gather/
insert plane is shard-local by construction (parallel/mesh.py:8-19).
This module parses compiled HLO text and lists every collective
instruction with its payload size so a test can pin that property
(tests/test_collective_census.py) and a tool can print the
bytes-over-interconnect model (tools/dump_superstep_hlo.py --fused).
"""
from __future__ import annotations

import re
from typing import Dict, List

COLLECTIVE_OPS = (
    "all-reduce", "all-gather", "all-to-all", "collective-permute",
    "reduce-scatter", "collective-broadcast", "ragged-all-to-all",
)

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2,
    "f16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
    "f64": 8, "c64": 8, "c128": 16,
}

# the opcode token: whitespace-preceded (operand USES are %-prefixed),
# immediately followed by its operand parens
_OP_PAT = re.compile(
    r"\s(" + "|".join(COLLECTIVE_OPS) + r")(-start|-done)?\(")


def shape_bytes(shape_str: str) -> int:
    """Total bytes of an HLO shape string (tuples summed)."""
    total = 0
    for m in re.finditer(r"([a-z]+\d*)\[([\d,]*)\]", shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_census(hlo_text: str) -> List[Dict]:
    """Every collective instruction in the module text.

    Returns [{name, op, shape, bytes}], skipping `-done` halves of
    async pairs (the matching `-start` carries the payload shape).
    """
    out = []
    for line in hlo_text.splitlines():
        s = line.strip().lstrip("%")
        if " = " not in s:
            continue
        name, rhs = s.split(" = ", 1)
        m = _OP_PAT.search(" " + rhs)
        if not m:
            continue
        op, phase = m.group(1), m.group(2)
        if phase == "-done":
            continue
        # the RESULT shape is everything before the opcode token
        # (tuple shapes may contain /*index=N*/ comments)
        shape = rhs[:max(m.start() - 1, 0)].strip()
        if phase == "-start" and shape.startswith("("):
            # async start ops return (aliased-operand, result, ...)
            # tuples — counting the whole tuple double-counts the
            # payload; the first element is the true payload shape
            shape = shape[1:].split(",", 1)[0].strip()
        out.append(dict(name=name.strip(), op=op, shape=shape,
                        bytes=shape_bytes(shape)))
    return out


def summarize(entries: List[Dict]) -> str:
    lines = [f"{len(entries)} collective instruction(s):"]
    for e in entries:
        lines.append(
            f"  {e['op']:<20s} {e['bytes']:>12,d} B   {e['shape']}")
    return "\n".join(lines)
