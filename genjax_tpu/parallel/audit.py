"""Static collective audit of compiled HLO.

No reference counterpart (the reference is single-device; `/root/reference
/src/genjax` contains no collectives to audit). This is scale-out tooling:
given a compiled program's HLO text, report every collective op — kind,
payload bytes, whether it executes per loop step (``lax.scan`` compiles to
a ``while`` whose body runs once per step) and how many devices its
replica group spans. The scaling harness (``scripts/scaling_profile.py``)
and the hierarchical-mesh tests use it to *prove* communication claims
("12 bytes/step", "per-step collectives never cross the island axis")
instead of asserting them in prose.
"""

from __future__ import annotations

import re

# The result type may be a TUPLE — `(f32[8,32]{1,0}, f32[1,8]{1,0})` —
# which contains spaces, so the type is captured non-greedily up to the
# op name rather than as one token (a `\S+` type pattern silently missed
# every tuple-typed collective, e.g. the tensor-parallel fused psum).
# Async collectives appear as a -start/-done PAIR for ONE transfer: only
# the -start matches this pattern (`-done(` cannot match `(-start)?\(`),
# and its aliasing (operands..., results...) tuple is reduced to the
# result half below. The optional ROOT prefix matters: a collective that
# is a computation root would otherwise be silently dropped.
COLLECTIVE_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?\S+ = (.+?) (all-reduce|all-gather"
    r"|collective-permute|reduce-scatter|all-to-all)(-start)?\(",
)
SHAPE_RE = re.compile(r"(f32|f64|s32|u32|pred|bf16)\[([0-9,]*)\]")

DTYPE_BYTES = {"f32": 4, "f64": 8, "s32": 4, "u32": 4, "pred": 1, "bf16": 2}

# computation headers start at column 0: `%name (params...) -> ... {` or
# `ENTRY %name (...`; params may nest parens (tuple types), so match only
# the name and require the opening brace at end of line
_COMP_HEAD_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(.*\{\s*$")
_BODY_REF_RE = re.compile(r"body=%?([\w.\-]+)")

# replica groups come in two syntaxes:
#   explicit lists:  replica_groups={{0,1,2,3},{4,5,6,7}}
#   iota form:       replica_groups=[2,4]<=[8] (dims before <= give the
#                    group layout: first dim = number of groups, the rest
#                    multiply to the group size)
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([0-9,{} ]*)\}\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[([0-9,]+)\]<=\[")


def _group_span(line: str) -> int | None:
    """Largest replica-group size of a collective op line, or None when the
    op carries no ``replica_groups`` attribute (= all devices)."""
    m = _GROUPS_LIST_RE.search(line)
    if m:
        groups = m.group(1).split("},{")
        return max(len([x for x in g.split(",") if x.strip()]) for g in groups)
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        dims = [int(d) for d in m.group(1).split(",")]
        size = 1
        for d in dims[1:]:
            size *= d
        return size
    if "replica_groups={}" in line:
        return None
    return None


def hlo_collectives(compiled_text: str):
    """Count collective ops in compiled HLO, sum their payload bytes, and
    record each op's replica-group span.

    ``lax.scan`` compiles to a ``while`` loop, so a collective inside the
    loop body appears ONCE in the text but executes once per step —
    per-step traffic is the body's collectives, not total/T. Collectives
    are therefore classified by enclosing computation: those in
    computations referenced by a ``while``'s ``body=`` execute per step;
    the rest once per run.

    Returns a dict with ``count``, ``bytes``, ``by_kind``, ``per_step``
    / ``once_per_run`` rollups, and ``ops`` — the raw per-op records
    ``{kind, bytes, per_step, group_span}``.
    """
    body_names = set(_BODY_REF_RE.findall(compiled_text))

    ops = []
    current_comp = None
    for line in compiled_text.splitlines():
        head = _COMP_HEAD_RE.match(line)
        if head:
            current_comp = head.group(1)
        m = COLLECTIVE_RE.match(line)
        if not m:
            continue
        result_type, kind, is_start = m.group(1), m.group(2), m.group(3)
        # payload: ALL shapes in the result type (tuple results sum
        # their elements); an async -start's tuple is
        # (operands..., results...), so only the RESULT half counts —
        # summed per shape, since e.g. all-gather-start's result is
        # larger than its operand
        per_shape = []
        for dt, dims in SHAPE_RE.findall(result_type):
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            per_shape.append(n * DTYPE_BYTES.get(dt, 4))
        if is_start and len(per_shape) >= 2:
            per_shape = per_shape[len(per_shape) // 2 :]
        nbytes = sum(per_shape)
        in_body = current_comp in body_names or (
            current_comp is not None
            and any(current_comp.startswith(b) for b in body_names)
        )
        ops.append(
            {
                "kind": kind,
                "bytes": nbytes,
                "per_step": in_body,
                "group_span": _group_span(line),
            }
        )
    total = sum(o["bytes"] for o in ops)
    by_kind = {}
    for o in ops:
        by_kind[o["kind"]] = by_kind.get(o["kind"], 0) + 1
    step_ops = [o for o in ops if o["per_step"]]
    return {
        "count": len(ops),
        "bytes": total,
        "by_kind": by_kind,
        "per_step": {
            "count": len(step_ops),
            "bytes": sum(o["bytes"] for o in step_ops),
        },
        "once_per_run": {
            "count": len(ops) - len(step_ops),
            "bytes": total - sum(o["bytes"] for o in step_ops),
        },
        "ops": ops,
    }
