"""Roofline terms from a dry run's counts (counterpart of
``repro.launch.roofline``).

Three terms per (arch x shape x mesh), all in seconds (per device, per
step):

  compute    = FLOPs / peak_FLOP/s
  memory     = bytes accessed / HBM_bw
  collective = link bytes moved / link_bw

The reference reads FLOPs and bytes from XLA's cost analysis of the
compiled per-device program and the collectives from its HLO text; the
port counts them while it runs one rank's program on meta tensors
(``launch/dryrun.py``), and `ring_bytes` turns the counted collectives
into the bytes the reference's parsers would give, with the same
ring-algorithm factors:

  all-reduce        2 * bytes * (G-1)/G
  all-gather        out_bytes * (G-1)/G
  reduce-scatter    out_bytes * (G-1)        (input = G * output)
  all-to-all        bytes * (G-1)/G
  collective-permute  bytes

The HLO-text parsers are kept as they are (they read strings), so the two
packages' collective bytes mean the same thing.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, Optional, Tuple

# NVIDIA H100 SXM5 80GB at 700 W: NVIDIA's data-sheet figures, not
# measured (the reference's are a TPU v5e's)
HW = {
    "peak_flops": 989.4e12,   # dense bf16 tensor-core FLOP/s per card
    "hbm_bw": 3.35e12,        # HBM3 bytes/s per card
    # takes the place of the reference's ``ici_bw``: NVLink 4 moves 900e9
    # B/s in total over both directions, 450e9 each way; the ring bytes
    # count what one device sends, so the per-direction 450e9 applies
    "link_bw": 450e9,
}

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "f8": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"\b([a-z]+\d*)\[([\d,]*)\]")
_GROUP_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUP_LIST_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")


def _shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    if dims.strip():
        for d in dims.split(","):
            n *= int(d)
    base = re.match(r"[a-z]+\d*", dtype).group(0)
    return n * _DTYPE_BYTES.get(base, 4)


def _group_size(line: str) -> int:
    m = _GROUP_IOTA_RE.search(line)
    if m:
        return int(m.group(2))
    m = _GROUP_LIST_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    return 2


def _moved(op: str, payload: float, G: int) -> float:
    """Bytes one device moves for a collective of ``payload`` bytes over a
    group of ``G`` (the ring factors)."""
    if op == "all-reduce":
        return 2.0 * payload * (G - 1) / G
    if op == "all-gather":
        return payload * (G - 1) / G
    if op == "reduce-scatter":
        return payload * (G - 1)
    if op == "all-to-all":
        return payload * (G - 1) / G
    return float(payload)


def collective_bytes(hlo_text: str) -> Dict[str, float]:
    """Per-device link bytes moved, bucketed by collective type."""
    out: Dict[str, float] = {c: 0.0 for c in _COLLECTIVES}
    for line in hlo_text.splitlines():
        stripped = line.strip()
        parts = stripped.split(" = ", 1)
        if len(parts) != 2:
            continue
        rhs = parts[1]
        op = None
        for c in _COLLECTIVES:
            # the op invocation appears as "<shapes> <op>(" (tuple-shaped
            # outputs start with "(f32[...], ...)", so search the full rhs)
            m = re.search(rf"\b{c}(-start)?\(", rhs)
            if m is not None and f"{c}-done" not in rhs:
                op = c
                seg = rhs[: m.start()]
                break
        if op is None:
            continue
        shapes = _SHAPE_RE.findall(seg)
        payload = sum(_shape_bytes(dt, dims) for dt, dims in shapes)
        if payload == 0:
            continue
        out[op] += _moved(op, payload, _group_size(stripped))
    out["total"] = sum(out[c] for c in _COLLECTIVES)
    return out


def collective_bytes_split(hlo_text: str):
    """(loop_body_bytes, one_time_bytes, per computation) — attributes
    collectives to while bodies vs straight-line code."""
    bodies = set(re.findall(r"body=%?([\w.\-]+)", hlo_text))
    cur = None
    per_comp: Dict[str, float] = {}
    for line in hlo_text.splitlines():
        if not line.startswith(" "):  # computation header
            m = re.match(r"(?:ENTRY\s+)?%?([\w.\-]+)\s*\(", line)
            if m:
                cur = m.group(1)
            continue
        sub = collective_bytes(line)
        if sub["total"]:
            per_comp[cur] = per_comp.get(cur or "?", 0.0) + sub["total"]
    loop = sum(v for k, v in per_comp.items() if k in bodies)
    once = sum(per_comp.values()) - loop
    return loop, once, per_comp


def ring_bytes(collectives: Iterable[Tuple[str, float, int]]
               ) -> Dict[str, float]:
    """Counted collectives — (type, payload bytes, group size) with the
    type one of the reference's five — as `collective_bytes` buckets them:
    per-device bytes moved by type, and their total."""
    out: Dict[str, float] = {c: 0.0 for c in _COLLECTIVES}
    for op, payload, G in collectives:
        if op not in out:
            raise ValueError(f"unknown collective type {op!r}")
        if payload:
            out[op] += _moved(op, payload, int(G))
    out["total"] = sum(out[c] for c in _COLLECTIVES)
    return out


def flops_and_bytes(counts) -> Dict[str, float]:
    """FLOPs and bytes accessed from a counting mode's counts (a mapping
    with ``flops`` and ``bytes``)."""
    return {"flops": float(counts["flops"]), "bytes": float(counts["bytes"])}


def memory_info(_=None) -> Dict[str, Optional[object]]:
    return {"available": False,
            "why": "torch runs no compiled program whose argument, output "
                   "and temp sizes could be read; see the record's "
                   "state_bytes_per_device for the params, optimizer state "
                   "and batch a device holds"}


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Lower-bound step time: the dominant term (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def fraction_of_roofline(self) -> float:
        """compute_s / step_s — how close the step is to compute-bound."""
        return self.compute_s / max(self.step_s, 1e-30)


def roofline_terms(flops: float, hbm_bytes: float,
                   link_bytes: float) -> Roofline:
    return Roofline(compute_s=flops / HW["peak_flops"],
                    memory_s=hbm_bytes / HW["hbm_bw"],
                    collective_s=link_bytes / HW["link_bw"])


def model_flops(cfg, shape, n_params_active: float, chips: int) -> float:
    """Analytic useful FLOPs per device per step: 6ND train, 2ND inference."""
    if shape.kind == "train":
        tok = shape.global_batch * shape.seq_len
        return 6.0 * n_params_active * tok / chips
    if shape.kind == "prefill":
        tok = shape.global_batch * shape.seq_len
        return 2.0 * n_params_active * tok / chips
    return 2.0 * n_params_active * shape.global_batch / chips
