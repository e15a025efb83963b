"""What the collectives move: calls and payload bytes, by kind and site.

The counterpart, for the collectives, of ``ops/launch_counts.py``'s
launch counters, and what ``analysis/scaling_comms.py`` reads where the
JAX package parses the compiled step's HLO. Each collective of the port's
step adds one call and its payload where it is issued: the bytes of its
result, as the JAX audit counts them (an all-reduce: the tensor; an
all-gather: the gathered tensor; a reduce-scatter: this rank's part).
Sites: the differentiable collectives of ``parallel/collectives.py`` (by
function, "... backward" for their adjoints), the gradient and metric
averages and the global norm of ``solvers/base.py``, and Lamb's trust
ratio (``solvers/optim.py``). The collectives run eagerly (a gloo
collective is never captured into a CUDA graph), so the counts are the
calls made.
"""

from __future__ import annotations

import torch

KINDS = ("all-reduce", "all-gather", "reduce-scatter")
COUNTS: dict = {}  # (kind, site) -> [calls, bytes]


def count(kind: str, site: str, *tensors: torch.Tensor) -> None:
    """One ``kind`` collective at ``site`` whose result is ``tensors``."""
    entry = COUNTS.setdefault((kind, site), [0, 0])
    entry[0] += 1
    entry[1] += sum(t.numel() * t.element_size() for t in tensors)


def reset() -> None:
    COUNTS.clear()


def by_kind() -> dict:
    """{kind: {"count", "bytes"}} over every site, and ``total_bytes``."""
    out = {k: {"count": 0, "bytes": 0} for k in KINDS}
    for (kind, _), (calls, nbytes) in COUNTS.items():
        out[kind]["count"] += calls
        out[kind]["bytes"] += nbytes
    out["total_bytes"] = sum(v["bytes"] for v in out.values() if isinstance(v, dict))
    return out


def by_site() -> dict:
    """{site: {"kind", "count", "bytes"}}."""
    return {site: {"kind": kind, "count": calls, "bytes": nbytes}
            for (kind, site), (calls, nbytes) in sorted(COUNTS.items(), key=lambda kv: kv[0][1])}
