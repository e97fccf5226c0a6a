"""Graph500 kernel 3: shortest paths from one root over the uint8 edge
weights, `GraphSession.sssp(root)`.

Every answer is held to the reference's distances, vertex for vertex,
and its reached set to the root's component.
"""
from __future__ import annotations

from gpubench.reference.graph import sssp_dist

LIMITS = {"reach_mismatch": 0, "dist_mismatch": 0}
CONTROL_WEIGHT_BITS = 4     # the nearest precision below uint8


def call(session, root: int):
    return session.sssp(root)


def host(out, n: int) -> dict:
    return {"dist": out.dist[:n].cpu()}


def control(ref, root: int) -> dict:
    """The control in the program's place: the reference over weights
    rounded to 4 bits."""
    return {"dist": sssp_dist(ref.graph, root,
                              weight_bits=CONTROL_WEIGHT_BITS).cpu()}


def judge(ref, root: int, got: dict) -> dict:
    """The numbers compared for one answer."""
    if ("sssp", root) not in ref.answers:   # roots repeat in a window
        ref.answers["sssp", root] = sssp_dist(ref.graph, root)
    want = ref.answers["sssp", root]
    dist = got["dist"].to(ref.device)
    comp = ref.labels == ref.labels[root]
    return {"reach_mismatch": int(((dist >= 0) != comp).sum()),
            "dist_mismatch": int((dist != want).sum())}
