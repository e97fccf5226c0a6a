"""Graph500 kernel 2: a BFS from one root, `GraphSession.bfs(root)`.

Judged against the reference's hop counts: every level equal, `n_levels`
one more than the deepest level plus the empty level that ends the loop,
and every parent a Graph500-valid one (a neighbour one level up).
"""
from __future__ import annotations

from gpubench.reference.graph import bfs_levels, bfs_levels_in_place
from gpubench.reference.graph500 import bad_preds

# the numbers compared and their limits: all exact
LIMITS = {"level_mismatch": 0, "n_levels_mismatch": 0, "bad_pred": 0}


def call(session, root: int):
    return session.bfs(root)


def host(out, n: int) -> dict:
    """The query's answer copied to the host, as a client reads it."""
    return {"level": out.level[:n].cpu(), "pred": out.pred[:n].cpu(),
            "n_levels": int(out.n_levels)}


def control(ref, root: int) -> dict:
    """The control in the program's place (see `bfs_levels_in_place`)."""
    level, pred, depth = bfs_levels_in_place(ref.graph, root)
    return {"level": level.cpu(), "pred": pred.cpu(), "n_levels": depth + 2}


def judge(ref, root: int, got: dict) -> dict:
    """The numbers compared for one answer."""
    if ("bfs", root) not in ref.answers:   # roots repeat in a window
        ref.answers["bfs", root] = bfs_levels(ref.graph, root)
    want, depth = ref.answers["bfs", root]
    level = got["level"].to(ref.device)
    pred = got["pred"].to(ref.device)
    return {"level_mismatch": int((level != want).sum()),
            "n_levels_mismatch": abs(got["n_levels"] - (depth + 2)),
            "bad_pred": bad_preds(ref.edges, level, pred, root)}
