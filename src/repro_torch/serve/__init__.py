"""Concurrent graph query service over resident `DistGraph`s
(DESIGN.md sec. 12), the port of `repro.serve`.

    from repro_torch.serve import GraphServer, ServeConfig

    server = GraphServer({"web": graph_a, "road": graph_b},
                         ServeConfig(max_batch=8, window_s=0.01)).start()
    server.warm()                                  # the B classes' entries
    ticket = server.bfs("web", root=17, tenant="alice")
    out = ticket.result(timeout=60).value          # bit-identical to a
    server.stop()                                  # direct session.bfs(17)

Continuous batching: compatible requests (same graph, program, config)
coalesce into the session layer's cached batched multi-root entry points
under a max-latency window; every result is demuxed from its batch slot
and is bit-identical to a direct `GraphSession` call.  Faults degrade one
request, not the server (`repro_torch.runtime.fault` retry + isolation
replay), and fault-tolerant batches drain through mid-traversal recovery.
"""
from repro_torch.serve.accounting import BatchRecord, ServeAccounting, \
    TenantStats
from repro_torch.serve.protocol import (PROGRAMS, BatchKey, QueryRequest,
                                        QueryResult, QueryTicket, ServeError,
                                        ServerClosed, ServerSaturated,
                                        pad_class, pad_classes)
from repro_torch.serve.scheduler import ContinuousBatcher, Entry, batch_key
from repro_torch.serve.server import GraphServer, ServeConfig

__all__ = [
    "GraphServer", "ServeConfig", "ServeAccounting", "TenantStats",
    "BatchRecord", "BatchKey", "QueryRequest", "QueryResult", "QueryTicket",
    "ServeError", "ServerClosed", "ServerSaturated", "ContinuousBatcher",
    "Entry", "batch_key", "pad_class", "pad_classes", "PROGRAMS",
]
