"""The serving tier of the port: one fleet trains and serves.

Port of ``repro.serve``, the same names. The async engine's ring of
retained global versions (``AsyncEngine.ring_snapshot``) becomes a
``VersionStore``; a ``ReplicaPool`` pins replicas to retained versions and
decodes request streams with continuous batching
(``repro_torch.serve.batching``: one batch-S cache per replica with a
per-row write index, one ``decode_step`` a tick, K5 on the GPU); a
``Router`` from the ``@register_router`` registry (round_robin /
least_loaded / the paper's Markov admission rule) decides which replica
admits each request, with Var[X] over replicas measured by the same Kahan
accumulators as the training load metric
(``core.load_metric.*_replica_accum``). Replica crashes
(``replica_crash``) fail their streams over to survivors.

    store = VersionStore.from_engine(engine, state)
    report = run_serve_loop(model, store, requests, router="markov",
                            n_replicas=4, slots=8)
    print(report.summary())   # ttft / tok/s / staleness / Var[X]
"""
from repro_torch.serve.batching import (  # noqa: F401
    init_slot_pool,
    prefill_tokens,
    read_slot,
    slot_decode_fn,
    write_slot,
)
from repro_torch.serve.loop import (  # noqa: F401
    ReplicaPool,
    Request,
    ServeReport,
    StreamResult,
    run_serve_loop,
)
from repro_torch.serve.router import (  # noqa: F401
    Router,
    make_router,
    penalized_load,
    register_router,
    router_names,
)
from repro_torch.serve.store import VersionRead, VersionStore  # noqa: F401

__all__ = [
    "VersionStore",
    "VersionRead",
    "Router",
    "make_router",
    "penalized_load",
    "register_router",
    "router_names",
    "ReplicaPool",
    "Request",
    "StreamResult",
    "ServeReport",
    "run_serve_loop",
    "prefill_tokens",
    "init_slot_pool",
    "slot_decode_fn",
    "write_slot",
    "read_slot",
]
