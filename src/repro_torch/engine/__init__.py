"""Unified federated engine API of the port.

The same contract as ``repro.engine``: name-based registries
(``register_policy`` / ``register_aggregator``), the ``Policy`` /
``Aggregator`` / ``Engine`` protocols, and ``RunConfig`` in, ``RunResult``
out, with one JSON-safe serializer. The synchronous and asynchronous
engines are ported (``SyncEngine``, ``AsyncEngine``) with the robustness
tier (faults, robust aggregators, deadline re-dispatch) and aggregation
topologies (``repro_torch.topo``); ``RunConfig`` rejects every option of a
later slice.
"""
from repro_torch.engine.registry import (  # noqa: F401
    aggregator_names,
    make_aggregator,
    make_policy,
    policy_names,
    register_aggregator,
    register_policy,
)
from repro_torch.engine.serialize import dump_json, to_jsonable  # noqa: F401
from repro_torch.engine.aggregators import Aggregator, staleness_weight  # noqa: F401
from repro_torch.engine import robust  # noqa: F401  (registers robust aggregators)
from repro_torch.engine.config import (  # noqa: F401
    RoundRecord,
    RunConfig,
    RunResult,
)
from repro_torch.engine.api import (  # noqa: F401
    HISTORY_CELL_CAP,
    Engine,
    make_engine,
    run_engine,
)
from repro_torch.engine.async_engine import AsyncEngine  # noqa: F401
from repro_torch.engine.sync import SyncEngine  # noqa: F401
from repro_torch.core.selection import Policy  # noqa: F401  (registers built-ins)
