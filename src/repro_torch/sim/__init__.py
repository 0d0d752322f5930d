"""Event-driven asynchronous fleet simulator (torch): latency profiles and
the event engine the async training loop runs over, and the serving
tier's request arrivals."""
from repro_torch.sim.arrivals import (  # noqa: F401
    ArrivalProcess,
    sample_arrival_counts,
    sample_gen_lens,
    sample_requests,
)
from repro_torch.sim.latency import (  # noqa: F401
    PROFILES,
    LatencyProfile,
    client_speed,
    get_profile,
    sample_avail_gap,
    sample_dropout,
    sample_latency,
)
from repro_torch.sim.events import (  # noqa: F401
    KERNEL_THRESHOLD,
    init_event_state,
    next_k_events,
    pop_events,
    schedule_completions,
)
from repro_torch.sim.async_rounds import (  # noqa: F401
    AsyncConfig,
    run_async_training,
)
