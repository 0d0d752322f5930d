"""Aggregation topology (``repro.topo``) of the port: so far only the
liveness predicate that the re-dispatch deadline shares with heartbeats
(``topo/heartbeat.py::expired``); the rest arrives with ROADMAP queue 1,
slice D."""
