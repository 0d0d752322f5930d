"""Serving primitives of the port. So far the prompt-ingestion path that
``launch.serve`` uses; the slot pool and the serving loop arrive with
ROADMAP queue 1, slice H."""
