"""Model configurations of the port (the paper CNN; the LM configs arrive
with ROADMAP queue 1, slice G)."""
