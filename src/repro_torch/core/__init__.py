"""The paper's core: AoI dynamics, the load metric X, selection policies,
and the port's random-draw sources."""
