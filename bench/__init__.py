"""The port's benchmark: ``python bench/run.py --workload <cell> ...``."""
