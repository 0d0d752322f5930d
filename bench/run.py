"""Run one cell of the port's benchmark and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. It needs an NVIDIA GPU and the port
(``src/repro_torch``); without either it exits non-zero and prints no
result. The last line on standard output is one JSON object; the numbers
that decide ``correct`` are printed beside their limits as the last lines
on standard error and under ``checks`` in that object. Kernel builds go to
fixed directories inside the checkout, so only a checkout's first run
builds.
"""
import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE, sub)
    import torch

    from bench import harness

    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 2
    spec = harness.cell_spec(args.workload)
    want = int(spec.entry["chips"])
    if torch.cuda.device_count() < want:
        print(f"bench: {args.workload} needs {want} GPUs, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    line = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                       T_START, "cuda", spec)
    for k, c in line["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
