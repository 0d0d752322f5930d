"""The readings that the limits of ``correct`` are set from (see PERF.md):

    python3 bench/control.py --workload <cell> --side program --seeds 1,2,3
    python3 bench/control.py --workload <cell> --side autocast --seeds 1,2,3
    python3 bench/control.py --workload <cell> --side control --seeds 1,2,3

``program``: whole runs of the cell (``harness.run``, a ``--seconds``
window) on each seed in one process, every number the comparison works
out. ``autocast`` (a control): the same runs with the program's set-up,
window and first steps under ``torch.autocast`` to bfloat16, one precision
below the configuration's float32. ``control``: the plain reference put in
the program's place, computed one precision below the configuration's
(wholly in bfloat16 for the float32 CNN, fp8 projections for the bfloat16
Mamba2), against the reference as it is, on the same inputs. ``half``
(training cells, a fault): the reference in the program's place with half
of each step's batch left out, the mean taken over the rest. One JSON
line per seed, with ``correct`` as the cell's limits judge the numbers.
Runs on the card; the benchmark's own runs never run this.
"""
import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def autocast_bf16(device: str = "cuda"):
    """The program's own path one precision below the CNN's float32:
    ``torch.autocast`` to bfloat16, its cast cache off (a window's many
    steps would fill it)."""
    import torch

    return torch.autocast(device, dtype=torch.bfloat16, cache_enabled=False)


def control_readings(name: str, seed: int, device: str = "cuda", spec=None):
    """The cell's compared numbers with the lower-precision reference in
    the program's place."""
    import torch

    from bench import gen, harness
    from bench.drivers import fl, lm

    spec = harness.cell_spec(name) if spec is None else spec
    ref = harness.reference(spec.entry["config"])
    t = spec.traffic
    if t["kind"] == "fl":
        cell = fl.Cell(spec, seed, device)
        cell.setup()  # the benchmark's draws, as the program asks for them
        logs = cell.first["draws"]
        cell.release()
        exact = ref.follow(spec, seed, device, logs)
        low = ref.follow(spec, seed, device, logs, compute_dtype=torch.bfloat16)
        return fl.compare(exact["p0"], low, exact)
    w = ref.weights(spec.config, seed, device)
    pool = gen.token_batches(seed, t["pool"], t["batch"], t["seq"], spec.config["vocab_size"],
                             device)
    if t["task"] == "train":
        batches = [(pool[i][:, :-1], pool[i][:, 1:]) for i in range(t["verify_steps"])]
        exact = ref.follow_train(spec.config, w, batches, t["lr"])
        low = ref.follow_train(spec.config, w, batches, t["lr"], q=ref.fp8)
        return lm.compare_train(low, exact)
    gap = state = 0.0
    for i in range(t["state_calls"] + 2):
        tok = pool[i][:, :-1]
        logits, states = ref.prefill(spec.config, w, tok)
        lo_logits, lo_states = ref.prefill(spec.config, w, tok, q=ref.fp8)
        gap = max(gap, lm.served_gap(lo_logits, logits))
        state = max(state, lm.state_gap(lo_states, states))
    return {"served_logit_gap": gap, "state_gap": state}


def half_batch_readings(name: str, seed: int, device: str = "cuda", spec=None):
    """A training cell's compared numbers with the reference put in the
    program's place and half of each step's batch (cohort) left out, the
    mean taken over the rest (a fault the cell has to catch)."""
    from bench import gen, harness
    from bench.drivers import fl, lm

    spec = harness.cell_spec(name) if spec is None else spec
    ref = harness.reference(spec.entry["config"])
    t = spec.traffic
    if t["kind"] == "fl":
        cell = fl.Cell(spec, seed, device)
        cell.setup()
        logs = cell.first["draws"]
        cell.release()
        exact = ref.follow(spec, seed, device, logs)
        return fl.compare(exact["p0"], ref.follow(spec, seed, device, logs, half=True), exact)
    w = ref.weights(spec.config, seed, device)
    pool = gen.token_batches(seed, t["pool"], t["batch"], t["seq"], spec.config["vocab_size"],
                             device)
    batches = [(pool[i][:, :-1], pool[i][:, 1:]) for i in range(t["verify_steps"])]
    exact = ref.follow_train(spec.config, w, batches, t["lr"])
    halves = [(x[: len(x) // 2], y[: len(y) // 2]) for x, y in batches]
    return lm.compare_train(ref.follow_train(spec.config, w, halves, t["lr"]), exact)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--side", required=True,
                    choices=("program", "autocast", "control", "half"))
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from bench import harness

    import torch

    limits = harness.cell_spec(args.workload).limits
    for seed in map(int, args.seeds.split(",")):
        t0 = time.time()
        if args.side in ("program", "autocast"):
            torch.cuda.reset_peak_memory_stats()
            within = autocast_bf16 if args.side == "autocast" else contextlib.nullcontext
            out = {}
            line = harness.run(args.workload, seed, args.seconds, False, t0, "cuda",
                               within=within, readings=out)
            out.update(correct=line["correct"], rate=line["metrics"],
                       peak=line["device"]["memory_peak_bytes"])
        else:
            read = control_readings if args.side == "control" else half_batch_readings
            out = read(args.workload, seed)
            out["correct"] = harness.judge(out, limits)[1]
        print(json.dumps({"workload": args.workload, "side": args.side, "seed": seed,
                          "s": time.time() - t0, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
