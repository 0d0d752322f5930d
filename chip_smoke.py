#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``src/repro_torch/csrc`` (one
``nvcc`` per source, all started together), then runs three phases and
prints one JSON line for each:

  kernel  K2 (``event_topk``) against its plain version on the card, at
          fleet sizes 16384 .. 2^20 and the edge cases (all ties, all idle,
          fewer pending events than k); its time (CUDA events, launch
          overhead included, and device-only from the profiler), the plain
          version's, the ``torch.topk`` yardstick's, and its bound.
  main    the driver's own path, ``repro_torch.launch.fl_async`` at the
          paper CNN's full widths on MNIST at its real size (60 000 images)
          over a 16 384-client fleet with a 256-update buffer, 20 steps:
          the K2 launch count of that run, device placement of the whole
          engine state, finite losses, E[X] against n/k, steps/s and peak
          device memory; then two steps under CUDA's sync debug mode (no
          step may synchronize with the host), a steady-state timing and
          a short profiler window of the same loop.
  parity  a small replayed run (48 clients, 6 steps, draws from a fixed
          numpy seed) three ways — K2 kernel and plain K2 on the card, plain
          on the CPU — with TF32 off: discrete outputs must be equal, params
          close.

Then the ``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi`` reports them, and, last, the device line. Any failure exits
non-zero; without a GPU, or outside a checkout of the repository, the
script fails before printing a result. It imports nothing of JAX.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
MAIN_ARGV = ["--dataset", "mnist", "--data-scale", "5", "--clients", "16384",
             "--k", "256", "--policy", "markov", "--latency-profile", "lognormal",
             "--rounds", "20"]
KERNEL_SHAPE = (16384, 256)  # (n, k) the main path gives K2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, calls: int = 100, trials: int = 7) -> float:
    """Median per-call device time of ``fn`` over ``trials`` runs of
    ``calls`` back-to-back calls, timed with CUDA events after a warm-up."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / calls)
    return statistics.median(per_call)


def device_ms(torch, fn, calls: int = 20) -> float:
    """Per-call device time of ``fn``: the summed time of the CUDA kernels
    it launches (``torch.profiler``), without the host's launch overhead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us = sum(ev.self_device_time_total for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA)
    return total_us / 1e3 / calls


def phase_kernel(torch, event_topk):
    gen = torch.Generator(device="cuda").manual_seed(0)

    def times(n, frac):
        t = torch.rand(n, generator=gen, device="cuda") * 100
        pending = torch.rand(n, generator=gen, device="cuda") < frac
        return torch.where(pending, t, torch.inf)

    cases = [(f"n{n}_k{k}", times(n, 0.3), k)
             for n in (16384, 65536, 1_000_003, 2**20) for k in (8, 256)]
    cases += [
        ("all_ties", torch.full((16384,), 5.0, device="cuda"), 256),
        ("all_idle", torch.full((65536,), float("inf"), device="cuda"), 8),
        ("fewer_than_k", times(1_000_003, 100 / 1_000_003), 256),
    ]
    max_err = 0.0
    for name, t, k in cases:
        v, i = event_topk.event_topk(t, k)
        pv, pi = event_topk.next_k_plain(t, k)
        torch.cuda.synchronize()
        fin = torch.isfinite(pv)
        if not (torch.equal(torch.isfinite(v), fin) and torch.equal(i[fin], pi[fin])):
            raise AssertionError(f"K2 disagrees with its plain version: {name}")
        if fin.any():
            max_err = max(max_err, float((v[fin] - pv[fin]).abs().max()))
        if max_err != 0.0:
            raise AssertionError(f"K2 times differ from the plain version: {name}")
        if name == "all_ties" and not torch.equal(i.cpu(), torch.arange(k)):
            raise AssertionError("K2 tie order is not lower-index-first")

    n, k = KERNEL_SHAPE
    t = times(n, 0.02)  # the main path's t_done: ~1-2% of the fleet in flight
    ms = cuda_ms(torch, lambda: event_topk.event_topk(t, k))
    plain_ms = cuda_ms(torch, lambda: event_topk.next_k_plain(t, k))
    library_ms = cuda_ms(torch, lambda: torch.topk(t, k, largest=False))
    bytes_moved = n * 4 + k * (4 + 8)  # times in; f32 times + i64 indices out
    ops = n  # one comparison per element is the least a selection needs
    bound_ms = max(bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
    entry = {
        "name": "event_topk", "route": "cuda",
        "source": "src/repro_torch/csrc/event_topk.cu",
        "replaces": "src/repro/kernels/event_topk.py:48",
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": library_ms,
    }
    emit({"phase": "kernel", "ok": True, "cases": len(cases), "n": n, "k": k,
          "passes": event_topk.num_passes(n, k), **entry,
          "device_ms": device_ms(torch, lambda: event_topk.event_topk(t, k)),
          "plain_device_ms": device_ms(torch, lambda: event_topk.next_k_plain(t, k)),
          "library_device_ms": device_ms(
              torch, lambda: torch.topk(t, k, largest=False))})
    return entry


def _state_tensors(tree, path=""):
    if isinstance(tree, dict):
        for key, val in tree.items():
            yield from _state_tensors(val, f"{path}/{key}")
    else:
        yield path, tree


def phase_main(torch, event_topk):
    from repro_torch.core import load_metric
    from repro_torch.engine import run_engine
    from repro_torch.launch import fl_async

    args = fl_async.parse_args(MAIN_ARGV)
    t0 = time.time()
    task, engine = fl_async.build(args)
    setup_s = time.time() - t0
    captured = {}
    finalize = engine.finalize

    def capture(state, *rest):
        captured["state"] = state
        return finalize(state, *rest)

    engine.finalize = capture
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    event_topk.launches = 0
    res = run_engine(engine, progress=True)
    launches = event_topk.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    fl_async.report(res, args)

    cfg = res.config
    off = [p for p, t in _state_tensors(captured["state"])
           if not (isinstance(t, torch.Tensor) and t.is_cuda)]
    if off:
        raise AssertionError(f"engine state off the GPU: {off}")
    if launches < cfg.rounds:
        raise AssertionError(f"K2 launched {launches} times in {cfg.rounds} steps")
    evals = [r.eval_loss for r in res.records]
    trains = [r.train_loss for r in res.records if r.buffer_fill > 0]
    if not all(map(math.isfinite, evals + trains)) or len(res.records) != cfg.rounds:
        raise AssertionError(f"non-finite losses: eval {evals} train {trains}")
    ws, ls = res.wall_stats, res.load_stats
    # E[X] by the renewal identity E[X] = n / E[cohort]: over 20 steps the
    # per-dispatch samples of X are cut short by the run (a client's first
    # sample is its steady-state start age, and gaps of ~n/k steps do not
    # fit in the run), so their mean is not E[X]
    target = cfg.n_clients / cfg.k
    mean_x = cfg.n_clients / ls["mean_cohort"]
    if abs(mean_x - target) > 0.15 * target:
        raise AssertionError(f"E[X] {mean_x} far from n/k = {target}")
    out = {
        "phase": "main", "ok": True, "argv": MAIN_ARGV,
        "kernel_launches": launches, "steps": cfg.rounds,
        "steps_per_s": cfg.rounds / res.wall_time_s,
        "wall_time_s": res.wall_time_s, "setup_s": setup_s,
        "eval_loss": evals[-1], "accuracy": res.records[-1].accuracy,
        "mean_X": mean_x, "n_over_k": target, "mean_cohort": ls["mean_cohort"],
        "mean_X_epoch": ws["mean_X_epoch"], "var_X_epoch": ws["var_X_epoch"],
        "var_X_round": ls["var_X"], "x_round_samples": ls["num_samples"],
        "random_selection_var": load_metric.random_selection_var(cfg.n_clients, cfg.k),
        "optimal_var": load_metric.optimal_var(cfg.n_clients, cfg.k, cfg.m),
        "mean_staleness": ws["mean_staleness"],
        "peak_mem_gib": peak_gib,
        "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                 "matmul": torch.backends.cuda.matmul.allow_tf32},
    }
    state, syncs = sync_free_steps(torch, engine, captured["state"], cfg.rounds)
    if syncs:
        raise AssertionError(f"a step synchronized with the host: {syncs}")
    out["host_syncs_in_2_steps"] = 0
    out.update(steady_and_profile(torch, engine, state, cfg.rounds + 2,
                                  res.wall_time_s))
    emit(out)
    return launches


def sync_free_steps(torch, engine, state, r0, steps=2):
    """Run ``steps`` steps as one chunk under
    ``torch.cuda.set_sync_debug_mode``; returns the new state and the
    messages of every synchronizing CUDA operation they made. A known sync
    (``.item()``) right after is the control: the mode must report it."""
    def is_sync(w):
        # torch warns "called a synchronizing CUDA operation" for each one;
        # its one-off notice that the mode is a prototype is not one
        msg = str(w.message)
        return "synchroniz" in msg and "prototype feature" not in msg

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, _ = engine.run_chunk(state, r0, steps, False)
            in_steps = len(caught)
            torch.zeros((), device="cuda").item()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    if not any(map(is_sync, caught[in_steps:])):
        raise AssertionError("sync debug mode missed a known sync (.item())")
    return state, [str(w.message) for w in caught[:in_steps] if is_sync(w)]


def _loop(engine, state, r0, steps):
    """``run_engine``'s loop at the driver's cadence: one step per chunk,
    its aux to the host, an eval and its record."""
    for r in range(r0, r0 + steps):
        state, aux = engine.run_chunk(state, r, 1, False)
        aux = {k: v.cpu().numpy() for k, v in aux.items()}
        engine.record(r, {k: v[-1] for k, v in aux.items()}, engine.evaluate(state))
    return state


def steady_and_profile(torch, engine, state, r0, wall_time_s, steps=10, prof_steps=3):
    """Steady-state step time (host clock over ``steps`` more steps of the
    driver's loop, after the counted run), the first run's warm-up derived
    from it, and device time by kernel over ``prof_steps`` further steps
    (``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.time()
    state = _loop(engine, state, r0, steps)
    torch.cuda.synchronize()
    steady_ms = (time.time() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _loop(engine, state, r0 + steps, prof_steps)
        torch.cuda.synchronize()
    rows = sorted(((ev.self_device_time_total / 1e3, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows) / prof_steps if rows else None
    return {
        "steady_ms_per_step": steady_ms, "steady_steps_per_s": 1e3 / steady_ms,
        "warmup_s": wall_time_s - engine.cfg.rounds * steady_ms / 1e3,
        "device_busy_ms_per_step": busy_ms if rows else "not measured",
        "device_busy_share": busy_ms / steady_ms if rows else "not measured",
        "profile_top": [{"ms_per_step": ms / prof_steps, "name": name[:90],
                         "calls_per_step": count / prof_steps}
                        for ms, name, count in rows[:12]],
    }


def _replay(n, k, m, steps, epochs, examples, shapes, seed=0):
    """Fixed numpy draws for every site of the calm async path."""
    import numpy as np

    from repro_torch.core import load_metric

    rng = np.random.default_rng(seed)
    pi = load_metric.steady_state(load_metric.optimal_probs(n, k, m))
    init = {f"params/{name}": rng.standard_normal(shape).astype(np.float32)
            for name, shape in shapes.items()}
    init["policy_init"] = rng.choice(m + 1, size=n, p=pi)
    init["speed"] = rng.standard_normal(n).astype(np.float32)
    per_step = []
    for _ in range(steps):
        per_step.append({
            "select": rng.random(n, dtype=np.float32),
            "latency_compute": rng.standard_normal(n).astype(np.float32),
            "latency_comm": rng.exponential(size=n).astype(np.float32),
            "local_perm": np.argsort(rng.random((k, epochs, examples)), axis=-1),
        })
    return init, per_step


def phase_parity(torch):
    import numpy as np

    from repro_torch.configs.paper_cnn import MNIST_CNN
    from repro_torch.core.draws import ReplayDraws
    from repro_torch.data.synthetic import load_dataset
    from repro_torch.engine import RunConfig, make_engine
    from repro_torch.fl import make_cnn_task
    from repro_torch.kernels import event_topk
    from repro_torch.sim import events as ev_mod

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n, k, m, steps, epochs = 48, 8, 10, 6, 2
    train, test = load_dataset("mnist", seed=0, scale=0.02)
    s = MNIST_CNN.image_size // 4
    shapes = {"conv1": (5, 5, 1, 32), "conv2": (5, 5, 32, 64),
              "fc1": (s * s * 64, 512), "fc2": (512, 10)}

    def run(device, use_kernel):
        task = make_cnn_task(MNIST_CNN, train, test, n, seed=0, device=device)
        init, per_step = _replay(n, k, m, steps, epochs, task.examples_per_client,
                                 shapes)
        cfg = RunConfig(mode="async", n_clients=n, k=k, m=m, policy="markov",
                        rounds=steps, local_epochs=epochs, batch_size=50,
                        lr0=0.02, seed=0, profile="lognormal",
                        use_kernel=use_kernel)
        engine = make_engine(task, cfg, draws=ReplayDraws(init, per_step, device))
        pops, orig = [], ev_mod.pop_events

        def recording(ev, kk, *, use_kernel=None):
            out = orig(ev, kk, use_kernel=use_kernel)
            pops.append((out[1].cpu(), out[2].cpu()))
            return out

        ev_mod.pop_events = recording
        try:
            state = engine.init()
            trace = []
            for r in range(steps):
                state, aux = engine.step(state, r)
                trace.append({
                    "send": aux["send"].cpu(), "version": int(state["version"]),
                    "ages": state["sched"]["ages"].cpu(),
                    "disp_ver": state["ev"]["disp_ver"].cpu(),
                    "clock": float(state["clock"]),
                    "params": {f"{a}.{b}": v.cpu() for a, lv in state["params"].items()
                               for b, v in lv.items()},
                })
        finally:
            ev_mod.pop_events = orig
        return trace, pops

    launches_before = event_topk.launches
    runs = {"cuda_kernel": run("cuda", True), "cuda_plain": run("cuda", False),
            "cpu_plain": run("cpu", False)}
    ref_trace, ref_pops = runs["cpu_plain"]
    worst = 0.0
    for name, (trace, pops) in runs.items():
        for r in range(steps):
            a, b = trace[r], ref_trace[r]
            same = (torch.equal(a["send"], b["send"]) and a["version"] == b["version"]
                    and torch.equal(a["ages"], b["ages"])
                    and torch.equal(a["disp_ver"], b["disp_ver"])
                    and torch.equal(pops[r][0], ref_pops[r][0])
                    and torch.equal(pops[r][1], ref_pops[r][1]))
            if not same:
                raise AssertionError(f"parity: {name} step {r} discrete outputs differ")
            if abs(a["clock"] - b["clock"]) > 1e-6 * abs(b["clock"]):
                raise AssertionError(f"parity: {name} step {r} clock differs")
            for key, val in a["params"].items():
                if not torch.allclose(val, b["params"][key], rtol=1e-4, atol=1e-5):
                    raise AssertionError(f"parity: {name} step {r} {key} differs")
                worst = max(worst, float((val - b["params"][key]).abs().max()))
    if event_topk.launches - launches_before < steps:
        raise AssertionError("parity: the cuda_kernel run did not launch K2 every step")
    emit({"phase": "parity", "ok": True, "runs": list(runs), "steps": steps,
          "popped": int(sum(int(v.sum()) for _, v in ref_pops)),
          "kernel_launches": event_topk.launches - launches_before,
          "max_param_abs_diff_vs_cpu": worst, "tf32": False})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build, event_topk

    t0 = time.time()
    build.build_all()
    emit({"phase": "build", "ok": True, "seconds": time.time() - t0,
          "ptxas": {k: [ln.strip() for ln in v.splitlines() if "Used" in ln]
                    for k, v in build.ptxas_log.items()}})
    entry = phase_kernel(torch, event_topk)
    entry["launches"] = phase_main(torch, event_topk)
    phase_parity(torch)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{key: entry[key] for key in keys}]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
