#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``src/repro_torch/csrc`` (one
``nvcc`` per source, all started together), then runs these phases and
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
  kernel_k1    K1 (``fedavg_reduce``) against its plain version on the card
          at the sync main path's shapes (30 cohort slots, each of the paper
          CNN's eight leaves), the fleet width (320 x the fc1 leaf) and the
          edge cases (C = 1, N not a multiple of 4, all-zero weights, an
          unaligned pointer, C above the staged-weight chunk); times as for
          K2, with ``torch.mv`` as the yardstick.
  sync_main    the sync driver's own path, ``repro_torch.launch.fl_train``
          at the paper's Sec. IV settings (100 clients, k = 15, m = 10,
          E = 5, B = 50) on MNIST at its real size, 60 rounds, with lr 0.02:
          on the synthetic MNIST stand-in the paper's lr 0.1 diverges in
          the first local steps, in the reference as in the port. K1
          launched once per param leaf per round, device placement, finite
          losses, accuracy rising, E[X] against n/k, Var[X] below random
          selection's; no host sync in two rounds; rounds/s, steady ms per
          round, device-busy share and peak memory.
  sync_parity  a small replayed sync run (48 clients, 6 rounds) with K1 on
          the card and plain on the CPU, TF32 off, each card round started
          from the CPU's params of the round before: discrete outputs
          equal, params close, K1 launched every round.

The main and sync_main phases run before the parity phases, which turn
TF32 off. Then the ``{"kernels": [...]}`` line (K2, then K1), the card's name and power limit as
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
SYNC_ARGV = ["--dataset", "mnist", "--data-scale", "5", "--clients", "100",
             "--k", "15", "--m", "10", "--policy", "markov", "--local-epochs", "5",
             "--batch-size", "50", "--lr", "0.02", "--rounds", "60"]
FLEET = (16384, 256)  # (n, k) of the async main path, for K1's fleet width
K1_RTOL, K1_ATOL = 1e-5, 1e-6  # relative to sum_c |w_c P_cn|: f32 sums in two orders


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


def _loop(engine, state, r0, steps, eval_every=1):
    """``run_engine``'s loop at the driver's cadence: one step per chunk,
    its aux to the host, and every ``eval_every`` steps an eval and its
    record."""
    for r in range(r0, r0 + steps):
        state, aux = engine.run_chunk(state, r, 1, False)
        aux = {k: v.cpu().numpy() for k, v in aux.items()}
        if (r + 1) % eval_every == 0:
            engine.record(r, {k: v[-1] for k, v in aux.items()},
                          engine.evaluate(state))
    return state


def _union_ms(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals in microseconds,
    as ms: device time with any kernel running, overlaps counted once."""
    total, cur_s, cur_e = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_e is None or start > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def steady_and_profile(torch, engine, state, r0, wall_time_s, steps=10, prof_steps=3,
                       match=None, eval_every=1):
    """Steady-state step time (host clock over ``steps`` more steps of the
    driver's loop, after the counted run, with an eval every
    ``eval_every`` steps), the first run's warm-up derived from it, and
    device time by kernel over ``prof_steps`` further steps
    (``torch.profiler``): summed kernel time, and the union of the kernel
    intervals over the window's host-clock wall time (kernels that
    overlap count once). With ``match``, also the device time per step of
    the kernels whose name contains it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.time()
    state = _loop(engine, state, r0, steps, eval_every)
    torch.cuda.synchronize()
    steady_ms = (time.time() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        _loop(engine, state, r0 + steps, prof_steps, eval_every)
        torch.cuda.synchronize()
        window_ms = (time.time() - t0) * 1e3
    rows = sorted(((ev.self_device_time_total / 1e3, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows) / prof_steps if rows else None
    union_ms = _union_ms((ev.time_range.start, ev.time_range.end)
                         for ev in prof.events()
                         if ev.device_type == DeviceType.CUDA)
    extra = {}
    if match and rows:
        extra[f"{match}_device_ms_per_step"] = sum(
            ms for ms, name, _ in rows if match in name) / prof_steps
    if union_ms > 0:
        extra["device_union_ms_per_step"] = union_ms / prof_steps
        extra["device_union_share_of_window"] = union_ms / window_ms
        extra["profiled_window_ms_per_step"] = window_ms / prof_steps
    return {
        **extra,
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


def phase_kernel_k1(torch, fedavg_reduce):
    from repro_torch.configs.paper_cnn import MNIST_CNN
    from repro_torch.core.draws import GeneratorDraws
    from repro_torch.core.tree import tree_leaves
    from repro_torch.engine.config import default_cohort_width
    from repro_torch.models.cnn import init_params

    gen = torch.Generator(device="cuda").manual_seed(1)
    leaves = [t.numel() for t in tree_leaves(init_params(GeneratorDraws(0, "cuda"),
                                                         MNIST_CNN))]
    width = default_cohort_width(100, 15)  # the sync main path's cohort slots
    fleet_width = default_cohort_width(*FLEET)

    def stack(C, N, active, offset=0):
        """(C, N) params with ``active`` leading 0/1-mask slots, as
        ``cohort_indices`` lays a cohort out; ``offset`` floats in, so the
        pointer loses its 16-byte alignment."""
        buf = torch.randn(C * N + offset, generator=gen, device="cuda")
        w = (torch.arange(C, device="cuda") < active).to(torch.float32)
        return buf[offset:].view(C, N), w

    def check(name, P, w):
        out = fedavg_reduce.fedavg_reduce(P, w)
        again = fedavg_reduce.fedavg_reduce(P, w)
        plain = fedavg_reduce.fedavg_reduce_plain(P, w)
        scale = (w.abs()[:, None] * P.abs()).sum(0)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"K1 launches differ bitwise: {name}")
        err = (out - plain).abs()
        if bool((err > K1_RTOL * scale + K1_ATOL).any()):
            raise AssertionError(f"K1 disagrees with its plain version: {name}")
        exact = (w.double()[:, None] * P.double()).sum(0)
        f64_err[name] = {"kernel": float((out.double() - exact).abs().max()),
                         "plain": float((plain.double() - exact).abs().max())}
        return float(err.max())

    main_cases = [(f"c{width}_n{N}", *stack(width, N, 15)) for N in leaves]
    fleet_case = (f"c{fleet_width}_n{max(leaves)}",
                  *stack(fleet_width, max(leaves), FLEET[1]))
    edge_cases = [
        ("c1_n17", *stack(1, 17, 1)),
        ("c7_n1001", *stack(7, 1001, 5)),
        ("zero_weights", *stack(width, 5120, 0)),
        ("unaligned", *stack(width, 1024, 15, offset=1)),
        ("c2050_n4096", *stack(2050, 4096, 1500)),  # weights staged in 2+ chunks
    ]
    if edge_cases[3][1].data_ptr() % 16 == 0:
        raise AssertionError("the unaligned case is aligned")
    cases = main_cases + [fleet_case] + edge_cases
    f64_err = {}
    max_err = max(check(name, P, w) for name, P, w in cases)

    def timed(name, P, w):
        C, N = P.shape
        return {
            "case": name, "C": C, "N": N,
            "ms": cuda_ms(torch, lambda: fedavg_reduce.fedavg_reduce(P, w)),
            "device_ms": device_ms(torch, lambda: fedavg_reduce.fedavg_reduce(P, w)),
            "plain_ms": cuda_ms(torch, lambda: fedavg_reduce.fedavg_reduce_plain(P, w)),
            "library_ms": cuda_ms(torch, lambda: torch.mv(P.t(), w)),
            "library_device_ms": device_ms(torch, lambda: torch.mv(P.t(), w)),
            # each input read once, the output written once; 2*C*N flops
            "bound_ms": max((C * N + C + N) * 4 / HBM_BYTES_PER_S,
                            2 * C * N / FP32_OPS_PER_S) * 1e3,
        }

    rows = [timed(*case) for case in main_cases + [fleet_case]]
    per_round = rows[:len(main_cases)]
    # one sync round launches K1 once per leaf: the entry sums those launches
    entry = {
        "name": "fedavg_reduce", "route": "cuda",
        "source": "src/repro_torch/csrc/fedavg_reduce.cu",
        "replaces": "src/repro/kernels/fedavg_reduce.py:35",
        "max_abs_err": max_err,
        **{key: sum(r[key] for r in per_round)
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
        "bound_by": "bytes",
    }
    emit({"phase": "kernel_k1", "ok": True, "cases": len(cases), "width": width,
          "leaves": leaves, "per_round": "sum over the sync round's leaf launches",
          **entry, "device_ms": sum(r["device_ms"] for r in per_round),
          "rows": rows, "max_abs_err_vs_f64": f64_err})
    return entry


def phase_sync_main(torch, fedavg_reduce):
    from repro_torch.core import load_metric
    from repro_torch.core.tree import tree_leaves
    from repro_torch.engine import run_engine
    from repro_torch.launch import fl_train

    args = fl_train.parse_args(SYNC_ARGV)
    t0 = time.time()
    task, engine = fl_train.build(args)
    setup_s = time.time() - t0
    captured = {}
    finalize = engine.finalize

    def capture(state, *rest):
        captured["state"] = state
        return finalize(state, *rest)

    engine.finalize = capture
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fedavg_reduce.launches = 0
    res = run_engine(engine, progress=True)
    launches = fedavg_reduce.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    fl_train.report(res, args)

    cfg = res.config
    state = captured["state"]
    off = [p for p, t in _state_tensors(state)
           if not (isinstance(t, torch.Tensor) and t.is_cuda)]
    if off:
        raise AssertionError(f"engine state off the GPU: {off}")
    n_leaves = len(tree_leaves(state["params"]))
    if launches != cfg.rounds * n_leaves:
        raise AssertionError(f"K1 launched {launches} times in {cfg.rounds} rounds "
                             f"of {n_leaves} leaves")
    evals = [r.eval_loss for r in res.records]
    trains = [r.train_loss for r in res.records]
    if not all(map(math.isfinite, evals + trains)):
        raise AssertionError(f"non-finite losses: eval {evals} train {trains}")
    accs = [r.accuracy for r in res.records]
    if not accs[-1] > accs[0]:
        raise AssertionError(f"accuracy did not rise: {accs}")
    ls = res.load_stats
    target = cfg.n_clients / cfg.k
    mean_x = cfg.n_clients / ls["mean_cohort"]
    if abs(mean_x - target) > 0.15 * target:
        raise AssertionError(f"E[X] {mean_x} far from n/k = {target}")
    var_random = load_metric.random_selection_var(cfg.n_clients, cfg.k)
    if not ls["var_X"] < var_random:
        raise AssertionError(f"markov Var[X] {ls['var_X']} not below random {var_random}")
    out = {
        "phase": "sync_main", "ok": True, "argv": SYNC_ARGV,
        "kernel_launches": launches, "rounds": cfg.rounds, "param_leaves": n_leaves,
        "cohort_width": cfg.cohort_width(), "eval_every": cfg.eval_every,
        "rounds_per_s": cfg.rounds / res.wall_time_s,
        "wall_time_s": res.wall_time_s, "setup_s": setup_s,
        "eval_loss": evals[-1], "accuracy": accs[-1], "first_accuracy": accs[0],
        "mean_X": mean_x, "n_over_k": target, "mean_X_gaps": ls["mean_X"],
        "var_X": ls["var_X"], "x_samples": ls["num_samples"],
        "random_selection_var": var_random,
        "optimal_var": load_metric.optimal_var(cfg.n_clients, cfg.k, cfg.m),
        "mean_cohort": ls["mean_cohort"], "std_cohort": ls["std_cohort"],
        "peak_mem_gib": peak_gib,
        "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                 "matmul": torch.backends.cuda.matmul.allow_tf32},
    }
    state, syncs = sync_free_steps(torch, engine, state, cfg.rounds)
    if syncs:
        raise AssertionError(f"a round synchronized with the host: {syncs}")
    out["host_syncs_in_2_rounds"] = 0
    steady = steady_and_profile(torch, engine, state, cfg.rounds + 2, res.wall_time_s,
                                steps=6, prof_steps=2, match="fedavg_reduce",
                                eval_every=cfg.eval_every)
    out.update({key.replace("_step", "_round"): val for key, val in steady.items()})
    emit(out)
    return launches


def _replay_sync(n, k, m, rounds, epochs, examples, shapes, width, seed=0):
    """Fixed numpy draws for every site of the calm sync path."""
    import numpy as np

    from repro_torch.core import load_metric

    rng = np.random.default_rng(seed)
    pi = load_metric.steady_state(load_metric.optimal_probs(n, k, m))
    init = {f"params/{name}": rng.standard_normal(shape).astype(np.float32)
            for name, shape in shapes.items()}
    init["policy_init"] = rng.choice(m + 1, size=n, p=pi)
    per_round = [{
        "select": rng.random(n, dtype=np.float32),
        "local_perm": np.argsort(rng.random((width, epochs, examples)), axis=-1),
    } for _ in range(rounds)]
    return init, per_round


def phase_sync_parity(torch, fedavg_reduce):
    from repro_torch.configs.paper_cnn import MNIST_CNN
    from repro_torch.core.draws import ReplayDraws
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.data.synthetic import load_dataset
    from repro_torch.engine import RunConfig, make_engine
    from repro_torch.engine.config import default_cohort_width
    from repro_torch.fl import make_cnn_task

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n, k, m, rounds, epochs = 48, 8, 10, 6, 2
    width = default_cohort_width(n, k)
    train, test = load_dataset("mnist", seed=0, scale=0.02)
    s = MNIST_CNN.image_size // 4
    shapes = {"conv1": (5, 5, 1, 32), "conv2": (5, 5, 32, 64),
              "fc1": (s * s * 64, 512), "fc2": (512, 10)}
    cfg = RunConfig(mode="sync", n_clients=n, k=k, m=m, policy="markov",
                    rounds=rounds, local_epochs=epochs, batch_size=50, lr0=0.02,
                    seed=0)
    tasks = {dev: make_cnn_task(MNIST_CNN, train, test, n, seed=0, device=dev)
             for dev in ("cpu", "cuda")}
    init, per_round = _replay_sync(n, k, m, rounds, epochs,
                                   tasks["cpu"].examples_per_client, shapes, width)
    engines = {dev: make_engine(task, cfg, draws=ReplayDraws(init, per_round, dev))
               for dev, task in tasks.items()}
    states = {dev: eng.init() for dev, eng in engines.items()}
    before = fedavg_reduce.launches
    worst, selected = 0.0, 0
    for r in range(rounds):
        if r:  # each card round starts from the CPU's params of the round before
            states["cuda"]["params"] = tree_map(lambda t: t.cuda(), states["cpu"]["params"])
        auxs = {}
        for dev in ("cpu", "cuda"):
            states[dev], auxs[dev] = engines[dev].step(states[dev], r)
        a, b = states["cuda"], states["cpu"]
        same = (torch.equal(auxs["cuda"]["send"].cpu(), auxs["cpu"]["send"])
                and torch.equal(a["sched"]["ages"].cpu(), b["sched"]["ages"])
                and all(torch.equal(a["load_acc"][key].cpu(), val)
                        for key, val in b["load_acc"].items()))
        if not same:
            raise AssertionError(f"sync parity: round {r} discrete outputs differ")
        selected += int(auxs["cpu"]["send"].sum())
        for got, exp in zip(tree_leaves(a["params"]), tree_leaves(b["params"])):
            got = got.cpu()
            if not torch.allclose(got, exp, rtol=1e-4, atol=1e-5):
                raise AssertionError(f"sync parity: round {r} params differ")
            worst = max(worst, float((got - exp).abs().max()))
    launches = fedavg_reduce.launches - before
    n_leaves = len(tree_leaves(states["cpu"]["params"]))
    if launches != rounds * n_leaves:
        raise AssertionError(f"sync parity: K1 launched {launches} times, "
                             f"expected {rounds * n_leaves}")
    emit({"phase": "sync_parity", "ok": True, "rounds": rounds, "width": width,
          "selected": selected,
          "kernel_launches": launches, "max_param_abs_diff_vs_cpu": worst,
          "tf32": False})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build, event_topk, fedavg_reduce

    t0 = time.time()
    build.build_all()
    emit({"phase": "build", "ok": True, "seconds": time.time() - t0,
          "ptxas": {k: [ln.strip() for ln in v.splitlines() if "Used" in ln]
                    for k, v in build.ptxas_log.items()}})
    entry = phase_kernel(torch, event_topk)
    k1_entry = phase_kernel_k1(torch, fedavg_reduce)
    entry["launches"] = phase_main(torch, event_topk)
    k1_entry["launches"] = phase_sync_main(torch, fedavg_reduce)
    phase_parity(torch)
    phase_sync_parity(torch, fedavg_reduce)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{key: e[key] for key in keys} for e in (entry, k1_entry)]})
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
