"""Traffic of kind ``fl``: the port's federated engine driven as its run
loop drives it (``repro_torch.engine.api.run_engine``): chunks of
``eval_every`` steps through ``engine.run_chunk``, the chunk's aux to the
host (the loop's one transfer a chunk), and an evaluation after each
chunk. A closed loop: the next chunk starts when the last one is back.

The workload file gives the run's settings (``mode`` sync or async, the
fleet, the policy, the local training, the evaluation cadence); the
configuration file gives the CNN and the data. The benchmark makes the
images and every random draw from ``--seed`` (``Draws``), records the
draws of the first steps, and hands the same to the plain reference."""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from bench import gen, harness, stats


class Draws:
    """The random source handed to the engine: the port's draw interface
    over the benchmark's own generator. While ``log`` is a list, each draw
    is appended to it as ``(site, tensor)``."""

    def __init__(self, seed: int, device, name: str = "draws"):
        self.seed, self.device = seed, torch.device(device)
        self.generator = gen.generator(seed, name, device)
        self.name = name
        self.log: Optional[List[Tuple[str, torch.Tensor]]] = None
        self._subs: Dict[str, "Draws"] = {}

    def step(self, r: int) -> "Draws":
        return self

    def sub(self, name: str) -> "Draws":
        if name not in self._subs:
            self._subs[name] = Draws(self.seed, self.device, f"{self.name}/{name}")
        return self._subs[name]

    def _rec(self, site: str, t: torch.Tensor) -> torch.Tensor:
        if self.log is not None:
            self.log.append((site, t))
        return t

    def uniform(self, site, shape, low=0.0, high=1.0):
        u = torch.rand(tuple(shape), generator=self.generator, device=self.device)
        return self._rec(site, u * (high - low) + low if (low, high) != (0.0, 1.0) else u)

    def normal(self, site, shape):
        return self._rec(site, torch.randn(tuple(shape), generator=self.generator,
                                           device=self.device))

    def exponential(self, site, shape):
        out = torch.empty(tuple(shape), device=self.device)
        return self._rec(site, out.exponential_(generator=self.generator))

    def poisson(self, site, rate, shape):
        lam = torch.full(tuple(shape), float(rate), device=self.device)
        return self._rec(site, torch.poisson(lam, generator=self.generator).long())

    def randint(self, site, low, high, shape):
        return self._rec(site, torch.randint(low, high, tuple(shape), generator=self.generator,
                                             device=self.device))

    def gumbel(self, site, shape):
        u = torch.rand(tuple(shape), generator=self.generator, device=self.device)
        return self._rec(site, -torch.log(-torch.log(u.clamp_min(1.1754944e-38))))

    def permutation(self, site, n, batch=()):
        u = torch.rand(tuple(batch) + (n,), generator=self.generator, device=self.device)
        return self._rec(site, torch.argsort(u, dim=-1, stable=True))

    def categorical(self, site, probs, shape):
        p = torch.as_tensor(np.asarray(probs, np.float64), dtype=torch.float32,
                            device=self.device)
        out = torch.multinomial(p, int(np.prod(shape)), replacement=True,
                                generator=self.generator)
        return self._rec(site, out.reshape(tuple(shape)))


def dataset(spec, seed: int, device):
    """(train images, train labels, test images, test labels) on ``device``."""
    c = spec.config
    n_train, n_test = c["train_examples"], c["test_examples"]
    x, y = gen.images(seed, n_train + n_test, c["image_size"], c["channels"],
                      c["num_classes"], device)
    return x[:n_train], y[:n_train], x[n_train:], y[n_train:]


def _tree_norms(a, b=None) -> List[float]:
    """Per-leaf norms of ``a`` (or of ``a - b``), leaves in sorted-path order."""
    out = []
    for key in sorted(a):
        for leaf in sorted(a[key]):
            x = a[key][leaf].double()
            if b is not None:
                x = x - b[key][leaf].double()
            out.append(float(torch.linalg.vector_norm(x)))
    return out


def _clone(tree):
    return {k: {n: v.detach().clone() for n, v in d.items()} for k, d in tree.items()}


class Cell:
    """One run of an ``fl`` cell: ``setup``, ``window``, ``traced_steps``,
    ``counters``, ``release``, ``verify``."""

    def __init__(self, spec, seed: int, device):
        self.spec, self.seed, self.device = spec, seed, torch.device(device)
        t = spec.traffic
        self.mode = t["mode"]
        self.chunk = int(t["eval_every"])
        self.rate_metric = t["rate_metric"]
        self.follow = int(t["verify_steps"])

    # --- the program -------------------------------------------------------
    def _build(self):
        from repro_torch.configs.paper_cnn import CNNConfig
        from repro_torch.data.synthetic import ImageDataset
        from repro_torch.engine import RunConfig, make_engine
        from repro_torch.fl import make_cnn_task

        c, t = self.spec.config, self.spec.traffic
        xtr, ytr, xte, yte = dataset(self.spec, self.seed, self.device)
        cnn = CNNConfig(c["name"], c["image_size"], c["channels"], c["num_classes"],
                        tuple(c["conv_channels"]), c["kernel"], c["fc_width"])
        train = ImageDataset(c["name"], xtr.cpu().numpy(), ytr.cpu().numpy().astype(np.int32))
        test = ImageDataset(c["name"], xte.cpu().numpy(), yte.cpu().numpy().astype(np.int32))
        del xtr, ytr, xte, yte
        task = make_cnn_task(cnn, train, test, t["clients"], seed=gen.sub_seed(self.seed, "partition"),
                             device=self.device)
        kw = {}
        if self.mode == "async":
            from repro_torch.sim.latency import LatencyProfile

            kw = dict(buffer_size=t["buffer"], max_versions=t["max_versions"],
                      profile=LatencyProfile(t["latency_profile"], **t["latency"]),
                      aggregator_kwargs={"staleness_mode": "poly",
                                         "staleness_exp": t["staleness_exp"]})
        cfg = RunConfig(mode=self.mode, n_clients=t["clients"], k=t["k"], m=t["m"],
                        policy=t["policy"], aggregator=t["aggregator"], rounds=10**9,
                        local_epochs=t["local_epochs"], batch_size=t["batch_size"],
                        lr0=t["lr"], lr_decay=t["lr_decay"], seed=0,
                        eval_every=self.chunk, steps_per_chunk=self.chunk,
                        collect_history=False, **kw)
        self.draws = Draws(self.seed, self.device)
        self.task = task
        self.engine = make_engine(task, cfg, draws=self.draws)

    def _chunk(self) -> Dict[str, np.ndarray]:
        """One chunk of the run loop and its evaluation."""
        from torch.autograd.profiler import record_function

        with record_function("bench.fl.chunk"):
            self.state, aux = self.engine.run_chunk(self.state, self.r, self.chunk, False)
        with record_function("bench.fl.aux_to_host"):
            aux = {k: v.cpu().numpy() for k, v in aux.items()}
        r = self.r + self.chunk - 1
        with record_function("bench.fl.eval"):
            self.engine.record(r, {k: v[-1] for k, v in aux.items()},
                               self.engine.evaluate(self.state))
        self.r += self.chunk
        return aux

    def _eval_logits(self) -> torch.Tensor:
        """The logits of the evaluation: the program's CNN forward over the
        held-out images in the evaluation's own batches (``fl/task.py``'s
        ``eval_sums`` reduces these to its loss and accuracy)."""
        from repro_torch.fl.task import EVAL_BATCH
        from repro_torch.models import cnn

        x = self.task.eval_data["x"]
        params = self.engine.eval_params(self.state)
        bs = min(EVAL_BATCH, x.shape[0])
        with torch.no_grad():
            return torch.cat([cnn.forward(params, x[i:i + bs]).float()
                              for i in range(0, x.shape[0], bs)])

    def _admitted(self) -> float:
        """Clients trained so far: the admitted cohort sizes (sync) or the
        updates aggregated (async), from the engine's accumulators."""
        if self.mode == "sync":
            acc = self.state["load_acc"]
            dev = float(acc["size_sum"]) - float(acc["c_size_sum"])
            return dev + int(acc["steps"]) * int(acc["size_shift"])
        return float(self.state["stats"]["updates"])

    def setup(self):
        self._build()
        self.draws.log = []
        self.state = self.engine.init()
        self.p0 = _clone(self.engine.eval_params(self.state))
        # the window's evaluation, at the start: the one forward that no
        # chain of SGD steps lies before (see ``compare``)
        eval0 = float(self.engine.evaluate(self.state)["loss"])
        self.first = {"loss": [], "send": [], "params": [], "draws": [self.draws.log],
                      "eval0": eval0, "logits0": self._eval_logits()}
        for r in range(self.follow):
            self.draws.log = []
            self.state, aux = self.engine.run_chunk(self.state, r, 1, True)
            self.first["draws"].append(self.draws.log)
            self.first["loss"].append(float(aux["loss"][0]))
            self.first["send"].append(aux["send"][0].clone())
            if "clock" in aux:
                self.first.setdefault("clock", []).append(float(aux["clock"][0]))
            self.first["params"].append(_clone(self.engine.eval_params(self.state)))
        self.draws.log = None
        self.first["acc"] = {k: v.clone() for k, v in self.state["load_acc"].items()}
        if "stats" in self.state:
            self.first["fleet"] = {k: float(v) for k, v in self.state["stats"].items()}
        self.r = self.follow
        self._chunk()  # the window's shapes: a whole chunk and an evaluation

    def window(self, seconds: float) -> Dict:
        import time

        a0 = self._admitted()  # a device read: the queue is drained
        t0 = time.perf_counter()
        steps = failed = 0
        while True:
            aux = self._chunk()
            steps += self.chunk
            failed += int(np.sum(~np.isfinite(aux["loss"])))
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        trained = self._admitted() - a0
        t = self.spec.traffic
        nb = max(self.task.examples_per_client // t["batch_size"], 1)
        bs = min(t["batch_size"], self.task.examples_per_client)
        return {self.rate_metric: steps / elapsed, "attempted": steps, "failed": failed,
                "window_s": elapsed, "steps": steps,
                "trained_examples": trained * t["local_epochs"] * nb * bs,
                "k1_shape": self._k1_shape()}

    def _k1_shape(self):
        numel = sum(v.numel() for d in self.engine.eval_params(self.state).values()
                    for v in d.values())
        return {"rows": self.engine.cfg.cohort_width(), "cols": numel}

    def traced_steps(self) -> int:
        import warnings

        n = int(self.spec.traffic["trace_chunks"])
        on_card = self.device.type == "cuda"
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if on_card:
                torch.cuda.set_sync_debug_mode(1)
            try:
                for _ in range(n):
                    self._chunk()
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode(0)
        self._syncs = sum("synchroniz" in str(w.message) for w in caught)
        return n * self.chunk

    def counters(self) -> Dict[str, float]:
        from repro_torch.kernels import event_topk, fedavg_reduce

        return {"k1_calls": fedavg_reduce.launches, "k2_calls": event_topk.launches,
                "host_syncs": getattr(self, "_syncs", 0)}

    def release(self):
        """Free the program's state before the reference runs."""
        self.state = self.engine = self.task = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --- the comparison ----------------------------------------------------
    def verify(self) -> Dict[str, float]:
        ref = harness.reference(self.spec.entry["config"])
        out = ref.follow(self.spec, self.seed, self.device, self.first["draws"])
        return compare(self.p0, self.first, out)


def logit_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest gap of a logit from the reference's, over that example's
    largest reference logit in magnitude, over all examples."""
    d = (got.double() - want.double()).abs().amax(dim=1)
    scale = want.double().abs().amax(dim=1).clamp_min(1e-30)
    gap = float((d / scale).max())
    return gap if math.isfinite(gap) else math.inf


def compare(p0, first, out) -> Dict[str, float]:
    """The numbers that decide ``correct`` for an FL cell, from the program's
    first steps (``first``) and the reference's (``out``): the senders and
    the load metric's accumulators (exact), the async fleet's clock, each
    step's loss, the models by leaf, and the evaluation at the start, its
    mean loss and its logits one by one. A client's E epochs of SGD amplify
    any rounding alike (float32 reordered, TF32 or bfloat16 all end a round
    about 1% apart: PERF.md), so the evaluation at the start, which no SGD
    step precedes, tells the precision."""
    r0 = out["params"]
    keep_norms = _tree_norms(r0[0], p0)
    med = float(np.median(keep_norms))
    keep = [v >= 1e-3 * med for v in keep_norms]
    admit = sum(int((a.cpu() != b.cpu()).sum()) for a, b in zip(first["send"], out["send"]))
    acc_p, acc_r = first["acc"], out["acc"]
    acc_diff = int((acc_p["last_sel"].cpu() != acc_r["last_sel"].cpu()).sum())
    for name, want in acc_r.items():
        if name == "last_sel":
            continue
        got = float(acc_p[name]) - float(acc_p.get("c_" + name, 0.0))
        acc_diff += int(got != float(want))
    out_ = {}
    if "fleet" in out:
        # the fleet's integer-valued counters (exact) and its clock
        for name, want in out["fleet"].items():
            if not name.startswith("wall_sx"):
                acc_diff += int(first["fleet"][name] != want)
        out_["clock_gap"] = max(stats.rel_gap(a, b) for a, b in zip(first["clock"], out["clock"]))
    return {
        **out_,
        "admissions_differing": float(admit),
        "accumulators_differing": float(acc_diff),
        "eval_gap": stats.rel_gap(first["eval0"], out["eval0"]),
        "eval_logit_gap": logit_gap(first["logits0"], out["logits0"]),
        "loss_gap": max(stats.rel_gap(a, b) for a, b in zip(first["loss"], out["loss"])),
        "first_update_gap": stats.worst_leaf_gap(_tree_norms(first["params"][0], p0),
                                                 keep_norms, keep),
        "change_gap": stats.worst_leaf_gap(_tree_norms(first["params"][-1], p0),
                                           _tree_norms(r0[-1], p0), keep),
    }
