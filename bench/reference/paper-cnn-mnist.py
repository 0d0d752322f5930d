"""Plain reference of ``paper-cnn-mnist``: the CNN of McMahan et al.
(arXiv:1602.05629) as arXiv:2408.00217 Sec. IV uses it, and the paper's
federated round over it, in plain PyTorch (float32, TF32 off) from the
published description. It imports nothing of the program: the images, the
client partition and every random draw are the benchmark's own, handed to
both sides.

- The CNN: two 5x5 SAME convolutions (32, 64 channels), each ReLU then a
  2x2 max-pool, a 512-unit ReLU layer and 10 logits; NHWC images, HWIO
  kernels, (in, out) dense weights, flattened in (H, W, C) order; He-normal
  weights (normal draws times sqrt(2 / fan_in)), zero biases.
- The policy (Sec. III, Theorem 2): client i sends when its uniform draw
  is below p[min(age_i, m)], with p* of Theorem 2; ages grow by one and
  reset on a send (Eq. 4).
- A sync round (FedAvg): the first ``width`` senders in index order train
  E epochs of SGD (batch B, a permutation a client and epoch, truncated to
  whole batches) from the global model at lr0 * decay^round; the new model
  is the mean of their models; the round's loss the mean of their mean step
  losses.
- The load metric's accumulators: for each send after a client's first,
  the gap X = round - last round sent, summed and squared; cohort sizes as
  deviations from k, their minimum and maximum.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from bench import gen

LEAVES = ("conv1", "conv2", "fc1", "fc2")


def optimal_probs(n: int, k: int, m: int) -> np.ndarray:
    """Theorem 2: with r = n/k and i = floor(r), p_m = 1/(r - m) when
    m <= i - 1, else p_{i-1} = i + 1 - r and p_j = 1 for j >= i."""
    r = n / k
    i = math.floor(r)
    p = np.zeros(m + 1)
    if m <= i - 1:
        p[m] = 1.0 / (r - m)
    else:
        if i >= 1:
            p[i - 1] = (i + 1) - r
        p[i:] = 1.0
    return p


def cohort_width(n: int, k: int) -> int:
    """The padded cohort: k plus four standard deviations of Binomial(n, k/n)."""
    q = k / n
    return min(n, int(k + 4 * math.sqrt(n * q * (1 - q))) + 1)


def init_params(normals: Dict[str, torch.Tensor]) -> Dict:
    """He-normal weights from the drawn standard normals, zero biases."""
    out = {}
    for name in LEAVES:
        w = normals[name]
        fan_in = math.prod(w.shape[:-1])
        out[name] = {"w": w.float() * math.sqrt(2.0 / fan_in),
                     "b": torch.zeros(w.shape[-1], device=w.device)}
    return out


def forward(p: Dict, x: torch.Tensor) -> torch.Tensor:
    h = x.permute(0, 3, 1, 2)
    for name in ("conv1", "conv2"):
        w = p[name]["w"].permute(3, 2, 0, 1)
        h = F.max_pool2d(F.relu(F.conv2d(h, w, p[name]["b"], padding=w.shape[-1] // 2)), 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = F.relu(h @ p["fc1"]["w"] + p["fc1"]["b"])
    return h @ p["fc2"]["w"] + p["fc2"]["b"]


def loss_fn(p, x, y) -> torch.Tensor:
    return F.cross_entropy(forward(p, x).float(), y)


@contextlib.contextmanager
def no_tf32():
    """float32 products computed in float32 (TF32 off), restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def cast(tree: Dict, dtype) -> Dict:
    return {k: {n: v.to(dtype) for n, v in d.items()} for k, d in tree.items()}


def inputs(spec, seed: int, device, dtype):
    """``client_data`` with the images in the computing ``dtype``."""
    cx, cy, (tx, ty) = client_data(spec, seed, device)
    return cx.to(dtype), cy, (tx.to(dtype), ty)


def local_sgd(p, x, y, perm, lr, epochs, nb, bs):
    """E epochs of SGD on one client; (params, mean step loss)."""
    losses = []
    for e in range(epochs):
        for b in range(nb):
            ii = perm[e, b * bs:(b + 1) * bs]
            leaves = {k: {n: v.detach().requires_grad_() for n, v in d.items()}
                      for k, d in p.items()}
            flat = [v for d in leaves.values() for v in d.values()]
            with torch.enable_grad():
                loss = loss_fn(leaves, x[ii], y[ii])
                grads = iter(torch.autograd.grad(loss, flat))
            p = {k: {n: (v - lr * next(grads)).detach() for n, v in d.items()}
                 for k, d in leaves.items()}
            losses.append(loss.detach())
    return p, float(torch.stack(losses).mean())


class _Log:
    """The benchmark's recorded draws of one step, taken by site in order."""

    def __init__(self, entries):
        self.entries = list(entries)

    def take(self, site: str) -> torch.Tensor:
        for i, (s, t) in enumerate(self.entries):
            if s == site:
                del self.entries[i]
                return t
        raise KeyError(f"no recorded draw at site {site!r}")


def client_data(spec, seed: int, device):
    """(client images (n, shard, H, W, C), client labels (n, shard)): the
    benchmark's images cut into IID shards by a permutation drawn from the
    seed's ``partition`` stream (numpy)."""
    c, t = spec.config, spec.traffic
    n_train = c["train_examples"]
    x, y = gen.images(seed, n_train + c["test_examples"], c["image_size"], c["channels"],
                      c["num_classes"], device)
    test = (x[n_train:], y[n_train:])
    x, y = x[:n_train], y[:n_train]
    n = t["clients"]
    order = np.random.default_rng(gen.sub_seed(seed, "partition")).permutation(n_train)
    shard = n_train // n
    parts = torch.as_tensor(order[:shard * n].reshape(n, shard), device=x.device)
    return x[parts], y[parts], test


def eval_logits(params, test, batch: int = 500) -> torch.Tensor:
    """The logits of the test images in whole batches of ``batch`` (the
    last partial batch left out), as float32."""
    x, _ = test
    used = max(x.shape[0] // batch, 1) * min(batch, x.shape[0])
    with torch.no_grad():
        return torch.cat([forward(params, x[i:i + batch]).float() for i in range(0, used, batch)])


def evaluate(logits: torch.Tensor, test) -> float:
    """Mean cross entropy of the test images' ``logits``."""
    return float(F.cross_entropy(logits.double(), test[1][:logits.shape[0]]))


def new_accumulators(n: int, device) -> Dict[str, torch.Tensor]:
    return {"last_sel": torch.full((n,), -1, dtype=torch.int64, device=device),
            "steps": 0, "size_min": None, "size_max": None, "gap_sum": 0.0,
            "gap_sumsq": 0.0, "gap_cnt": 0.0, "size_sum": 0.0, "size_sumsq": 0.0}


def accumulate(acc: Dict, send: torch.Tensor, k: int) -> Dict:
    r = acc["steps"]
    has = send & (acc["last_sel"] >= 0)
    gap = (r - acc["last_sel"][has]).double()
    size = int(send.sum())
    return {"last_sel": torch.where(send, torch.full_like(acc["last_sel"], r), acc["last_sel"]),
            "steps": r + 1,
            "size_min": size if acc["size_min"] is None else min(acc["size_min"], size),
            "size_max": size if acc["size_max"] is None else max(acc["size_max"], size),
            "gap_sum": acc["gap_sum"] + float(gap.sum()),
            "gap_sumsq": acc["gap_sumsq"] + float((gap * gap).sum()),
            "gap_cnt": acc["gap_cnt"] + float(has.sum()),
            "size_sum": acc["size_sum"] + (size - k),
            "size_sumsq": acc["size_sumsq"] + (size - k) ** 2}


def follow(spec, seed: int, device, logs: List, compute_dtype=torch.float32,
           half: bool = False) -> Dict:
    """The reference's first ``len(logs) - 1`` steps from the benchmark's
    draws (``logs[0]`` the draws of the start, ``logs[r + 1]`` of step r):
    the model after each, each step's loss and senders, the accumulators,
    and the evaluation at the start. ``compute_dtype`` (the control:
    bfloat16) holds the weights and images and computes in that type.
    ``half`` (a fault, for the limits' readings): each step's mean is taken
    over the first half of the clients trained, the rest left out."""
    if spec.traffic["mode"] == "async":
        return follow_async(spec, seed, device, logs, compute_dtype, half)
    t = spec.traffic
    n, k, m = t["clients"], t["k"], t["m"]
    with no_tf32():
        cx, cy, test = inputs(spec, seed, device, compute_dtype)
        init = _Log(logs[0])
        params = cast(init_params({name: init.take(f"params/{name}") for name in LEAVES}),
                      compute_dtype)
        ages = init.take("policy_init").long()
        p = torch.as_tensor(optimal_probs(n, k, m), dtype=torch.float32, device=ages.device)
        width = cohort_width(n, k)
        examples = cx.shape[1]
        bs = min(t["batch_size"], examples)
        nb = max(examples // t["batch_size"], 1)
        acc = new_accumulators(n, ages.device)
        out = {"params": [], "loss": [], "send": [],
               "p0": {key: dict(d) for key, d in params.items()},
               "logits0": eval_logits(params, test)}
        out["eval0"] = evaluate(out["logits0"], test)
        for r, entries in enumerate(logs[1:]):
            log = _Log(entries)
            send = log.take("select") < p[ages.clamp(max=m)]
            ages = (ages + 1) * (~send)
            perms = log.take("local_perm")
            lr = float(np.float32(t["lr"]) * np.float32(t["lr_decay"]) ** np.float32(r))
            cohort = torch.nonzero(send)[:width, 0].tolist()
            if half:
                cohort = cohort[:(len(cohort) + 1) // 2]
            models, losses = [], []
            for j, c in enumerate(cohort):
                q, loss = local_sgd(params, cx[c], cy[c], perms[j], lr, t["local_epochs"],
                                    nb, bs)
                models.append(q)
                losses.append(loss)
            if models:
                params = {key: {nm: sum(q[key][nm] for q in models) / len(models)
                                for nm in params[key]} for key in params}
            out["params"].append({key: dict(d) for key, d in params.items()})
            out["loss"].append(sum(losses) / len(losses) if losses else math.nan)
            out["send"].append(send)
            acc = accumulate(acc, send, k)
    out["acc"] = acc
    return out


def follow_async(spec, seed: int, device, logs: List, compute_dtype=torch.float32,
                 half: bool = False) -> Dict:
    """The buffered asynchronous loop (FedBuff over the event-driven fleet),
    its first steps from the benchmark's draws. A step: idle clients whose
    availability has begun consult the policy and the senders are
    dispatched with a latency speed_i * exp(mu + sigma z) + shift + Exp/rate
    (speed_i = exp(hetero z_i), drawn once); the ``buffer`` earliest
    completions (ties to the lower index) are popped and the clock moves to
    the latest of them; each popped client trains E epochs from the model
    of the version it was dispatched with (the oldest of the last H kept,
    if older) at lr0 * decay^version; the model moves by the mean of their
    deltas weighted (1 + staleness)^-a, and the version by one; popped
    clients are idle again at once (no off-time, no dropout: the profile's
    spreads of those are 0). Reports as ``follow``, with the step's clock
    and the fleet counters."""
    t = spec.traffic
    lat = t["latency"]
    if lat["avail_gap"] or lat["dropout"]:
        raise NotImplementedError("off-time and dropout are not in this reference")
    n, k, m, B, H = t["clients"], t["k"], t["m"], t["buffer"], t["max_versions"]
    with no_tf32():
        cx, cy, test = inputs(spec, seed, device, compute_dtype)
        init = _Log(logs[0])
        params = cast(init_params({name: init.take(f"params/{name}") for name in LEAVES}),
                      compute_dtype)
        ages = init.take("policy_init").long()
        dev = ages.device
        speed = torch.exp(lat["hetero"] * init.take("speed"))
        p = torch.as_tensor(optimal_probs(n, k, m), dtype=torch.float32, device=dev)
        examples = cx.shape[1]
        bs = min(t["batch_size"], examples)
        nb = max(examples // t["batch_size"], 1)
        inf = torch.tensor(float("inf"), device=dev)
        t_done = torch.full((n,), float("inf"), device=dev)
        disp_ver = torch.full((n,), -1, dtype=torch.int64, device=dev)
        next_avail = torch.zeros(n, device=dev)
        last_done = torch.full((n,), -1.0, device=dev)
        clock = torch.zeros((), device=dev)
        version = 0
        hist = {0: params}  # the kept models by version
        acc = new_accumulators(n, dev)
        fleet = {"ep_sx": 0.0, "ep_sx2": 0.0, "ep_cnt": 0.0, "stale_sum": 0.0,
                 "stale_cnt": 0.0, "stale_max": 0.0, "updates": 0.0, "aggs": 0.0,
                 "wall_sx": 0.0, "wall_sx2": 0.0, "wall_cnt": 0.0}
        out = {"params": [], "loss": [], "send": [], "clock": [],
               "p0": {key: dict(d) for key, d in params.items()},
               "logits0": eval_logits(params, test)}
        out["eval0"] = evaluate(out["logits0"], test)
        for entries in logs[1:]:
            log = _Log(entries)
            idle, avail = torch.isinf(t_done), next_avail <= clock
            send = (log.take("select") < p[ages.clamp(max=m)]) & idle & avail
            x = (ages[send] + 1).double()
            fleet["ep_sx"] += float(x.sum())
            fleet["ep_sx2"] += float((x * x).sum())
            fleet["ep_cnt"] += float(send.sum())
            ages = (ages + 1) * (~send)
            latency = speed * torch.exp(lat["compute_mu"] + lat["compute_sigma"]
                                        * log.take("latency_compute")) \
                + (torch.full((n,), lat["comm_shift"], device=dev)
                   + log.take("latency_comm") / lat["comm_rate"])
            t_done = torch.where(send, clock + latency, t_done)
            disp_ver = torch.where(send, torch.full_like(disp_ver, version), disp_ver)
            order = torch.argsort(t_done, stable=True)[:B]
            t_ev = t_done[order]
            valid = torch.isfinite(t_ev)
            popped = order[valid]
            t_done = t_done.index_fill(0, popped, float("inf"))
            clock = torch.maximum(clock, t_ev[valid].max()) if bool(valid.any()) else \
                torch.maximum(clock, next_avail.min())
            perms = log.take("local_perm")
            oldest = max(version - (H - 1), 0)
            dsum = {key: {nm: torch.zeros_like(v) for nm, v in d.items()}
                    for key, d in params.items()}
            wsum, lsum = 0.0, 0.0
            slots = torch.nonzero(valid)[:, 0].tolist()
            for j in slots[:(len(slots) + 1) // 2] if half else slots:
                c = int(order[j])
                dv = int(disp_ver[c])
                base = hist[min(max(dv, oldest), version)]
                lr = float(np.float32(t["lr"]) * np.float32(t["lr_decay"]) ** np.float32(max(dv, 0)))
                q, loss = local_sgd(base, cx[c], cy[c], perms[j], lr, t["local_epochs"], nb, bs)
                s = max(version - dv, 0)
                w = (1.0 + s) ** (-t["staleness_exp"])
                for key in dsum:
                    for nm in dsum[key]:
                        dsum[key][nm] += w * (q[key][nm] - base[key][nm])
                wsum += w
                lsum += w * loss
                fleet["stale_sum"] += s
                fleet["stale_cnt"] += 1
                fleet["stale_max"] = max(fleet["stale_max"], s)
            if wsum > 0:
                params = {key: {nm: params[key][nm] + dsum[key][nm] / wsum for nm in d}
                          for key, d in params.items()}
                version += 1
                hist[version] = params
                hist.pop(version - H, None)
            fleet["updates"] += float(valid.sum())
            fleet["aggs"] += float(wsum > 0)
            next_avail[popped] = clock
            prev = last_done[popped]
            ok = prev >= 0
            gap = (t_ev[valid] - prev)[ok]
            fleet["wall_sx"] += float(gap.double().sum())
            fleet["wall_sx2"] += float((gap.double() ** 2).sum())
            fleet["wall_cnt"] += float(ok.sum())
            last_done[popped] = t_ev[valid]
            out["params"].append({key: dict(d) for key, d in params.items()})
            out["loss"].append(lsum / wsum if wsum > 0 else math.nan)
            out["send"].append(send)
            out["clock"].append(float(clock))
            acc = accumulate(acc, send, k)
    out["acc"] = acc
    out["fleet"] = fleet
    return out
