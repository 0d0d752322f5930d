"""Traffic of kind ``lm``: the port's language model through its own
entry points (``repro_torch.models.factory.build``), at the published
widths, with the benchmark's weights and tokens.

- ``task: train``: ``model.sgd_train_step`` on batches of ``batch`` rows
  of ``seq`` tokens, every row different; at most two steps in flight.
- ``task: prefill``: ``model.prefill`` of ``batch`` fresh prompts of
  ``seq`` tokens a call, a closed loop; each call is timed from the call
  to its logits and caches being ready (a device sync).

The first ``verify_steps`` training steps (set-up, through the window's
own call) are held to the reference; a prefill's answers in the window
are sampled from the seed after it closes."""
from __future__ import annotations

import statistics
import time
from typing import Dict

import torch

from bench import gen, harness, stats

SSM_KEYS = ("w_in", "conv_w", "conv_b", "A_log", "dt_bias", "D", "norm_scale", "w_out")


def arch(cfg):
    """The port's ``ArchConfig`` of the configuration file."""
    from repro_torch.configs.base import ArchConfig, LayerSpec, MLPSpec, SSMSpec

    layer = LayerSpec(kind="mamba", ssm=SSMSpec(
        d_inner=cfg["expand"] * cfg["d_model"], d_state=cfg["d_state"],
        head_dim=cfg["headdim"], conv_width=cfg["d_conv"], chunk=cfg["chunk_size"]),
        mlp=MLPSpec(kind="none"))
    return ArchConfig(name=cfg["name"], family="ssm", citation="arXiv:2405.21060",
                      d_model=cfg["d_model"], vocab_size=cfg["vocab_size"], pattern=(layer,),
                      repeats=cfg["n_layer"], norm_eps=cfg["norm_eps"],
                      tie_embeddings=cfg["tie_embeddings"])


def to_program(w: Dict[str, torch.Tensor]) -> Dict:
    """The benchmark's weights in the port's tree."""
    return {"embed": w["embed"], "final_norm": {"scale": w["final_norm"]},
            "blocks": ({"ln1": {"scale": w["ln1"]}, "ssm": {k: w[k] for k in SSM_KEYS}},)}


def from_program(p: Dict) -> Dict[str, torch.Tensor]:
    blk = p["blocks"][0]
    return {"embed": p["embed"], "final_norm": p["final_norm"]["scale"],
            "ln1": blk["ln1"]["scale"], **blk["ssm"]}


class Cell:
    def __init__(self, spec, seed: int, device):
        self.spec, self.seed, self.device = spec, seed, torch.device(device)
        t = spec.traffic
        self.task, self.B, self.S = t["task"], t["batch"], t["seq"]
        self.ref = harness.reference(spec.entry["config"])
        self.on_card = self.device.type == "cuda"

    def _sync(self):
        if self.on_card:
            torch.cuda.synchronize()

    def setup(self):
        from repro_torch.models import factory

        c, t = self.spec.config, self.spec.traffic
        self.model_cfg = arch(c)
        self.model = factory.build(self.model_cfg, remat=t.get("remat", True))
        w = self.ref.weights(c, self.seed, self.device)
        self.params = to_program(w)
        self.pool = gen.token_batches(self.seed, t["pool"], self.B, self.S, c["vocab_size"],
                                      self.device)
        self.i = 0
        if self.task == "train":
            self.lr = torch.full((), t["lr"], device=self.device)
            self._first_steps(w)
        else:
            self._prefill_setup()

    # --- training ----------------------------------------------------------
    def _batch(self, i):
        tok = self.pool[i % self.pool.shape[0]]
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}

    def _first_steps(self, w):
        n = int(self.spec.traffic["verify_steps"])
        p0 = {k: v.clone() for k, v in w.items()}
        self.first = {"loss": []}
        for i in range(n):
            self.params, metrics = self.model.sgd_train_step(self.params, self._batch(i), self.lr)
            self.first["loss"].append(float(metrics["loss"]))
            if i == 0:
                self.first["update_norms"] = self.ref.leaf_norms(from_program(self.params), p0)
        self.first["change_norms"] = self.ref.leaf_norms(from_program(self.params), p0)
        del p0
        self.i = n

    def _train_window(self, seconds):
        losses, prev = [], None
        self._sync()
        t0 = time.perf_counter()
        while True:
            self.params, metrics = self.model.sgd_train_step(self.params, self._batch(self.i),
                                                             self.lr)
            self.i += 1
            losses.append(metrics["loss"])
            ev = torch.cuda.Event() if self.on_card else None
            if ev is not None:
                ev.record()
            if prev is not None:
                prev.synchronize()
            prev = ev
            if time.perf_counter() - t0 >= seconds:
                break
        self._sync()
        elapsed = time.perf_counter() - t0
        steps = len(losses)
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        tokens = steps * self.B * self.S
        return {"train_tokens_per_s": tokens / elapsed, "attempted": steps, "failed": failed,
                "window_s": elapsed, "steps": steps, "tokens": tokens}

    # --- prefill -----------------------------------------------------------
    def _prefill_setup(self):
        t = self.spec.traffic
        g = gen.generator(self.seed, "sample", "cpu")
        # calls whose final states are kept (drawn before the window, among
        # the first ones, which every run finishes)
        self.keep_states = set(torch.randperm(t["state_calls_from"], generator=g)
                               [:t["state_calls"]].tolist())
        self.answers, self.states = [], {}
        for _ in range(int(t["warmup_calls"])):
            self.model.prefill(self.params, {"tokens": self.pool[0][:, :-1]})
        self._sync()

    def _prefill(self, i):
        tok = self.pool[i % self.pool.shape[0]][:, :-1]
        logits, caches = self.model.prefill(self.params, {"tokens": tok})
        return logits, caches

    def _prefill_window(self, seconds):
        lat = []
        self._sync()
        t0 = time.perf_counter()
        while True:
            t1 = time.perf_counter()
            logits, caches = self._prefill(self.i)
            self._sync()
            lat.append(time.perf_counter() - t1)
            self.answers.append(logits[:, -1])
            if self.i in self.keep_states:
                self.states[self.i] = caches["blocks"][0]["h"]
            del caches
            self.i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
        return {"prefill_ms_p95": stats.p95(lat) * 1e3, "attempted": len(lat), "failed": 0,
                "window_s": elapsed, "steps": len(lat), "tokens": len(lat) * self.B * self.S,
                "latencies_s": lat}

    # --- the harness's interface -------------------------------------------
    def window(self, seconds):
        return self._train_window(seconds) if self.task == "train" else self._prefill_window(seconds)

    def traced_steps(self) -> int:
        n = int(self.spec.traffic["trace_steps"])
        if self.task == "train":
            for _ in range(n):
                self.params, _ = self.model.sgd_train_step(self.params, self._batch(self.i),
                                                           self.lr)
                self.i += 1
        else:
            for _ in range(n):
                self._prefill(self.i)
                self.i += 1
        return n

    def counters(self):
        from repro_torch.kernels import ssd_scan

        return {"k6_calls": ssd_scan.launches, "k6_bwd_calls": ssd_scan.bwd_launches}

    def release(self):
        self.params = self.model = None
        if self.on_card:
            torch.cuda.empty_cache()

    def verify(self) -> Dict[str, float]:
        c = self.spec.config
        w = self.ref.weights(c, self.seed, self.device)
        if self.task == "train":
            n = int(self.spec.traffic["verify_steps"])
            batches = [(b["tokens"], b["labels"]) for b in map(self._batch, range(n))]
            out = self.ref.follow_train(c, w, batches, self.spec.traffic["lr"])
            return compare_train(self.first, out)
        return self._verify_prefill(w)

    def _verify_prefill(self, w):
        t = self.spec.traffic
        g = gen.generator(self.seed, "sample", "cpu")
        torch.randperm(t["state_calls_from"], generator=g)  # the draw of the kept states
        done = len(self.answers)
        sample = sorted(set(torch.randperm(done, generator=g)[:t["verify_calls"]].tolist())
                        | set(self.states))
        worst_gap, worst_state = 0.0, 0.0
        for i in sample:
            tok = self.pool[i % self.pool.shape[0]][:, :-1]
            logits, states = self.ref.prefill(self.spec.config, w, tok)
            worst_gap = max(worst_gap, served_gap(self.answers[i], logits))
            if i in self.states:
                worst_state = max(worst_state, state_gap(self.states[i], states))
        return {"served_logit_gap": worst_gap, "state_gap": worst_state}


def served_gap(answer: torch.Tensor, ref_logits: torch.Tensor) -> float:
    """The widest gap by which the reference's logit of the token the
    program serves first (its argmax) lies below the reference's best."""
    tok = answer.float().argmax(-1)
    best = ref_logits.max(-1).values
    got = ref_logits.gather(-1, tok[:, None])[:, 0]
    return float((best - got).max())


def state_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst layer's ||h - h_ref|| / ||h_ref|| over the final states."""
    p, r = prog.double(), ref.double()
    diff = torch.linalg.vector_norm((p - r).flatten(1), dim=1)
    return float((diff / torch.linalg.vector_norm(r.flatten(1), dim=1)).max())


def compare_train(first: Dict, out: Dict) -> Dict[str, float]:
    """Each step's loss, and the median leaf's first update and change
    after the followed steps: with bfloat16 weights at this learning rate
    most of an update rounds away, so a single leaf's norm is the noise of
    a few elements crossing a rounding boundary (PERF.md)."""
    grads = out["grad_norms"]
    med = statistics.median(grads)
    keep = [g >= 1e-3 * med for g in grads]

    def median_gap(prog, ref):
        pick = [i for i, k in enumerate(keep) if k]
        return stats.rel_gap(statistics.median(prog[i] for i in pick),
                             statistics.median(ref[i] for i in pick))

    return {
        "loss_gap": max(stats.rel_gap(a, b) for a, b in zip(first["loss"], out["loss"])),
        "update_median_gap": median_gap(first["update_norms"], out["update_norms"]),
        "change_median_gap": median_gap(first["change_norms"], out["change_norms"]),
    }
