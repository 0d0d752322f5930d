"""Plain reference of ``mamba2-370m`` (arXiv:2405.21060): the Mamba-2 block
and its language model in plain PyTorch, float32 with TF32 off, from the
published description. It imports nothing of the program.

- The model: token embeddings; per layer x + Mamba2(RMSNorm(x)); a final
  RMSNorm; logits against the tied embedding.
- The Mamba-2 block: in_proj to [z (d_inner), x (d_inner), B (d_state),
  C (d_state), dt (heads)]; a causal depthwise convolution of width 4 over
  [x, B, C] with bias, then SiLU; dt = softplus(dt + dt_bias), A =
  -exp(A_log); the SSD recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t
  B_t^T, y_t = C_t h_t + D x_t (one group: B and C shared by the heads),
  computed in its chunked dual form; the gated RMSNorm of y * silu(z) with
  a scale, eps 1e-5; out_proj.
- Training: mean next-token cross entropy; one SGD step p - lr * g, the
  new value rounded to the parameter's dtype (bfloat16 weights; A_log,
  dt_bias and D in float32), as the configuration states.

Layers are checkpointed (recomputed in the backward) and the loss is taken
a row at a time, so the float32 model fits beside nothing else. ``q`` is
applied to both operands of every projection: the identity here, and an
fp8 (e4m3) round trip in the control.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench import gen

def dims(cfg) -> Dict[str, int]:
    di = cfg["expand"] * cfg["d_model"]
    return {"d": cfg["d_model"], "di": di, "ds": cfg["d_state"], "hd": cfg["headdim"],
            "nh": di // cfg["headdim"], "W": cfg["d_conv"], "L": cfg["chunk_size"],
            "V": cfg["vocab_size"], "layers": cfg["n_layer"]}


def weights(cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    """The benchmark's weights for ``cfg``, the same for the program and the
    reference: stacked over layers, bfloat16 (A_log, dt_bias, D float32).
    Normal draws in one call: embedding N(0, 0.02^2), in_proj and out_proj
    N(0, 1/fan_in), conv N(0, 0.01); biases 0, norm scales 1, A_log =
    log(1..16 over the heads), dt_bias = softplus^-1(0.01), D = 1."""
    m = dims(cfg)
    n, d, di, ds, nh = m["layers"], m["d"], m["di"], m["ds"], m["nh"]
    ch = di + 2 * ds
    bf = torch.bfloat16
    w = gen.normal_tree(seed, [("embed", (m["V"], d), 0.02),
                               ("w_in", (n, d, 2 * di + 2 * ds + nh), d ** -0.5),
                               ("conv_w", (n, m["W"], ch), 0.1),
                               ("w_out", (n, di, d), di ** -0.5)], bf, device)
    f32 = dict(dtype=torch.float32, device=torch.device(device))
    w.update({
        "final_norm": torch.ones((d,), dtype=bf, device=torch.device(device)),
        "ln1": torch.ones((n, d), dtype=bf, device=torch.device(device)),
        "conv_b": torch.zeros((n, ch), dtype=bf, device=torch.device(device)),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)).expand(n, nh).contiguous(),
        "dt_bias": torch.full((n, nh), math.log(math.expm1(0.01)), **f32),
        "D": torch.ones((n, nh), **f32),
        "norm_scale": torch.ones((n, di), dtype=bf, device=torch.device(device)),
    })
    return w


LAYER_KEYS = ("ln1", "w_in", "conv_w", "conv_b", "A_log", "dt_bias", "D", "norm_scale", "w_out")


def rms_norm(x, scale, eps=1e-5):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def fp8(t: torch.Tensor) -> torch.Tensor:
    """An e4m3 round trip at a per-tensor scale; the gradient passes as is."""
    s = t.detach().abs().amax().clamp_min(1e-12) / 448.0
    q = (t.detach() / s).to(torch.float8_e4m3fn).float() * s
    return t + (q - t).detach()


def ssd(x, dt, A, B, C, L: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD recurrence in its chunked dual form (chunks of ``L``):
    x (b, s, h, p), dt (b, s, h), A (h,), B and C (b, s, n) ->
    (y (b, s, h, p), final state (b, h, p, n))."""
    b, s, h, p = x.shape
    n, c = B.shape[-1], s // L
    X = (x * dt[..., None]).view(b, c, L, h, p)
    acs = torch.cumsum((dt * A).view(b, c, L, h).permute(0, 3, 1, 2), -1)  # b h c l
    Bc, Cc = B.view(b, c, L, n), C.view(b, c, L, n)
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp((acs[..., :, None] - acs[..., None, :]).masked_fill(~causal, -math.inf))
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    y = torch.einsum("bcls,bhcls,bcshp->bclhp", scores, decay, X)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, torch.exp(acs[..., -1:] - acs), X)
    state = torch.zeros(b, h, p, n, dtype=x.dtype, device=x.device)
    entering = []
    for i in range(c):
        entering.append(state)
        state = state * torch.exp(acs[:, :, i, -1])[..., None, None] + states[:, i]
    y = y + torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, torch.stack(entering, 1), torch.exp(acs))
    return y.reshape(b, s, h, p), state


def block(lw: Dict[str, torch.Tensor], x: torch.Tensor, m, q: Callable):
    """One layer: (x + Mamba2(RMSNorm(x)), its final SSM state)."""
    di, ds, nh, hd, W = m["di"], m["ds"], m["nh"], m["hd"], m["W"]
    f = {k: v.float() for k, v in lw.items()}
    h = rms_norm(x, f["ln1"])
    proj = q(h) @ q(f["w_in"])
    z, xbc, dtr = proj[..., :di], proj[..., di:2 * di + 2 * ds], proj[..., 2 * di + 2 * ds:]
    conv = F.conv1d(xbc.transpose(1, 2), f["conv_w"].t()[:, None, :], f["conv_b"],
                    padding=W - 1, groups=xbc.shape[-1])[..., :xbc.shape[1]]
    xbc = F.silu(conv.transpose(1, 2))
    xs = xbc[..., :di].reshape(*xbc.shape[:2], nh, hd)
    Bm, Cm = xbc[..., di:di + ds], xbc[..., di + ds:]
    dt = F.softplus(dtr + f["dt_bias"])
    y, state = ssd(xs, dt, -torch.exp(f["A_log"]), Bm, Cm, m["L"])
    y = (y + f["D"][:, None] * xs).reshape(*x.shape[:2], di)
    g = rms_norm(y * F.silu(z), f["norm_scale"])
    return x + q(g) @ q(f["w_out"]), state


def _layer(w, i):
    return {k: w[k][i] for k in LAYER_KEYS}


def hidden(w, tokens, m, q, remat: bool):
    """Final normed hidden states and each layer's final SSM state."""
    x = w["embed"][tokens].float()
    states = []
    for i in range(m["layers"]):
        lw = _layer(w, i)
        if remat:
            x, st = checkpoint(block, lw, x, m, q, use_reentrant=False)
        else:
            x, st = block(lw, x, m, q)
        states.append(st)
    return rms_norm(x, w["final_norm"].float()), states


def prefill(cfg, w, tokens, q=lambda t: t):
    """(last-position logits (b, V), final SSM states (layers, b, h, p, n))."""
    m = dims(cfg)
    with torch.no_grad():
        x, states = hidden(w, tokens, m, q, remat=False)
        logits = q(x[:, -1]) @ q(w["embed"].float()).t()
    return logits, torch.stack(states)


def loss_and_grads(cfg, w, tokens, labels, q=lambda t: t):
    """Mean next-token cross entropy and its gradient by leaf name."""
    m = dims(cfg)
    leaves = {k: v.detach().float().requires_grad_() for k, v in w.items()}
    with torch.enable_grad():
        x, _ = hidden(leaves, tokens, m, q, remat=True)
        head = q(leaves["embed"]).t()
        # a row at a time: (S, V) logits
        total = sum(F.cross_entropy(q(x[r]) @ head, labels[r], reduction="sum")
                    for r in range(x.shape[0])) / labels.numel()
        grads = torch.autograd.grad(total, list(leaves.values()), allow_unused=True)
    return float(total.detach()), {k: (g if g is not None else torch.zeros_like(leaves[k]))
                          for k, g in zip(leaves, grads)}


def sgd(w, grads, lr: float):
    """p - lr * g, rounded to each parameter's dtype (lr first rounded to it)."""
    out = {}
    for k, v in w.items():
        lr_k = float(torch.tensor(lr, dtype=v.dtype))
        out[k] = (v.float() - lr_k * grads[k]).to(v.dtype)
    return out


def leaf_norms(tree: Dict[str, torch.Tensor], base=None) -> List[float]:
    """Norms of each layer's slice of each leaf (of ``tree - base``), in a
    fixed order: the unstacked leaves, then each layer's."""
    out = []
    for k in sorted(tree):
        t = tree[k].double() - (base[k].double() if base is not None else 0)
        rows = [t] if k not in LAYER_KEYS else list(t)
        out.extend(float(torch.linalg.vector_norm(r)) for r in rows)
    return out


def follow_train(cfg, w, batches, lr: float, q=lambda t: t) -> Dict:
    """The reference's SGD steps over ``batches`` from ``w``: each step's
    loss, the first gradient's and update's norms by leaf, and the norms
    of the change after the last step."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        p, losses, out = dict(w), [], {}
        for i, (tokens, labels) in enumerate(batches):
            loss, grads = loss_and_grads(cfg, p, tokens, labels, q)
            losses.append(loss)
            if i == 0:
                out["grad_norms"] = leaf_norms(grads)
            p = sgd(p, grads, lr)
            del grads
            if i == 0:
                out["update_norms"] = leaf_norms(p, w)
        out["change_norms"] = leaf_norms(p, w)
        out["loss"] = losses
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
