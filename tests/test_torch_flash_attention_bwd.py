"""K4's backward schedule (``kernels/flash_attention.py::bwd_plan``): the
bf16 kernels' work items and steps, held on the CPU to what the mask
allows through ``kv_state`` and ``dq_state`` (copies of the CUDA source's
device functions of those names), and ``emulate_bwd``, the kernels' walk
replayed on CPU tensors, held to the plain backward and to ``jax.grad`` of
the reference's jnp attention.

The schedule tests are exact (pairs counted). The emulation is held to
``flash_attention_bwd_plain`` at 1e-5 of each gradient's max in f32 (the
same formulas summed in another order, exp2 of log2-scaled scores against
exp) and 2e-2 in bf16 (P and dS rounded to bf16 in both, from slightly
different f32 values), and to ``jax.grad`` at 1e-4 in f32 (the f32
tolerance of the backward's GPU tests). On a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_attention_bwd.py
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as k4  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

MASKS = [("full", 0), ("sliding", 100), ("sliding", 128), ("chunked", 100), ("chunked", 128)]
SMEM_LIMIT = 232448  # dynamic shared memory a block can use on an H100
SMS = 132  # an H100 SXM's SMs
SKIP, MASKED, CLEAN = 0, 1, 2  # a warpgroup's share of one step


def kv_state(q0, bm, kmin, S, kind, w):
    """The dK/dV kernel's ``kv_state``: keys [kmin, kmin + 63] of one
    warpgroup against queries [q0, q0 + bm - 1]: SKIP (no allowed pair),
    MASKED (the element mask runs) or CLEAN (every pair allowed; a query
    row past S has P = 0 from its +inf lse)."""
    if kmin > S - 1:
        return SKIP
    kmax, qb = kmin + 63, min(q0 + bm - 1, S - 1)
    if max(q0, kmin) > min(qb, k4._last_query(min(kmax, S - 1), S, kind, w)):
        return SKIP
    clean = (kmax <= q0 and (kind != 1 or kmin > qb - w)
             and (kind != 2 or kmin // w == qb // w))
    return CLEAN if clean else MASKED


def dq_state(kt, bn, qa, S, kind, w):
    """The dQ kernel's ``dq_state``: queries [qa, qa + 63] of one warpgroup
    against keys [kt, kt + bn - 1]."""
    if qa > S - 1:
        return SKIP
    qb, lo = min(qa + 63, S - 1), max(qa, kt)
    if lo > qb or k4._first_key(lo, kind, w) > kt + bn - 1:
        return SKIP
    clean = kt + bn - 1 <= qa and k4._first_key(qb, kind, w) <= kt
    return CLEAN if clean else MASKED


def kv_steps(plan, kt):
    """(q0, (state of keys 0-63, state of keys 64-127)) for each step of
    key tile ``kt``'s walk, in the kernel's order."""
    k0 = kt * plan.kv_keys
    return [(q0, tuple(kv_state(q0, plan.kv_queries, k0 + 64 * cw, plan.S, plan.kind,
                                plan.window) for cw in (0, 1)))
            for q0 in k4.kv_walk(plan, kt)]


def dq_steps(plan, qt):
    """(kt, (state of queries 0-63, state of queries 64-127)) for each step
    of query tile ``qt``'s walk."""
    q0 = qt * plan.q_rows
    return [(kt, tuple(dq_state(kt, plan.q_keys, q0 + 64 * cw, plan.S, plan.kind,
                                plan.window) for cw in (0, 1)))
            for kt in k4.dq_walk(plan, qt)]


def emulate_bwd(q, k, v, out, lse, dout, *, scale, kind="full", window=0):
    """The bf16 route's schedule on CPU tensors: ``bwd_plan``'s work items
    and steps (a SKIP share computes nothing, a CLEAN one runs no element
    mask), f32 sums in the kernels' order (dK, dV over the query tiles of a
    key tile's walk, last first, and the heads at each; dQ over its key
    tiles), P and dS rounded to q's dtype as the products' operands,
    P = exp2(s * scale * log2 e - lse * log2 e). Returns (dq, dk, dv) in
    q's, k's and v's dtypes."""
    B, Hk, G, S, D = q.shape
    plan = k4.bwd_plan(B, Hk, G, S, D, kind, window, sms=SMS)
    dt, pad = q.dtype, plan.s_pad - S
    c = torch.tensor(scale * k4.LOG2E, dtype=torch.float32)
    qf, dof = (torch.nn.functional.pad(t.float(), (0, 0, 0, pad)) for t in (q, dout))
    kf, vf = (torch.nn.functional.pad(t.float(), (0, 0, 0, pad)) for t in (k, v))
    inf = torch.full((B, Hk, G, pad), math.inf)
    lse2 = torch.cat([lse.float() * torch.tensor(k4.LOG2E, dtype=torch.float32), inf], -1)
    dl = torch.nn.functional.pad((dout.float() * out.float()).sum(-1), (0, pad))
    mask = k4._mask(plan.s_pad, kind, window, "cpu")  # [query, key]

    dk = torch.zeros(B, Hk, plan.s_pad, D)
    dv = torch.zeros(B, Hk, plan.s_pad, D)
    bm = plan.kv_queries
    for kt in plan.kv_order:
        for b in range(B):
            for h in range(Hk):
                for cw in (0, 1):
                    ks = slice(kt * plan.kv_keys + 64 * cw, kt * plan.kv_keys + 64 * cw + 64)
                    K, V = kf[b, h, ks], vf[b, h, ks]
                    dK, dV = torch.zeros(64, D), torch.zeros(64, D)
                    for q0, states in kv_steps(plan, kt):
                        if states[cw] == SKIP:
                            continue
                        for g in range(G):
                            qs = slice(q0, q0 + bm)
                            Q, dO = qf[b, h, g, qs], dof[b, h, g, qs]
                            p = torch.exp2(K @ Q.T * c - lse2[b, h, g, qs])
                            if states[cw] == MASKED:
                                p = torch.where(mask[qs, ks].T, p, 0.0)
                            ds = p * (V @ dO.T - dl[b, h, g, qs])
                            dV += p.to(dt).float() @ dO
                            dK += ds.to(dt).float() @ Q
                    dk[b, h, ks], dv[b, h, ks] = dK * scale, dV

    dq = torch.zeros(B, Hk, G, plan.s_pad, D)
    bn = plan.q_keys
    for qt in plan.q_order:
        for b in range(B):
            for h in range(Hk):
                for g in range(G):
                    for cw in (0, 1):
                        qs = slice(qt * plan.q_rows + 64 * cw, qt * plan.q_rows + 64 * cw + 64)
                        Q, dO = qf[b, h, g, qs], dof[b, h, g, qs]
                        dQ = torch.zeros(64, D)
                        for kt, states in dq_steps(plan, qt):
                            if states[cw] == SKIP:
                                continue
                            ks = slice(kt, kt + bn)
                            K, V = kf[b, h, ks], vf[b, h, ks]
                            p = torch.exp2(Q @ K.T * c - lse2[b, h, g, qs, None])
                            if states[cw] == MASKED:
                                p = torch.where(mask[qs, ks], p, 0.0)
                            ds = p * (dO @ V.T - dl[b, h, g, qs, None])
                            dQ += ds.to(dt).float() @ K
                        dq[b, h, g, qs] = dQ * scale
    return dq[..., :S, :].to(q.dtype), dk[:, :, :S].to(k.dtype), dv[:, :, :S].to(v.dtype)


def _allowed(S, kind, window):
    """(S, S) boolean [query, key] of the mask, as numpy."""
    return k4._mask(S, kind, window, "cpu").numpy()


def _masks(plan):
    """(allowed, real): [query, key] booleans over the padded positions."""
    S, pad = plan.S, plan.s_pad
    allowed = np.zeros((pad, pad), bool)
    allowed[:S, :S] = _allowed(S, ("full", "sliding", "chunked")[plan.kind], plan.window)
    real = np.zeros((pad, pad), bool)
    real[:S, :S] = True
    return allowed, real


def _shares(plan):
    """Each warpgroup share of both walks, per query head: (walk, state,
    query slice, key slice)."""
    for kt in range(plan.s_pad // plan.kv_keys):
        for q0, states in kv_steps(plan, kt):
            for cw, st in enumerate(states):
                k0 = kt * plan.kv_keys + 64 * cw
                yield "kv", st, slice(q0, q0 + plan.kv_queries), slice(k0, k0 + 64)
    for qt in range(plan.s_pad // plan.q_rows):
        for kt, states in dq_steps(plan, qt):
            for cw, st in enumerate(states):
                qa = qt * plan.q_rows + 64 * cw
                yield "dq", st, slice(qa, qa + 64), slice(kt, kt + plan.q_keys)


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("S", [200, 384, 1000])
@pytest.mark.parametrize("kind,window", MASKS)
def test_plan_covers_every_allowed_pair_once(kind, window, S, D):
    """Both walks compute every pair the mask allows exactly once per query
    head (the dK/dV walk takes each of its query tiles once for every head)."""
    plan = k4.bwd_plan(1, 1, 1, S, D, kind, window, sms=SMS)
    allowed, _ = _masks(plan)
    counts = {"kv": np.zeros(allowed.shape, np.int32), "dq": np.zeros(allowed.shape, np.int32)}
    for walk, st, qs, ks in _shares(plan):
        if st != SKIP:
            counts[walk][qs, ks] += 1
    for cnt in counts.values():
        assert (cnt[allowed] == 1).all()


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("S", [200, 384, 1000])
@pytest.mark.parametrize("kind,window", MASKS)
def test_plan_visits_no_forbidden_pair_past_the_cut_tiles(kind, window, S, D):
    """A share the plan marks CLEAN (no element mask) holds only allowed
    pairs of real positions; a SKIP share holds no allowed pair, and every
    other share holds one, so no wholly forbidden tile is computed."""
    plan = k4.bwd_plan(1, 1, 1, S, D, kind, window, sms=SMS)
    allowed, real = _masks(plan)
    for walk, st, qs, ks in _shares(plan):
        if st == CLEAN:
            assert not (real[qs, ks] & ~allowed[qs, ks]).any(), (walk, qs, ks)
        assert allowed[qs, ks].any() == (st != SKIP), (walk, st, qs, ks)


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("G", [1, 5, 8, 16])
@pytest.mark.parametrize("kind,window", MASKS)
def test_plan_runs_the_longest_work_items_first(kind, window, G, D):
    """Work item t of each kernel is no shorter than item t + 1, every tile
    appears once in each order, and each persistent grid is one CTA per SM
    of the card, fewer when there are fewer items."""
    B, Hk, S = 2, 3, 1000
    plan = k4.bwd_plan(B, Hk, G, S, D, kind, window, sms=SMS)
    n_t = plan.s_pad // 128
    assert sorted(plan.kv_order) == list(range(n_t)) == sorted(plan.q_order)
    kv_len = [G * len(k4.kv_walk(plan, plan.kv_order[t // (B * Hk)]))
              for t in range(plan.kv_items)]
    q_len = [len(k4.dq_walk(plan, plan.q_order[t // (B * Hk * G)]))
             for t in range(plan.q_items)]
    assert kv_len == sorted(kv_len, reverse=True)
    assert q_len == sorted(q_len, reverse=True)
    assert (plan.kv_items, plan.q_items) == (B * Hk * n_t, B * Hk * G * n_t)
    assert plan.kv_grid == min(plan.kv_items, SMS)
    assert plan.q_grid == min(plan.q_items, SMS)
    small = k4.bwd_plan(B, Hk, G, S, D, kind, window, sms=8)
    assert (small.kv_grid, small.q_grid) == (8, 8)
    assert small._replace(kv_grid=plan.kv_grid, q_grid=plan.q_grid) == plan


@pytest.mark.parametrize("D", [32, 64, 128])
def test_plan_fits_the_card_and_sizes_the_workspace(D):
    """Shared memory within an H100 block's 227 KB; the workspace is two
    f32 (B Hk G, s_pad) arrays with s_pad = S rounded up to 128; three
    kernels a call."""
    plan = k4.bwd_plan(4, 4, 8, 2047, D, sms=SMS)
    assert plan.kv_smem <= SMEM_LIMIT and plan.q_smem <= SMEM_LIMIT
    assert plan.s_pad == 2048 and plan.workspace_bytes == 2 * 4 * 4 * 8 * 2048 * 4
    assert plan.launches == 3
    assert plan.kv_keys == plan.q_rows == 128


def test_training_shape_plan():
    """tinyllama-1.1b's training shape: 256 dK/dV items (16 key tiles of 16
    (batch, kv head) pairs), 2048 dQ items, 132 CTAs each, 2 MB of
    workspace; key tile 0 walks every query tile."""
    plan = k4.bwd_plan(4, 4, 8, 2048, 64, sms=SMS)
    assert (plan.kv_items, plan.q_items, plan.kv_grid, plan.q_grid) == (256, 2048, 132, 132)
    assert plan.workspace_bytes == 2 * 2**20
    assert plan.kv_order[0] == 0 and plan.q_order[0] == 15
    assert len(k4.kv_walk(plan, 0)) == 2048 // plan.kv_queries


def _inputs(B, Hk, G, S, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((B, Hk, G, S, D)).astype(np.float32))
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, Hk, S, D)).astype(np.float32))
            for _ in range(2))
    return [t.to(getattr(torch, dtype)) for t in (q, k, v, do)]


def _rel(got, exp):
    return float((got.float() - exp.float()).abs().max() / exp.float().abs().max())


EMU_CASES = [(1, 2, G, S, D, kind, w) for (kind, w), G, S, D in [
    (("full", 0), 5, 200, 32), (("full", 0), 1, 384, 64), (("full", 0), 8, 130, 128),
    (("sliding", 100), 5, 200, 64), (("sliding", 128), 1, 300, 32),
    (("chunked", 100), 16, 200, 64), (("chunked", 128), 8, 260, 128)]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hk,G,S,D,kind,window", EMU_CASES)
def test_emulation_matches_the_plain_backward(B, Hk, G, S, D, kind, window, dtype):
    """The kernels' walk on CPU tensors against ``flash_attention_bwd_plain``
    on the same out and lse (f32 1e-5, bf16 2e-2 of each gradient's max)."""
    q, k, v, do = _inputs(B, Hk, G, S, D, dtype, seed=S + G)
    kw = dict(scale=D**-0.5, kind=kind, window=window)
    out, lse = k4.flash_attention_plain(q.float(), k.float(), v.float(), **kw, return_lse=True)
    out = out.to(q.dtype)
    emu = emulate_bwd(q, k, v, out, lse, do, **kw)
    plain = k4.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for name, e, p in zip(("dq", "dk", "dv"), emu, plain):
        assert e.dtype == p.dtype and e.shape == p.shape, name
        assert _rel(e, p) <= tol, (name, _rel(e, p))


@pytest.mark.parametrize("B,Hk,G,S,D,kind,window", EMU_CASES[:1] + EMU_CASES[3:])
def test_emulation_matches_jax_grad_of_the_reference(B, Hk, G, S, D, kind, window):
    """f32: the kernels' walk against ``jax.grad`` of the reference's jnp
    attention (``repro.kernels.ref.flash_attention_ref``) contracted with
    the same output gradient, within 1e-4 of each gradient's max."""
    jax = pytest.importorskip("jax")
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as ref_ref

    q, k, v, do = _inputs(B, Hk, G, S, D, "float32", seed=S + 7)
    kw = dict(scale=D**-0.5, kind=kind, window=window)

    def loss(q_, k_, v_):
        return jnp.sum(ref_ref.flash_attention_ref(q_, k_, v_, **kw) * jnp.asarray(do.numpy()))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(t.numpy()) for t in (q, k, v)))
    out, lse = k4.flash_attention_plain(q, k, v, **kw, return_lse=True)
    got = emulate_bwd(q, k, v, out, lse, do, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel(g, torch.from_numpy(np.asarray(w))) <= 1e-4, name


def test_build_lists_the_headers_each_source_includes(tmp_path, monkeypatch):
    """Each library's name hashes the csrc headers its source includes, so
    an edit to one rebuilds its users; both K4 sources build on hopper.cuh,
    which alone defines the Hopper helpers they share."""
    csrc = Path(build.CSRC)
    for src in csrc.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "SOURCES", {n: tmp_path / p.name for n, p in build.SOURCES.items()})
    for name, src in build.SOURCES.items():
        for header in re.findall(r'#include "([^"]+)"', src.read_text()):
            before = build._target(name)
            with (tmp_path / header).open("a") as f:
                f.write("\n// edited\n")
            assert build._target(name) != before, (name, header)
    for name in ("flash_attention", "flash_attention_bwd"):
        assert '#include "hopper.cuh"' in build.SOURCES[name].read_text(), name
    for helper in ("mbar_wait", "tma_load_5d", "sdesc", "encode_map", "wgmma_ss<64>"):
        pattern = rf"(void|int|uint64_t)\s+{re.escape(helper)}\("
        defined = [name for name in ("hopper.cuh", "flash_attention.cu", "flash_attention_bwd.cu")
                   if re.search(pattern, (csrc / name).read_text())]
        assert defined == ["hopper.cuh"], (helper, defined)


def test_bwd_source_has_no_float_atomics_or_mma_sync():
    """The bf16 route is wgmma on TMA rings: no mma.sync kernel, no float
    atomics, no free-order reductions."""
    text = (Path(build.CSRC) / "flash_attention_bwd.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in text.splitlines())
    for word in ("atomicAdd", "red.", "cp.reduce", "mma.sync", "mma_tiles", "ldmatrix"):
        assert word not in code, word
    assert "wgmma_ss<" in code and "wgmma_rs<" in code and "tma_load_5d(" in code


def _gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hk,G,S,D,kind,window", [
    (4, 4, 8, 2048, 64, "full", 0),  # tinyllama-1.1b's training shape
    (1, 2, 5, 200, 32, "sliding", 100),
])
def test_three_launches_give_the_same_bits_on_gpu(B, Hk, G, S, D, kind, window):
    """Three backward launches on the same inputs (the model's strided
    layouts) are bitwise equal, and each counts once."""
    _gpu()
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((B, S, Hk * G, D)).astype(np.float32)).to(
        "cuda", torch.bfloat16).view(B, S, Hk, G, D).permute(0, 2, 3, 1, 4)
    k, v = (torch.from_numpy(rng.standard_normal((B, S, Hk, D)).astype(np.float32)).to(
        "cuda", torch.bfloat16).permute(0, 2, 1, 3) for _ in range(2))
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    kw = dict(scale=D**-0.5, kind=kind, window=window)
    out, lse = k4.flash_attention_with_lse(q, k, v, **kw)
    before = k4.bwd_launches
    runs = [k4.flash_attention_bwd(q, k, v, out, lse, do, **kw) for _ in range(3)]
    torch.cuda.synchronize()
    assert k4.bwd_launches == before + 3
    for again in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], again))
