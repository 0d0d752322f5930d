"""The slot pool of the serving tier (``repro_torch.serve.batching``) on its
own, torch only (no JAX, so ``-m cuda`` runs this file on the card):

* a pool is one batch-S cache tree whose attention ``index`` is per row;
  ``write_slot``/``read_slot`` write and read row s of every leaf, which is
  axis 1 under ``blocks`` and axis 0 under ``prefix``/``remainder`` (a model
  with all three parts);
* one ``decode_step`` over a pool whose rows sit at different positions
  equals batch-1 decodes row by row. Not bitwise on the CPU: the batch-S
  matmuls block their sums differently from batch 1 (about 2e-6 apart), so
  the logits are held at atol 1e-5 and the greedy tokens exactly; the
  serving contract (``test_torch_serve_loop.py``) is bitwise against a
  stream decoded alone in a pool of the same width;
* on the card (``cuda``): the pool tick launches K5 once per full layer
  with a ragged ``(S,)`` ``valid_len``, and join/evict churn leaves every
  stream's tokens bitwise equal to its decode alone in a same-width pool;
* the encoder-decoder's cache tree in a pool (slice G3): rows carried
  exactly, a tick equal to batch-1 rows.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.kernels import flash_decode as k5  # noqa: E402
from repro_torch.models import factory  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ReplicaPool,
    Request,
    VersionStore,
    init_slot_pool,
    prefill_tokens,
    read_slot,
    run_serve_loop,
    slot_decode_fn,
    write_slot,
)
from _torch_threads import _worker_threads  # noqa: E402,F401

ARCH = get_arch("tinyllama-1.1b").reduced()
S, CTX = 4, 16


def _model(cfg, device="cpu"):
    model = factory.build(cfg)
    return model, model.init(torch.Generator(device=device).manual_seed(0))


def _prefilled(model, params, prompt, device="cpu"):
    caches = model.init_decode_caches(1, CTX, device)
    with torch.no_grad():
        logits, caches = prefill_tokens(model.decode_step, params, caches,
                                        torch.as_tensor(prompt, device=device)[None])
    return logits, caches


def test_write_and_read_slot_rows_of_every_part():
    cfg = dataclasses.replace(ARCH, prefix=ARCH.pattern, remainder=ARCH.pattern, repeats=2)
    model, params = _model(cfg)
    pool = init_slot_pool(model, S, CTX, "cpu")
    idx = [t for part in pool.values() for t in tree_leaves(part) if t.dtype == torch.int32]
    assert sorted(tuple(t.shape) for t in idx) == sorted(
        [(S,)] * 2 * len(ARCH.pattern) + [(2, S)] * len(ARCH.pattern))
    rng = np.random.default_rng(0)
    ones = {}
    for s in (2, 0):
        ones[s] = _prefilled(model, params, rng.integers(0, cfg.vocab_size, 3 + s))[1]
        write_slot(pool, s, ones[s])
    for s, one in ones.items():
        back = read_slot(pool, s)
        for a, b in zip(tree_leaves(back), tree_leaves(one)):
            assert a.shape == b.shape and torch.equal(a, b)
    # rows 1 and 3 are still the fresh pool's zeros, index 0
    for s in (1, 3):
        assert all(not t.any() for t in tree_leaves(read_slot(pool, s)))
    # under blocks the row is axis 1: slot 2's row of a K cache, every repeat
    k = pool["blocks"][0]["k"]
    assert k.shape[:2] == (2, S) and k[:, 2].any() and not k[:, 1].any()


def test_per_row_decode_step_equals_batch_one_rows():
    model, params = _model(ARCH)
    pool = init_slot_pool(model, S, CTX, "cpu")
    rng = np.random.default_rng(1)
    ones, toks = [], []
    for s in range(S):  # rows at positions 2, 3, 4, 5
        logits, one = _prefilled(model, params, rng.integers(0, ARCH.vocab_size, s + 2))
        write_slot(pool, s, one)
        ones.append(one)
        toks.append(int(logits[0, -1].argmax()))
    tick = slot_decode_fn(model)
    tok = torch.tensor(toks, dtype=torch.int32)[:, None]
    with torch.no_grad():
        for step in range(3):
            lp, pool = tick(params, pool, tok)
            rows = [model.decode_step(params, ones[s], tok[s:s + 1])[0] for s in range(S)]
            lb = torch.cat(rows)
            torch.testing.assert_close(lp, lb, atol=1e-5, rtol=0)
            assert torch.equal(lp[:, -1].argmax(-1), lb[:, -1].argmax(-1))
            tok = lp[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    index = [t for t in tree_leaves(pool) if t.dtype == torch.int32][0]
    assert index.reshape(-1).tolist() == [s + 2 + 3 for s in range(S)]


@pytest.mark.parametrize("kind,window", [("full", 0), ("sliding", 3), ("chunked", 4)])
def test_per_row_attention_decode_equals_rows_at_zero_d_index(kind, window):
    """``attention_decode`` with a (B,) index against each row decoded with
    its own 0-d index: the RoPE position, ring slot, and ``valid_len`` or
    window mask of every row its own (the cache of L = 6 slots wraps)."""
    from repro_torch.configs.base import AttentionSpec
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.attention import RopeTable

    spec = AttentionSpec(num_heads=4, num_kv_heads=2, head_dim=32, kind=kind, window=window)
    gen = torch.Generator().manual_seed(3)
    p = attn_mod.init_attention(gen, 64, spec, torch.float32)
    rope = RopeTable(1.0 / (10000.0 ** (torch.arange(0, 32, 2).float() / 32)), 32)
    B, L = 3, 6
    cache = {"k": torch.randn((B, L, 2, 32), generator=gen),
             "v": torch.randn((B, L, 2, 32), generator=gen),
             "index": torch.tensor([0, 4, 9], dtype=torch.int32)}
    rows = [{"k": cache["k"][b:b + 1].clone(), "v": cache["v"][b:b + 1].clone(),
             "index": cache["index"][b].clone()} for b in range(B)]
    x = torch.randn((B, 1, 64), generator=gen)
    for _ in range(4):
        y, cache = attn_mod.attention_decode(p, x, spec, rope, cache)
        ys = [attn_mod.attention_decode(p, x[b:b + 1], spec, rope, rows[b])[0]
              for b in range(B)]
        torch.testing.assert_close(y, torch.cat(ys), atol=1e-5, rtol=0)
    for b in range(B):
        # the same ring slots written (the projections' sums may differ in ulps)
        torch.testing.assert_close(cache["k"][b], rows[b]["k"][0], atol=1e-5, rtol=0)
        assert cache["index"][b] == rows[b]["index"]


def _store(params, h=4, latest=3):
    lo = max(latest - (h - 1), 0)
    slot_ver = [0] * h
    for v in range(lo, latest + 1):
        slot_ver[v % h] = v
    hist = tree_map(lambda p: torch.stack([p * (1.0 + 0.01 * v) for v in slot_ver]), params)
    return VersionStore(hist, torch.tensor(latest, dtype=torch.int32,
                                           device=tree_leaves(params)[0].device), h)


def _solo(model, store, req, version, slots, ctx, device):
    """``req`` decoded alone in a replica pool of ``slots`` slots pinned to
    ``version``: the serving contract's reference."""
    pool = ReplicaPool(model, 1, slots, ctx, device=device)
    pool.params[0] = store.read(version).params
    done = pool.join(0, req, 0)
    t = 0
    while done is None:
        finished = pool.decode_tick(t)
        done = finished[0] if finished else None
        t += 1
    return done.tokens


def churn_matches_solo(model, params, device):
    """Six requests joining and leaving around each other on 2 replicas x
    2 slots (round_robin, stagger 1): every stream's tokens equal its solo
    decode on the version it was served; Var[X] = 0 and E[X] = 2."""
    store = _store(params)
    rng = np.random.default_rng(7)
    reqs = [Request(rid=i, tick=i, prompt=rng.integers(0, model.cfg.vocab_size, 5)
                    .astype(np.int32), gen_len=3 + i % 3) for i in range(6)]
    ctx = max(len(r.prompt) + r.gen_len for r in reqs)
    report = run_serve_loop(model, store, reqs, router="round_robin", n_replicas=2,
                            slots=2, ctx=ctx, device=device)
    assert len(report.results) == len(reqs) and report.queue_left == 0
    assert {r.staleness for r in report.results} == {0, 1}
    for res in report.results:
        solo = _solo(model, store, reqs[res.rid], res.version, 2, ctx, device)
        assert res.tokens == solo, f"stream {res.rid} diverged"
    assert report.serve_stats["var_X"] == 0.0
    assert report.serve_stats["mean_X"] == 2.0
    return report


def test_join_evict_streams_bitwise_vs_solo():
    churn_matches_solo(*_model(ARCH), "cpu")


def test_encoder_decoder_pool_rows_and_tick_equal_batch_one_rows():
    """whisper's cache tree in a pool (``self``, ``cross_k``, ``cross_v``,
    rows on axis 1 under the decoder's layer axis): ``write_slot`` and
    ``read_slot`` carry a row exactly, the ``self`` index becomes
    (layers, S), and two ticks equal each row's batch-1 decode (the
    per-row sinusoid position included) within 1e-5."""
    cfg = get_arch("whisper-tiny").reduced()
    model, params = _model(cfg)
    pool = init_slot_pool(model, 2, CTX, "cpu")
    assert tuple(pool["self"]["index"].shape) == (cfg.num_layers, 2)
    rng = np.random.default_rng(4)
    ones, toks = [], []
    for s in range(2):  # rows at positions 2 and 3
        logits, one = _prefilled(model, params, rng.integers(0, cfg.vocab_size, s + 2))
        write_slot(pool, s, one)
        for a, b in zip(tree_leaves(read_slot(pool, s)), tree_leaves(one)):
            assert torch.equal(a, b)
        ones.append(one)
        toks.append(int(logits[0, -1].argmax()))
    tok = torch.tensor(toks, dtype=torch.int32)[:, None]
    with torch.no_grad():
        for _ in range(2):
            lp, pool = slot_decode_fn(model)(params, pool, tok)
            lb = torch.cat([model.decode_step(params, ones[s], tok[s:s + 1])[0]
                            for s in range(2)])
            torch.testing.assert_close(lp, lb, atol=1e-5, rtol=0)
            tok = lp[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    assert pool["self"]["index"][0].tolist() == [4, 5]


@pytest.mark.cuda
def test_pool_tick_launches_k5_per_layer_with_ragged_valid_len_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the K5 kernel has no CPU mode)")
    model, params = _model(ARCH, "cuda")
    pool = init_slot_pool(model, S, CTX, "cuda")
    rng = np.random.default_rng(2)
    for s in range(S - 1):  # rows at 1, 5, 9; the last row empty, at 0
        write_slot(pool, s, _prefilled(model, params,
                                       rng.integers(0, ARCH.vocab_size, 4 * s + 1), "cuda")[1])
    seen = []
    real = k5.flash_decode

    def spy(q, k, v, valid_len, **kw):
        seen.append(valid_len.clone())
        return real(q, k, v, valid_len, **kw)

    tok = torch.ones((S, 1), dtype=torch.int32, device="cuda")
    before = k5.launches
    k5.flash_decode = spy
    try:
        with torch.no_grad():
            logits, _ = slot_decode_fn(model)(params, pool, tok)
    finally:
        k5.flash_decode = real
    torch.cuda.synchronize()
    assert k5.launches - before == ARCH.num_layers
    assert [v.tolist() for v in seen] == [[2, 6, 10, 1]] * ARCH.num_layers
    assert bool(torch.isfinite(logits).all())


@pytest.mark.cuda
def test_join_evict_streams_bitwise_vs_solo_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the K5 kernel has no CPU mode)")
    model, params = _model(ARCH, "cuda")
    before = k5.launches
    churn_matches_solo(model, params, "cuda")
    assert k5.launches > before
