"""Windowed decode on K5 (``repro_torch.models.attention._k5_valid_len``).

A decode step goes through K5 wherever the ring's valid slots are the
prefix ``0 .. valid_len - 1``: full layers, sliding layers with L <= W,
chunked layers with L == W. Held here, exactly:

* ``arange(L) < valid_len`` equals ``_slot_valid``'s mask (the port's and
  the reference's) at every index 0 .. 3L, with a 0-d index and with a (B,)
  index holding all of them at once;
* a chunked ring shorter than its chunk is not a prefix once it wraps, so
  that layer keeps the masked route, chosen from shapes alone;
* ``attention_decode`` calls K5's entry point exactly on those routes.

On the card (``cuda``, torch only): a gemma3-shaped decode step (H 32,
Hk 16, D 128, W 1024, bf16 and f32) of a sliding and a chunked layer
through K5 with per-row indices, against the masked softmax of
``_slot_valid``; f32 holds the window tightly enough that one slot more
or fewer fails.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import AttentionSpec  # noqa: E402
from repro_torch.kernels import flash_decode as k5  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

# (kind, window, L): the routes K5 takes
PREFIX_CASES = [("full", 0, 8), ("sliding", 8, 8), ("sliding", 8, 5), ("sliding", 8, 1),
                ("chunked", 8, 8), ("chunked", 4, 4)]


def _spec(kind, window, H=4, Hk=2, D=32):
    return AttentionSpec(num_heads=H, num_kv_heads=Hk, head_dim=D, kind=kind, window=window)


def _prefix(valid_len, L):
    return torch.arange(L) < valid_len[..., None]


@pytest.mark.parametrize("kind,window,L", PREFIX_CASES)
def test_k5_valid_len_is_the_slot_valid_mask(kind, window, L):
    spec = _spec(kind, window)
    index = torch.arange(3 * L + 1, dtype=torch.int32)  # (B,): every index at once
    vl = A._k5_valid_len(spec, L, index)
    assert vl is not None and vl.dtype == torch.int32
    want = A._slot_valid(spec, A._slot_positions(spec, L, index), index)
    assert torch.equal(_prefix(vl, L), want)
    for i in range(3 * L + 1):  # 0-d index
        idx = torch.tensor(i, dtype=torch.int32)
        v0 = A._k5_valid_len(spec, L, idx)
        assert v0.dim() == 0 and int(v0) == int(vl[i])
        assert torch.equal(_prefix(v0, L),
                           A._slot_valid(spec, A._slot_positions(spec, L, idx), idx))


@pytest.mark.parametrize("kind,window,L", PREFIX_CASES)
def test_the_prefix_is_the_references_slot_valid(kind, window, L):
    jnp = pytest.importorskip("jax.numpy")
    from repro.configs.base import AttentionSpec as RefSpec
    from repro.models import attention as ref_attn

    spec_r = RefSpec(num_heads=4, num_kv_heads=2, head_dim=32, kind=kind, window=window)
    spec = _spec(kind, window)
    for i in range(3 * L + 1):
        want = ref_attn._slot_valid(spec_r, ref_attn._slot_positions(spec_r, L, jnp.int32(i)),
                                    jnp.int32(i))
        vl = A._k5_valid_len(spec, L, torch.tensor(i, dtype=torch.int32))
        np.testing.assert_array_equal(_prefix(vl, L).numpy(), np.asarray(want))


def test_a_chunked_ring_shorter_than_its_chunk_keeps_the_masked_route():
    spec = _spec("chunked", 8)
    L = 3
    assert A._k5_valid_len(spec, L, torch.tensor(0, dtype=torch.int32)) is None
    index = torch.arange(3 * 8, dtype=torch.int32)
    masks = A._slot_valid(spec, A._slot_positions(spec, L, index), index)
    prefix = [bool(torch.equal(m, torch.arange(L) < int(m.sum()))) for m in masks]
    assert all(prefix[:L]) and not all(prefix)  # a prefix until the ring wraps
    assert A._k5_valid_len(_spec("sliding", 8), 9, index) is None  # L > W: no prefix


@pytest.mark.parametrize("kind,window,L,k5", [
    ("full", 0, 6, True), ("sliding", 6, 6, True), ("sliding", 8, 6, True),
    ("chunked", 6, 6, True), ("chunked", 8, 6, False)])
def test_attention_decode_takes_k5_exactly_on_the_prefix_routes(kind, window, L, k5,
                                                                 monkeypatch):
    spec = _spec(kind, window)
    gen = torch.Generator().manual_seed(0)
    p = A.init_attention(gen, 64, spec, torch.float32)
    seen = []
    real = A.kops.flash_decode
    monkeypatch.setattr(A.kops, "flash_decode",
                        lambda *a, **kw: seen.append(1) or real(*a, **kw))
    rope = A.RopeTable(torch.ones(16), 32)
    cache = A.init_cache(spec, 2, L, torch.float32)
    cache["index"] = torch.tensor([3, 13], dtype=torch.int32)
    A.attention_decode(p, torch.randn((2, 1, 64), generator=gen), spec, rope, cache)
    assert seen == ([1] if k5 else [])


def _gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the K5 kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind", ["sliding", "chunked"])
def test_gemma3_shaped_windowed_decode_on_k5_against_the_mask_on_gpu(kind, dtype):
    """(B, Hk, G, L, D) = (2, 16, 2, 1024, 128), W = L = 1024: rows at
    indices 5000 and 300 (the ring wrapped and not), K5's output against
    the masked softmax over the same cache (bf16 2e-2, f32 2e-5)."""
    _gpu()
    dt = getattr(torch, dtype)
    spec = _spec(kind, 1024, H=32, Hk=16, D=128)
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = A.init_attention(gen, 5376, spec, dt)
    cache = A.init_cache(spec, 2, 1024, dt, "cuda")
    cache["k"].normal_(generator=gen)
    cache["v"].normal_(generator=gen)
    cache["index"] = torch.tensor([5000, 300], dtype=torch.int32, device="cuda")
    x = torch.randn((2, 1, 5376), generator=gen, device="cuda").to(dt)
    before = k5.launches
    with torch.no_grad():
        y, cache = A.attention_decode(p, x, spec, None, cache)
    torch.cuda.synchronize()
    assert k5.launches == before + 1
    # the masked route on the cache as written (index now one past)
    index = cache["index"] - 1
    valid = A._slot_valid(spec, A._slot_positions(spec, 1024, index), index)
    q = torch.einsum("bsd,dhe->bshe", x, p["w_q"]).reshape(2, 16, 2, 128)
    kg, vg = cache["k"].permute(0, 2, 1, 3), cache["v"].permute(0, 2, 1, 3)
    s = torch.einsum("bhgd,bhld->bhgl", q, kg).float() * 128**-0.5
    w = torch.softmax(torch.where(valid[:, None, None], s, -1e30), -1)
    out = torch.einsum("bhgl,bhld->bhgd", w.to(vg.dtype), vg).reshape(2, 1, 32, 128)
    want = torch.einsum("bshe,hed->bsd", out, p["w_o"])
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    torch.testing.assert_close(y.float(), want.float(), atol=tol, rtol=tol)
