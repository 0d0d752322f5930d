"""K4 and K5 on the card at the rank-local shapes of ``chip_smoke.py``'s
``tp_main`` (tinyllama-1.1b at (4, 2048) on mesh (model 4) and (data 2 x
model 2); 32 decode steps from the prefill's caches, whose 2048-slot rings
are full), each against its plain version in f32 at the kernels' bf16
tolerance. Torch only: these run under ``-m cuda`` on the card and skip
elsewhere.
"""
import pytest

torch = pytest.importorskip("torch")
from _torch_threads import _worker_threads  # noqa: E402,F401


# (B/dp, Hk/tp, G, S, D) of tinyllama-1.1b at (4, 2048) on model 4 and on
# data 2 x model 2; K5 the same ranks' decode over the prefill's full ring
K4_SHAPES = [(4, 1, 8, 2048, 64), (2, 2, 8, 2048, 64)]
K5_SHAPES = [(4, 1, 8, 2048, 64), (2, 2, 8, 2048, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K4_SHAPES)
def test_k4_at_the_rank_local_shapes_on_gpu(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K4 kernel has no CPU mode")
    from repro_torch.kernels import flash_attention as k4

    Bl, Hk, G, S, D = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((Bl, Hk, G, S, D), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((Bl, Hk, S, D), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((Bl, Hk, S, D), generator=gen, device="cuda").to(torch.bfloat16)
    before = k4.launches
    out = k4.flash_attention(q, k, v, scale=D**-0.5)
    assert k4.launches == before + 1
    plain = k4.flash_attention_plain(q.float(), k.float(), v.float(), scale=D**-0.5)
    assert float((out.float() - plain).abs().max()) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K5_SHAPES)
def test_k5_at_the_rank_local_shapes_on_gpu(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the K5 kernel has no CPU mode")
    from repro_torch.kernels import flash_decode as k5

    Bl, Hk, G, L, D = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((Bl, Hk, G, D), generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn((Bl, Hk, L, D), generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn((Bl, Hk, L, D), generator=gen, device="cuda").to(torch.bfloat16)
    vl = torch.tensor(L, device="cuda")  # every slot valid: the ring full after the prompt
    before = k5.launches
    out = k5.flash_decode(q, k, v, vl, scale=D**-0.5)
    assert k5.launches == before + 1
    plain = k5.flash_decode_plain(q.float(), k.float(), v.float(), vl, scale=D**-0.5)
    assert float((out.float() - plain).abs().max()) <= 2e-2
