"""The port's roofline (``repro_torch.roofline``): ``analysis`` against the
reference's ``repro.roofline.analysis``, ``op_cost`` (the eager
counterpart of ``hlo_cost``) on programs of known cost, each kernel's
``cost`` against the bounds ``PERF.md`` records, and the kernels' meta
routes (K4 both ways, K5, K6 both ways): the kernel route's shapes,
strides, dtypes and refusals, and never the plain version.

The analogues of ``tests/test_hlo_cost.py``: one matmul, a batched einsum,
a loop of R layers (eager code runs every layer, so R layers count R
times one: there is no trip count to infer), and the dominance cases of
``roofline_terms`` restated with the H100's constants.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.roofline import analysis as ref_analysis  # noqa: E402
from repro.roofline import hw as ref_hw  # noqa: E402
from repro_torch.kernels import _report  # noqa: E402
from repro_torch.kernels import flash_attention as k4  # noqa: E402
from repro_torch.kernels import flash_decode as k5  # noqa: E402
from repro_torch.kernels import ssd_scan as k6  # noqa: E402
from repro_torch.roofline import analysis, collective_bytes, hw, model_flops  # noqa: E402
from repro_torch.roofline import op_cost, roofline_terms  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401


BF16 = torch.bfloat16


# ---------------------------------------------------------------------------
# analysis: the reference's functions over the port's constants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flops,nbytes,coll", [
    (197e12, 100e9, {"all-reduce": 0}),
    (1e9, 819e9, {"all-reduce": 0}),
    (1e9, 1e6, {"all-reduce": 50e9 * 3}),
    (3.3e13, 7.1e11, {"all-gather": 123456789, "all-reduce": 2 ** 33, "reduce-scatter": 77,
                      "all-to-all": 0, "collective-permute": 0}),
    (0.0, 0.0, {}),
])
def test_roofline_terms_equal_the_reference_on_its_constants(monkeypatch, flops, nbytes, coll):
    monkeypatch.setattr(hw, "PEAK_FLOPS_BF16", ref_hw.PEAK_FLOPS_BF16)
    monkeypatch.setattr(hw, "HBM_BW", ref_hw.HBM_BW)
    monkeypatch.setattr(hw, "LINK_BW", ref_hw.ICI_BW)
    assert roofline_terms(flops, nbytes, coll) == ref_analysis.roofline_terms(flops, nbytes, coll)


@pytest.mark.parametrize("n,tokens,mode", [(1e9, 1000, "train"), (1e9, 1, "serve"),
                                           (1_100_048_384, 256 * 4096, "train"),
                                           (17e9, 32 * 32768, "serve")])
def test_model_flops_equal_the_reference(n, tokens, mode):
    assert model_flops(n, tokens, mode) == ref_analysis.model_flops(n, tokens, mode)


def test_roofline_terms_dominance_on_the_h100():
    t = roofline_terms(989e12, 100e9, {"all-reduce": 0})
    assert t["dominant"] == "compute_s"
    assert t["compute_s"] == pytest.approx(1.0)
    t = roofline_terms(1e9, 3.35e12, {"all-reduce": 0})
    assert t["dominant"] == "memory_s"
    assert t["memory_s"] == pytest.approx(1.0)
    t = roofline_terms(1e9, 1e6, {"all-reduce": 450e9 * 3})
    assert t["dominant"] == "collective_s"
    assert t["collective_s"] == pytest.approx(3.0)


def test_collective_bytes_takes_pshard_kinds_to_the_references_names():
    counts = {"psum": {"calls": 2, "bytes": 800}, "all_gather": {"calls": 3, "bytes": 96},
              "reduce_scatter": {"calls": 1, "bytes": 40}}
    assert collective_bytes(counts) == {"all-gather": 96, "all-reduce": 800,
                                        "reduce-scatter": 40, "all-to-all": 0,
                                        "collective-permute": 0}
    assert set(collective_bytes({})) == set(analysis.KINDS)
    with pytest.raises(ValueError, match="unknown collective kind"):
        collective_bytes({"broadcast": {"calls": 1, "bytes": 1}})


# ---------------------------------------------------------------------------
# op_cost on programs of known cost
# ---------------------------------------------------------------------------


def _rand(shape, device, seed=0):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal(shape).astype(np.float32)).to(device)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_single_matmul_flops(device):
    a, b = _rand((128, 256), device), _rand((256, 64), device, 1)
    c = op_cost.analyze(lambda x, y: x @ y, a, b)
    assert c["flops"] == 2 * 128 * 256 * 64
    assert c["bytes"] == 128 * 64 * 4  # the result, written once
    assert c["memory"]["argument_bytes"] == (128 * 256 + 256 * 64) * 4
    assert c["memory"]["output_bytes"] == 128 * 64 * 4


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_batched_einsum_flops(device):
    x, w = _rand((4, 64, 32), device), _rand((4, 32, 16), device, 1)
    c = op_cost.analyze(lambda a, b: torch.einsum("bij,bjk->bik", a, b), x, w)
    assert c["flops"] == 2 * 4 * 64 * 32 * 16


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_a_loop_of_r_layers_counts_r_times_one_layer(device):
    w = _rand((64, 64), device)
    x = _rand((32, 64), device, 1)

    def layers(r):
        def f(a):
            for _ in range(r):
                a = torch.tanh(a @ w)
            return a
        return f

    one, eleven = (op_cost.analyze(layers(r), x) for r in (1, 11))
    assert one["flops"] == 2 * 32 * 64 * 64
    assert eleven["flops"] == 11 * one["flops"]
    assert eleven["bytes"] == 11 * one["bytes"]
    assert eleven["ops"]["aten::mm"]["calls"] == 11


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_a_view_costs_no_bytes(device):
    x = _rand((16, 32), device)
    c = op_cost.analyze(lambda a: a.view(32, 16).transpose(0, 1)[2:10].unsqueeze(0).expand(
        3, 8, 32).permute(2, 0, 1), x)
    assert c["bytes"] == 0 and c["flops"] == 0
    assert c["memory"]["peak_bytes"] == c["memory"]["argument_bytes"]  # nothing allocated


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_a_ring_slot_write_costs_one_slot(device):
    """The decode ring's write (``models/attention.py::_write_ring``): one
    slot of a (B, L, Hk, D) cache, whichever form."""
    ring = torch.zeros((2, 64, 4, 8), device=device)
    new = _rand((2, 1, 4, 8), device)
    slot = torch.tensor([5], device=device)
    c = op_cost.analyze(lambda: ring.index_copy_(1, slot, new))
    assert c["bytes"] == new.numel() * 4
    rows = torch.arange(2, device=device)
    c = op_cost.analyze(lambda: ring.index_put_((rows, torch.tensor([3, 9], device=device)),
                                                new[:, 0]))
    assert c["ops"]["aten::index_put_"]["bytes"] == new.numel() * 4
    c = op_cost.analyze(lambda: ring.add_(1.0))  # an in-place op writes what it mutates
    assert c["bytes"] == ring.numel() * 4


def test_meta_and_cpu_runs_count_the_same():
    """A function with matmuls, elementwise ops, views and a backward: its
    FLOPs, bytes, op tally and live bytes equal on the CPU and on meta."""
    def step(x, w1, w2):
        with torch.enable_grad():
            h = torch.nn.functional.silu(x @ w1).reshape(8, 4, 16).sum(1)
            loss = (h @ w2).square().mean()
            return torch.autograd.grad(loss, (w1, w2))

    out = {}
    for dev in ("cpu", "meta"):
        args = [_rand((8, 32), dev), _rand((32, 64), dev, 1).requires_grad_(),
                _rand((16, 8), dev, 2).requires_grad_()]
        out[dev] = op_cost.analyze(step, *args)
    cpu, meta = out["cpu"], out["meta"]
    assert cpu["flops"] == meta["flops"] > 0
    assert cpu["bytes"] == meta["bytes"] > 0
    assert cpu["ops"] == meta["ops"] and cpu["memory"] == meta["memory"]
    top = op_cost.top_contributors(cpu, 3)
    assert [r["bytes"] for r in top] == sorted((r["bytes"] for r in top), reverse=True)


def test_collectives_are_the_pshard_counts_of_the_call():
    from repro_torch.launch.mesh import make_dry_mesh
    from repro_torch.models import pshard

    mesh = make_dry_mesh({"data": 2, "model": 4}, 0)
    x = torch.empty((8, 16), device="meta")
    pshard._count("psum", 7)  # before the call: not the call's
    with pshard.mesh_context(mesh):
        c = op_cost.analyze(lambda t: pshard.all_gather(pshard.psum(t, "model"), "data", 0), x)
    assert c["collectives"] == {"psum": {"calls": 1, "bytes": 2 * 8 * 16 * 4},
                                "all_gather": {"calls": 1, "bytes": 2 * 8 * 16 * 4}}
    assert c["out"].shape == (16, 16) and c["out"].is_meta


# ---------------------------------------------------------------------------
# each kernel's cost: PERF.md's bound column, H100 constants
# ---------------------------------------------------------------------------


def _bound_ms(flops, nread, nwritten, peak=hw.PEAK_FLOPS_BF16):
    return float(f"{max(flops / peak, (nread + nwritten) / hw.HBM_BW) * 1e3:.3g}")


def test_kernel_costs_reproduce_the_recorded_bounds():
    """``PERF.md`` §6's bound column (H100 80GB HBM3 data-sheet peaks)."""
    assert _bound_ms(*k4.cost(4, 4, 8, 2048, 64, BF16)) == 0.0695
    assert _bound_ms(*k4.cost(4, 4, 8, 2048, 64, BF16, backward=True)) == 0.174
    assert _bound_ms(*k5.cost(8, 4, 8, 640, 64, BF16)) == 0.00158
    assert _bound_ms(*k6.cost(4, 2048, 32, 64, 128, 256, BF16)) == 0.0329
    assert _bound_ms(*k6.cost(4, 2048, 32, 64, 128, 256, BF16, backward=True)) == 0.0545
    # the FMA routes' schedules, against the f32 peak (PERF.md's K6 row)
    assert _bound_ms(*k6.cost(4, 2048, 32, 64, 128, 256, torch.float32),
                     hw.PEAK_FLOPS_F32) == 0.321


@pytest.mark.parametrize("S,kind,window", [(384, "full", 0), (384, "sliding", 100),
                                           (384, "chunked", 100), (200, "sliding", 256),
                                           (2048, "chunked", 128)])
def test_k4_pairs_are_the_masks_allowed_pairs(S, kind, window):
    assert k4.allowed_pairs(S, kind, window) == int(k4._mask(S, kind, window, "cpu").sum())


# ---------------------------------------------------------------------------
# the meta routes
# ---------------------------------------------------------------------------


def _meta(shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.fixture
def no_plain(monkeypatch):
    """Every plain version raises: a meta call must not reach one."""
    def boom(*a, **k):
        raise AssertionError("a meta call reached a plain version")

    for mod, names in ((k4, ("flash_attention_plain", "flash_attention_bwd_plain")),
                       (k5, ("flash_decode_plain",)),
                       (k6, ("ssd_chunked_plain", "ssd_chunked_bwd_plain"))):
        for n in names:
            monkeypatch.setattr(mod, n, boom)


@pytest.mark.parametrize("dtype", [BF16, torch.float32])
def test_k4_meta_route_gives_the_kernels_layouts(no_plain, dtype):
    B, Hk, G, S, D = 2, 2, 4, 256, 64
    q = _meta((B, Hk, G, S, D), dtype)
    k, v = _meta((B, Hk, S, D), dtype), _meta((B, Hk, S, D), dtype)
    f0, m0, mb0 = k4.launches, k4.meta_launches, k4.meta_bwd_launches
    out = k4.flash_attention(q, k, v, scale=0.125)
    kernel_out = torch.empty((B, S, Hk, G, D)).permute(0, 2, 3, 1, 4)  # (B, S, Hk, G, D) order
    assert out.is_meta and out.dtype == dtype and out.shape == q.shape
    assert out.stride() == kernel_out.stride()
    o, lse = k4.flash_attention_with_lse(q, k, v, scale=0.125, kind="sliding", window=64)
    assert lse.shape == (B, Hk, G, S) and lse.dtype == torch.float32
    dq, dk, dv = k4.flash_attention_bwd(q, k, v, o, lse, o, scale=0.125)
    assert dq.stride() == kernel_out.stride() and dq.dtype == dtype
    assert dk.shape == k.shape and dk.stride() == torch.empty((B, S, Hk, D)).permute(
        0, 2, 1, 3).stride()
    # through autograd: one forward and one backward meta call
    qr = q.clone().requires_grad_()
    k4.flash_attention(qr, k, v, scale=0.125).sum().backward()
    assert qr.grad.shape == q.shape
    assert (k4.launches, k4.meta_launches - m0, k4.meta_bwd_launches - mb0) == (f0, 3, 2)


def test_k5_and_k6_meta_routes_give_the_kernels_outputs(no_plain):
    q, kv = _meta((3, 2, 4, 64)), _meta((3, 2, 96, 64))
    m0 = k5.meta_launches
    out = k5.flash_decode(q, kv, kv, torch.tensor(5), scale=0.125)
    assert out.is_meta and out.shape == q.shape and out.dtype == BF16 and out.is_contiguous()
    assert (k5.launches, k5.meta_launches - m0) == (k5.launches, 1)
    B, S, nh, hd, ds = 2, 512, 4, 64, 128
    x, dt, A = _meta((B, S, nh, hd)), _meta((B, S, nh), torch.float32), _meta((nh,),
                                                                            torch.float32)
    Bm, Cm = _meta((B, S, ds)), _meta((B, S, ds))
    f0, b0, m0, mb0 = k6.launches, k6.bwd_launches, k6.meta_launches, k6.meta_bwd_launches
    y, h = k6.ssd_scan(x, dt, A, Bm, Cm, 256)
    assert (y.shape, y.dtype, h.shape, h.dtype) == ((B, S, nh, hd), torch.float32,
                                                    (B, nh, hd, ds), torch.float32)
    _, _, h_in = k6.ssd_scan_with_h_in(x, dt, A, Bm, Cm, 256)
    assert h_in.shape == (B, nh, 2, hd, ds) and h_in.dtype == torch.float32
    grads = k6.ssd_scan_bwd(x, dt, A, Bm, Cm, 256, h_in, _meta(x.shape, torch.float32))
    assert [tuple(g.shape) for g in grads] == [(B, S, nh, hd), (B, S, nh), (B, nh),
                                               (B, S, ds), (B, S, ds), (B, nh, hd, ds)]
    assert [g.dtype for g in grads] == [BF16, torch.float32, torch.float32, BF16, BF16,
                                        torch.float32]
    xr = x.clone().requires_grad_()
    k6.ssd_scan(xr, dt, A, Bm, Cm, 256)[0].sum().backward()
    assert xr.grad.shape == x.shape
    assert (k6.launches - f0, k6.bwd_launches - b0) == (0, 0)
    assert (k6.meta_launches - m0, k6.meta_bwd_launches - mb0) == (3, 2)


def test_meta_routes_refuse_what_the_kernels_refuse(no_plain):
    with pytest.raises(ValueError, match=r"^the K4 kernel takes head dims \(32, 64, 128\), "
                                         r"got 48$"):
        k4.flash_attention(_meta((1, 1, 2, 128, 48)), _meta((1, 1, 128, 48)),
                           _meta((1, 1, 128, 48)), scale=0.1)
    with pytest.raises(ValueError, match="^bf16 q, k and v need 16-byte aligned rows$"):
        q = torch.empty_strided((1, 1, 2, 128, 64), (128 * 2 * 68, 128 * 2 * 68, 68, 2 * 68, 1),
                                dtype=BF16, device="meta")  # rows 68 apart: not 16 bytes
        k4.flash_attention(q, _meta((1, 1, 128, 64)), _meta((1, 1, 128, 64)), scale=0.1)
    with pytest.raises(ValueError, match="^the bf16 K4 kernel takes 1 <= G <= 128"):
        k4.flash_attention(_meta((1, 1, 130, 128, 64)), _meta((1, 1, 128, 64)),
                           _meta((1, 1, 128, 64)), scale=0.1)
    with pytest.raises(ValueError, match=r"^the K5 kernel takes head dims \(32, 64, 128\), "
                                         r"got 48$"):
        k5.flash_decode(_meta((1, 1, 2, 48)), _meta((1, 1, 8, 48)), _meta((1, 1, 8, 48)), 3,
                        scale=0.1)
    with pytest.raises(ValueError, match=r"^the K6 kernel takes \(head_dim, d_state\) in"):
        k6.ssd_scan(_meta((1, 64, 2, 48)), _meta((1, 64, 2), torch.float32),
                    _meta((2,), torch.float32), _meta((1, 64, 16)), _meta((1, 64, 16)), 64)
    with pytest.raises(ValueError, match="^the K6 kernel takes x, B_ and C_ all float32"):
        k6.ssd_scan(_meta((1, 64, 2, 64), torch.float16), _meta((1, 64, 2), torch.float32),
                    _meta((2,), torch.float32), _meta((1, 64, 64), torch.float16),
                    _meta((1, 64, 64), torch.float16), 64)


def test_a_meta_call_reports_its_kernel_cost_and_no_ops():
    B, Hk, G, S, D = 1, 2, 2, 256, 32
    q, k = _meta((B, Hk, G, S, D)), _meta((B, Hk, S, D))
    c = op_cost.analyze(lambda: k4.flash_attention(q, k, k, scale=0.1, kind="chunked",
                                                   window=128))
    flops, nread, nwritten = k4.cost(B, Hk, G, S, D, BF16, "chunked", 128)
    assert nwritten == B * Hk * G * S * D * 2  # the output; q, k and v are read
    assert c["kernels"] == {"flash_attention": {"launches": 1, "flops": flops,
                                                "bytes": nwritten, "read_bytes": nread}}
    assert c["flops"] == 0 and c["bytes"] == 0  # the route's own ops are the kernel's
    assert _report.call("x", lambda: (1, 1, 1)) is _report._NULL  # no listener: nothing


def test_the_factorys_shape_only_trees_count_nothing():
    """The meta trees the sharding rules read shapes off are no work: made
    inside an ``analyze``, they add no op, byte or live storage."""
    from repro_torch.configs import get_arch
    from repro_torch.models import factory

    c = op_cost.analyze(lambda: factory._abstract_caches(get_arch("llama3-8b").reduced(),
                                                         2, 64))
    assert (c["ops"], c["bytes"], c["memory"]["peak_bytes"]) == ({}, 0, 0)


@pytest.mark.cuda
def test_a_cuda_tensor_launches_and_reports_what_meta_reports():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    B, Hk, G, S, D = 1, 2, 4, 256, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((B, Hk, G, S, D), generator=gen, device="cuda").to(BF16)
    k = torch.randn((B, Hk, S, D), generator=gen, device="cuda").to(BF16)
    f0, m0 = k4.launches, k4.meta_launches
    card = op_cost.analyze(lambda: k4.flash_attention(q, k, k, scale=0.125))
    meta = op_cost.analyze(lambda: k4.flash_attention(q.to("meta"), k.to("meta"),
                                                      k.to("meta"), scale=0.125))
    assert (k4.launches - f0, k4.meta_launches - m0) == (1, 1)
    assert card["kernels"] == meta["kernels"]
