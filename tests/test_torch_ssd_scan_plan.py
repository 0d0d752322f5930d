"""The schedule of K6's tensor-core backward (``kernels/ssd_scan.py::bwd_plan``):
its work items, walks, head groups, grids, shared memory and workspace, on
the CPU in seconds. The kernels (``csrc/ssd_scan_bwd.cu``) decode their work
items as ``bwd_item`` does and check the plan's shared memory against
their own at the first launch; these tests hold the plan to what the
kernels need: every (head, i >= j) block pair of every (batch, chunk)
visited exactly once by the j-side kernel and once by the i-side kernel,
every head in one group, work items longest walk first, grids of at most
one CTA an SM, and shared memory within the card's 227 KB.
"""
import itertools

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ssd_scan  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

SMEM_CAP = 232448  # bytes of shared memory a block may use on an H100
# (B, S, nh, hd, ds, chunk): every (hd, ds) of the route, chunks of 16, 64,
# 100 (S = 200) and 256, head counts below, at and above a group, odd ones
SHAPES = [(B, S, nh, hd, ds, L)
          for hd, ds in ((32, 64), (32, 128), (64, 64), (64, 128))
          for (B, S, nh, L) in ((2, 64, 3, 16), (1, 128, 8, 64), (1, 200, 2, 100),
                                (2, 512, 11, 256), (4, 2048, 32, 256))]
IDS = [f"B{B}_S{S}_nh{nh}_hd{hd}_ds{ds}_L{L}" for B, S, nh, hd, ds, L in SHAPES]


def _plan(shape, sms=132):
    B, S, nh, hd, ds, L = shape
    return ssd_scan.bwd_plan(B, S, nh, hd, ds, L, sms=sms)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("side", ["j", "i"])
def test_every_block_pair_is_visited_once(shape, side):
    plan = _plan(shape)
    seen = [p for t in range(plan.items) for p in ssd_scan.bwd_walk(plan, t, side)]
    want = [(b, c, h, ib, jb) for b, c, h in itertools.product(
        range(plan.B), range(plan.chunks), range(plan.nh))
        for ib in range(plan.blocks) for jb in range(ib + 1)]
    assert len(seen) == len(want) == len(set(seen))
    assert set(seen) == set(want)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_every_head_falls_in_one_group(shape):
    plan = _plan(shape)
    heads = [h for g in range(plan.groups)
             for h in range(g * plan.group, min(plan.nh, (g + 1) * plan.group))]
    assert sorted(heads) == list(range(plan.nh)) == heads
    assert plan.group == min(plan.nh, ssd_scan.BWD_GROUP)
    # each (b, chunk, block) has one item per group on each side
    for side in ("j", "i"):
        items = [ssd_scan.bwd_item(plan, t, side) for t in range(plan.items)]
        assert len(set(items)) == plan.items == plan.B * plan.chunks * plan.blocks * plan.groups


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("side", ["j", "i"])
def test_items_run_longest_first(shape, side):
    plan = _plan(shape)
    # a head's steps: i blocks from j's on (j side), j blocks up to i's (i side)
    lengths = [len({(p[3], p[4]) for p in ssd_scan.bwd_walk(plan, t, side)})
               for t in range(plan.items)]
    assert lengths == sorted(lengths, reverse=True)
    # j block 0 walks every i block of its chunk first; i block nb - 1 every j block
    first = ssd_scan.bwd_item(plan, 0, side)[2]
    assert first == (0 if side == "j" else plan.blocks - 1)
    assert lengths[0] == plan.blocks


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("sms", [1, 132, 10_000])
def test_grids_are_at_most_one_cta_an_sm(shape, sms):
    plan = _plan(shape, sms)
    assert plan.j_grid == plan.i_grid == min(plan.items, sms)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_shared_memory_and_workspace_match_the_source(shape):
    """The plan's shared memory is ``TcCfg``'s (``ssd_scan_bwd_config``)
    and within the card's cap; its workspace is ``ssd_scan_bwd_workspace``'s
    layout, region by region, each rounded up to whole KB."""
    B, S, nh, hd, ds, L = shape
    plan = _plan(shape)
    x, bc, st, cb, rows = 64 * hd * 2, 64 * ds * 2, hd * ds * 2, 16384, 256
    r1k = lambda n: -(-n // 1024) * 1024  # noqa: E731
    bars = 8 * (8 + 2 * 2) + 1024
    j = 2 * bc + 2 * r1k(2 * x) + 2 * r1k(max(bc + cb + 4 * x + 2 * rows, 4 * st)) + bars
    i = 2 * bc + 2 * r1k(4 * x) + 2 * r1k(max(bc + cb + 2 * x + 4 * rows, 4 * st)) + bars
    assert (plan.j_smem, plan.i_smem, plan.stages) == (j, i, 2)
    assert max(plan.j_smem, plan.i_smem, plan.prep_smem) <= SMEM_CAP
    nc, lp, ldc, ng = S // L, -(-L // 64) * 64, -(-L // 4) * 4, -(-nh // plan.group)
    regions = {
        "own state terms": B * nh * nc * hd * ds, "totals": B * nh * nc,
        "dA parts": B * nh * nc,
        "cs": B * nh * nc * lp, "dt": B * nh * nc * lp,
        "dy planes": B * nh * nc * lp * hd,  # two bf16 planes: a float an element
        "dH_out planes": B * nh * nc * hd * ds, "h_in planes": B * nh * nc * hd * ds,
        "CB": B * nc * L * ldc, "dot partials": B * nh * nc * hd * ds // 128,
        "d cs rows": B * nh * S, "d cs columns": B * nh * S, "ddt direct": B * nh * S,
        "w u": B * nh * S, "dB groups": ng * B * S * ds, "dC groups": ng * B * S * ds}
    assert plan.workspace_bytes == 4 * sum(-(-n // 256) * 256 for n in regions.values())


def test_the_group_size_does_not_depend_on_the_batch():
    """A cohort folded into B sums its heads as each client's own call does:
    the groups and orders depend on nh alone."""
    one, cohort = (ssd_scan.bwd_plan(B, 2048, 32, 64, 128, 256, sms=132) for B in (1, 4))
    assert (one.group, one.groups, one.j_order, one.i_order) == (
        cohort.group, cohort.groups, cohort.j_order, cohort.i_order)
    assert cohort.items == 4 * one.items


@pytest.mark.parametrize("dtype,ds,L,route", [
    (torch.bfloat16, 128, 256, True), (torch.bfloat16, 64, 16, True),
    (torch.bfloat16, 16, 64, False), (torch.bfloat16, 64, 300, False),
    (torch.float32, 128, 256, False)])
def test_the_route_and_what_the_plan_refuses(dtype, ds, L, route):
    assert ssd_scan.tc_route(dtype, ds, L) is route
    if not route and dtype == torch.bfloat16:
        with pytest.raises(ValueError, match="no tensor-core backward"):
            ssd_scan.bwd_plan(1, 600, 2, 64, ds, L, sms=132)


def test_bwd_source_has_no_float_atomics_or_mma_sync_of_its_own():
    """The tensor-core route's block-pair products are wgmma on TMA-fed
    rings: the source issues no mma.sync or ldmatrix of its own (the CB pass
    is the forward's kernel, shared through ssd_common.cuh), and no float
    atomics or free-order reductions."""
    from pathlib import Path

    from repro_torch.kernels import build

    text = (Path(build.CSRC) / "ssd_scan_bwd.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in text.splitlines())
    for word in ("atomicAdd", "red.", "cp.reduce", "mma.sync", "ldsm", "ldmatrix", "mma("):
        assert word not in code, word
    for word in ("wgmma_ss<", "wgmma_sst<", "wgmma_rs<", "tma_load_3d(", "tma_load_4d(", "bulk_load(",
                 "ssd_cb_kernel<"):
        assert word in code, word
    # the CB kernel and the warp-scan cumsum are defined once, in ssd_common.cuh
    for definition in ("ssd_cb_kernel(const", "void chunk_cumsum("):
        defined = [name for name in ("ssd_common.cuh", "ssd_scan.cu", "ssd_scan_bwd.cu")
                   if definition in (Path(build.CSRC) / name).read_text()]
        assert defined == ["ssd_common.cuh"], (definition, defined)
