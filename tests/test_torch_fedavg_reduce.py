"""K1 (``fedavg_reduce``): the port's wrapper and plain version against the
reference's Pallas kernel (interpret mode on the CPU, as
``tests/test_kernels.py`` runs it) and its oracle ``fedavg_reduce_ref``.

The sums run in another order than the reference's (a torch reduction
against a Pallas dot or an einsum), so values agree within rtol 1e-5 /
atol 1e-6, not bitwise. On a card, the CUDA kernel is held against the
plain version at the same tolerance (the reference is imported inside the
tests that use it, so the file also runs where JAX is absent):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_fedavg_reduce.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fedavg_reduce as k1  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

RTOL, ATOL = 1e-5, 1e-6


def _reference():
    """(jax.numpy, repro.kernels.ops, repro.kernels.ref)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as ref_ops
    from repro.kernels import ref as ref_ref

    return jnp, ref_ops, ref_ref


def _inputs(C, N, seed, zero_slots=0):
    rng = np.random.default_rng(seed)
    params = rng.standard_normal((C, N)).astype(np.float32)
    logits = rng.standard_normal(C)
    w = np.exp(logits) / np.exp(logits).sum()
    if zero_slots:
        w[C - zero_slots:] = 0.0  # cohort padding
        w /= w.sum()
    return params, w.astype(np.float32)


@pytest.mark.parametrize("C,N,block,zero_slots", [
    (4, 1000, 256, 0), (4, 1000, 256, 1), (33, 4096, 4096, 0), (33, 4096, 4096, 7),
    (1, 17, 8, 0),
])
def test_plain_k1_matches_pallas_and_oracle(C, N, block, zero_slots):
    jnp, ref_ops, ref_ref = _reference()
    params, w = _inputs(C, N, seed=C * N, zero_slots=zero_slots)
    got = ops.fedavg_reduce(torch.from_numpy(params), torch.from_numpy(w)).numpy()
    pallas = np.asarray(ref_ops.fedavg_reduce(jnp.asarray(params), jnp.asarray(w),
                                              block_n=block))
    oracle = np.asarray(ref_ref.fedavg_reduce_ref(jnp.asarray(params), jnp.asarray(w)))
    assert got.shape == (N,) and got.dtype == np.float32
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        ref.fedavg_reduce_ref(torch.from_numpy(params), torch.from_numpy(w)).numpy(),
        oracle, rtol=RTOL, atol=ATOL)


def test_masked_weights_contribute_nothing():
    """Zero weights (cohort padding) add exactly 0, as in the reference's
    ``test_fedavg_reduce_masked_weights``."""
    jnp, ref_ops, _ = _reference()
    params = np.stack([np.ones(100), 5 * np.ones(100), 9 * np.ones(100)]).astype(np.float32)
    w = np.array([0.5, 0.5, 0.0], np.float32)
    got = ops.fedavg_reduce(torch.from_numpy(params), torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, 3.0 * np.ones(100, np.float32))
    pallas = np.asarray(ref_ops.fedavg_reduce(jnp.asarray(params), jnp.asarray(w),
                                              block_n=64))
    np.testing.assert_allclose(got, pallas, atol=ATOL)


def test_nan_in_a_zero_weight_slot_propagates_as_in_the_reference():
    """Every slot counts, as in the Pallas dot: 0 * NaN is NaN."""
    jnp, ref_ops, _ = _reference()
    params = np.ones((3, 8), np.float32)
    params[2, 5] = np.nan
    w = np.array([0.5, 0.5, 0.0], np.float32)
    got = ops.fedavg_reduce(torch.from_numpy(params), torch.from_numpy(w)).numpy()
    pallas = np.asarray(ref_ops.fedavg_reduce(jnp.asarray(params), jnp.asarray(w),
                                              block_n=8))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(pallas))
    assert np.isnan(got[5]) and not np.isnan(np.delete(got, 5)).any()


@pytest.mark.parametrize("params,weights,match", [
    (torch.zeros((3, 4), dtype=torch.float64), torch.zeros(3), "2-D float32"),
    (torch.zeros((3, 4, 2)), torch.zeros(3), "2-D float32"),
    (torch.zeros((3, 4)), torch.zeros(3, dtype=torch.float16), "1-D float32"),
    (torch.zeros((3, 4)), torch.zeros((3, 1)), "1-D float32"),
    (torch.zeros((3, 4)), torch.zeros(4), "length"),
    (torch.zeros((3, 4)), torch.zeros(3, device="meta"), "on cpu"),
    (torch.zeros((4, 3)).t(), torch.zeros(3), "contiguous"),
    (torch.zeros((3, 4), device="meta"), torch.zeros(3, device="meta"), "cpu or cuda"),
], ids=["dtype", "rank", "w_dtype", "w_rank", "length", "device", "strided", "meta"])
def test_wrapper_rejects_bad_input(params, weights, match):
    before = k1.launches
    with pytest.raises(ValueError, match=match):
        k1.fedavg_reduce(params, weights)
    assert k1.launches == before


def test_cpu_tensor_takes_the_plain_version_without_counting():
    params, w = _inputs(5, 300, seed=3)
    P, W = torch.from_numpy(params), torch.from_numpy(w)
    before = k1.launches
    out = k1.fedavg_reduce(P, W)
    assert torch.equal(out, k1.fedavg_reduce_plain(P, W))
    assert k1.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("C,N", [
    (30, 800), (30, 32), (30, 1_605_632), (30, 10), (1, 17), (7, 1001),
    (320, 1_605_632), (2050, 4096),
])
def test_kernel_matches_plain_on_gpu(C, N):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    params, w = _inputs(C, N, seed=N, zero_slots=C // 3)
    P, W = torch.from_numpy(params).cuda(), torch.from_numpy(w).cuda()
    before = k1.launches
    out = k1.fedavg_reduce(P, W)
    again = k1.fedavg_reduce(P, W)
    plain = k1.fedavg_reduce_plain(P, W)
    torch.cuda.synchronize()
    assert k1.launches == before + 2
    assert torch.equal(out, again)  # a fixed-order sum: launches repeat bitwise
    torch.testing.assert_close(out, plain, rtol=RTOL, atol=ATOL)


# --- the grouped launch: one K1 call for a whole parameter tree -------------

# the paper CNN's eight leaves (conv1 w/b, conv2 w/b, fc1 w/b, fc2 w/b) at
# MNIST's 28 x 28 input, flattened as fl/server.py flattens them
CNN_LEAVES = [800, 32, 51200, 64, 1_605_632, 512, 5120, 10]


def test_cnn_leaf_sizes_match_the_model():
    from repro_torch.configs.paper_cnn import MNIST_CNN
    from repro_torch.core.draws import GeneratorDraws
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models.cnn import init_params

    sizes = [t.numel() for t in tree_leaves(init_params(GeneratorDraws(0, "cpu"), MNIST_CNN))]
    assert sorted(sizes) == sorted(CNN_LEAVES)


def test_plain_leaves_match_per_leaf_and_pallas():
    """The grouped entry's plain route on the paper CNN's eight leaves at a
    small cohort: bitwise the per-leaf plain version, and within the module
    tolerance of the reference's Pallas kernel run leaf by leaf in
    interpret mode."""
    jnp, ref_ops, _ = _reference()
    rng = np.random.default_rng(7)
    C = 3
    stacks = [rng.standard_normal((C, n)).astype(np.float32) for n in CNN_LEAVES]
    w = np.array([0.5, 0.5, 0.0], np.float32)  # a padded slot, as in a cohort
    before = k1.launches
    got = ops.fedavg_reduce_leaves([torch.from_numpy(s) for s in stacks], torch.from_numpy(w))
    assert k1.launches == before  # the CPU takes the plain version
    assert len(got) == len(CNN_LEAVES)
    for s, out in zip(stacks, got):
        assert out.shape == (s.shape[1],) and out.dtype == torch.float32
        assert torch.equal(out, k1.fedavg_reduce_plain(torch.from_numpy(s), torch.from_numpy(w)))
        pallas = np.asarray(ref_ops.fedavg_reduce(jnp.asarray(s), jnp.asarray(w),
                                                  block_n=min(s.shape[1], 1 << 18)))
        np.testing.assert_allclose(out.numpy(), pallas, rtol=RTOL, atol=ATOL)


def _covered(sizes, vec):
    """Columns each leaf's CTAs cover under ``plan_launches``: the kernel's
    block-to-leaf lookup and column walk, in Python."""
    seen = [np.zeros(n, np.int64) for n in sizes]
    for table in k1.plan_launches(sizes, vec):
        assert 1 <= len(table) <= k1.MAX_LEAVES
        total = table[-1][1]
        for bx in range(total):
            slot = next(j for j, (_, end) in enumerate(table) if bx < end)
            leaf = table[slot][0]
            block = bx - (table[slot - 1][1] if slot else 0)
            cols = k1.VEC_COLS if vec[leaf] else 1
            first = block * k1.THREADS * cols
            for t in range(k1.THREADS):
                lo = first + t * cols
                seen[leaf][lo:min(lo + cols, sizes[leaf])] += 1
    return seen


@pytest.mark.parametrize("sizes,vec", [
    (CNN_LEAVES[:4] + [4100] + CNN_LEAVES[5:], [True] * 8),  # the CNN, fc1 cut short
    ([1, 3, 4, 17, 1024, 1025, 0, 5], [False, False, True, False, True, False, True, False]),
    ([7 * i + 1 for i in range(20)], [i % 3 == 0 for i in range(20)]),  # over 16 leaves
    ([0, 0, 12], [True, False, True]),
], ids=["cnn", "mixed", "twenty", "empty_leaves"])
def test_leaf_table_covers_every_column_once(sizes, vec):
    seen = _covered(sizes, vec)
    for n, s in zip(sizes, seen):
        assert s.shape == (n,) and (s == 1).all()
    plans = k1.plan_launches(sizes, vec)
    assert len(plans) == -(-len(sizes) // k1.MAX_LEAVES)
    assert [i for table in plans for i, _ in table] == list(range(len(sizes)))


def test_leaf_blocks():
    assert k1.leaf_blocks(0, True) == 0
    assert k1.leaf_blocks(1, False) == 1
    assert k1.leaf_blocks(256, False) == 1 and k1.leaf_blocks(257, False) == 2
    assert k1.leaf_blocks(1024, True) == 1 and k1.leaf_blocks(1028, True) == 2
    assert k1.leaf_blocks(1_605_632, True) == 1568


def test_leaves_reject_a_bad_stack_without_counting():
    before = k1.launches
    with pytest.raises(ValueError, match="length"):
        k1.fedavg_reduce_leaves([torch.zeros((3, 4)), torch.zeros((2, 4))], torch.zeros(3))
    assert k1.launches == before


def test_leaves_of_an_empty_tree():
    assert k1.fedavg_reduce_leaves([], torch.zeros(3)) == []


@pytest.mark.cuda
def test_grouped_kernel_is_bitwise_single_leaf_launches_on_gpu():
    """One launch for the CNN's eight leaves; each leaf's sum bitwise equal
    to its own single-leaf launch (the same column walk), and close to the
    plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    rng = np.random.default_rng(11)
    C = 30
    stacks = [torch.from_numpy(rng.standard_normal((C, n)).astype(np.float32)).cuda()
              for n in CNN_LEAVES]
    _, w = _inputs(C, 1, seed=3, zero_slots=15)
    W = torch.from_numpy(w).cuda()
    before = k1.launches
    outs = k1.fedavg_reduce_leaves(stacks, W)
    assert k1.launches == before + 1
    singles = [k1.fedavg_reduce(P, W) for P in stacks]
    torch.cuda.synchronize()
    for P, out, single in zip(stacks, outs, singles):
        assert torch.equal(out, single)
        torch.testing.assert_close(out, k1.fedavg_reduce_plain(P, W), rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_grouped_kernel_cuts_long_trees_on_gpu():
    """21 leaves (mixed vector and scalar, an empty one, an unaligned stack):
    two launches, every leaf bitwise its single-leaf launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    rng = np.random.default_rng(12)
    C = 7
    sizes = [1, 3, 4, 17, 1024, 4096, 0, 5, 8, 33, 64, 100, 7, 12, 16, 31, 4100, 2, 9, 640]
    stacks = [torch.from_numpy(rng.standard_normal((C, n)).astype(np.float32)).cuda()
              for n in sizes]
    buf = torch.from_numpy(rng.standard_normal(C * 1001 + 1).astype(np.float32)).cuda()
    stacks.append(buf[1:].view(C, 1001))  # loses 16-byte alignment
    W = torch.from_numpy(rng.random(C).astype(np.float32)).cuda()
    before = k1.launches
    outs = k1.fedavg_reduce_leaves(stacks, W)
    assert k1.launches == before + 2
    for P, out in zip(stacks, outs):
        assert out.shape == (P.shape[1],)
        if P.shape[1]:
            assert torch.equal(out, k1.fedavg_reduce(P, W))
            torch.testing.assert_close(out, k1.fedavg_reduce_plain(P, W), rtol=RTOL, atol=ATOL)


# --- the segmented route: tier merges of the tiered aggregation -------------

def _segmented_case(case, C=64, N=1001):
    """(stack, weights, seg, num_segments) for one named case."""
    rng = np.random.default_rng(sum(map(ord, case)))
    P = rng.standard_normal((C, N)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, C).astype(np.float32)
    E, seg = 8, rng.integers(0, 8, C)
    if case == "one_node":
        E, seg = 1, np.zeros(C)
    elif case == "own_node":
        E, seg = C, np.arange(C)
    elif case == "nodes64":
        E, seg = 64, rng.integers(0, 64, C)
    elif case == "empty_node":
        seg = np.where(seg == 5, 4, seg)
    elif case == "padded":
        w[C - 10:] = 0.0
        seg[C - 10:] = 0
    elif case == "nan_row":
        P[7, 3] = np.nan
    return P, w, seg.astype(np.int32), E


SEG_CASES = ["one_node", "own_node", "nodes8", "nodes64", "empty_node", "padded",
             "nan_row"]


@pytest.mark.parametrize("case", SEG_CASES)
def test_segmented_plain_keeps_rows_in_their_segment(case):
    P, w, seg, E = _segmented_case(case)
    out = k1.fedavg_reduce_leaves([torch.from_numpy(P)], torch.from_numpy(w),
                                  torch.from_numpy(seg), E)[0].numpy()
    assert out.shape == (E, P.shape[1])
    for e in range(E):
        rows = seg == e
        np.testing.assert_allclose(out[e], (w[rows, None] * P[rows]).sum(0),
                                   rtol=RTOL, atol=ATOL)
    if case == "nan_row":
        assert np.isnan(out).any(axis=1).tolist() == [e == seg[7] for e in range(E)]
    if case == "empty_node":
        assert (out[5] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", SEG_CASES + ["n_mult4", "unaligned"])
def test_segmented_kernel_matches_plain_on_gpu(case):
    """The segmented route against its plain version (``index_add_``) within
    K1's tolerance, NaN rows contained in their segment, empty segments
    exactly 0, launches bitwise repeatable, one launch for the tree."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    P, w, seg, E = _segmented_case(case, N=1024 if case == "n_mult4" else 1001)
    if case == "unaligned":
        buf = torch.from_numpy(np.concatenate([[0.0], P.ravel()]).astype(np.float32))
        Pd = buf.cuda()[1:].view(P.shape)
        assert Pd.data_ptr() % 16
    else:
        Pd = torch.from_numpy(P).cuda()
    small = torch.from_numpy(P[:, :5].copy()).cuda()
    W, S = torch.from_numpy(w).cuda(), torch.from_numpy(seg).cuda()
    before = k1.launches
    out, out_small = k1.fedavg_reduce_leaves([Pd, small], W, S, E)
    again = k1.fedavg_reduce_leaves([Pd, small], W, S, E)[0]
    torch.cuda.synchronize()
    assert k1.launches == before + 2
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))
    for got, stack in ((out, Pd), (out_small, small)):
        plain = k1.segment_reduce_plain(stack.cpu(), W.cpu(), S.cpu(), E)
        torch.testing.assert_close(got.cpu(), plain, rtol=RTOL, atol=ATOL,
                                   equal_nan=True)
    if case == "nan_row":
        assert out.isnan().any(dim=1).cpu().tolist() == [e == seg[7] for e in range(E)]
    if case == "empty_node":
        assert bool((out[5] == 0).all())
