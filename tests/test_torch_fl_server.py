"""The port's FedAvg server (``repro_torch.fl.server``) against the
reference's ``repro.fl.server`` on the same inputs.

``cohort_indices`` must equal the reference exactly (it decides which
clients train). ``fedavg_aggregate`` agrees within rtol 1e-6 / atol 1e-6
on both branches: the port's plain branch sums as the reference's jnp
branch does, and its kernel branch goes to K1's plain version on the CPU,
whose sum runs in another order than the Pallas dot.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.fl import server as ref_server  # noqa: E402
from repro_torch.fl import server  # noqa: E402
from repro_torch.kernels import fedavg_reduce as k1  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401


def _mask(n, count, seed):
    rng = np.random.default_rng(seed)
    sel = np.zeros(n, bool)
    sel[rng.choice(n, size=count, replace=False)] = True
    return sel


@pytest.mark.parametrize("n,count,width", [
    (20, 0, 6),      # empty cohort
    (20, 20, 20),    # full fleet
    (20, 6, 6),      # exactly width
    (20, 11, 6),     # overflow: the highest indices drop
    (48, 9, 19),     # a markov-sized cohort with padding
    (1, 1, 1),
])
def test_cohort_indices_equal_the_reference(n, count, width):
    sel = _mask(n, count, seed=n * 100 + count)
    idx, w = server.cohort_indices(torch.from_numpy(sel), width)
    ridx, rw = ref_server.cohort_indices(jnp.asarray(sel), width)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(w.numpy(), np.asarray(rw))
    assert idx.dtype == torch.int64 and w.dtype == torch.float32
    assert int(w.sum()) == min(count, width)


def _trees(seed, C=5):
    rng = np.random.default_rng(seed)
    g = {"a": {"w": rng.standard_normal((4, 3)).astype(np.float32)},
         "b": rng.standard_normal((7,)).astype(np.float32)}
    c = {"a": {"w": rng.standard_normal((C, 4, 3)).astype(np.float32)},
         "b": rng.standard_normal((C, 7)).astype(np.float32)}
    return g, c


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else torch.from_numpy(v) for k, v in tree.items()}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + ".")
        else:
            yield prefix + k, np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)


@pytest.mark.parametrize("port_kernel", [False, True], ids=["port_plain", "port_k1"])
@pytest.mark.parametrize("ref_kernel", [False, True], ids=["ref_jnp", "ref_pallas"])
@pytest.mark.parametrize("weights", [
    [1, 1, 0, 1, 0], [0.5, 2, 1, 1, 0.25], [0, 0, 0, 0, 0],
], ids=["mask", "weighted", "empty"])
def test_fedavg_aggregate_matches_the_reference(port_kernel, ref_kernel, weights):
    g, c = _trees(seed=len(weights) + int(sum(weights) * 4))
    w = np.asarray(weights, np.float32)
    before = k1.launches
    got = server.fedavg_aggregate(_t(g), _t(c), torch.from_numpy(w),
                                  use_kernel=port_kernel)
    assert k1.launches == before  # the CPU takes K1's plain version
    exp = ref_server.fedavg_aggregate(
        {"a": {"w": jnp.asarray(g["a"]["w"])}, "b": jnp.asarray(g["b"])},
        {"a": {"w": jnp.asarray(c["a"]["w"])}, "b": jnp.asarray(c["b"])},
        jnp.asarray(w), use_kernel=ref_kernel)
    got_f, exp_f = dict(_flat(got)), dict(_flat(exp))
    assert got_f.keys() == exp_f.keys()
    for key, val in exp_f.items():
        np.testing.assert_allclose(got_f[key], val, rtol=1e-6, atol=1e-6, err_msg=key)
        if not w.any():  # an empty cohort keeps the global params exactly
            np.testing.assert_array_equal(got_f[key], dict(_flat(g))[key])


def test_broadcast_to_cohort_is_a_view():
    p = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    b = server.broadcast_to_cohort(p, 4)
    assert b["w"].shape == (4, 2, 3) and b["w"].stride(0) == 0
    assert b["w"].data_ptr() == p["w"].data_ptr()
    np.testing.assert_array_equal(
        b["w"].numpy(),
        np.asarray(ref_server.broadcast_to_cohort({"w": jnp.asarray(p["w"].numpy())}, 4)["w"]))
