"""The version store over the async engine's ring against the reference
(``repro.serve.store``), on the reduced tinyllama's seed-0 params (f32,
the same arrays in both packages):

* read clipping to ``[max(latest - (H - 1), 0), latest]``, before and after
  the ring's first wrap, and ``ring_miss``: every read's version, staleness
  and flag equal the reference's, and its params are views of the ring
  slot, bitwise the reference's slot;
* ``AsyncEngine.ring_snapshot`` of the port's engine: the state's own
  tensors (no copy), and the head read bitwise ``state["params"]``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.serve import VersionStore as RefStore  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.paper_cnn import MNIST_CNN  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.data.synthetic import make_image_dataset  # noqa: E402
from repro_torch.engine import AsyncEngine, RunConfig  # noqa: E402
from repro_torch.fl import make_cnn_task  # noqa: E402
from repro_torch.models import factory  # noqa: E402
from repro_torch.serve import VersionStore  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

ARCH = "tinyllama-1.1b"


@pytest.fixture(scope="module")
def ref_params():
    """The reduced tinyllama's seed-0 params (the port's init) as numpy."""
    model = factory.build(get_arch(ARCH).reduced())
    return convert.lm_params_to_jax(model.init(torch.Generator().manual_seed(0)))


def _stores(ref_params, h, latest):
    """The reference's synthetic ring (slot v % h carries version v's params
    times 1 + 0.01 v) and the port's store over the same arrays."""
    lo = max(latest - (h - 1), 0)
    slot_ver = [0] * h
    for v in range(lo, latest + 1):
        slot_ver[v % h] = v
    hist = jax.tree.map(lambda p: np.stack([p * np.float32(1.0 + 0.01 * v)
                                            for v in slot_ver]), ref_params)
    ref = RefStore(jax.tree.map(jnp.asarray, hist), jnp.asarray(latest, jnp.int32), h)
    port = VersionStore(convert.lm_params_from_jax(hist, "cpu"),
                        torch.tensor(latest, dtype=torch.int32), h)
    return ref, port


@pytest.mark.parametrize("h,latest", [(4, 10), (4, 1), (3, 0), (1, 5)])
def test_read_clipping_equals_reference(ref_params, h, latest):
    ref, port = _stores(ref_params, h, latest)
    assert port.latest == ref.latest == latest
    assert port.oldest_retained == ref.oldest_retained
    assert port.retained_versions() == ref.retained_versions()
    for v in range(-3, latest + 4):
        got, want = port.read(v), ref.read(v)
        for name in ("read_ver", "staleness", "ring_miss"):
            t = getattr(got, name)
            assert isinstance(t, torch.Tensor) and t.shape == ()
            assert t.item() == getattr(want, name).item(), (v, name)
        assert got.read_ver.dtype == got.staleness.dtype == torch.int32
        assert got.ring_miss.dtype == torch.bool
        slot = got.read_ver.item() % h
        for a, b, ring in zip(tree_leaves(got.params), jax.tree.leaves(want.params),
                              tree_leaves(port.hist)):
            assert a.data_ptr() == ring[slot].data_ptr()  # a view of the slot
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_window_after_and_before_the_first_wrap(ref_params):
    _, port = _stores(ref_params, 4, 10)  # retained: 7..10
    assert port.retained_versions() == [7, 8, 9, 10]
    assert [port.read(v).read_ver.item() for v in (6, 3, 0, -2)] == [7] * 4
    assert [port.read(v).staleness.item() for v in (6, 7, 10, 99)] == [3, 3, 0, 0]
    assert not port.read(7).ring_miss.item() and port.read(6).ring_miss.item()
    assert not port.read(99).ring_miss.item()  # a future clips to the head, no miss
    _, early = _stores(ref_params, 4, 1)  # ring not yet wrapped
    assert early.oldest_retained == 0
    assert early.read(-3).read_ver.item() == 0 and early.read(5).read_ver.item() == 1
    # a 0-d tensor version reads like an int
    assert early.read(torch.tensor(1)).read_ver.item() == 1


SMALL_CNN = dataclasses.replace(MNIST_CNN, name="paper-cnn-mnist-small", image_size=16,
                                conv_channels=(8, 16), fc_width=64)


def test_ring_snapshot_of_the_port_engine():
    train, test = make_image_dataset("mnist-small", 10, 16, 1, 600, 500, seed=0,
                                     difficulty=0.8)
    task = make_cnn_task(SMALL_CNN, train, test, n_clients=12, device="cpu")
    cfg = RunConfig(mode="async", n_clients=12, k=3, m=4, policy="markov", rounds=6,
                    local_epochs=1, batch_size=10, eval_every=6, max_versions=4,
                    collect_history=False)
    engine = AsyncEngine(task, cfg)
    state = engine.init()
    state, _ = engine.run_chunk(state, 0, 6, False)
    hist, version, h = engine.ring_snapshot(state)
    assert hist is state["hist"] and version is state["version"] and h == 4
    store = VersionStore.from_engine(engine, state)
    latest = int(state["version"])
    assert store.max_versions == 4 and store.latest == latest and latest >= 4
    head = store.read(latest)
    assert head.staleness.item() == 0 and not head.ring_miss.item()
    for a, b in zip(tree_leaves(head.params), tree_leaves(state["params"])):
        assert torch.equal(a, b)
    old = store.read(latest - 10)
    assert old.read_ver.item() == max(latest - 3, 0) and old.ring_miss.item()
