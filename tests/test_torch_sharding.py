"""The port's sharding rules (``repro_torch.sharding``), meshes and pshard
context against the reference's, on the CPU, with no ranks:

* ``params_pspecs`` equal to ``repro.sharding.params_pspecs`` leaf by leaf
  for every arch of ``all_archs()`` (full size: the port's tree on the meta
  device, the reference's from ``jax.eval_shape``) on the mesh shapes
  {data 16, model 16}, {pod 2, data 16, model 16}, {data 2, model 2} and
  {data 1, model 4};
* ``input_specs`` of every applicable (arch, shape) pair: the reference's
  shapes and dtypes, on the meta device; ``batch_pspecs`` and
  ``cache_pspecs`` equal to the reference's on both production meshes;
  long_500k's caches under 14 GB a device, as the reference bounds them;
* ``pshard``'s context, as ``tests/test_pshard.py`` holds the reference's;
* ``shard_tree`` over every rank of a mesh, the blocks concatenated in rank
  order, gives the tree back bit for bit (``unshard_tree`` over live ranks:
  ``tests/test_torch_tp.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import sharding as ref_sharding  # noqa: E402
from repro.configs import INPUT_SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import all_archs as ref_all_archs  # noqa: E402
from repro.models import factory as ref_factory  # noqa: E402
from repro_torch import configs, sharding  # noqa: E402
from repro_torch.core.tree import tree_paths  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_production_mesh  # noqa: E402
from repro_torch.models import factory, pshard  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2},
          "1x4": {"data": 1, "model": 4}}
ARCHS = sorted(configs.all_archs())


def _ref_paths(tree):
    """(path, leaf) in the port's ``tree_paths`` naming."""
    out = []
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            tree, is_leaf=lambda x: isinstance(x, JP)):
        parts = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out.append(("/".join(parts), leaf))
    return out


def _assert_same_specs(port_specs, ref_specs):
    got, want = tree_paths(port_specs), _ref_paths(ref_specs)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert isinstance(a, sharding.P), path
        assert tuple(a) == tuple(b), (path, a, b)


_REF_PARAMS = {}


def _ref_params(arch):
    if arch not in _REF_PARAMS:
        model = ref_factory.build(ref_all_archs()[arch])
        _REF_PARAMS[arch] = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    return _REF_PARAMS[arch]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_params_pspecs_match_the_reference(arch, mesh):
    shape_only = Mesh(MESHES[mesh])
    abstract = factory.abstract_params(configs.get_arch(arch))
    assert all(t.device.type == "meta" for _, t in tree_paths(abstract))
    ref = _ref_params(arch)
    assert [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for _, t in tree_paths(abstract)] == \
        [(tuple(t.shape), str(t.dtype)) for _, t in _ref_paths(ref)]
    _assert_same_specs(sharding.params_pspecs(abstract, shape_only),
                       ref_sharding.params_pspecs(ref, shape_only))


def _bytes_per_device(tree, specs, mesh) -> float:
    total = 0.0
    for (_, leaf), (_, spec) in zip(tree_paths(tree), tree_paths(specs)):
        n = leaf.numel() * leaf.element_size()
        for ax in spec:
            if ax is not None:
                n /= sharding.mesh_axis_size(mesh, ax)
        total += n
    return total


@pytest.mark.parametrize("shape", sorted(REF_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_batch_cache_pspecs_match_the_reference(arch, shape):
    cfg, sc = configs.get_arch(arch), configs.INPUT_SHAPES[shape]
    ok, why = configs.shape_applicable(cfg, sc)
    assert (ok, why) == ref_sharding_applicable(arch, shape)
    if not ok:
        return
    specs = factory.input_specs(cfg, sc)
    ref = ref_factory.input_specs(ref_all_archs()[arch], REF_SHAPES[shape])
    got, want = tree_paths(specs), _ref_paths(ref)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.device.type == "meta", path  # nothing allocated
        assert (tuple(a.shape), str(a.dtype).replace("torch.", "")) == \
            (tuple(b.shape), str(b.dtype)), path
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        if sc.mode == "decode":
            port = sharding.cache_pspecs(specs["caches"], mesh)
            _assert_same_specs(port, ref_sharding.cache_pspecs(ref["caches"], mesh))
            if shape == "long_500k" and not multi:
                total = _bytes_per_device(specs["caches"], port, mesh)
                assert total < 14e9, (arch, f"{total / 1e9:.1f} GB/device")
        else:
            _assert_same_specs(sharding.batch_pspecs(specs, mesh),
                               ref_sharding.batch_pspecs(ref, mesh))


def ref_sharding_applicable(arch, shape):
    from repro.configs import shape_applicable

    return shape_applicable(ref_all_archs()[arch], REF_SHAPES[shape])


def test_production_meshes_are_abstract():
    m = make_production_mesh()
    assert m.shape == {"data": 16, "model": 16} and m.abstract and m.size == 256
    m2 = make_production_mesh(multi_pod=True)
    assert m2.axis_names == ("pod", "data", "model") and m2.size == 512
    with pytest.raises(ValueError):
        m.index("model")
    assert sharding.dp_axes(m2) == ("pod", "data")
    assert sharding.mesh_axis_size(m2, ("pod", "data")) == 32


def test_constrain_noop_without_mesh():
    x = torch.ones((4, 8))
    assert pshard.constrain(x, "data", "model") is x


def test_axis_size_and_dp_without_mesh():
    assert pshard.axis_size("model") == 1
    assert pshard.dp() == ()


def test_mesh_context_restores():
    m = Mesh({"data": 4, "model": 2})
    assert pshard.current_mesh() is None
    with pshard.mesh_context(m):
        assert pshard.current_mesh() is m
        assert pshard.axis_size("model") == 2
        assert pshard.axis_size(("data", "model")) == 8
        assert pshard.dp() == ("data",)
        x = torch.ones((4, 8))
        assert pshard.constrain(x, ("data",), "model") is x  # eager: the block as it is
    assert pshard.current_mesh() is None


def test_collectives_are_the_identity_without_ranks():
    x = torch.randn(4, 6)
    for y in (pshard.psum(x, "model"), pshard.copy(x, "model"),
              pshard.all_gather(x, "model", 1), pshard.reduce_scatter(x, "model", 0),
              pshard.split(x, "model", 1), pshard.one_owner(x, "data")):
        assert y is x


@pytest.mark.parametrize("mesh", ["2x2", "1x4", "2x16x16"])
def test_shard_tree_blocks_tile_the_tree(mesh):
    """Every rank's ``shard_tree`` blocks, concatenated in rank order over
    each sharded dim, give the full tree bit for bit (tinyllama reduced)."""
    shape = MESHES[mesh] if mesh != "2x16x16" else {"pod": 2, "data": 2, "model": 2}
    cfg = configs.get_arch("tinyllama-1.1b").reduced()
    full = factory.build(cfg).init(torch.Generator().manual_seed(0))
    specs = sharding.params_pspecs(full, Mesh(shape))
    names = list(shape)
    coords = [dict(zip(names, np.unravel_index(r, [shape[n] for n in names])))
              for r in range(int(np.prod([shape[n] for n in names])))]
    blocks = [sharding.shard_tree(full, specs, Mesh(shape, {k: int(v) for k, v in c.items()}))
              for c in coords]
    for (path, leaf), (_, spec) in zip(tree_paths(full), tree_paths(specs)):
        parts = {tuple(c.items()): dict(tree_paths(b))[path] for c, b in zip(coords, blocks)}
        mesh0 = Mesh(shape, {n: 0 for n in names})
        assert tuple(parts[tuple(coords[0].items())].shape) == \
            sharding.local_shape(leaf.shape, spec, mesh0)

        def assemble(fixed, dim):
            if dim == leaf.dim():
                key = tuple((n, fixed.get(n, 0)) for n in names)
                return parts[key]
            ax = spec[dim]
            axes = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
            if not axes:
                return assemble(fixed, dim + 1)
            sizes = [shape.get(a, 1) for a in axes]
            cat = []
            for idx in np.ndindex(*sizes):
                cat.append(assemble({**fixed, **dict(zip(axes, map(int, idx)))}, dim + 1))
            return torch.cat(cat, dim)

        got = assemble({}, 0)
        assert torch.equal(got, leaf), path
