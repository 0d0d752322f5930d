"""The serving tier's arrival process against the reference
(``repro.sim.arrivals``): the validation messages, ``from_profile``, and a
trace replayed from the reference's draws (``sample_requests`` splits its
key in three: the Poisson counts, the length normals, the prompt
integers; fed through ``ReplayDraws``) equal to the reference's trace
exactly: ticks, prompts and generation lengths. The port's own generator
draws give a trace of the same shape and laws.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.sim import arrivals as ref_arr  # noqa: E402
from repro.sim import get_profile as ref_get_profile  # noqa: E402
from repro_torch.core.draws import GeneratorDraws, ReplayDraws  # noqa: E402
from repro_torch.sim import arrivals, get_profile  # noqa: E402
from _torch_threads import _worker_threads  # noqa: E402,F401


def _message(cls, *args):
    with pytest.raises(ValueError) as info:
        cls(*args)
    return str(info.value)


@pytest.mark.parametrize("args", [("x", -0.5, 4, 4), ("x", 1.0, 0, 4), ("x", 1.0, 4, 0)])
def test_validation_messages_equal_reference(args):
    assert _message(arrivals.ArrivalProcess, *args) == _message(ref_arr.ArrivalProcess, *args)


@pytest.mark.parametrize("profile", ["lognormal", "uniform"])
def test_from_profile_equals_reference(profile):
    got = arrivals.from_profile(get_profile(profile), 1.5, 16, 32)
    want = ref_arr.from_profile(ref_get_profile(profile), 1.5, 16, 32)
    assert (got.name, got.rate, got.prompt_len, got.gen_len) == (
        want.name, want.rate, want.prompt_len, want.gen_len)
    assert got.len_spread == pytest.approx(want.len_spread, abs=0)


def _replayed(key, proc, ticks, vocab):
    """The reference's primitive draws under its split of ``key``."""
    k_cnt, k_len, k_tok = jax.random.split(key, 3)
    counts = np.asarray(jax.random.poisson(k_cnt, proc.rate, (ticks,)))
    total = int(counts.sum())
    init = {"counts": counts,
            "prompt": np.asarray(jax.random.randint(k_tok, (total, proc.prompt_len), 0,
                                                    vocab, jnp.int32))}
    if proc.len_spread:
        init["gen_len"] = np.asarray(jax.random.normal(k_len, (total,)))
    return ReplayDraws(init, [], "cpu")


@pytest.mark.parametrize("profile,rate,gen", [("lognormal", 1.0, 32), ("lognormal", 2.5, 8),
                                              ("uniform", 1.0, 8)])
def test_replayed_trace_equals_reference(profile, rate, gen):
    proc = arrivals.from_profile(get_profile(profile), rate, 8, gen)
    ref_proc = ref_arr.from_profile(ref_get_profile(profile), rate, 8, gen)
    key = jax.random.PRNGKey(17)
    want = ref_arr.sample_requests(key, ref_proc, 40, 512)
    got = arrivals.sample_requests(_replayed(key, ref_proc, 40, 512), proc, 40, 512)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert (a.rid, a.tick, a.gen_len) == (b.rid, b.tick, b.gen_len)
        assert a.prompt.dtype == np.int32
        np.testing.assert_array_equal(a.prompt, b.prompt)
    lens = np.array([r.gen_len for r in got])
    assert lens.min() >= 1 and lens.max() <= 2 * gen
    assert (len(set(lens)) > 1) == (profile != "uniform")


def test_generator_trace_shape_and_laws():
    proc = arrivals.from_profile(get_profile("lognormal"), 2.0, 6, 16)
    reqs = arrivals.sample_requests(GeneratorDraws(0, "cpu"), proc, 400, 100)
    counts = np.bincount([r.tick for r in reqs], minlength=400)
    assert counts.mean() == pytest.approx(2.0, rel=0.1)
    assert counts.var() == pytest.approx(2.0, rel=0.2)  # Poisson: var = mean
    lens = np.array([r.gen_len for r in reqs])
    assert 1 <= lens.min() and lens.max() <= 32
    assert np.median(lens) == pytest.approx(16, abs=2)
    assert [r.rid for r in reqs] == list(range(len(reqs)))
    assert all(r.prompt.shape == (6,) and 0 <= r.prompt.min() and r.prompt.max() < 100
               for r in reqs)
    again = arrivals.sample_requests(GeneratorDraws(0, "cpu"), proc, 400, 100)
    assert all(np.array_equal(a.prompt, b.prompt) and a.gen_len == b.gen_len
               for a, b in zip(reqs, again))
