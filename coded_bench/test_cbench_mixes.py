"""Each mix's draws for fixed seeds, and the files each mix names."""
import itertools

import numpy as np
import pytest
import torch

from coded_bench import run, spec, traffic

coded = spec.module("problems", "coded_matmul")
MIXES = sorted(p.stem for p in (spec.HERE / "mixes").glob("*.json"))


def _take(it, n):
    return list(itertools.islice(it, n))


def test_first_tau_is_uniform_over_the_sets():
    reqs = _take(traffic.requests(spec.mix("direct-first-tau"), 10, 4, 12345), 21000)
    assert all(r.erasure["mask"].sum() == 4 for r in reqs)
    counts = {}
    for r in reqs:
        key = tuple(np.flatnonzero(r.erasure["mask"]))
        counts[key] = counts.get(key, 0) + 1
    assert len(counts) == 210
    expected = 21000 / 210
    chi2 = sum((c - expected) ** 2 / expected for c in counts.values())
    assert chi2 < 300          # 209 degrees of freedom: mean 209, sd about 20
    assert [r.pair for r in reqs[:6]] == [0, 1, 2, 3, 0, 1]


def test_first_tau_at_nine_of_ten():
    reqs = _take(traffic.requests(spec.mix("direct-first-tau"), 10, 9, 7), 2000)
    assert all(r.erasure["mask"].sum() == 9 for r in reqs)
    assert len({tuple(r.erasure["mask"]) for r in reqs}) == 10


def test_draws_follow_the_seed_whatever_its_size():
    mix = spec.mix("direct-first-tau")
    for seed in (0, 2**31 + 17, 2**40 + 3):
        a = _take(traffic.requests(mix, 10, 9, seed), 1100)
        b = _take(traffic.requests(mix, 10, 9, seed), 1100)
        assert all(np.array_equal(x.erasure["mask"], y.erasure["mask"])
                   for x, y in zip(a, b))
    c = _take(traffic.requests(mix, 10, 9, 1), 50)
    d = _take(traffic.requests(mix, 10, 9, 2), 50)
    assert any(not np.array_equal(x.erasure["mask"], y.erasure["mask"])
               for x, y in zip(c, d))


@pytest.mark.parametrize("tau", [4, 9])
def test_progress_leaves_tau_finishers_on_every_chunk(tau):
    mix = spec.mix("partial-stragglers-q4")
    Q = mix["erasures"]["sub_tasks"]
    reqs = _take(traffic.requests(mix, 10, tau, 99), 300)
    partial = 0
    for r in reqs:
        counts = np.round(r.erasure["progress"] * Q).astype(int)
        holds = (np.arange(Q)[:, None] - np.arange(10)[None, :]) % Q
        cover = (holds < counts).sum(axis=1)
        assert np.all(cover >= tau)
        # the first such moment: one chunk fewer somewhere would undercover
        assert np.any(cover == tau)
        partial += np.any((counts > 0) & (counts < Q))
    assert partial > 0


def test_chunk_counts_waits_for_the_slowest_needed_chunk():
    draws = spec.module("draws", "random_stragglers")
    times = np.array([1.0] * 4 + [10.0] * 6)
    counts = draws.chunk_counts(times, Q=1, tau=4)
    assert counts.tolist() == [1] * 4 + [0] * 6


def test_serve_feed_keeps_its_slow_set_for_six_steps():
    params = spec.mix("adaptive-serve-feed")["worker_times"]
    feed = traffic.model(params).feed(params, 10, 5)
    rng = np.random.default_rng(0)
    slow_sets = []
    for step in range(18):
        t = feed(step, rng)
        assert t.shape == (10,) and np.all(t >= 1.0)
        slow_sets.append(frozenset(np.flatnonzero(t >= 2.0)))
    for block in range(3):
        sets = slow_sets[6 * block:6 * block + 6]
        common = frozenset.intersection(*sets)
        assert len(common) == 2       # round(0.25 * 10) persistent stragglers


def test_a_mix_without_erasures_sends_operands_alone():
    reqs = _take(traffic.requests(spec.mix("adaptive-serve-feed"), 10, 9, 3), 5)
    assert [r.pair for r in reqs] == [0, 1, 2, 3, 0]
    assert all(r.erasure == {} for r in reqs)


def test_operands_are_seeded_integers_in_the_bound():
    cfg = dict(v=16, r=8, t=12, entry_max=3)
    A, B = coded.make_operands(4, cfg, 2**33 + 1, torch.device("cpu"))
    A2, _ = coded.make_operands(4, cfg, 2**33 + 1, torch.device("cpu"))
    assert A.shape == (4, 16, 8) and B.shape == (4, 16, 12)
    assert A.dtype == torch.float64 and torch.equal(A, A2)
    assert A.min() >= 0 and A.max() <= 3 and torch.equal(A, A.round())
    assert set(A.unique().tolist()) == {0.0, 1.0, 2.0, 3.0}


@pytest.mark.parametrize("name", MIXES)
def test_mix_names_its_files(name):
    mix = spec.mix(name)
    assert hasattr(spec.module("entries", mix["entry"]), "Entry")
    assert hasattr(spec.module("loops", mix["loop"]), "serve")
    assert mix["operand_pool"] >= 1
    if "erasures" in mix:
        assert hasattr(traffic.model(mix["erasures"]), "draw")
    if "worker_times" in mix:
        assert hasattr(traffic.model(mix["worker_times"]), "feed")


def test_the_closed_loop_refuses_more_than_one_in_flight():
    mix = dict(spec.mix("direct-first-tau"), in_flight=2)
    ctx = run.Context("x", {}, mix, 1, 0.1, False, torch.device("cpu"),
                      torch.float64, 1)
    with pytest.raises(ValueError, match="one request in flight"):
        spec.module("loops", "closed").serve(ctx, iter(()))


def test_an_unknown_file_is_refused_by_name():
    with pytest.raises(KeyError, match="loops"):
        spec.module("loops", "open")
