"""The traffic generator: seeded, within the mix's ranges."""
import json

import numpy as np
import pytest

from bench import harness, traffic


def _cfg(name):
    return json.loads((harness.ROOT / "configs" / f"{name}.json").read_text())


def _mix(name):
    return json.loads((harness.ROOT / "traffic" / f"{name}.json").read_text())


def _count(preds):
    return 1000 * (1 + sum(a for a, _ in preds))


@pytest.mark.parametrize("seed", [0, 2**31 + 12345, 3 * 2**40])
def test_streams_are_seeded_and_in_range(seed):
    cfg, mix = _cfg("synth-fig3"), _mix("browse-open")
    a = traffic.QueryStream(cfg, mix, seed, traffic.STREAM_WINDOW, _count).take(300)
    b = traffic.QueryStream(cfg, mix, seed, traffic.STREAM_WINDOW, _count).take(300)
    c = traffic.QueryStream(cfg, mix, seed + 1, traffic.STREAM_WINDOW, _count).take(300)
    assert a == b and a != c
    for q in a:
        attrs = [p[0] for p in q.predicates]
        assert attrs in cfg["templates"] and q.op == "and"
        assert all(v in cfg["values"][at] for at, v in q.predicates)
        assert q.k in {max(int(r * _count(q.predicates)), 1) for r in cfg["sample_rates"]}


def test_every_seed_deals_the_same_pool():
    cfg, mix = _cfg("synth-fig3"), _mix("browse-open")
    n = int(mix["pool"])
    a = traffic.QueryStream(cfg, mix, 1, traffic.STREAM_WINDOW, _count).take(n)
    b = traffic.QueryStream(cfg, mix, 2, traffic.STREAM_WINDOW, _count).take(n)
    assert a != b and sorted(a, key=repr) == sorted(b, key=repr)
    # the browse and sample mixes draw the same queries; only their arrivals differ
    c = traffic.QueryStream(cfg, _mix("sample-closed"), 1, traffic.STREAM_WINDOW, _count).take(n)
    assert c == a


def test_templates_take_k_from_the_matches():
    cfg, mix = _cfg("synth-fig3"), _mix("sample-closed")
    seen = []

    def count(preds):
        seen.append(preds)
        return 123_456

    stream = traffic.QueryStream(cfg, mix, 7, traffic.STREAM_WINDOW, count)
    qs = stream.take(len(stream.pool))
    strata = len(cfg["templates"]) * len(cfg["sample_rates"])
    for q in qs:
        assert [p[0] for p in q.predicates] in cfg["templates"]
        assert q.k in {max(int(r * 123_456), 1) for r in cfg["sample_rates"]}
        assert q.op == "and"
    # every (template, rate) pair is equally common in the pool
    pairs = {}
    for q in qs:
        key = (tuple(p[0] for p in q.predicates), q.k)
        pairs[key] = pairs.get(key, 0) + 1
    assert len(pairs) == strata and set(pairs.values()) == {len(qs) // strata}
    assert len(seen) == len(set(seen))  # each distinct query counted once
    with pytest.raises(ValueError):
        traffic.QueryStream(cfg, dict(mix, queries="random_pairs"), 7, traffic.STREAM_WINDOW,
                            count)


def test_poisson_arrivals():
    t = traffic.poisson_arrivals(1000.0, 5.0, 99, 4096)
    assert np.all(np.diff(t) > 0) and t[0] >= 0 and t[-1] < 5.0
    assert abs(t.size - 5000) < 5 * np.sqrt(5000)
    np.testing.assert_array_equal(t, traffic.poisson_arrivals(1000.0, 5.0, 99, 4096))
    other = traffic.poisson_arrivals(1000.0, 5.0, 100, 4096)
    assert not np.array_equal(t[:100], other[:100])
    assert abs(other.size - t.size) < 100  # the same gaps, in another order
