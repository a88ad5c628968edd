"""The traffic generator follows its mix file and depends on the seed only
for token ids and order."""

from __future__ import annotations

import json
import math
import statistics

import pytest

from portbench import traffic
from portbench.tests.conftest import ROOT

MIXES = ROOT / "portbench" / "traffic"


def mix(name, **extra):
    m = json.loads((MIXES / f"{name}.json").read_text())
    m.update(extra)
    return m


def sizes(plan):
    gaps = [r.due_s for r in plan.requests if r.due_s is not None]
    gaps = sorted(round(b - a, 9) for a, b in zip([0.0] + gaps, gaps))
    return (sorted(r.isl for r in plan.requests),
            sorted(r.osl for r in plan.requests), gaps)


@pytest.mark.parametrize("name,extra", [
    ("prefill-heavy", {"rate_rps": 4.8}),
    ("decode-heavy", {}),
])
def test_deterministic_per_seed(name, extra):
    a = traffic.build(mix(name, **extra), 2**31 + 5, 40, 32768)
    b = traffic.build(mix(name, **extra), 2**31 + 5, 40, 32768)
    c = traffic.build(mix(name, **extra), 2**31 + 6, 40, 32768)
    key = [(r.isl, r.osl, r.due_s, r.client, r.token_ids) for r in a.requests]
    assert key == [(r.isl, r.osl, r.due_s, r.client, r.token_ids)
                   for r in b.requests]
    assert key != [(r.isl, r.osl, r.due_s, r.client, r.token_ids)
                   for r in c.requests]
    # another seed: the same sizes, in another order
    assert sizes(a) == sizes(c)


def test_open_loop_follows_its_file():
    m = mix("prefill-heavy", rate_rps=4.8)
    plan = traffic.build(m, 123, 40, 32768)
    n = math.floor(4.8 * 40)
    assert len(plan.requests) == n
    due = [r.due_s for r in plan.requests]
    assert due == sorted(due) and 0 < due[0] and due[-1] < 40
    # Poisson at the rate: the mean gap is close to 1 / rate
    assert abs(due[-1] / n - 1 / 4.8) < 0.05 / 4.8
    isl = [r.isl for r in plan.requests]
    osl = [r.osl for r in plan.requests]
    assert min(isl) >= 512 and max(isl) == 6144
    assert abs(statistics.median(isl) / 2048 - 1) < 0.05
    assert 32 <= min(osl) and max(osl) <= 128
    assert all(len(r.token_ids) == r.isl for r in plan.requests)
    assert all(0 < t < 32768 for r in plan.requests for t in r.token_ids)
    # every block of order_block requests holds the same set of sizes
    k = m["order_block"]
    blocks = [sorted(isl[i:i + k]) for i in range(0, n - n % k, k)]
    assert all(b == blocks[0] for b in blocks)


def test_closed_loop_follows_its_file():
    m = mix("decode-heavy")
    plan = traffic.build(m, 99, 40, 32000)
    c, k, n = m["clients"], m["requests_per_client"], m["rounds"]
    assert len(plan.clients) == c
    assert all(len(q) == k * n for q in plan.clients)
    # a later round repeats the client's sizes with token ids of its own
    for q in plan.clients:
        assert [r.round for r in q] == [i // k for i in range(k * n)]
        for i in range(k, k * n):
            assert (q[i].isl, q[i].osl) == (q[i % k].isl, q[i % k].osl)
            assert q[i].token_ids != q[i % k].token_ids
    firsts = [q[0].osl for q in plan.clients]
    rest = [r.osl for q in plan.clients for r in q[1:k]]
    assert min(firsts) >= m["first_osl"]["min"]
    assert max(firsts) <= m["first_osl"]["max"]
    assert m["osl"]["min"] <= min(rest) and max(rest) <= m["osl"]["max"]
    isl = [r.isl for r in plan.requests]
    assert min(isl) >= 64 and max(isl) <= 1024
    assert abs(statistics.median(isl) / 256 - 1) < 0.05


def test_quantiles_of_each_distribution():
    assert list(traffic.quantiles({"dist": "uniform", "min": 1, "max": 4},
                                  4)) == [1, 2, 3, 4]
    assert list(traffic.quantiles({"dist": "fixed", "value": 7}, 3)) \
        == [7, 7, 7]
    with pytest.raises(ValueError):
        traffic.quantiles({"dist": "zipf"}, 3)


def test_rounds_leave_the_first_round_as_it_was():
    one = traffic.build(mix("decode-heavy", rounds=1), 2**31 + 3, 50, 32000)
    four = traffic.build(mix("decode-heavy", rounds=4), 2**31 + 3, 50,
                         32000)
    key = lambda r: (r.idx, r.isl, r.osl, r.client, r.token_ids)  # noqa
    assert [key(r) for r in one.requests] == \
        [key(r) for r in four.requests[:len(one.requests)]]


def test_unknown_arrivals_are_refused():
    with pytest.raises(ValueError, match="arrivals"):
        traffic.build(mix("prefill-heavy", rate_rps=4.8, arrivals="bursty"),
                      1, 10, 32768)
