"""The one traffic generator: a mix's parameters in, the run's requests out.

A mix is a data file under ``traffic/`` (see ``prefill-heavy.json``); a
cell may add or override parameters in ``cells/<cell>.json`` (its fixed
rate). The seed draws the prompts' token ids and the ORDER of sizes and
gaps, never the sizes themselves: every seed gets the same set of prompt
lengths, output lengths and inter-arrival gaps (stratified quantiles of the
mix's distributions), so runs on different seeds do the same amount of
work in another order.

- ``loop: open``: Poisson arrivals (``arrivals: poisson``, the one kind
  there is) at ``rate_rps``; ``floor(rate * seconds)`` requests, each with a due time inside the window. With
  ``order_block: k`` every run of k consecutive requests holds the same
  stratified set of sizes and gaps, so a seed reorders requests within a
  block and cannot bunch the long prompts of the whole window together.
- ``order_seed``: the order is drawn once from this number, not from the
  run's seed: every run serves one fixed request set (a replayed trace),
  which the run's seed rotates by whole blocks (open loop) or hands round
  the clients (closed loop), and whose token ids it draws. At 0.8 of the
  knee the order alone moves the tail of the first-token time by ~18%
  from seed to seed (the same seed repeats within ~1%).
- ``loop: closed``: ``clients`` clients, each with its own queue of
  ``requests_per_client`` requests, sending the next when the last ends.
  A client's first request takes its output length from ``first_osl``
  when the mix gives it (a residual life, so the clients do not all end
  their first request together). With ``rounds: r`` a client that has
  sent its queue starts it again, ``r`` times in all: the same sizes with
  token ids of their own, drawn after every first-round request's, so
  adding rounds leaves the first round as it was. Rounds keep a client
  busy to the window's end however fast the program serves.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from statistics import NormalDist
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Req:
    idx: int
    isl: int
    osl: int
    token_ids: List[int] = field(repr=False)
    due_s: Optional[float] = None    # offset from the window's start (open)
    client: int = -1                 # closed loop
    round: int = 0                   # closed loop: the pass over the queue


@dataclass
class Plan:
    loop: str
    requests: List[Req]              # open: by due time; closed: all
    clients: List[List[Req]]         # closed: each client's queue


def _grid(n: int) -> np.ndarray:
    """n stratified probabilities in (0, 1)."""
    return (np.arange(n) + 0.5) / n


def quantiles(dist: Dict, n: int) -> np.ndarray:
    """n integer sizes at stratified quantiles of ``dist``."""
    u = _grid(n)
    kind = dist["dist"]
    if kind == "lognormal":
        z = np.array([NormalDist().inv_cdf(p) for p in u])
        x = dist["median"] * np.exp(dist["sigma"] * z)
    elif kind == "uniform":
        lo, hi = dist["min"], dist["max"]
        x = lo + np.floor(u * (hi - lo + 1))
    elif kind == "fixed":
        x = np.full(n, dist["value"], dtype=np.float64)
    else:
        raise ValueError(f"unknown size distribution {kind!r}")
    lo, hi = dist.get("min", 1), dist.get("max", math.inf)
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def exp_gaps(rate: float, n: int) -> np.ndarray:
    """n inter-arrival gaps at stratified quantiles of Exp(rate)."""
    return -np.log1p(-_grid(n)) / rate


def blocked(rng, n: int, block: int, draw) -> np.ndarray:
    """n values in blocks of ``block``: each block holds the same
    stratified set ``draw(block)`` (the last, shorter one ``draw(rest)``),
    in an order of the seed's own. ``block`` 0 is one block of n."""
    block = block or n
    parts = []
    for start in range(0, n, block):
        parts.append(rng.permutation(draw(min(block, n - start))))
    return np.concatenate(parts)


def build(mix: Dict, seed: int, seconds: float, vocab: int) -> Plan:
    rng = np.random.Generator(np.random.PCG64(int(seed)))
    # the order of sizes and gaps: the seed's own, or, with order_seed, a
    # fixed request set that the seed rotates
    fixed = "order_seed" in mix
    order = (np.random.Generator(np.random.PCG64(int(mix["order_seed"])))
             if fixed else rng)
    loop = mix["loop"]
    arrivals = mix.get("arrivals", "poisson")
    if arrivals != "poisson":
        raise ValueError(f"unknown arrivals {arrivals!r}")
    if loop == "open":
        n = int(math.floor(mix["rate_rps"] * seconds))
        if n < 1:
            raise ValueError("an open loop needs rate_rps * seconds >= 1")
        k = int(mix.get("order_block", 0))
        rate = mix["rate_rps"]
        isl = blocked(order, n, k, lambda m: quantiles(mix["isl"], m))
        osl = blocked(order, n, k, lambda m: quantiles(mix["osl"], m))
        gaps = blocked(order, n, k, lambda m: exp_gaps(rate, m))
        if fixed:
            # by whole blocks, so every block keeps its set of sizes
            shift = (int(rng.integers(0, 2**31)) % max(1, n // (k or n))) \
                * (k or n)
            isl, osl, gaps = (np.roll(a, -shift) for a in (isl, osl, gaps))
        due = np.cumsum(gaps)
        reqs = [Req(i, int(isl[i]), int(osl[i]),
                    rng.integers(1, vocab, int(isl[i])).tolist(),
                    due_s=float(due[i])) for i in range(n)]
        return Plan(loop, reqs, [])
    if loop == "closed":
        c, k = mix["clients"], mix["requests_per_client"]
        n = c * k
        isl = order.permutation(quantiles(mix["isl"], n))
        if "first_osl" in mix:
            osl = np.concatenate([
                order.permutation(quantiles(mix["first_osl"], c)),
                order.permutation(quantiles(mix["osl"], n - c))])
        else:
            osl = order.permutation(quantiles(mix["osl"], n))
        # with a fixed request set the seed hands the queues round the
        # clients
        shift = int(rng.integers(0, c)) if fixed else 0
        reqs, clients = [], [[] for _ in range(c)]
        for i in range(n):
            # request i is client (i + shift) % c's (i // c)-th: the first
            # c are the clients' first requests
            who = (i + shift) % c
            r = Req(i, int(isl[i]), int(osl[i]),
                    rng.integers(1, vocab, int(isl[i])).tolist(),
                    client=who)
            reqs.append(r)
            clients[who].append(r)
        for rnd in range(1, int(mix.get("rounds", 1))):
            for who in range(c):
                for r in clients[who][:k]:
                    again = Req(len(reqs), r.isl, r.osl,
                                rng.integers(1, vocab, r.isl).tolist(),
                                client=who, round=rnd)
                    reqs.append(again)
                    clients[who].append(again)
        return Plan(loop, reqs, clients)
    raise ValueError(f"unknown loop {loop!r}")
