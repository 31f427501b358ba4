"""Topology Bypassing: relay routes over already-installed circuits.

A copy of the reference package's relay enumeration; the grid greedy reads
``relay_depth_table``.

The paper's third latency-hiding technique (alongside Heterogeneous
Message Splitting and Asynchronous Overlapping): when a step's pairing is
not installed on any plane, traffic can still flow as a *relay* over
circuits that ARE installed -- node ``x`` forwards its chunk to an
intermediate node over one installed circuit, which forwards it onward
over another, until the composition of the traversed permutations equals
the step's pairing.  No reconfiguration latency is paid; the price is
relay bandwidth: every hop carries the full chunk, so an ``h``-hop relay
delivers at ``bandwidth / h`` while consuming link capacity on each hop's
plane (the store-and-forward serialization the executor models).

The greedy enumerates *self-composition* relays (`relay_depth_table`):
an ``h``-hop walk over a SINGLE plane's installed circuit: ``x -> P[x] ->
P^2[x] -> ...``, legal when ``P^h`` equals the step pairing.  This is the
rotation-algebra case (ring / pairwise all-to-all: ``rot(a)^h = rot(h*a
mod n)``); a single plane's relay maps onto the water-filling machinery as
a server with effective bandwidth ``bw / h``.  The executor and validator
accept general cross-plane routes too (P4); the reference's cross-plane
route enumeration is not ported, as no port code uses it.

Permutation convention: ``perm[x]`` is the node ``x`` sends to, and a
route's hops apply in forward data order, so a route ``(j0, j1)`` with
installed permutations ``p0, p1`` realizes ``x -> p1[p0[x]]``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.patterns import Pattern


def config_perms(pattern: Pattern) -> dict[int, tuple[int, ...]]:
    """Config id -> node pairing, from the pattern's steps.

    ``Pattern.validate`` guarantees a config id maps to one permutation;
    config ids never mentioned by a step have no known pairing (and thus
    cannot participate in a relay composition).
    """
    perms: dict[int, tuple[int, ...]] = {}
    for step in pattern.steps:
        perms.setdefault(step.config, step.perm)
    return perms


def compose(first: tuple[int, ...], then: tuple[int, ...]) -> tuple[int, ...]:
    """Apply ``first`` then ``then``: ``result[x] = then[first[x]]``."""
    return tuple(then[y] for y in first)


def self_relay_depth(
    perm: tuple[int, ...], target: tuple[int, ...], max_depth: int
) -> int:
    """Minimal ``h`` in ``[2, max_depth]`` with ``perm^h == target``.

    Returns 0 when no such depth exists.  ``h = 1`` (the installed
    pairing already matches) is deliberately excluded: that is a direct
    transmission, not a bypass.
    """
    cur = perm
    for h in range(2, max_depth + 1):
        cur = compose(cur, perm)
        if cur == target:
            return h
    return 0


def relay_depth_table(pattern: Pattern, max_depth: int) -> np.ndarray:
    """``(C, C)`` table of minimal self-relay depths between config ids.

    Entry ``[a, c]`` is the minimal ``h`` in ``[2, max_depth]`` such that
    ``perm_a`` composed with itself ``h`` times equals ``perm_c``, or 0
    when no bypass exists (including unknown config ids).  ``C`` is
    ``max config id + 1`` over the pattern; ``max_depth < 2`` yields an
    all-zero table (bypassing disabled).
    """
    perms = config_perms(pattern)
    c_max = max(perms) + 1 if perms else 0
    table = np.zeros((c_max, c_max), dtype=np.int64)
    if max_depth < 2:
        return table
    for a, pa in perms.items():
        for c, pc in perms.items():
            table[a, c] = self_relay_depth(pa, pc, max_depth)
    return table
