"""Vectorized linear-segment decomposition (pointer doubling).

The reference walks linear paths edge-by-edge with rank/select per step
(``src/Graph.tcc:21-46`` ``linearPath``, used by ``printLinearSegments``
at ``src/GossCmdPrintContigs.cc:49-196`` and ``EntryEdgeSet::build`` at
``src/EntryEdgeSet.cc:154-290``).  Sequential pointer chasing does not vectorize, so we restructure it: the successor table is a
functional graph over edge ranks, and pointer doubling labels every edge
with its chain start and position in O(n log n) fully-vectorized work.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .graph import Graph


@dataclass
class SegmentDecomposition:
    """Chain labelling of all edges of a symmetric graph.

    start[i]  rank of the first edge of i's chain (= i for chain heads)
    pos[i]    position of edge i within its chain (0 for heads)
    cyclic[i] True for edges on isolated cycles (no chain head exists)
    order     edge ranks sorted by (start, pos): chains laid contiguously
    seg_off/seg_len  CSR layout of chains over ``order`` (cycles excluded)
    seg_start        chain head rank per segment, ascending
    """

    start: np.ndarray
    pos: np.ndarray
    cyclic: np.ndarray
    order: np.ndarray
    seg_off: np.ndarray
    seg_len: np.ndarray
    seg_start: np.ndarray


def decompose_mesh(g: Graph, mesh) -> SegmentDecomposition:
    """Chain decomposition with the WALKS on the device mesh: successor
    and predecessor tables come from live-weighted rank queries over the
    contiguously sharded edge planes, chains resolve by pointer doubling
    with one all_gather per round (``parallel/walk_sharded.py``); only
    the final CSR layout (a lexsort) happens on the host.  Byte-
    identical to :func:`decompose` (tests/test_walk_sharded.py)."""
    n = g.count
    if n == 0:
        z = np.zeros(0, dtype=np.int64)
        return SegmentDecomposition(z, z, z.astype(bool), z, z, z, z)
    from ..parallel.walk_sharded import sharded_segment_table

    start, pos, _end, _lenE, cyclic = sharded_segment_table(
        mesh, np.asarray(g.lo), g.rho)
    live = ~cyclic
    order = np.lexsort((pos[live], start[live]))
    order = np.nonzero(live)[0][order]
    return _csr_tail(start, pos, cyclic, order)


def decompose(g: Graph) -> SegmentDecomposition:
    n = g.count
    if n == 0:
        z = np.zeros(0, dtype=np.int64)
        return SegmentDecomposition(z, z, z.astype(bool), z, z, z, z)
    nxt = g.successor_table()
    from ..io.native import native_chains

    nat = native_chains(nxt)
    if nat is not None:
        # host path: direct O(n) chain walks (the pointer-doubling
        # formulation below is the device-friendly shape; on the host
        # CPU sequential walks are ~10x less work)
        start, pos, order, _ = nat
        cyclic = start < 0
    else:
        # prev[j] = i iff nxt[i] = j  (injective: to(i) is 1-in/1-out)
        prev = np.full(n, -1, dtype=np.int64)
        dom = np.nonzero(nxt >= 0)[0]
        prev[nxt[dom]] = dom

        # pointer doubling towards chain heads
        jump = np.where(prev < 0, np.arange(n, dtype=np.int64), prev)
        dist = (prev >= 0).astype(np.int64)
        rounds = max(1, int(np.ceil(np.log2(n + 1))) + 1)
        for _ in range(rounds):
            j2 = jump[jump]
            if j2 is jump or np.array_equal(j2, jump):
                break  # all chains resolved (fixed point)
            dist = dist + dist[jump]
            jump = j2
        cyclic = prev[jump] >= 0  # never reached a head: isolated cycle
        start = jump
        pos = dist

        live = ~cyclic
        order = np.lexsort((pos[live], start[live]))
        order = np.nonzero(live)[0][order]
    return _csr_tail(start, pos, cyclic, order)


def _csr_tail(start, pos, cyclic, order) -> SegmentDecomposition:
    if len(order):
        s = start[order]
        head = np.ones(len(order), dtype=bool)
        head[1:] = s[1:] != s[:-1]
        seg_off = np.nonzero(head)[0]
        seg_len = np.diff(np.append(seg_off, len(order)))
        seg_start = s[seg_off]
    else:
        seg_off = np.zeros(0, dtype=np.int64)
        seg_len = np.zeros(0, dtype=np.int64)
        seg_start = np.zeros(0, dtype=np.int64)
    return SegmentDecomposition(start, pos, cyclic, order, seg_off, seg_len, seg_start)
