"""Mesh-sharded graph cleanup passes (SURVEY.md §2.10 traversal story).

The cleanup algorithms' core primitive is *degree lookup*: rank queries
against the globally sorted edge set.  On the mesh the edge planes are
sharded contiguously by rank; a query's GLOBAL rank is the ``psum`` of
its per-shard lower bounds (each shard holds a sorted subsequence, and
lower bounds over a partition into sorted pieces add up), so degrees
come from one ``all_gather`` of the query block + a local sort-join +
one ``psum`` — no routing, no bucketing.  Reference analog: the
per-thread block partitioning of ``GossCmdPruneTips.cc:290-312``
re-aimed at chips, with the shared succinct graph replaced by the
gather/psum pair.

Narrow keys only (2*rho <= 62; u32 planes, device u64 avoided).

Provided passes:

* :func:`sharded_degrees` — (out_degree, in_degree) of every edge's
  from-node, sharded.
* :func:`sharded_tip_candidates` — prune-tips pass-1 candidate marking
  (in-degree-0 from-nodes, ``GossCmdPruneTips.cc:93-97``).
* :func:`sharded_trim_mask` — trim-graph's count>=C survivor mask +
  global survivor count (``GossCmdTrimGraph.cc``).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

U32 = jnp.uint32
SENT32 = 0xFFFFFFFF


def shard_planes(lo: np.ndarray, counts: np.ndarray | None, n_dev: int):
    """Split sorted u64 keys into contiguous per-device u32 plane blocks
    (sentinel-padded to equal width).  Returns (l1, l0, c) stacked
    [n_dev, B] arrays and the global count."""
    n = len(lo)
    B = -(-max(n, 1) // n_dev)
    l1 = np.full((n_dev, B), SENT32, np.uint32)
    l0 = np.full((n_dev, B), SENT32, np.uint32)
    c = np.zeros((n_dev, B), np.int32)
    for d in range(n_dev):
        seg = lo[d * B : (d + 1) * B]
        l1[d, : len(seg)] = (seg >> np.uint64(32)).astype(np.uint32)
        l0[d, : len(seg)] = seg.astype(np.uint32)
        if counts is not None:
            cc = counts[d * B : (d + 1) * B]
            c[d, : len(cc)] = cc.astype(np.int32)
    return l1, l0, c, n


def _local_rank(s_l1, s_l0, q_l1, q_l0):
    """Lower-bound ranks of queries in this shard's sorted keys via one
    tagged sort + scan (sentinel-padded lanes rank at live count)."""
    m = s_l1.shape[0]
    q = q_l1.shape[0]
    k1 = jnp.concatenate([s_l1, q_l1])
    k0 = jnp.concatenate([s_l0, q_l0])
    # queries (tag 0) sort BEFORE equal set keys (tag 1): lower bound
    tag = jnp.concatenate([jnp.ones((m,), U32), jnp.zeros((q,), U32)])
    payload = jnp.concatenate([
        jnp.zeros((m,), jnp.int32),
        1 + jax.lax.broadcasted_iota(jnp.int32, (q,), 0),
    ])
    k1, k0, tag, payload = jax.lax.sort((k1, k0, tag, payload), num_keys=3)
    pos = jax.lax.broadcasted_iota(jnp.int32, (m + q,), 0)
    qidx = jnp.cumsum((tag == 0).astype(jnp.int32))
    rank_lane = pos - qidx + 1
    # scatter-free unsort of query answers: sort by payload (queries
    # carry 1 + original index, set lanes 0 and land in front)
    _, ranks = jax.lax.sort(
        (payload, jnp.where(tag == 0, rank_lane, 0)), num_keys=1)
    return ranks[m:]


def _shift_planes_left2(l1, l0):
    """(l1,l0) << 2 (node -> first out-edge key)."""
    return (l1 << U32(2)) | (l0 >> U32(30)), l0 << U32(2)


def _rc_node(l1, l0, k: int):
    """Reverse complement of a 2k-bit node in u32 planes."""
    from ..ops.engine import rc_planes

    # rc_planes is written for rho-keys; reuse with rho=k
    return rc_planes(l1, l0, k)


def _add4(l1, l0):
    nl0 = l0 + U32(4)
    carry = (nl0 < l0).astype(U32)
    return l1 + carry, nl0


def _put(mesh: Mesh, arr: np.ndarray):
    """Host array -> mesh-sharded device array; multi-process safe (each
    process materializes only its addressable shards)."""
    sh = NamedSharding(mesh, P("d"))
    return jax.make_array_from_callback(arr.shape, sh,
                                        lambda idx: arr[idx])


def make_degree_fn(mesh: Mesh, rho: int, replicated: bool = False):
    """Compiled sharded pass: edge planes [N, B] -> per-edge
    (out_degree, in_degree) of the from-node, same sharding (or
    gathered to every device with ``replicated`` — the multi-process
    mode, where only replicated outputs are host-addressable)."""
    k = rho - 1
    n_dev = mesh.devices.size

    def local(idx_l1, idx_l0, e_l1, e_l0):
        idx_l1 = idx_l1[0]
        idx_l0 = idx_l0[0]
        q_l1 = e_l1[0]
        q_l0 = e_l0[0]
        B = q_l1.shape[0]
        sent = U32(SENT32)
        is_pad = (q_l1 == sent) & (q_l0 == sent)
        # from-node = edge >> 2
        f_l1 = q_l1 >> U32(2)
        f_l0 = (q_l0 >> U32(2)) | (q_l1 << U32(30))
        r_l1, r_l0 = _rc_node(f_l1, f_l0, k)
        # 4 query streams: f<<2, f<<2+4, rc<<2, rc<<2+4
        a1, a0 = _shift_planes_left2(f_l1, f_l0)
        b1, b0 = _add4(a1, a0)
        c1, c0 = _shift_planes_left2(r_l1, r_l0)
        d1, d0 = _add4(c1, c0)
        ql1 = jnp.concatenate([a1, b1, c1, d1])
        ql0 = jnp.concatenate([a0, b0, c0, d0])
        # pad lanes query sentinels (rank contributions still finite but
        # masked on combine)
        ql1 = jnp.where(jnp.tile(is_pad, 4), sent, ql1)
        ql0 = jnp.where(jnp.tile(is_pad, 4), sent, ql0)
        # frontier exchange: everyone answers everyone's queries
        g1 = jax.lax.all_gather(ql1, "d")  # [n_dev, 4B]
        g0 = jax.lax.all_gather(ql0, "d")
        r = _local_rank(idx_l1, idx_l0, g1.reshape(-1), g0.reshape(-1))
        # subtract this shard's sentinel-pad contribution: pad keys are
        # sentinels, queries below them rank < live automatically; but
        # sentinel QUERY lanes rank past live keys — masked later
        r = jax.lax.psum(r.reshape(n_dev, -1), "d")
        mine = r[jax.lax.axis_index("d")]
        out_d = (mine[B : 2 * B] - mine[:B]).astype(jnp.int32)
        in_d = (mine[3 * B :] - mine[2 * B : 3 * B]).astype(jnp.int32)
        out_d = jnp.where(is_pad, 0, out_d)
        in_d = jnp.where(is_pad, 0, in_d)
        if replicated:
            return (jax.lax.all_gather(out_d, "d"),
                    jax.lax.all_gather(in_d, "d"))
        return out_d[None], in_d[None]

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P("d"), P("d"), P("d"), P("d")),
        out_specs=(P(), P()) if replicated else (P("d"), P("d")),
        check_vma=False,
    ))


def sharded_degrees(mesh: Mesh, lo: np.ndarray, rho: int,
                    replicated: bool = False):
    """(out_degree, in_degree) of from(e) for every edge, via the mesh.

    ``replicated=True`` gathers the result to every device — required
    when the mesh spans processes (sharded outputs are not fully host-
    addressable there)."""
    n_dev = mesh.devices.size
    l1, l0, _c, n = shard_planes(lo, None, n_dev)
    fn = make_degree_fn(mesh, rho, replicated)
    l1d = _put(mesh, l1)
    l0d = _put(mesh, l0)
    out_d, in_d = fn(l1d, l0d, l1d, l0d)
    out_d = np.asarray(out_d).reshape(-1)[:n]
    in_d = np.asarray(in_d).reshape(-1)[:n]
    return out_d, in_d


def sharded_tip_candidates(mesh: Mesh, lo: np.ndarray, rho: int):
    """Tip-start candidate mask: edges whose from-node has in-degree 0
    (prune-tips pass 1, ``GossCmdPruneTips.cc:93-97``)."""
    out_d, in_d = sharded_degrees(mesh, lo, rho)
    return in_d == 0


def make_trim_fn(mesh: Mesh, cutoff: int):
    def local(c):
        keep = c[0] > jnp.int32(cutoff - 1)
        # sentinel-padded lanes carry count 0 -> dropped automatically
        kept = jax.lax.psum(jnp.sum(keep.astype(jnp.int32)), "d")
        return keep[None], kept[None]

    return jax.jit(shard_map(local, mesh=mesh, in_specs=(P("d"),),
                             out_specs=(P("d"), P())))


def sharded_trim_mask(mesh: Mesh, counts: np.ndarray, cutoff: int):
    """(keep mask, global survivor count) for trim-graph on the mesh."""
    n_dev = mesh.devices.size
    n = len(counts)
    B = -(-max(n, 1) // n_dev)
    c = np.zeros((n_dev, B), np.int32)
    flat = counts.astype(np.int32)
    for d in range(n_dev):
        seg = flat[d * B : (d + 1) * B]
        c[d, : len(seg)] = seg
    fn = make_trim_fn(mesh, cutoff)
    keep, kept = fn(jax.device_put(c, NamedSharding(mesh, P("d"))))
    return np.asarray(keep).reshape(-1)[:n], int(np.asarray(kept)[0])
