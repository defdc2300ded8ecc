"""Multi-chip k-mer counting on engine v2: data-parallel reads,
hash-sharded k-mer space, all-to-all exchange between devices.

Device replacement for the reference's single-node spill-and-merge
scale story (``src/GossCmdBuildKmerSet.tcc:246-328``, SURVEY.md §2.10):
instead of disk spill files, devices exchange k-mers (NVLink on a
multi-GPU host).

Design (scaling-book recipe: pick a mesh, annotate shardings, let XLA
insert collectives):

* **Data-parallel reads.** Each chip kmerizes its own packed chunk of
  the flat base stream (``P('d')`` on the batch axis; packed-transfer
  format of :func:`gossamer_tpu.ops.engine.kmerize_packed`).
* **Hash-partitioned key space.** Chip ``s`` owns keys whose mixed hash
  ends in ``s`` (murmur-style u32 finalizer).  Range partitioning by
  value — the round-1 design — is structurally skewed for min-by-value
  canonical classes (representatives bias toward small values) and
  biologically skewed (poly-A, repeats); hashing balances both, so the
  fixed per-destination buckets need only small slack.
* **Scatter-free routing.**  Lanes sort by (owner, key); each
  destination's bucket is a dynamic slice of the sorted lanes, exchanged
  with one tiled ``all_to_all``.  Overflowed lanes are *counted* (psum)
  and raise on the host — with hash partitioning this is a statistical
  impossibility at 2x slack rather than a data-dependent hazard.
* **Engine-v2 merge.**  Each chip folds its received keys into a running
  packed spectrum with one sort per batch
  (:func:`gossamer_tpu.ops.engine._sort_count_compact` — u32 planes,
  cumsum-difference counts).

``finish()`` pulls the per-shard spectra (disjoint key sets, each sorted
by value) and k-way merges them on the host into the global sorted
spectrum; build-graph's symmetric fwd+rc expansion happens on the host
exactly as the single-chip spill path does
(:func:`gossamer_tpu.ops.count._expand_symmetric`).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops import engine as E

U32 = jnp.uint32
SENT32 = E.SENT32


def mix_owner(l1, l0, n_shards: int):
    """Owner shard from a murmur3-style u32 finalizer over the key planes.

    Depends only on the key value, never the canonicalization mode, so
    every producer routes a key to the same owner.
    """
    h = l0 ^ (l1 * U32(0x9E3779B9))
    h ^= h >> U32(16)
    h *= U32(0x85EBCA6B)
    h ^= h >> U32(13)
    h *= U32(0xC2B2AE35)
    h ^= h >> U32(16)
    return (h & U32(n_shards - 1)).astype(jnp.int32)


def make_sharded_batch_step(mesh: Mesh, rho: int, chunk: int, mode: str,
                            cap_l: int, slack: int = 2):
    """Jitted sharded batch step over packed input.

    (words (N, W), inval (N, VB), spectrum planes (N, cap_l) x3) ->
    (new planes (N, cap_l) x3, live (N,), overflow-psum (N,)).

    ``cap_l`` is the per-shard distinct-key cap; ``slack`` scales the
    per-destination exchange buckets above the uniform share.
    """
    n = mesh.devices.size
    lanes = chunk
    per = min(lanes, max(128, (slack * lanes) // n))

    def local_step(words, inval, s_l1, s_l0, s_c):
        l1, l0, valid = E.kmerize_packed(words[0], inval[0], rho, chunk)
        l1 = l1.reshape(-1)
        l0 = l0.reshape(-1)
        valid = valid.reshape(-1)
        canon = E._CANON[mode]
        if canon is not None:
            l1, l0 = canon(l1, l0, rho)
        sent = U32(SENT32)
        lane = jax.lax.broadcasted_iota(jnp.int32, (lanes,), 0)
        owner = jnp.where(valid, mix_owner(l1, l0, n), lane & (n - 1))
        l1 = jnp.where(valid, l1, sent)
        l0 = jnp.where(valid, l0, sent)
        c = valid.astype(U32)

        # sort by (owner, key); each destination's lanes are contiguous
        # and ascending (sentinels last within their destination)
        owner, l1, l0, c = jax.lax.sort((owner, l1, l0, c), num_keys=3)
        starts = jnp.searchsorted(owner, jnp.arange(n, dtype=jnp.int32))
        ends = jnp.concatenate(
            [starts[1:], jnp.full((1,), lanes, jnp.int32)])
        cnts = ends - starts
        overflow = jnp.sum(jnp.maximum(cnts - per, 0))

        # scatter-free buckets: one dynamic slice per destination.  Pad
        # by ``per`` sentinel lanes so a slice starting near the end is
        # never clamped back onto earlier destinations' lanes.
        sent_pad = jnp.full((per,), sent)
        p1 = jnp.concatenate([l1, sent_pad])
        p0 = jnp.concatenate([l0, sent_pad])
        pc = jnp.concatenate([c, jnp.zeros((per,), U32)])
        iota_p = jax.lax.broadcasted_iota(jnp.int32, (per,), 0)
        bl1, bl0, bc = [], [], []
        for d in range(n):
            s0 = starts[d]
            k1 = jax.lax.dynamic_slice(p1, (s0,), (per,))
            k0 = jax.lax.dynamic_slice(p0, (s0,), (per,))
            kc = jax.lax.dynamic_slice(pc, (s0,), (per,))
            keep = iota_p < cnts[d]
            bl1.append(jnp.where(keep, k1, sent))
            bl0.append(jnp.where(keep, k0, sent))
            bc.append(jnp.where(keep, kc, U32(0)))
        bl1 = jnp.stack(bl1)
        bl0 = jnp.stack(bl0)
        bc = jnp.stack(bc)

        # exchange: row d goes to shard d
        rl1 = jax.lax.all_to_all(bl1, "d", split_axis=0, concat_axis=0,
                                 tiled=True)
        rl0 = jax.lax.all_to_all(bl0, "d", split_axis=0, concat_axis=0,
                                 tiled=True)
        rc = jax.lax.all_to_all(bc, "d", split_axis=0, concat_axis=0,
                                tiled=True)

        # fold received keys into the running shard spectrum (engine v2:
        # one sort per batch, cumsum-difference counts)
        k1 = jnp.concatenate([s_l1[0], rl1.reshape(-1)])
        k0 = jnp.concatenate([s_l0[0], rl0.reshape(-1)])
        w = jnp.concatenate([s_c[0], rc.reshape(-1)])
        o_l1, o_l0, o_c, live = E._sort_count_compact(k1, k0, w, cap_l)
        overflow = jax.lax.psum(overflow, "d")
        return (o_l1[None], o_l0[None], o_c[None], live[None],
                overflow[None])

    step = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P("d", None),) * 5,
        out_specs=(P("d", None), P("d", None), P("d", None), P("d"),
                   P("d")),
        check_vma=False,
    )
    return jax.jit(step)


class ShardedSpectrumEngine:
    """Multi-device counterpart of :class:`gossamer_tpu.ops.engine.
    SpectrumEngine`: stream packed chunks in groups of ``n_devices``.

    ``mode`` semantics match the single-device engine ('value' for
    build-graph canonical classes, 'ref' for build-kmer-set FNV parity,
    'plain' for forward-strand).  ``finish()``/``finish_expanded()``
    return the identical global spectrum the single-device engine
    produces (equivalence-tested on the 8-device CPU mesh).
    """

    def __init__(self, mesh: Mesh, rho: int, mode: str, chunk: int,
                 cap: int = 1 << 23, slack: int = 2):
        n_dev = mesh.devices.size
        assert n_dev & (n_dev - 1) == 0, (
            "mix_owner partitions with '& (n-1)': the mesh size must be "
            "a power of two")
        assert E.narrow_keys(rho) and rho <= 33
        assert chunk % 16 == 0
        self.mesh = mesh
        self.n = mesh.devices.size
        self.rho = rho
        self.mode = mode
        self.chunk = chunk
        self.cap_l = max(256, cap // self.n)
        self.step = make_sharded_batch_step(mesh, rho, chunk, mode,
                                            self.cap_l, slack)
        self.buf: list[tuple[np.ndarray, np.ndarray]] = []
        self.spec = None
        self.live_scalars: list = []
        self._geom = E.packed_geometry(rho, chunk)

    @property
    def _n_local(self) -> int:
        """Chunks this PROCESS feeds per flush: its local device count.
        Single-process == the mesh size; under jax.distributed each
        host streams its own files and contributes its local rows
        (``parallel/distributed.py``)."""
        import jax

        if jax.process_count() == 1:
            return self.n
        return len([d for d in self.mesh.devices.flat
                    if d.process_index == jax.process_index()])

    def add_chunk_packed(self, words: np.ndarray, inval: np.ndarray) -> None:
        self.buf.append((words, inval))
        if len(self.buf) >= self._n_local:
            self._flush()

    def _global_batch(self, arr: np.ndarray, dtype) -> jnp.ndarray:
        """(n_local, ...) host rows -> (n, ...) device array sharded
        over the mesh; multi-process assembles from process-local
        data (every process must flush in lockstep)."""
        import jax
        from jax.sharding import NamedSharding

        if jax.process_count() == 1:
            return jnp.asarray(arr)
        sh = NamedSharding(self.mesh, P("d", *([None] * (arr.ndim - 1))))
        return jax.make_array_from_process_local_data(
            sh, np.ascontiguousarray(arr, dtype=dtype),
            global_shape=(self.n,) + arr.shape[1:])

    def _to_host(self, garr) -> np.ndarray:
        """Global sharded array -> full host copy on EVERY process.
        Each process fills its addressable rows, zeros elsewhere; a
        process_allgather sum reconstitutes (each row has exactly one
        non-zero contributor)."""
        import jax

        if jax.process_count() == 1:
            return np.asarray(garr)
        from jax.experimental import multihost_utils as mh

        rows = np.zeros(garr.shape, garr.dtype)
        for s in garr.addressable_shards:
            rows[s.index] = np.asarray(s.data)
        return np.asarray(mh.process_allgather(rows)).sum(
            axis=0).astype(garr.dtype)

    def _flush(self) -> None:
        if not self.buf:
            return
        nw, nv = self._geom
        while len(self.buf) < self._n_local:  # pad to the device count
            self.buf.append((np.zeros(nw, np.uint32),
                             np.full(nv, 0xFF, np.uint8)))
        words = self._global_batch(np.stack([w for w, _ in self.buf]),
                                   np.uint32)
        inval = self._global_batch(np.stack([v for _, v in self.buf]),
                                   np.uint8)
        self.buf = []
        if self.spec is None:
            sent = np.uint32(SENT32)
            nl = self._n_local
            self.spec = (
                self._global_batch(np.full((nl, self.cap_l), sent,
                                           np.uint32), np.uint32),
                self._global_batch(np.full((nl, self.cap_l), sent,
                                           np.uint32), np.uint32),
                self._global_batch(np.zeros((nl, self.cap_l), np.uint32),
                                   np.uint32),
            )
        l1, l0, c, live, ovf = self.step(words, inval, *self.spec)
        if int(self._to_host(ovf).sum()) > 0:
            raise RuntimeError(
                "shard exchange bucket overflow — statistically "
                "impossible under hash partitioning at 2x slack; raise "
                "slack or report a bug")
        self.spec = (l1, l0, c)
        self.live_scalars.append(live)

    def finish(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (lo u64, hi u64 zeros, counts i64), globally sorted."""
        self._flush()
        if self.spec is None:
            z = np.zeros(0, np.uint64)
            return z, z.copy(), np.zeros(0, np.int64)
        # Max over ALL flushes, per shard: _sort_count_compact crops the
        # spectrum on overflow, so a transient mid-stream overflow could
        # end back under cap_l — checking only the last flush would be
        # silent key loss (mirrors SpectrumEngine._check_live).
        live_all = np.stack([self._to_host(x) for x in self.live_scalars])
        live = live_all[-1]
        if (live_all.max(axis=0) > self.cap_l).any():
            raise RuntimeError(
                f"shard spectrum exceeded per-shard cap ({self.cap_l}); "
                f"rerun with a larger --spectrum-cap")
        l1 = self._to_host(self.spec[0])
        l0 = self._to_host(self.spec[1])
        c = self._to_host(self.spec[2])
        los, cs = [], []
        for s in range(self.n):
            k = int(live[s])
            los.append((l1[s, :k].astype(np.uint64) << 32) | l0[s, :k])
            cs.append(c[s, :k].astype(np.int64))
        lo = np.concatenate(los)
        cnt = np.concatenate(cs)
        order = np.argsort(lo, kind="stable")  # disjoint shard key sets
        lo, cnt = lo[order], cnt[order]
        return lo, np.zeros_like(lo), cnt

    def finish_expanded(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Symmetric fwd+rc edge spectrum (build-graph semantics)."""
        from ..ops.count import _expand_symmetric

        lo, _hi, c = self.finish()
        if len(lo) == 0:
            return lo, _hi, c
        return _expand_symmetric(lo, c, self.rho)


# ---------------------------------------------------------------------------
# wide keys (31 < rho <= 63): four u32 limb planes over the same design
# (data-parallel kmerize -> hash-owner all_to_all -> per-shard fold),
# completing the reference's k <= 62 matrix on the mesh
# (``src/Graph.hh:87-89``; VERDICT r4 missing #2).
# ---------------------------------------------------------------------------

def mix_owner_wide(p3, p2, p1, p0, n_shards: int):
    """4-limb murmur-style owner hash (value-only, mode-independent)."""
    h = p0 ^ (p1 * U32(0x9E3779B9)) ^ (p2 * U32(0x85EBCA6B)) \
        ^ (p3 * U32(0xC2B2AE35))
    h ^= h >> U32(16)
    h *= U32(0x85EBCA6B)
    h ^= h >> U32(13)
    h *= U32(0xC2B2AE35)
    h ^= h >> U32(16)
    return (h & U32(n_shards - 1)).astype(jnp.int32)


def make_sharded_batch_step_wide(mesh: Mesh, rho: int, chunk: int,
                                 mode: str, cap_l: int, slack: int = 2):
    """Wide-key sharded batch step over RAW code chunks (u8[C+rho-1]).

    (codes (N, C+rho-1), spectrum planes (N, cap_l) x5) ->
    (new planes x5, live (N,), overflow-psum (N,)).
    """
    from ..ops import engine_wide as EW

    n = mesh.devices.size
    lanes = chunk
    per = min(lanes, max(128, (slack * lanes) // n))

    def local_step(codes, s3, s2, s1, s0, s_c):
        p3, p2, p1, p0, valid = EW.kmerize_planes_wide(codes[0], rho)
        p3, p2, p1, p0 = (x.reshape(-1) for x in (p3, p2, p1, p0))
        valid = valid.reshape(-1)
        canon = EW._CANON_W[mode]
        if canon is not None:
            p3, p2, p1, p0 = canon(p3, p2, p1, p0, rho)
        sent = U32(SENT32)
        lane = jax.lax.broadcasted_iota(jnp.int32, (lanes,), 0)
        owner = jnp.where(valid, mix_owner_wide(p3, p2, p1, p0, n),
                          lane & (n - 1))
        p3 = jnp.where(valid, p3, sent)
        p2 = jnp.where(valid, p2, sent)
        p1 = jnp.where(valid, p1, sent)
        p0 = jnp.where(valid, p0, sent)
        c = valid.astype(U32)

        owner, p3, p2, p1, p0, c = jax.lax.sort(
            (owner, p3, p2, p1, p0, c), num_keys=5)
        starts = jnp.searchsorted(owner, jnp.arange(n, dtype=jnp.int32))
        ends = jnp.concatenate(
            [starts[1:], jnp.full((1,), lanes, jnp.int32)])
        cnts = ends - starts
        overflow = jnp.sum(jnp.maximum(cnts - per, 0))

        sent_pad = jnp.full((per,), sent)
        padded = [jnp.concatenate([x, sent_pad]) for x in (p3, p2, p1, p0)]
        padded.append(jnp.concatenate([c, jnp.zeros((per,), U32)]))
        iota_p = jax.lax.broadcasted_iota(jnp.int32, (per,), 0)
        buckets = [[] for _ in range(5)]
        for d in range(n):
            s0_ = starts[d]
            keep = iota_p < cnts[d]
            for i, p in enumerate(padded):
                sl = jax.lax.dynamic_slice(p, (s0_,), (per,))
                fill = U32(0) if i == 4 else sent
                buckets[i].append(jnp.where(keep, sl, fill))
        stacked = [jnp.stack(b) for b in buckets]
        recv = [jax.lax.all_to_all(b, "d", split_axis=0, concat_axis=0,
                                   tiled=True) for b in stacked]

        k = [jnp.concatenate([s[0], r.reshape(-1)])
             for s, r in zip((s3, s2, s1, s0, s_c), recv)]
        o3, o2, o1, o0, oc, live = EW._sort_count_compact_wide(
            k[0], k[1], k[2], k[3], k[4], cap_l)
        overflow = jax.lax.psum(overflow, "d")
        return (o3[None], o2[None], o1[None], o0[None], oc[None],
                live[None], overflow[None])

    step = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P("d", None),) * 6,
        out_specs=(P("d", None),) * 5 + (P("d"), P("d")),
        check_vma=False,
    )
    return jax.jit(step)


class ShardedSpectrumEngineWide:
    """Wide-key multi-device engine: same contract as
    :class:`ShardedSpectrumEngine` but streaming RAW code chunks
    (u8[chunk + rho - 1]) and keeping 4-limb spectra per shard."""

    def __init__(self, mesh: Mesh, rho: int, mode: str, chunk: int,
                 cap: int = 1 << 22, slack: int = 2):
        from ..ops import engine_wide as EW

        n_dev = mesh.devices.size
        assert n_dev & (n_dev - 1) == 0
        assert EW.wide_keys(rho)
        self.mesh = mesh
        self.n = n_dev
        self.rho = rho
        self.mode = mode
        self.chunk = chunk
        self.cap_l = max(256, cap // self.n)
        self.step = make_sharded_batch_step_wide(mesh, rho, chunk, mode,
                                                 self.cap_l, slack)
        self.buf: list[np.ndarray] = []
        self.spec = None
        self.live_scalars: list = []

    _n_local = ShardedSpectrumEngine._n_local
    _global_batch = ShardedSpectrumEngine._global_batch
    _to_host = ShardedSpectrumEngine._to_host

    def add_chunk(self, codes: np.ndarray) -> None:
        assert len(codes) == self.chunk + self.rho - 1
        self.buf.append(codes)
        if len(self.buf) >= self._n_local:
            self._flush()

    def _flush(self) -> None:
        if not self.buf:
            return
        while len(self.buf) < self._n_local:
            self.buf.append(np.full(self.chunk + self.rho - 1, 255,
                                    np.uint8))
        codes = self._global_batch(np.stack(self.buf), np.uint8)
        self.buf = []
        if self.spec is None:
            sent = np.uint32(SENT32)
            nl = self._n_local
            full = lambda: self._global_batch(
                np.full((nl, self.cap_l), sent, np.uint32), np.uint32)
            self.spec = (full(), full(), full(), full(),
                         self._global_batch(
                             np.zeros((nl, self.cap_l), np.uint32),
                             np.uint32))
        *planes, live, ovf = self.step(codes, *self.spec)
        if int(self._to_host(ovf).sum()) > 0:
            raise RuntimeError(
                "shard exchange bucket overflow — raise slack")
        self.spec = tuple(planes)
        self.live_scalars.append(live)

    def finish(self):
        """-> (lo u64, hi u64, counts i64), globally sorted by (hi, lo)."""
        self._flush()
        if self.spec is None:
            z = np.zeros(0, np.uint64)
            return z, z.copy(), np.zeros(0, np.int64)
        live_all = np.stack([self._to_host(x) for x in self.live_scalars])
        live = live_all[-1]
        if (live_all.max(axis=0) > self.cap_l).any():
            raise RuntimeError(
                f"shard spectrum exceeded per-shard cap ({self.cap_l}); "
                f"rerun with a larger --spectrum-cap")
        p = [self._to_host(x) for x in self.spec]
        los, his, cs = [], [], []
        for s in range(self.n):
            k = int(live[s])
            his.append((p[0][s, :k].astype(np.uint64) << 32) | p[1][s, :k])
            los.append((p[2][s, :k].astype(np.uint64) << 32) | p[3][s, :k])
            cs.append(p[4][s, :k].astype(np.int64))
        lo = np.concatenate(los)
        hi = np.concatenate(his)
        cnt = np.concatenate(cs)
        order = np.lexsort((lo, hi))  # disjoint shard key sets
        return lo[order], hi[order], cnt[order]

    def finish_expanded(self):
        """Symmetric fwd+rc edge spectrum (build-graph semantics)."""
        from ..core import kmer as KK

        lo, hi, c = self.finish()
        if len(lo) == 0:
            return lo, hi, c
        rlo, rhi = KK.reverse_complement(lo, hi, self.rho)
        pal = (rlo == lo) & (rhi == hi)
        out_lo = np.concatenate([lo, rlo[~pal]])
        out_hi = np.concatenate([hi, rhi[~pal]])
        out_c = np.concatenate([np.where(pal, c * 2, c), c[~pal]])
        order = np.lexsort((out_lo, out_hi))
        return out_lo[order], out_hi[order], out_c[order]
