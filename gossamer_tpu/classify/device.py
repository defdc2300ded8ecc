"""Device-side read classification (xenome/electus lookup engine).

The host engine's ``searchsorted`` lookup is gather-bound; on the
device the same join runs as *sort + scan* (see docs/design.md):

1. encode the annotated set as E = (key << 2) | class, sorted;
2. queries as (key << 2) | 3, tagged;
3. one sort of [set ++ queries] by (E, tag) puts each query directly
   after its (potential) set match;
4. a ``cummax`` forward-fill propagates the most recent set entry to
   every query lane (monotone because keys ascend);
5. per-read blrg = segmented OR, again via cummax over read-id-sorted
   lanes, compacted with a final key sort.

Zero gathers/scatters; three sorts per batch.  Narrow keys only
(k <= 30: 2k+2 <= 62 bits).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import device_kmer as dk

U64 = jnp.uint64
MAXU64 = 0xFFFFFFFFFFFFFFFF


def encode_set(lo: np.ndarray, lhs: np.ndarray, rhs: np.ndarray) -> np.ndarray:
    """Annotated set -> sorted E = (key << 2) | (lhs<<1|rhs) plane."""
    cls = (lhs.astype(np.uint64) << np.uint64(1)) | rhs.astype(np.uint64)
    return (lo << np.uint64(2)) | cls


@partial(jax.jit, static_argnums=(2, 3))
def classify_batch(codes, set_E, k: int, max_reads: int):
    """codes uint8[W + k - 1] (255-separated reads) -> blrg uint8[max_reads].

    Read i's windows are those following the i-th separator boundary;
    reads beyond max_reads must not appear in the batch.
    """
    W = codes.shape[0] - k + 1
    lo, hi, valid = dk.kmerize_flat(codes, k)
    nlo, nhi, _ = dk.normalize(lo, hi, k)
    rid = jnp.cumsum((codes == 255).astype(jnp.int32))[:W]

    qE = jnp.where(valid, (nlo << 2) | U64(3), U64(MAXU64))
    qh = (qE >> 32).astype(jnp.uint32)
    ql = qE.astype(jnp.uint32)
    sh = (set_E >> 32).astype(jnp.uint32)
    sl = set_E.astype(jnp.uint32)
    return _classify_join(sh, sl, qh, ql, rid, max_reads)


def _classify_join(sh, sl, qh, ql, rid, max_reads: int):
    """Shared sort-join tail: sorted set planes + query planes + per-
    window read ids -> per-read blrg."""
    n_set = sh.shape[0]
    W = qh.shape[0]
    # one dummy query lane per read so every rid has a group
    dummy = jnp.full((max_reads,), jnp.uint32(0xFFFFFFFF))
    dummy_rid = jnp.arange(max_reads, dtype=jnp.int32)

    eh = jnp.concatenate([sh, qh, dummy])
    el = jnp.concatenate([sl, ql, dummy])
    is_q = jnp.concatenate([
        jnp.zeros((n_set,), jnp.int32),
        jnp.ones((W + max_reads,), jnp.int32),
    ])
    rids = jnp.concatenate([jnp.zeros((n_set,), jnp.int32), rid, dummy_rid])

    eh, el, is_q, rids = jax.lax.sort((eh, el, is_q, rids), num_keys=3)

    # Forward-fill the set entry's class across its key group.  All
    # scans are i32, and the
    # union set holds each key once, so the only set lane that can
    # match a query is the one inside the query's own key group —
    # a segment id + an i32 cummax of (seg*8 | cls+1) recovers it.
    n_lanes = eh.shape[0]
    # seg*8 must fit i32; beyond this, split the set (multipass/sharded)
    assert n_lanes < (1 << 28), "classify batch too large for i32 scans"
    new_key = jnp.ones((n_lanes,), bool).at[1:].set(
        (eh[1:] != eh[:-1]) | ((el[1:] >> 2) != (el[:-1] >> 2)))
    seg = jnp.cumsum(new_key.astype(jnp.int32)) - 1  # group count < 2^28
    cls_lane = (el & 3).astype(jnp.int32)
    fcode = jnp.where(is_q == 0, seg * 8 + cls_lane + 1, 0)
    m = jax.lax.cummax(fcode)
    is_sent = (eh == jnp.uint32(0xFFFFFFFF)) & (el == jnp.uint32(0xFFFFFFFF))
    match = (is_q == 1) & (m > seg * 8) & ~is_sent
    cls = jnp.clip((m & 7) - 1, 0, 3)
    bits = jnp.where(match, jnp.int32(1) << cls, 0)

    # aggregate per read: sort query lanes by rid, set lanes to the tail
    ridq = jnp.where(is_q == 1, rids, jnp.int32(max_reads))
    return _agg_blrg(ridq, bits, max_reads)


def _agg_blrg(ridq, bits, max_reads: int):
    """(read id | max_reads for non-query lanes, per-lane class bits)
    -> per-read blrg via rid sort + per-bit i32 cummax + compaction."""
    rid2, bits2 = jax.lax.sort((ridq, bits), num_keys=1)
    # per-read OR of the 4 class bits: one i32 cummax per bit over
    # rid-major lanes (rid*2 + bit is monotone per read; i32 is safe —
    # rid2 <= max_reads < 2^30)
    blrg_lane = jnp.zeros_like(bits2)
    base = rid2 * 2
    for c in range(4):
        bit = (bits2 >> c) & 1
        mb = jax.lax.cummax(base + bit)
        blrg_lane = blrg_lane | (jnp.clip(mb - base, 0, 1) << c)
    n = rid2.shape[0]
    is_last = jnp.ones((n,), dtype=bool)
    is_last = is_last.at[:-1].set(rid2[1:] != rid2[:-1])
    key = jnp.where(is_last & (rid2 < max_reads), rid2, jnp.int32(n))
    key, blrg_sorted = jax.lax.sort((key, blrg_lane), num_keys=1)
    return blrg_sorted[:max_reads].astype(jnp.uint8)


@partial(jax.jit, static_argnums=(4, 5, 6))
def classify_batch_packed(words, inval, set_eh, set_el, k: int,
                          max_reads: int, C: int):
    """:func:`classify_batch` over the packed-transfer format (0.375
    B/base host->device instead of 1 B/base).  The invalid-code bitmap's cumsum
    yields BOTH the window validity and the read ids (every invalid code
    is a read separator in the reader's encoding — non-ACGT maps to
    0xFF), so no scatters/gathers anywhere.
    """
    from ..ops.engine import _kmerize_words, _phase_major, canon_ref

    l1, l0 = _kmerize_words(words, k, C)
    bits = (inval[:, None] >> jnp.arange(8, dtype=jnp.uint8)) & jnp.uint8(1)
    inv = bits.reshape(-1)[: C + k - 1]
    cnt = jnp.cumsum(inv.astype(jnp.int32))
    hi_cnt = cnt[k - 1 : k - 1 + C]
    lo_cnt = jnp.concatenate([jnp.zeros((1,), jnp.int32), cnt[: C - 1]])
    valid = (hi_cnt - lo_cnt) == 0  # no invalid code in [p, p + k)
    rid = lo_cnt  # separators before the window = read id
    valid = _phase_major(valid, C).reshape(-1)
    rid = _phase_major(rid, C).reshape(-1)
    l1 = l1.reshape(-1)
    l0 = l0.reshape(-1)
    n1, n0 = canon_ref(l1, l0, k)
    qh = (n1 << jnp.uint32(2)) | (n0 >> jnp.uint32(30))
    ql = (n0 << jnp.uint32(2)) | jnp.uint32(3)
    sent = jnp.uint32(0xFFFFFFFF)
    qh = jnp.where(valid, qh, sent)
    ql = jnp.where(valid, ql, sent)
    rid = jnp.where(valid, rid, 0)
    return _classify_join(set_eh, set_el, qh, ql, rid, max_reads)


@partial(jax.jit, static_argnums=(4, 5, 6, 7))
def classify_batch_periodic(words, nwin, set_eh, set_el, k: int,
                            max_reads: int, C: int, T: int):
    """:func:`classify_batch_packed` for FIXED-LENGTH read streams laid
    out periodically (T-1 bases + 1 separator, reads starting at phase
    0): only the 2-bit words cross the wire (0.25 B/base), and both the
    validity mask and the read ids are direct iota expressions — window
    q belongs to read q // T, valid iff q % T <= T-1-k — with no
    vector division (minor/major axes of a (rows, T) iota ARE the
    residue and quotient).
    """
    from ..ops.engine import _kmerize_words, _phase_major, canon_ref

    l1, l0 = _kmerize_words(words, k, C)
    rows = -(-C // T) + 1
    res = jax.lax.broadcasted_iota(jnp.int32, (rows, T), 1).reshape(-1)[:C]
    quo = jax.lax.broadcasted_iota(jnp.int32, (rows, T), 0).reshape(-1)[:C]
    q = jax.lax.broadcasted_iota(jnp.int32, (C,), 0)
    valid = (res <= jnp.int32(T - 1 - k)) & (q < jnp.asarray(nwin, jnp.int32))
    valid = _phase_major(valid, C).reshape(-1)
    rid = _phase_major(quo, C).reshape(-1)
    l1 = l1.reshape(-1)
    l0 = l0.reshape(-1)
    n1, n0 = canon_ref(l1, l0, k)
    qh = (n1 << jnp.uint32(2)) | (n0 >> jnp.uint32(30))
    ql = (n0 << jnp.uint32(2)) | jnp.uint32(3)
    sent = jnp.uint32(0xFFFFFFFF)
    qh = jnp.where(valid, qh, sent)
    ql = jnp.where(valid, ql, sent)
    rid = jnp.where(valid, rid, 0)
    return _classify_join(set_eh, set_el, qh, ql, rid, max_reads)


def recanon_set_value(set_E: np.ndarray, k: int) -> np.ndarray:
    """Re-represent an annotated set's classes by their min-by-VALUE
    canonical k-mer (keys stay distinct: each key is one canonical
    class, and this just picks the other representative of the same
    class).  Lets the device classifier canonicalize queries with the
    cheap :func:`~gossamer_tpu.ops.engine.canon_value` instead of the
    reference's FNV hash-then-value ordering — per-read blrg results
    are identical because membership is class membership.
    """
    from ..core import kmer as K

    lo = set_E >> np.uint64(2)
    cls = (set_E & np.uint64(3)).astype(np.uint8)
    rlo, _ = K.reverse_complement(lo, np.zeros_like(lo), k)
    vlo = np.minimum(lo, rlo)
    order = np.argsort(vlo, kind="stable")
    return (vlo[order] << np.uint64(2)) | cls[order]


@partial(jax.jit, static_argnums=(4, 5, 6, 7))
def classify_batch_periodic2(words, n_reads, set_eh, set_el, k: int,
                             max_reads: int, C: int, T: int):
    """Round-5 periodic classifier: one 2-key join sort + one 1-key
    aggregation sort (vs the round-4 3-key sort + two payload sorts).

    Levers:

    * VALID-ONLY lanes: fixed-length reads make window validity a pure
      position property, so slicing ``[:, :T-k]`` of the (reads, T)
      window matrix keeps exactly each read's T-k real k-mers — ~25%
      fewer lanes in every sort (no sentinel lanes ride along).
    * value canonicalization (the set is re-represented once on the
      host, :func:`recanon_set_value`) — no FNV hashing of 2x20M lanes.
    * the rid payload doubles as the set/query tag (set lanes ride
      rid = -1), so the join sort is 2 keys + 1 payload, not 3 + 1.
    * aggregation: one SINGLE-PLANE u32 sort of ``(rid << 4) | bits``;
      every read then owns exactly T-k contiguous lanes, so per-read
      blrg is a reshape + OR-tree — no dummy lanes, no segment scans,
      no compaction sort.

    The T period is ``C // max_reads`` (callers fix max_reads =
    C // T).  Set classes ride the low 2 bits of ``set_el``; queries
    carry tag 3 so a stable sort puts the set lane first in its key
    group (``src/GossCmdGroupReads.cc:381-468`` is the semantic
    contract: per-read OR of per-k-mer class one-hots).
    """
    return _classify_periodic2_body(words, n_reads, set_eh, set_el, k,
                                    max_reads, C, T)


def _classify_periodic2_body(words, n_reads, set_eh, set_el, k: int,
                             max_reads: int, C: int, T: int):
    from ..ops.engine import _kmerize_words, canon_value

    assert C % 16 == 0 and max_reads * T <= C
    n_set = set_eh.shape[0]
    l1, l0 = _kmerize_words(words, k, C)
    # natural window order (the kmerizer emits phase-major)
    l1 = l1.T.reshape(-1)
    l0 = l0.T.reshape(-1)
    nk = T - k  # valid windows per read (read_len - k + 1)
    q1 = l1[: max_reads * T].reshape(max_reads, T)[:, :nk].reshape(-1)
    q0 = l0[: max_reads * T].reshape(max_reads, T)[:, :nk].reshape(-1)
    n1, n0 = canon_value(q1, q0, k)
    qh = (n1 << jnp.uint32(2)) | (n0 >> jnp.uint32(30))
    ql = (n0 << jnp.uint32(2)) | jnp.uint32(3)
    rid = jax.lax.broadcasted_iota(jnp.int32, (max_reads, nk), 0).reshape(-1)
    live = rid < jnp.asarray(n_reads, jnp.int32)
    sent = jnp.uint32(0xFFFFFFFF)
    qh = jnp.where(live, qh, sent)
    ql = jnp.where(live, ql, sent)
    NQ = max_reads * nk
    assert n_set + NQ < (1 << 28), "classify batch too large for i32 scans"

    eh = jnp.concatenate([set_eh, qh])
    el = jnp.concatenate([set_el, ql])
    ridp = jnp.concatenate([jnp.full((n_set,), -1, jnp.int32), rid])
    eh, el, ridp = jax.lax.sort((eh, el, ridp), num_keys=2)

    n = eh.shape[0]
    new_key = jnp.ones((n,), bool).at[1:].set(
        (eh[1:] != eh[:-1]) | ((el[1:] >> 2) != (el[:-1] >> 2)))
    seg = jnp.cumsum(new_key.astype(jnp.int32)) - 1
    is_set = ridp < 0
    fcode = jnp.where(is_set, seg * 8 + (el & 3).astype(jnp.int32) + 1, 0)
    m = jax.lax.cummax(fcode)
    match = ~is_set & (m > seg * 8)
    bits = jnp.where(match, jnp.int32(1) << jnp.clip((m & 7) - 1, 0, 3), 0)

    agg = jnp.where(is_set, sent,
                    (ridp.astype(jnp.uint32) << jnp.uint32(4))
                    | bits.astype(jnp.uint32))
    agg = jax.lax.sort(agg)
    q = agg[:NQ].reshape(max_reads, nk)
    pad = (1 << int(np.ceil(np.log2(nk)))) - nk
    if pad:
        q = jnp.concatenate(
            [q, jnp.zeros((max_reads, pad), jnp.uint32)], axis=1)
    while q.shape[1] > 1:
        h = q.shape[1] // 2
        q = q[:, :h] | q[:, h:]
    return (q[:, 0] & jnp.uint32(15)).astype(jnp.uint8)


def prepare_set_value(set_E: np.ndarray, k: int):
    """One-time set prep for :func:`classify_periodic_stream2`:
    re-represent by value canon (host) and stage the u32 planes on
    device.  Pass a NUMPY set — converting a device-resident set back
    to host costs a full D2H pull of the plane."""
    set_Ev = recanon_set_value(np.asarray(set_E), k)
    return (jnp.asarray((set_Ev >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray(set_Ev.astype(np.uint32)))


def classify_periodic_stream2(chunks, set_E, k: int, window: int,
                              read_len: int, prepared=None) -> np.ndarray:
    """Device classify over words-only chunks of FIXED-LENGTH reads —
    the round-5 two-sort engine (:func:`classify_batch_periodic2`).

    ``chunks``: iterable of ``(words, n_reads)`` as in
    :func:`classify_periodic_stream`; ``set_E`` holds the annotated
    union set in any canonical representation (re-represented by value
    once on the host; pass ``prepared=prepare_set_value(...)`` to reuse
    that prep across calls).
    """
    T = read_len + 1
    max_reads = window // T
    sh, sl = prepared if prepared is not None else prepare_set_value(
        set_E, k)
    chunks = list(chunks)
    if not chunks:
        return np.zeros(0, np.uint8)
    counts = [n for _, n in chunks]
    assert max(counts) <= max_reads
    # per-chunk programs, one device_get at the end.  (A vmapped
    # all-chunks-in-one-program variant was measured and REJECTED: the
    # batched lax.sort ran 3x slower than the per-chunk programs,
    # swamping the saved launch gaps — docs/design.md.)
    out_dev = [
        classify_batch_periodic2(
            jnp.asarray(w), np.int32(n), sh, sl, k, max_reads, window, T)
        for w, n in chunks
    ]
    pulled = jax.device_get(out_dev)
    return np.concatenate([p[:n] for p, n in zip(pulled, counts)])


def classify_periodic_stream(chunks, set_E, k: int, window: int,
                             read_len: int,
                             max_reads: int | None = None) -> np.ndarray:
    """Device classify over words-only chunks of FIXED-LENGTH reads.

    ``chunks``: iterable of ``(words, n_reads)`` where each chunk holds
    whole reads of ``read_len`` bases at period ``read_len + 1``
    (separator cells may hold any code; they are masked by position).
    """
    T = read_len + 1
    if max_reads is None:
        max_reads = max(256, window // 32)
    set_E = jnp.asarray(set_E)
    sh = (set_E >> np.uint64(32)).astype(jnp.uint32)
    sl = set_E.astype(jnp.uint32)
    out_dev = []
    out_counts = []
    for words, n_reads in chunks:
        assert n_reads <= max_reads
        nwin = max(0, n_reads * T - k + 1)
        out_dev.append(classify_batch_periodic(
            jnp.asarray(words), np.int32(nwin), sh, sl, k, max_reads,
            window, T))
        out_counts.append(n_reads)
    if not out_dev:
        return np.zeros(0, np.uint8)
    pulled = jax.device_get(out_dev)
    return np.concatenate([p[:n] for p, n in zip(pulled, out_counts)])


def classify_packed_stream(chunks, set_E, k: int, window: int,
                           max_reads: int | None = None) -> np.ndarray:
    """Device classify over pre-packed chunks.

    ``chunks``: iterable of ``(words, inval, n_reads)`` where each
    chunk's code stream is 255-separated whole reads padded to
    ``window`` windows (the native reader's block format fed through
    :func:`gossamer_tpu.io.stream.pack_chunk`).  Returns blrg per read,
    in stream order.
    """
    import jax.numpy as jnp

    if max_reads is None:
        max_reads = max(256, window // 32)
    set_E = jnp.asarray(set_E)
    sh = (set_E >> np.uint64(32)).astype(jnp.uint32)
    sl = set_E.astype(jnp.uint32)
    out_dev = []
    out_counts = []
    for words, inval, n_reads in chunks:
        assert n_reads <= max_reads
        out_dev.append(classify_batch_packed(
            jnp.asarray(words), jnp.asarray(inval), sh, sl, k,
            max_reads, window))
        out_counts.append(n_reads)
    if not out_dev:
        return np.zeros(0, np.uint8)
    pulled = jax.device_get(out_dev)
    return np.concatenate([p[:n] for p, n in zip(pulled, out_counts)])


def encode_set_wide(lo, hi, lhs, rhs, k: int):
    """Annotated WIDE set (k > 31; 128-bit keys as u64 pairs) -> four
    sorted u32 planes of E = (key << 2) | cls, value-recanonicalized
    (see :func:`recanon_set_value`; classes are representation-
    independent, so min-by-value lets queries skip FNV hashing)."""
    from ..core import kmer as K

    lo = np.asarray(lo, np.uint64)
    hi = np.asarray(hi, np.uint64)
    rlo, rhi = K.reverse_complement(lo, hi, k)
    take = (rhi < hi) | ((rhi == hi) & (rlo < lo))
    vlo = np.where(take, rlo, lo)
    vhi = np.where(take, rhi, hi)
    order = np.lexsort((vlo, vhi))
    vlo, vhi = vlo[order], vhi[order]
    cls = ((np.asarray(lhs, np.uint64) << np.uint64(1))
           | np.asarray(rhs, np.uint64))[order]
    e_lo = (vlo << np.uint64(2)) | cls
    e_hi = (vhi << np.uint64(2)) | (vlo >> np.uint64(62))
    return ((e_hi >> np.uint64(32)).astype(np.uint32),
            e_hi.astype(np.uint32),
            (e_lo >> np.uint64(32)).astype(np.uint32),
            e_lo.astype(np.uint32))


@partial(jax.jit, static_argnums=(5, 6))
def classify_batch_wide(codes, s3, s2, s1, s0, k: int, max_reads: int):
    """Wide-key (31 < k <= 62) device classify batch: the sort-join of
    :func:`classify_batch` over FOUR u32 limb planes — completes the
    reference's k <= 62 range on the device path
    (``src/Graph.hh:87-89``; VERDICT r4 missing #2)."""
    from ..ops.engine_wide import canon_value_wide, kmerize_planes_wide

    W = codes.shape[0] - k + 1
    p3, p2, p1, p0, valid = kmerize_planes_wide(codes, k)
    rid = jnp.cumsum((codes == 255).astype(jnp.int32))[:W]
    n3, n2, n1_, n0 = canon_value_wide(p3, p2, p1, p0, k)
    q3 = (n3 << 2) | (n2 >> 30)
    q2 = (n2 << 2) | (n1_ >> 30)
    q1 = (n1_ << 2) | (n0 >> 30)
    q0 = (n0 << 2) | jnp.uint32(3)
    sent = jnp.uint32(0xFFFFFFFF)
    q3 = jnp.where(valid, q3, sent)
    q2 = jnp.where(valid, q2, sent)
    q1 = jnp.where(valid, q1, sent)
    q0 = jnp.where(valid, q0, sent)
    n_set = s3.shape[0]

    dummy = jnp.full((max_reads,), sent)
    dummy_rid = jnp.arange(max_reads, dtype=jnp.int32)
    e3 = jnp.concatenate([s3, q3, dummy])
    e2 = jnp.concatenate([s2, q2, dummy])
    e1 = jnp.concatenate([s1, q1, dummy])
    e0 = jnp.concatenate([s0, q0, dummy])
    ridp = jnp.concatenate([jnp.full((n_set,), -1, jnp.int32), rid,
                            dummy_rid])
    # stable 4-key sort: set lanes precede equal-key queries (cls=3 tie)
    e3, e2, e1, e0, ridp = jax.lax.sort((e3, e2, e1, e0, ridp),
                                        num_keys=4)
    n = e3.shape[0]
    assert n < (1 << 28), "classify batch too large for i32 scans"
    new_key = jnp.ones((n,), bool).at[1:].set(
        (e3[1:] != e3[:-1]) | (e2[1:] != e2[:-1]) | (e1[1:] != e1[:-1])
        | ((e0[1:] >> 2) != (e0[:-1] >> 2)))
    seg = jnp.cumsum(new_key.astype(jnp.int32)) - 1
    is_set = ridp < 0
    fcode = jnp.where(is_set, seg * 8 + (e0 & 3).astype(jnp.int32) + 1, 0)
    m = jax.lax.cummax(fcode)
    is_sent = (e3 == sent) & (e2 == sent) & (e1 == sent) & (e0 == sent)
    match = ~is_set & (m > seg * 8) & ~is_sent
    bits = jnp.where(match,
                     jnp.int32(1) << jnp.clip((m & 7) - 1, 0, 3), 0)
    ridq = jnp.where(is_set, jnp.int32(max_reads), ridp)
    return _agg_blrg(ridq, bits, max_reads)


def classify_codes_device_wide(codes_list, set_planes, k: int,
                               window: int | None = None) -> np.ndarray:
    """Host driver for the wide device classifier; ``set_planes`` from
    :func:`encode_set_wide`.  Same batching contract as
    :func:`classify_codes_device` (one compiled shape per window)."""
    s3, s2, s1, s0 = (jnp.asarray(p) for p in set_planes)
    if window is None:
        total = sum(len(c) + 1 for c in codes_list)
        window = max(1 << 12, 1 << int(np.ceil(np.log2(max(total, 2)))))
        window = min(window, 1 << 22)
    max_reads = max(256, window // 32)
    out_dev = []
    out_counts = []
    buf: list[np.ndarray] = []
    buf_len = 0

    def flush():
        parts = []
        for c in buf:
            parts.append(c)
            parts.append(np.array([255], np.uint8))
        flat = np.concatenate(parts)
        pad = window + k - 1 - len(flat)
        flat = np.concatenate([flat, np.full(pad, 255, np.uint8)])
        out_dev.append(classify_batch_wide(jnp.asarray(flat), s3, s2, s1,
                                           s0, k, max_reads))
        out_counts.append(len(buf))

    for c in codes_list:
        if (buf_len + len(c) + 1 > window or len(buf) >= max_reads) and buf:
            flush()
            buf, buf_len = [], 0
        buf.append(c)
        buf_len += len(c) + 1
    if buf:
        flush()
    if not out_dev:
        return np.zeros(0, np.uint8)
    pulled = jax.device_get(out_dev)
    return np.concatenate([p[:n] for p, n in zip(pulled, out_counts)])


@partial(jax.jit, static_argnums=(2,))
def join_ranks_batch(codes, set_lo, k: int):
    """codes uint8[W + k - 1] (255-separated) -> i32[W]: for each
    window, the RANK of its normalized k-mer in the sorted ``set_lo``
    plane, or -1.  The sort-join generalized to annotation-valued sets
    (taxonomy `classify-reads`/`annotate-kmers`): the per-key payload
    lives on the HOST side as ``annot[rank]``, so the device only
    resolves ranks — all scans i32.
    """
    W = codes.shape[0] - k + 1
    lo, hi, valid = dk.kmerize_flat(codes, k)
    nlo, nhi, _ = dk.normalize(lo, hi, k)
    n_set = set_lo.shape[0]
    qk = jnp.where(valid, nlo, U64(MAXU64))

    keys = jnp.concatenate([set_lo, qk])
    is_q = jnp.concatenate([jnp.zeros((n_set,), jnp.int32),
                            jnp.ones((W,), jnp.int32)])
    # payload: set lanes carry their rank, query lanes their window idx
    payload = jnp.concatenate([
        jax.lax.broadcasted_iota(jnp.int32, (n_set,), 0),
        jax.lax.broadcasted_iota(jnp.int32, (W,), 0),
    ])
    kh = (keys >> 32).astype(jnp.uint32)
    kl = keys.astype(jnp.uint32)
    kh, kl, is_q, payload = jax.lax.sort((kh, kl, is_q, payload),
                                         num_keys=3)
    n = kh.shape[0]
    assert n < (1 << 30)
    new_key = jnp.ones((n,), bool).at[1:].set(
        (kh[1:] != kh[:-1]) | (kl[1:] != kl[:-1]))
    seg = jnp.cumsum(new_key.astype(jnp.int32)) - 1
    m = jax.lax.cummax(jnp.where(is_q == 0, seg + 1, 0))
    rank_ff = jax.lax.cummax(jnp.where(is_q == 0, payload, -1))
    is_sent = (kh == jnp.uint32(0xFFFFFFFF)) & (kl == jnp.uint32(0xFFFFFFFF))
    match = (is_q == 1) & (m == seg + 1) & ~is_sent
    r = jnp.where(match, rank_ff, jnp.int32(-1))
    # unsort query lanes back to window order
    okey = jnp.where(is_q == 1, payload, jnp.int32(W))
    _, r_sorted = jax.lax.sort((okey, r), num_keys=1)
    return r_sorted[:W]


def join_ranks_device(codes_list, set_lo_dev, k: int,
                      window: int | None = None):
    """Host driver: list of read code arrays -> (rid i64[M], rank
    i32[M]) over all MATCHED windows, read ids in input order."""
    if window is None:
        total = sum(len(c) + 1 for c in codes_list)
        window = max(1 << 12, 1 << int(np.ceil(np.log2(max(total, 2)))))
        window = min(window, 1 << 22)
    out_dev = []
    metas = []  # (n_windows, rid array for this batch)
    buf: list[np.ndarray] = []
    buf_len = 0
    rid_base = 0

    def flush():
        nonlocal rid_base
        parts = []
        for c in buf:
            parts.append(c)
            parts.append(np.array([255], np.uint8))
        flat = np.concatenate(parts)
        pad = window + k - 1 - len(flat)
        if pad < 0:
            raise ValueError("batch exceeds window")
        flat = np.concatenate([flat, np.full(pad, 255, np.uint8)])
        out_dev.append(join_ranks_batch(jnp.asarray(flat), set_lo_dev, k))
        W = window
        rid = rid_base + np.cumsum(flat[:W] == 255)
        metas.append(rid)
        rid_base += len(buf)

    for c in codes_list:
        if buf_len + len(c) + 1 > window and buf:
            flush()
            buf, buf_len = [], 0
        buf.append(c)
        buf_len += len(c) + 1
    if buf:
        flush()
    if not out_dev:
        return np.zeros(0, np.int64), np.zeros(0, np.int32)
    pulled = jax.device_get(out_dev)
    rids, ranks = [], []
    for r, rid in zip(pulled, metas):
        m = r >= 0
        rids.append(rid[m].astype(np.int64))
        ranks.append(r[m])
    return np.concatenate(rids), np.concatenate(ranks)


def classify_codes_device(codes_list, set_E_dev, k: int,
                          window: int | None = None) -> np.ndarray:
    """Host driver: list of per-read code arrays -> blrg per read.

    Three rules (their cost on the GPU is not measured yet):

    * ONE compiled shape — ``max_reads`` is a window-derived constant,
      not the per-batch read count (each distinct shape compiles);
    * the window scales with the set so the set plane (re-sorted every
      batch) is never more than ~half the sorted lanes;
    * per-batch results stay on device; one ``device_get`` at the end.
    """
    if window is None:
        # throughput wants >=4M query lanes per batch and a window no
        # smaller than the set plane (re-sorted every batch); tiny
        # inputs cap at their own padded size so a 300-read call does
        # not sort 4M sentinel lanes (windows are pow2 -> one compiled
        # shape per size class)
        total = sum(len(c) + 1 for c in codes_list) if isinstance(
            codes_list, list) else None
        window = max(1 << 22, 1 << int(np.ceil(np.log2(
            max(int(set_E_dev.shape[0]), 1) + 1))))
        if total is not None and total < window:
            window = max(1 << 12, 1 << int(np.ceil(np.log2(max(total, 2)))))
    # dummy lanes cost sort width, so bound reads-per-batch well below
    # the worst case; the fill loop also flushes on read COUNT so the
    # bound holds even for degenerate sub-32-base read sets
    max_reads = max(256, window // 32)
    out_dev = []
    out_counts = []
    buf: list[np.ndarray] = []
    buf_len = 0
    # packed transfer (0.375 B/base) when the window admits it and the
    # set is already on device as a u64 plane
    packed_ok = window % 16 == 0 and 2 * k + 2 <= 64
    if packed_ok:
        sh = (jnp.asarray(set_E_dev) >> np.uint64(32)).astype(jnp.uint32)
        sl = jnp.asarray(set_E_dev).astype(jnp.uint32)

    def flush(n_reads):
        parts = []
        for c in buf:
            parts.append(c)
            parts.append(np.array([255], np.uint8))
        flat = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        pad = window + k - 1 - len(flat)
        if pad < 0:
            raise ValueError("batch exceeds window; lower batch size")
        flat = np.concatenate([flat, np.full(pad, 255, np.uint8)])
        L = len(buf[0]) if buf else 0
        uniform = (packed_ok and buf
                   and all(len(c) == L for c in buf)
                   and bool((flat[: n_reads * (L + 1)].reshape(
                       n_reads, L + 1)[:, :L] < 4).all()))
        if uniform:
            # uniform clean-read batch: periodic program, words-only
            # wire (position masks replace the invalid-code bitmap; an
            # N inside a read would defeat position masking, hence the
            # cleanliness check)
            from ..io.stream import pack_chunk

            T = L + 1
            nwin = max(0, n_reads * T - k + 1)
            out_dev.append(classify_batch_periodic(
                jnp.asarray(pack_chunk(flat, k, window)[0]),
                np.int32(nwin), sh, sl, k, max_reads, window, T))
        elif packed_ok:
            from ..io.stream import pack_chunk

            w_, v_ = pack_chunk(flat, k, window)
            out_dev.append(classify_batch_packed(
                jnp.asarray(w_), jnp.asarray(v_), sh, sl, k, max_reads,
                window))
        else:
            out_dev.append(classify_batch(jnp.asarray(flat), set_E_dev, k,
                                          max_reads))
        out_counts.append(n_reads)

    for c in codes_list:
        if (buf_len + len(c) + 1 > window or len(buf) >= max_reads) and buf:
            flush(len(buf))
            buf, buf_len = [], 0
        buf.append(c)
        buf_len += len(c) + 1
    if buf:
        flush(len(buf))
    if not out_dev:
        return np.zeros(0, np.uint8)
    pulled = jax.device_get(out_dev)
    return np.concatenate([p[:n] for p, n in zip(pulled, out_counts)])
