"""Batched k-mer counting engine v2 — u32 key planes, one sort per batch.

Device replacement for the reference counting pipeline
(``src/GossCmdBuildGraph.cc:270-491``: BackyardHash insert -> BlendedSort
radix sort -> spill runs -> AsyncMerge).  Narrow keys only (2*rho <= 62).

Design (see docs/design.md; per-operation GPU times are in PERF.md):

* **u32 planes.**  Keys travel as two explicit uint32 planes
  ``(l1, l0)`` end to end and sort as a 2-key sort.  Whether one u64
  key sorts faster on the GPU is not measured yet.
* **One sort per batch.**  Each batch of B chunks is kmerized,
  canonicalized and concatenated with the running spectrum, then a
  single 2-key sort + one 1-key compaction sort produce the new packed
  spectrum.  No per-chunk sorts, no merge tree: the previous engine
  sorted every lane ~16x per batch, this one exactly twice.
* **Counts by cumsum difference.**  The wrapped-uint32 running sum ``S``
  of the count plane rides through the compaction sort as a payload;
  per-key totals are adjacent differences of the packed ``S`` — exact
  mod 2^32 per group at any stream length, with no cummax forward-fill
  and no 64-bit scan.
* **Value-order canonicalization for symmetric spectra.**  A symmetric
  (fwd+rc) edge spectrum is fully determined by canonical-class counts,
  and *any* consistent class representative yields the same expanded
  spectrum.  The build-graph path therefore uses cheap min-by-value
  canonicalization and expands at the end; only artifacts that expose
  the representative itself (build-kmer-set) pay for the reference's
  FNV hash-then-value ordering (``src/RankSelect.hh:126-140``).

Zero host-device synchronization in steady state: per-batch live counts
are device scalars validated at ``finish()``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32
SENT32 = 0xFFFFFFFF  # sentinel in both planes; > any valid key (<= 62 bits)


def narrow_keys(rho: int) -> bool:
    return 2 * rho <= 62


# --------------------------------------------------------------------------
# kmerization + canonicalization on u32 planes
# --------------------------------------------------------------------------

def kmerize_planes(codes, rho: int):
    """uint8[..., W] -> (l1, l0, valid) planes of the W-rho+1 windows.

    Bases A=0 C=1 G=2 T=3 (``src/GossReadBaseString.hh``); any byte >= 4
    (separator 255 / N) invalidates the windows covering it.
    """
    C = codes.shape[-1] - rho + 1
    l0 = jnp.zeros(codes.shape[:-1] + (C,), U32)
    l1 = jnp.zeros_like(l0)
    valid = jnp.ones(l0.shape, bool)
    for j in range(rho):
        b = codes[..., j : j + C]
        valid &= b < 4
        l1 = (l1 << 2) | (l0 >> 30)
        l0 = (l0 << 2) | (b.astype(U32) & U32(3))
    return l1, l0, valid


def kmerize_packed(words, inval, rho: int, C: int):
    """Packed-stream kmerization: 16 funnel-shift phases.

    ``words``: uint32[..., C//16 + 2] — the 2-bit base stream packed
    big-endian (base at stream position p occupies bits
    ``[30 - 2*(p % 16), +2)`` of word ``p // 16``), zero-padded.
    ``inval``: uint8[..., ceil((C + rho - 1)/8)] — little-endian bitmap,
    bit p set iff code p is NOT a valid base (N/separator/padding).

    Returns (l1, l0, valid) covering the C windows in PHASE-MAJOR order
    (window ``p = 16*i + ph`` lands at flat index ``ph*C//16 + i``) — a
    fixed permutation, fine for sorting consumers.  The key at window p
    is bits ``[2p, 2p + 2*rho)`` of the packed stream, i.e. exactly the
    MSB-first 2-bit code concatenation of :func:`kmerize_planes`; one
    u32 funnel shift replaces the rho-step shift-or loop (2.7x less
    input transferred, ~3x fewer vector ops).
    """
    assert C % 16 == 0
    l1, l0 = _kmerize_words(words, rho, C)

    # window validity from the invalid-code bitmap: no invalid code in
    # [p, p+rho).  cumsum diff, then reshape (C16, 16) -> transpose to
    # match phase-major key order.
    bits = (inval[..., :, None] >> jnp.arange(8, dtype=jnp.uint8)) & jnp.uint8(1)
    inv = bits.reshape(inval.shape[:-1] + (-1,))[..., : C + rho - 1]
    cnt = jnp.cumsum(inv.astype(jnp.int32), axis=-1)
    # windows p=0..C-1: bad(p) = cnt[p+rho-1] - (cnt[p-1] if p else 0)
    hi_cnt = cnt[..., rho - 1 : rho - 1 + C]
    lo_cnt = jnp.concatenate(
        [jnp.zeros_like(cnt[..., :1]), cnt[..., : C - 1]], axis=-1)
    valid = (hi_cnt - lo_cnt) == 0
    return l1, l0, _phase_major(valid, C)


def _kmerize_words(words, rho: int, C: int):
    """Funnel-shift kmerization of the packed word stream (phase-major)."""
    C16 = C // 16
    A = words[..., :C16]
    Bw = words[..., 1 : C16 + 1]
    Cw = words[..., 2 : C16 + 2]
    sh = 64 - 2 * rho  # narrow keys: 2 <= sh <= 32+...
    l1s, l0s = [], []
    for ph in range(16):
        s = 2 * ph
        if s == 0:
            hi, lo = A, Bw
        else:
            hi = (A << U32(s)) | (Bw >> U32(32 - s))
            lo = (Bw << U32(s)) | (Cw >> U32(32 - s))
        if sh < 32:
            l0s.append((lo >> U32(sh)) | (hi << U32(32 - sh)))
            l1s.append(hi >> U32(sh))
        elif sh == 32:
            l0s.append(hi)
            l1s.append(jnp.zeros_like(hi))
        else:
            l0s.append(hi >> U32(sh - 32))
            l1s.append(jnp.zeros_like(hi))
    # phase-major layout: stack on a new axis before the lane axis
    return jnp.stack(l1s, axis=-2), jnp.stack(l0s, axis=-2)


def _phase_major(valid, C: int):
    C16 = C // 16
    return jnp.swapaxes(valid.reshape(valid.shape[:-1] + (C16, 16)), -1, -2)


def kmerize_packed_sparse(words, invpos, nwin, rho: int, C: int):
    """:func:`kmerize_packed` with SPARSE invalidity: ``invpos`` holds
    the sorted stream positions of invalid codes (u32, padded with
    values >= C + rho - 1) and ``nwin`` (i32 per chunk) the number of
    real windows — trailing padding is a count, not positions.  For
    read streams the separators are ~1% of codes, so this moves ~0.094
    B/base of host->device transfer down to ~0.016.
    """
    assert C % 16 == 0
    l1, l0 = _kmerize_words(words, rho, C)
    # window p valid iff no invalid position in [p, p + rho):
    # #(pos < p + rho) == #(pos < p).  Both via searchsorted into the
    # small sorted position table.
    pos = invpos.astype(U32)
    p = jax.lax.broadcasted_iota(U32, (C,), 0)
    shape = pos.shape[:-1] + (C,)
    pb = jnp.broadcast_to(p, shape)

    def ss(ps, qs):
        return jnp.searchsorted(ps, qs, side="left")

    if pos.ndim == 1:
        lo_cnt = ss(pos, pb)
        hi_cnt = ss(pos, pb + U32(rho))
    else:
        f = jax.vmap(ss)
        p2 = pos.reshape(-1, pos.shape[-1])
        lo_cnt = f(p2, pb.reshape(-1, C)).reshape(shape)
        hi_cnt = f(p2, (pb + U32(rho)).reshape(-1, C)).reshape(shape)
    valid = (hi_cnt == lo_cnt) & (pb < jnp.asarray(nwin, U32)[..., None])
    return l1, l0, _phase_major(valid, C)


def kmerize_packed_periodic(words, ph, bound, nwin, rho: int, C: int,
                            T: int):
    """:func:`kmerize_packed` for PERIODIC read streams: fixed-length
    reads of T-1 bases + 1 separator repeat with period T, so validity
    is ``(p + phase) % T <= T - 1 - rho`` — no invalid-code bitmap on
    the wire at all (words only: 0.25 B/base, the H2D floor).  ``ph``
    is the chunk's offset within its read period; ``bound`` the
    chunk-local position where a new read-group (coverage pass / file)
    starts its own period at phase 0 (no boundary: bound >= C + rho);
    ``nwin`` crops trailing padding.  Separator cells pack as code 0 in
    ``words`` (garbage keys, masked here).
    """
    assert C % 16 == 0
    l1, l0 = _kmerize_words(words, rho, C)
    q = jax.lax.broadcasted_iota(jnp.int32, (C,), 0)
    # q % T without a vector integer division: a (rows, T) iota along
    # the minor axis flattens to exactly the residue sequence
    rows = -(-C // T) + 1
    r0 = jax.lax.broadcasted_iota(jnp.int32, (rows, T), 1).reshape(-1)[:C]
    ph = jnp.asarray(ph, jnp.int32)[..., None]
    bound = jnp.asarray(bound, jnp.int32)[..., None]
    nwin = jnp.asarray(nwin, jnp.int32)[..., None]
    lim = jnp.int32(T - 1 - rho)
    Tj = jnp.int32(T)
    r1 = r0 + ph  # ph < T -> r1 in [0, 2T): one conditional subtract
    r1 = jnp.where(r1 >= Tj, r1 - Tj, r1)
    # (q - bound) % T = (r0 - bound%T) mod T; bound%T is a per-chunk
    # SCALAR mod (cheap), the vector side is add + conditional subtract
    bmod = bound % Tj
    r2 = r0 - bmod + Tj
    r2 = jnp.where(r2 >= Tj, r2 - Tj, r2)
    valid = jnp.where(q < bound, r1 <= lim, r2 <= lim) & (q < nwin)
    return l1, l0, _phase_major(valid, C)


@partial(jax.jit, static_argnums=(7, 8, 9, 10, 11))
def batch_step_packed_periodic(words, ph, bound, nwin, s_l1, s_l0, s_c,
                               rho: int, mode: str, cap: int, C: int,
                               T: int):
    """:func:`batch_step_packed` over periodic-validity input."""
    l1, l0, valid = kmerize_packed_periodic(words, ph, bound, nwin, rho,
                                            C, T)
    l1, l0, valid = _canon_mask_flat(l1, l0, valid, rho, mode)
    c = valid.astype(U32)
    k1 = jnp.concatenate([s_l1, l1])
    k0 = jnp.concatenate([s_l0, l0])
    w = jnp.concatenate([s_c, c])
    return _sort_count_compact(k1, k0, w, cap)


@partial(jax.jit, static_argnums=(6, 7, 8, 9))
def batch_step_packed_sparse(words, invpos, nwin, s_l1, s_l0, s_c,
                             rho: int, mode: str, cap: int, C: int):
    """:func:`batch_step_packed` over sparse-invalidity input."""
    l1, l0, valid = kmerize_packed_sparse(words, invpos, nwin, rho, C)
    l1, l0, valid = _canon_mask_flat(l1, l0, valid, rho, mode)
    c = valid.astype(U32)
    k1 = jnp.concatenate([s_l1, l1])
    k0 = jnp.concatenate([s_l0, l0])
    w = jnp.concatenate([s_c, c])
    return _sort_count_compact(k1, k0, w, cap)


def packed_geometry(rho: int, C: int) -> tuple[int, int]:
    """(words_len, inval_len) of one packed chunk of C windows."""
    return C // 16 + 2, -(-(C + rho - 1) // 8)


def _canon_mask_flat(l1, l0, valid, rho: int, mode: str):
    """Shared tail of the batch steps: canonicalize + sentinel-mask."""
    l1 = l1.reshape(-1)
    l0 = l0.reshape(-1)
    valid = valid.reshape(-1)
    canon = _CANON[mode]
    if canon is not None:
        l1, l0 = canon(l1, l0, rho)
    sent = U32(SENT32)
    l1 = jnp.where(valid, l1, sent)
    l0 = jnp.where(valid, l0, sent)
    return l1, l0, valid


@partial(jax.jit, static_argnums=(5, 6, 7, 8))
def batch_step_packed(words, inval, s_l1, s_l0, s_c, rho: int, mode: str,
                      cap: int, C: int):
    """:func:`batch_step` over packed input (XLA sort path)."""
    l1, l0, valid = kmerize_packed(words, inval, rho, C)
    l1, l0, valid = _canon_mask_flat(l1, l0, valid, rho, mode)
    c = valid.astype(U32)
    k1 = jnp.concatenate([s_l1, l1])
    k0 = jnp.concatenate([s_l0, l0])
    w = jnp.concatenate([s_c, c])
    return _sort_count_compact(k1, k0, w, cap)


def _rev2_u32(x):
    """Reverse 2-bit groups within each uint32 (``src/Utils.hh:377-396``)."""
    m2 = U32(0x33333333)
    m4 = U32(0x0F0F0F0F)
    m8 = U32(0x00FF00FF)
    x = ((x & m2) << 2) | ((x >> 2) & m2)
    x = ((x & m4) << 4) | ((x >> 4) & m4)
    x = ((x & m8) << 8) | ((x >> 8) & m8)
    return (x << 16) | (x >> 16)


def rc_planes(l1, l0, rho: int):
    """Reverse complement of a 2*rho-bit key in u32 planes
    (``src/BigInteger.hh:193-216``: NOT, 2-bit reverse, shift down)."""
    n1 = _rev2_u32(~l0)  # 64-bit 2-bit-reverse swaps the planes
    n0 = _rev2_u32(~l1)
    s = 64 - 2 * rho
    if s == 0:
        return n1, n0
    if s < 32:
        return (n1 >> s) | jnp.zeros_like(n1), (n0 >> s) | (n1 << (32 - s))
    if s == 32:
        return jnp.zeros_like(n1), n1
    return jnp.zeros_like(n1), n1 >> (s - 32)


def _less(a1, a0, b1, b0):
    return (a1 < b1) | ((a1 == b1) & (a0 < b0))


def canon_value(l1, l0, rho: int):
    """min(x, rc(x)) by value — consistent class representative for
    symmetric spectra (orientation-independent; see module docstring)."""
    r1, r0 = rc_planes(l1, l0, rho)
    take = _less(r1, r0, l1, l0)
    return jnp.where(take, r1, l1), jnp.where(take, r0, l0)


def fnv_planes(l1, l0):
    """FNV-1a over the 16 LE bytes of the 128-bit value (hi word zero for
    narrow keys), digit-decomposed so no 64-bit multiply is emulated
    (``src/BigInteger.hh:528-536,572-582``).  Returns (hash_hi32, hash_lo32).
    """
    FNV_OFFSET = 14695981039346656037
    d = [
        jnp.full(l0.shape, (FNV_OFFSET >> (16 * i)) & 0xFFFF, U32)
        for i in range(4)
    ]
    m16 = U32(0xFFFF)
    c1b3 = U32(0x1B3)

    def step(d, byte):
        d0 = d[0] ^ byte
        t0 = d0 * c1b3
        t1 = d[1] * c1b3
        t2 = d[2] * c1b3
        t3 = d[3] * c1b3
        r2 = (d0 << 8) & m16
        r3 = ((d0 >> 8) | (d[1] << 8)) & m16
        s0 = t0
        s1 = t1 + (s0 >> 16)
        s2 = t2 + r2 + (s1 >> 16)
        s3 = t3 + r3 + (s2 >> 16)
        return [s0 & m16, s1 & m16, s2 & m16, s3 & m16]

    for word in (l0, l1):
        for i in range(4):
            d = step(d, (word >> (8 * i)) & U32(0xFF))
    zero = jnp.zeros_like(l0)
    for _ in range(8):  # hi u64 word of the 128-bit value is zero
        d = step(d, zero)
    return (d[3] << 16) | d[2], (d[1] << 16) | d[0]


def canon_ref(l1, l0, rho: int):
    """Reference canonicalization: min by (FNV hash, value)
    (``src/RankSelect.hh:126-140``)."""
    r1, r0 = rc_planes(l1, l0, rho)
    fh, fl = fnv_planes(l1, l0)
    rh, rl = fnv_planes(r1, r0)
    take = _less(rh, rl, fh, fl) | (
        (rh == fh) & (rl == fl) & _less(r1, r0, l1, l0)
    )
    return jnp.where(take, r1, l1), jnp.where(take, r0, l0)


_CANON = {"plain": None, "value": canon_value, "ref": canon_ref}


# --------------------------------------------------------------------------
# the batch step: kmerize -> canon -> [spectrum ++ batch] -> sort ->
# group-count -> compact -> crop.  One jitted program, compiled once.
# --------------------------------------------------------------------------

@partial(jax.jit, static_argnums=(4, 5, 6))
def batch_step(codes, s_l1, s_l0, s_c, rho: int, mode: str, cap: int):
    """Fold one batch of code chunks into the running spectrum.

    codes: uint8[B, C + rho - 1]; spectrum planes at ``cap`` lanes,
    packed ascending, sentinel tail.  Returns (l1, l0, c, live) where
    ``live`` (device scalar) is the distinct-key count — if it exceeds
    ``cap`` the crop lost keys and the caller must fail/retry.
    """
    l1, l0, valid = kmerize_planes(codes, rho)
    l1 = l1.reshape(-1)
    l0 = l0.reshape(-1)
    valid = valid.reshape(-1)
    canon = _CANON[mode]
    if canon is not None:
        l1, l0 = canon(l1, l0, rho)
    sent = U32(SENT32)
    l1 = jnp.where(valid, l1, sent)
    l0 = jnp.where(valid, l0, sent)
    c = valid.astype(U32)

    k1 = jnp.concatenate([s_l1, l1])
    k0 = jnp.concatenate([s_l0, l0])
    w = jnp.concatenate([s_c, c])
    return _sort_count_compact(k1, k0, w, cap)


def _sort_count_compact(k1, k0, w, cap: int):
    """Sort (k1,k0) lanes, sum counts of equal keys, pack reps, crop."""
    n = k1.shape[0]
    k1, k0, w = jax.lax.sort((k1, k0, w), num_keys=2)
    S = jnp.cumsum(w)  # u32, wraps; per-group diffs stay exact
    is_new = jnp.ones((n,), bool).at[1:].set(
        (k1[1:] != k1[:-1]) | (k0[1:] != k0[:-1]))
    is_last = jnp.ones((n,), bool).at[:-1].set(is_new[1:])
    # group representatives (last lanes) are already in key order, so the
    # lane index itself is a valid compaction key — no seg cumsum needed
    lane = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    comp_key = jnp.where(is_last, lane, jnp.int32(n))
    _, k1, k0, S = jax.lax.sort((comp_key, k1, k0, S), num_keys=1)
    k1, k0, S = k1[:cap], k0[:cap], S[:cap]
    c = S - jnp.concatenate([jnp.zeros((1,), U32), S[:-1]])
    n_groups = jnp.sum(is_new.astype(jnp.int32))
    # a sentinel group exists iff the largest key is sentinel; its rep is
    # the last packed lane (rank n_groups-1, clamped if the crop lost it)
    idx = jnp.minimum(n_groups - 1, cap - 1)
    sent = U32(SENT32)
    has_sentinel = (k1[idx] == sent) & (k0[idx] == sent)
    live = jnp.where(has_sentinel, n_groups - 1, n_groups)
    lane = jnp.arange(cap, dtype=jnp.int32)
    keep = lane < live
    return (
        jnp.where(keep, k1, sent),
        jnp.where(keep, k0, sent),
        jnp.where(keep, c, U32(0)),
        live,
    )


@partial(jax.jit, static_argnums=(3,))
def expand_step(l1, l0, c, rho: int):
    """Canonical-class spectrum -> symmetric (fwd+rc) edge spectrum.

    Palindromic keys collapse to one entry with doubled count, matching
    the reference's fwd+rc insertion (``src/ReverseComplementAdapter.hh``).
    Output is packed ascending over 2*cap lanes.
    """
    cap = l1.shape[0]
    sent = U32(SENT32)
    is_sent = (l1 == sent) & (l0 == sent)
    r1, r0 = rc_planes(l1, l0, rho)
    r1 = jnp.where(is_sent, sent, r1)
    r0 = jnp.where(is_sent, sent, r0)
    k1 = jnp.concatenate([l1, r1])
    k0 = jnp.concatenate([l0, r0])
    w = jnp.concatenate([c, c])
    return _sort_count_compact(k1, k0, w, 2 * cap)


@partial(jax.jit, static_argnums=(6,))
def spectra_merge(a_l1, a_l0, a_c, b_l1, b_l0, b_c, cap: int):
    """Merge two packed spectra (counts summed on equal keys)."""
    k1 = jnp.concatenate([a_l1, b_l1])
    k0 = jnp.concatenate([a_l0, b_l0])
    w = jnp.concatenate([a_c, b_c])
    return _sort_count_compact(k1, k0, w, cap)


def empty_spec(cap: int):
    """Fresh all-sentinel spectrum planes at ``cap`` lanes."""
    sent = np.uint32(SENT32)
    return (
        jnp.full((cap,), sent),
        jnp.full((cap,), sent),
        jnp.zeros((cap,), U32),
    )


class SpectrumEngine:
    """Host driver: stream code chunks, keep a packed device spectrum.

    ``mode``: 'value' (min-by-value classes, for symmetric expansion),
    'ref' (reference FNV canonicalization, build-kmer-set parity), or
    'plain' (forward strand as-is).

    ``cap`` bounds the *device-resident* distinct-key working set.  When
    ``spill=True`` (default) a spectrum outgrowing it is pulled to host
    RAM as a sorted run and the device spectrum restarts — the
    HBM->host-RAM analog of the reference's RAM->disk spill
    (``src/GossCmdBuildKmerSet.tcc:246-328``); runs are k-way merged at
    ``finish()``.  Spills are scheduled without per-batch syncs: the
    live count can grow at most by the lanes inserted since it was last
    read, so a device sync is only needed when that bound approaches
    ``cap``.  With ``spill=False`` overflowing ``cap`` raises instead.
    """

    def __init__(self, rho: int, mode: str, chunk: int, batch: int = 8,
                 cap: int = 1 << 23, spill: bool = True, on_spill=None,
                 early_pull_flush: int | None = None,
                 expected_distinct: int | None = None, period: int = 0,
                 first_batch: int | None = None):
        assert narrow_keys(rho), "engine requires 2*rho <= 62"
        assert mode in _CANON
        self.rho = rho
        self.mode = mode
        self.chunk = chunk
        self.batch = batch
        # a smaller FIRST flush moves the early-pull snapshot forward:
        # the key-plane transfer then overlaps more remaining compute
        # (one extra small-width program compile, cached)
        self.first_batch = first_batch if first_batch else batch
        # ``cap`` is the ceiling; the current device cap starts sized to
        # the first flush and grows geometrically through spills, so tiny
        # inputs never sort ceiling-sized padding
        self.req_cap = cap
        self.cap = 0
        self.spill_enabled = spill
        self.on_spill = on_spill  # callback(run_index, run_len) telemetry
        self.spills = 0
        # None until the first chunk arrives: raw-u8 (add_chunk) and
        # packed (add_chunk_packed[_sparse]) inputs must not mix in one
        # engine
        self.packed: bool | None = None
        self.sparse = False
        self.periodic = False
        self.period = int(period)  # fixed read period (read_len + 1)
        self.buf: list[np.ndarray] = []
        self.spec = None
        self.live_scalars: list = []
        self.host_runs: list[tuple[np.ndarray, np.ndarray]] = []
        # overflow-safe sync scheduling: live <= checked_live + lanes
        # inserted since the check
        self._checked_live = 0
        self._lanes_since_check = 0
        # early pull: after flush #early_pull_flush, snapshot the key
        # planes and start their device->host transfer asynchronously so
        # it overlaps the remaining batches' compute; finish() then only
        # pulls final counts + keys discovered after the snapshot.
        # expected_distinct (a hint, e.g. genome-size estimate) lets the
        # snapshot size its transfer without a device sync.
        self.early_pull_flush = early_pull_flush
        self.expected_distinct = expected_distinct
        self._nflush = 0
        self._snap = None  # (planes, k_pieces, async arrays, live scalar)
        self._prex = None  # (sel, future) background snapshot pre-work
        self._prex_pool = None
        # finish-time programs dispatched BEFORE the live-scalar sync so
        # their compute and device->host transfer ride the queue behind
        # the last flush instead of serializing after it
        self._fin = None
        self._last_reconcile = None
        # per-phase wall seconds of the last finish (VERDICT r4 item 7:
        # a BENCH line must carry the phase split, not just the total)
        self.phases: dict[str, float] = {}

    def _empty_spec(self):
        return empty_spec(self.cap)

    def _trigger(self) -> int:
        """Chunks that trigger a flush (smaller for the first one)."""
        return self.first_batch if self._nflush == 0 else self.batch

    def add_chunk(self, codes: np.ndarray) -> None:
        if self.packed is None:
            self.packed = False
        assert not self.packed
        self.buf.append(codes)
        if len(self.buf) >= self._trigger():
            self._flush()

    def add_chunk_packed(self, words: np.ndarray, inval: np.ndarray) -> None:
        """Queue one packed chunk (see :func:`kmerize_packed`); 2.7x less
        host->device transfer than :meth:`add_chunk`."""
        if self.packed is None:
            self.packed = True
        assert self.packed and not self.sparse
        self.buf.append((words, inval))
        if len(self.buf) >= self._trigger():
            self._flush()

    def add_chunk_packed_sparse(self, words: np.ndarray, invpos: np.ndarray,
                                nwin: int) -> None:
        """Queue one sparse-invalidity packed chunk (see
        :func:`kmerize_packed_sparse`); ~0.26 B/base on the wire."""
        if self.packed is None:
            self.packed = True
            self.sparse = True
        assert self.packed and self.sparse
        self.buf.append((words, invpos, np.int32(nwin)))
        if len(self.buf) >= self._trigger():
            self._flush()

    def add_chunk_packed_periodic(self, words: np.ndarray, ph: int,
                                  bound: int, nwin: int) -> None:
        """Queue one periodic-validity packed chunk (fixed-length read
        streams, see :func:`kmerize_packed_periodic`): 0.25 B/base on
        the wire — the H2D floor.  Requires ``period`` set on the
        engine (read length + 1)."""
        if self.packed is None:
            self.packed = True
            self.periodic = True
        assert self.packed and self.periodic and self.period > 0
        self.buf.append((words, np.int32(ph), np.int32(bound),
                         np.int32(nwin)))
        if len(self.buf) >= self._trigger():
            self._flush()

    def _finish_flush(self) -> None:
        """Drain the queue at finish (the padded partial batch)."""
        self._flush()
        self._prefetch_finish()

    def _flush(self) -> None:
        if not self.buf:
            return
        if self.packed is None:
            self.packed = False
        # A short *first* batch compiles its own (smaller) program instead
        # of sorting filler; a short *final* batch after full ones pads to
        # the batch width to reuse the already-compiled program.
        if self.spec is not None and len(self.buf) < self.batch:
            if self.periodic:
                pad = (np.zeros_like(self.buf[0][0]), np.int32(0),
                       np.int32(0), np.int32(0))
            elif self.sparse:
                pad = (np.zeros_like(self.buf[0][0]),
                       self.buf[0][1].copy(), np.int32(0))
            elif self.packed:
                pad = (np.zeros_like(self.buf[0][0]),
                       np.full_like(self.buf[0][1], 0xFF))
            else:
                pad = np.full_like(self.buf[0], 255)
            while len(self.buf) < self.batch:
                self.buf.append(pad)
        if self.periodic:
            stack = (jnp.asarray(np.stack([t[0] for t in self.buf])),
                     jnp.asarray(np.stack([t[1] for t in self.buf])),
                     jnp.asarray(np.stack([t[2] for t in self.buf])),
                     jnp.asarray(np.stack([t[3] for t in self.buf])))
        elif self.sparse:
            stack = (jnp.asarray(np.stack([t[0] for t in self.buf])),
                     jnp.asarray(np.stack([t[1] for t in self.buf])),
                     jnp.asarray(np.stack([t[2] for t in self.buf])))
        elif self.packed:
            stack = (jnp.asarray(np.stack([w for w, _ in self.buf])),
                     jnp.asarray(np.stack([v for _, v in self.buf])))
        else:
            stack = jnp.asarray(np.stack(self.buf))
        batch_lanes = len(self.buf) * self.chunk
        self.buf = []
        want = min(self.req_cap, max(1 << 14, 2 * batch_lanes))
        if want > self.cap:
            if self.spec is not None and self.live_scalars:
                self._spill_to_host()
            self.cap = want
            self.spec = self._empty_spec()
        elif self.spec is None:
            self.spec = self._empty_spec()
        if self.periodic:
            l1, l0, c, live = batch_step_packed_periodic(
                *stack, *self.spec, self.rho, self.mode, self.cap,
                self.chunk, self.period)
        elif self.sparse:
            l1, l0, c, live = batch_step_packed_sparse(
                *stack, *self.spec, self.rho, self.mode, self.cap,
                self.chunk)
        elif self.packed:
            l1, l0, c, live = batch_step_packed(
                *stack, *self.spec, self.rho, self.mode, self.cap,
                self.chunk)
        else:
            l1, l0, c, live = batch_step(stack, *self.spec, self.rho,
                                         self.mode, self.cap)
        self.spec = (l1, l0, c)
        self._fin = None  # any cached finish programs are now stale
        self.live_scalars.append(live)
        self._nflush += 1
        if not self.spill_enabled:
            # zero-sync mode: overflow is caught by the consolidated
            # max-live check at finish(); start the scalar's transfer now
            # so the finish-time read does not wait for it
            try:
                live.copy_to_host_async()
            except Exception:
                pass
            if self._nflush == self.early_pull_flush:
                self.snapshot_async()
            return
        self._lanes_since_check += batch_lanes
        bound = self._checked_live + self._lanes_since_check
        next_lanes = self.batch * self.chunk
        if bound + next_lanes > self.cap:
            self._checked_live = int(live)  # device sync
            self._lanes_since_check = 0
            if self._checked_live > self.cap:
                raise RuntimeError(
                    f"distinct keys of one batch ({self._checked_live}) "
                    f"exceeded cap ({self.cap}); raise --spectrum-cap "
                    f"or lower --buffer-size")
            if self._checked_live + next_lanes > self.cap:
                if self.cap < self.req_cap:
                    # grow geometrically: spill and restart wider
                    self._spill_to_host()
                    self.cap = min(self.req_cap, 2 * self.cap)
                    self.spec = self._empty_spec()
                elif self.spill_enabled:
                    self._spill_to_host()
                else:
                    raise RuntimeError(
                        f"spectrum working set exceeded cap ({self.cap}); "
                        f"rerun with a larger --spectrum-cap")
        if self._nflush == self.early_pull_flush:
            self.snapshot_async()

    def snapshot_async(self) -> bool:
        """Snapshot the key planes and begin their async device->host pull.

        The spectrum only gains keys between flushes, so a mid-stream
        snapshot is a subset of the final keyset; its ~5 B/key transfer
        rides the link while the remaining batches compute, and
        ``finish()`` reconciles: it pulls only the final count plane
        (1 B/key) plus the delta-packed keys discovered after the
        snapshot.  This converts the finish-time pull from the largest
        serial phase into max(compute, transfer) — the overlap the
        reference gets from draining Graph::Builder concurrently with
        merge fill jobs (``src/AsyncMerge.tcc:237-257``).

        Returns False (no snapshot) when ineligible: empty spectrum,
        spilled runs present, sparse keyspace where u32 deltas overflow,
        or a spectrum too small for the delta path to pay off.
        """
        if self.spec is None or self.host_runs or not self.live_scalars:
            return False
        if self.expected_distinct is not None:
            n_bound = min(self.cap,
                          int(1.25 * self.expected_distinct) + (1 << 16))
        else:
            n_bound = int(self.live_scalars[-1])  # device sync
        dense = 2 * self.rho <= 31 or n_bound >= (1 << (2 * self.rho - 31))
        if n_bound < _DELTA_MIN or not dense:
            return False
        pieces, excp, n_exc = _delta_pack(*self.spec, self.cap)
        npc = -(-self.cap // _PIECE)
        k = min(npc, -(-n_bound // _PIECE))
        pe = _exc_est_pieces(n_bound)
        # keys only: the snapshot's counts are stale by finish time (the
        # final count plane is re-pulled there), so not transferring them
        # makes snapshot+finish pull FEWER total bytes than the classic
        # finish-time pull — on top of the compute overlap
        sel = pieces[:k] + excp[:pe] + [n_exc]
        for a in sel:
            try:
                a.copy_to_host_async()
            except Exception:
                pass
        live_s = self.live_scalars[-1]
        self._snap = (self.spec, k, pe, sel, excp, live_s)
        # background pre-work: as soon as the snapshot pieces land, a
        # worker thread decodes the keys AND pre-computes the symmetric
        # expansion order (rc + argsort — the finish() tail's largest
        # host phase) while the device still streams batches
        if self.mode in ("value", "ref"):
            import concurrent.futures as _fut

            if self._prex_pool is None:
                self._prex_pool = _fut.ThreadPoolExecutor(
                    1, thread_name_prefix="goss-prex")
            self._prex = (sel, self._prex_pool.submit(
                self._prex_work, sel, k, pe, excp, live_s))
        return True

    def _prex_work(self, sel, k: int, pe: int, excp, live_s):
        """Worker: wait for the snapshot pieces to land and decode the
        keys, overlapping the remaining flushes' device compute, and
        (with the native library) the symmetric-expansion order."""
        try:
            n1 = int(live_s)
            if n1 <= 0 or n1 > k * _PIECE:
                return None
            sflat = [np.asarray(a) for a in sel]
            s_nexc = int(sflat[k + pe])
            if s_nexc > _EXC_CAP:
                return None
            s_exc = _exc_fetch(excp, s_nexc, sflat[k : k + pe])
            lo_s, _cs = _delta_unpack(sflat[:k], [np.zeros(n1, np.uint32)],
                                      s_exc, s_nexc, n1)
            out = {"n1": n1, "lo_s": lo_s}
            if self.mode in ("value", "ref"):
                # the symmetric-expansion ORDER depends only on the keys:
                # compute it here (native 2-thread radix merge) so the
                # finish tail is just a counts gather.  Skipped silently
                # without the native library (finish falls back to the
                # full expand).
                from ..io.native import native_expand_order

                order = native_expand_order(lo_s, self.rho)
                if order is not None:
                    out["out"], out["src"], out["dbl"] = order
            return out
        except Exception:
            return None

    def _fin_programs(self, spec_s, planes):
        """Reconcile + count-pack program results for ``planes`` vs the
        snapshot — reusing the instance dispatched by
        :meth:`_prefetch_finish` when it matches (re-calling the jitted
        functions would re-execute the programs on device)."""
        if self._fin is not None and self._fin[0] is planes:
            return self._fin[1]
        nexcp, nnew_dev = _reconcile_new_keys(spec_s[0], spec_s[1],
                                              planes[0], planes[1],
                                              self.cap)
        out = (nexcp, nnew_dev) + _count_pack(planes[0], planes[1],
                                              planes[2], self.cap)
        self._fin = (planes, out)
        return out

    def _prefetch_finish(self) -> None:
        """Dispatch the finish-time reconcile/count-pack programs and
        start their device->host transfers right after the final flush,
        BEFORE the live-scalar sync: their compute queues behind the
        last batch and the pulled pieces ride the link under it, so the
        finish-time ``device_get`` mostly finds resident arrays.  Piece
        counts are sized from ``expected_distinct`` (the fallback path
        re-fetches any shortfall)."""
        if (self._snap is None or self.spec is None or self.host_runs
                or self.expected_distinct is None):
            return
        spec_s = self._snap[0]
        nexcp, nnew_dev, cpk, cexcp, cnexc = \
            self._fin_programs(spec_s, self.spec)
        npc = -(-self.cap // _PIECE)
        n_b = min(self.cap,
                  int(1.25 * self.expected_distinct) + (1 << 16))
        kc = min(npc, -(-max(n_b, 1) // _PIECE))
        # count-overflow exceptions (count >= 255) are rare — start one
        # piece; new keys after the snapshot are few — start two exact-
        # row pieces (32K keys); _exc_fetch covers any shortfall
        sel = (cpk[:kc] + cexcp[:1] + [cnexc] + nexcp[:2] + [nnew_dev])
        for a in sel:
            try:
                a.copy_to_host_async()
            except Exception:
                pass

    def _pull_reconciled(self, planes, n_out: int):
        """Finish-time pull against a mid-stream snapshot; None -> caller
        falls back to the exact pull (snapshot bound exceeded, exception
        overflow, or a consistency check failed)."""
        spec_s, k, pe, sel, s_excp, live_s = self._snap
        n1 = int(live_s)
        if n1 <= 0 or n1 > k * _PIECE or n_out < n1:
            return None
        npc = -(-self.cap // _PIECE)
        kc = min(npc, -(-max(n_out, 1) // _PIECE))
        nexcp, nnew_dev, cpk, cexcp, cnexc = \
            self._fin_programs(spec_s, planes)
        pn = _exc_est_pieces(max(n_out - n1, 1))
        import time as _time

        t0 = _time.time()
        flat = jax.device_get(nexcp[:pn] + [nnew_dev]
                              + cpk[:kc] + cexcp[:1] + [cnexc])
        self.phases["fin_get"] = round(_time.time() - t0, 3)
        self.phases["fin_arrays"] = pn + kc + 3
        n_new = int(flat[pn])
        if n_new != n_out - n1 or n_new > _EXC_CAP:
            return None
        cbase = pn + 1
        c_nexc = int(flat[cbase + kc + 1])
        if c_nexc > _EXC_CAP:
            return None
        cexc = _exc_fetch(cexcp, c_nexc, flat[cbase + kc : cbase + kc + 1])
        c = _counts_from_pack(flat[cbase : cbase + kc], cexc, c_nexc, n_out)
        if c is None:
            return None
        # snapshot keys (and usually the expansion order): decoded by
        # the background worker while the remaining flushes computed
        lo_s = prex = None
        if self._prex is not None and self._prex[0] is sel:
            t0 = _time.time()
            prex = self._prex[1].result()
            self.phases["prex_wait"] = round(_time.time() - t0, 3)
            if prex is not None and prex["n1"] == n1:
                lo_s = prex["lo_s"]
            else:
                prex = None
        if lo_s is None:
            sflat = [np.asarray(a) for a in sel]
            s_nexc = int(sflat[k + pe])
            if s_nexc > _EXC_CAP:
                return None
            s_exc = _exc_fetch(s_excp, s_nexc, sflat[k : k + pe])
            lo_s, _cs = _delta_unpack(sflat[:k],
                                      [np.zeros(n1, np.uint32)],
                                      s_exc, s_nexc, n1)
        if n_new:
            exc = _exc_fetch(nexcp, n_new, flat[:pn])
            lo_n = ((exc[1][:n_new].astype(np.uint64) << np.uint64(32))
                    | exc[2][:n_new])
            lo = np.insert(lo_s, np.searchsorted(lo_s, lo_n), lo_n)
        else:
            lo_n = None
            lo = lo_s
        self._last_reconcile = {"prex": prex, "n1": n1, "n_new": n_new,
                                "lo_s": lo_s, "lo_n": lo_n}
        return lo, np.zeros_like(lo), c

    def _spill_to_host(self) -> None:
        """Pull the packed device spectrum to host RAM and restart.

        Runs are held varint-delta encoded (~5 B/key vs 16 raw; the
        reference's spill-file design, ``src/EdgeAndCount.hh:78-112``)
        so beyond-HBM spectra fit ~3x more host RAM; raw arrays when
        the native codec is unavailable."""
        self._snap = None  # snapshot refers to the spectrum being retired
        self._prex = None
        self._fin = None
        lo, _hi, c = self._finish_planes(self.spec)
        from ..io.native import encode_spill_run

        enc = encode_spill_run(lo, c)
        if enc is not None:
            self.host_runs.append((("eac", enc, len(lo)), None))
        else:
            self.host_runs.append((lo, c))
        self.spills += 1
        if self.on_spill is not None:
            self.on_spill(self.spills, len(lo))
        self.spec = self._empty_spec()
        self.live_scalars = []
        self._checked_live = 0
        self._lanes_since_check = 0

    def _merged_host(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """finish() result via host-RAM k-way merge of spilled runs."""
        from ..io.native import decode_spill_run

        runs = []
        for a, b in self.host_runs:
            if isinstance(a, tuple) and a[0] == "eac":
                runs.append(decode_spill_run(a[1], a[2]))
            else:
                runs.append((a, b))
        lo, _hi, c = self._finish_planes(self.spec)
        runs.append((lo, c))
        while len(runs) > 1:
            runs.sort(key=lambda r: len(r[0]))
            (alo, ac), (blo, bc) = runs.pop(0), runs.pop(0)
            lo = np.concatenate([alo, blo])
            c = np.concatenate([ac, bc])
            order = np.argsort(lo, kind="stable")
            lo, c = lo[order], c[order]
            new = np.ones(len(lo), bool)
            new[1:] = lo[1:] != lo[:-1]
            idx = np.cumsum(new) - 1
            out = np.zeros(int(idx[-1]) + 1 if len(idx) else 0, c.dtype)
            np.add.at(out, idx, c)
            runs.append((lo[new], out))
        lo, c = runs[0]
        return lo, np.zeros_like(lo), c

    def finish(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (lo u64, hi u64 zeros, counts i64), packed ascending."""
        self._finish_flush()
        if self.spec is None:
            z = np.zeros(0, np.uint64)
            return z, z.copy(), np.zeros(0, np.int64)
        if self.host_runs:
            return self._merged_host()
        return self._finish_planes(self.spec)

    def finish_expanded(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Finish and expand to the symmetric fwd+rc edge spectrum on
        device (build-graph semantics; requires mode 'value' or 'ref')."""
        import time as _time

        t0 = _time.time()
        self._finish_flush()
        self.phases = {"flush_tail": round(_time.time() - t0, 3)}
        if self.spec is None:
            z = np.zeros(0, np.uint64)
            return z, z.copy(), np.zeros(0, np.int64)
        from .count import _expand_symmetric

        if self.host_runs:
            lo, _hi, c = self._merged_host()
            return _expand_symmetric(lo, c, self.rho)
        # reconciled fast path: the snapshot worker decoded the keys
        # mid-stream and the finish-time programs + their transfers were
        # prefetched before this sync, so the tail is counts-decode +
        # the native symmetric expansion
        if self._snap is not None and self._prex is not None:
            t0 = _time.time()
            n_out = int(self.live_scalars[-1]) if self.live_scalars else 0
            self._check_live()
            self.phases["sync"] = round(_time.time() - t0, 3)
            t0 = _time.time()
            out = self._pull_reconciled_expanded(self.spec, n_out)
            self.phases["reconcile"] = round(_time.time() - t0, 3)
            if out is not None:
                self._snap = None
                self._prex = None
                return out
        # pull the CANONICAL spectrum and expand on the host: half the
        # device->host bytes of pulling the expanded planes
        t0 = _time.time()
        lo, _hi, c = self._finish_planes(self.spec)
        self.phases["pull"] = round(_time.time() - t0, 3)
        t0 = _time.time()
        out = _expand_symmetric(lo, c, self.rho)
        self.phases["expand"] = round(_time.time() - t0, 3)
        return out

    def _pull_reconciled_expanded(self, planes, n_out: int):
        """Reconciled finish, then the native symmetric expansion."""
        import time as _time

        out = self._pull_reconciled(planes, n_out)
        if out is None:
            return None
        from .count import _expand_symmetric

        lo, _hi, c = out
        info = self._last_reconcile or {}
        prex = info.get("prex")
        t0 = _time.time()
        self.phases["expand_path"] = (
            "order" if prex is not None and "out" in prex else "full")
        if prex is not None and "out" in prex:
            # apply final counts through the background-computed order
            n1, n_new = info["n1"], info["n_new"]
            if n_new:
                # counts c align with merge(lo_s, lo_n); split them in
                # one native pass (numpy fallback below)
                from ..io.native import native_split_counts

                t1 = _time.time()
                idx = np.searchsorted(info["lo_s"], info["lo_n"])
                out = native_split_counts(idx, c, n1, n_new)
                self.phases["exp_split"] = round(_time.time() - t1, 3)
                if out is not None:
                    c_snap, c_new = out
                else:
                    cum = np.cumsum(np.bincount(idx,
                                                minlength=n1 + 1))[:n1]
                    c_snap = c[np.arange(n1, dtype=np.int64) + cum]
                    c_new = c[idx + np.arange(n_new, dtype=np.int64)]
            else:
                c_snap = c
            out_lo = prex["out"]
            from ..io.native import native_apply_order

            t1 = _time.time()
            out_c = native_apply_order(prex["src"], prex["dbl"], c_snap)
            self.phases["exp_apply"] = round(_time.time() - t1, 3)
            if out_c is None:
                out_c = c_snap[prex["src"]]
                out_c = np.where(prex["dbl"], 2 * out_c, out_c)
            if n_new:
                from ..core import kmer as K
                from ..io.native import native_insert_merge

                lo_n = info["lo_n"]
                rlo_n, _ = K.reverse_complement(lo_n, np.zeros_like(lo_n),
                                                self.rho)
                paln = rlo_n == lo_n
                npaln = ~paln
                add_lo = np.concatenate([lo_n, rlo_n[npaln]])
                add_c = np.concatenate([np.where(paln, 2 * c_new, c_new),
                                        c_new[npaln]])
                o2 = np.argsort(add_lo, kind="stable")
                add_lo, add_c = add_lo[o2], add_c[o2]
                t1 = _time.time()
                merged = native_insert_merge(out_lo, out_c, add_lo, add_c)
                if merged is not None:
                    out_lo, out_c = merged
                else:
                    ins = np.searchsorted(out_lo, add_lo)
                    out_lo = np.insert(out_lo, ins, add_lo)
                    out_c = np.insert(out_c, ins, add_c)
                self.phases["exp_merge"] = round(_time.time() - t1, 3)
            self.phases["expand"] = round(_time.time() - t0, 3)
            return out_lo, np.zeros_like(out_lo), out_c.astype(np.int64)
        res = _expand_symmetric(lo, c, self.rho)
        self.phases["expand"] = round(_time.time() - t0, 3)
        return res

    def _finish_planes(self, planes):
        # read the FINAL batch's live scalar first: it forces the whole
        # deferred chain in one round trip (its transfer was prefetched
        # at dispatch); earlier scalars are then already resident.
        n_out = int(self.live_scalars[-1]) if self.live_scalars else 0
        self._check_live()
        if self._snap is not None and planes is self.spec:
            out = self._pull_reconciled(planes, n_out)
            self._snap = None
            if out is not None:
                return out
        return self._pull_planes(planes, n_out)

    def _check_live(self):
        arr = np.array([int(x) for x in self.live_scalars], np.int64)
        max_live = int(arr.max()) if len(arr) else 0
        if max_live > self.cap:
            raise RuntimeError(
                f"spectrum working set ({max_live}) exceeded cap "
                f"({self.cap}); rerun with a larger --spectrum-cap")

    def _pull_planes(self, planes, n_out: int):
        # pull only the live prefix, padded to bound the number of
        # compiled slice shapes; split into 4MB pieces pulled with one
        # device_get so transfers overlap.  Large spectra
        # use the delta-compressed pull (5 B/key); smaller ones the
        # packed-count pull (8 B/key), whose fixed overhead is lower.
        total = planes[0].shape[0]
        # delta pull pays off when the spectrum is dense enough that
        # consecutive deltas fit u32 (mean delta = keyspace / n_out)
        dense = n_out > 0 and (2 * self.rho <= 31
                               or n_out >= (1 << (2 * self.rho - 31)))
        if n_out >= _DELTA_MIN and dense:
            out = self._pull_delta(planes, n_out)
            if out is not None:
                return out
        npc = -(-total // _PIECE)  # pieces per plane
        k = min(npc, -(-max(n_out, 1) // _PIECE))  # live-prefix pieces
        l1_bits = max(0, 2 * self.rho - 32)
        c_bits = 32 - l1_bits
        if c_bits >= 8:
            sat = (1 << c_bits) - 1
            pieces = _slice_pieces_packed(planes[0], planes[1], planes[2],
                                          l1_bits)
            flat = jax.device_get(pieces[:k] + pieces[npc : npc + k])
            p1 = np.concatenate(flat[:k])[:n_out]
            l0 = np.concatenate(flat[k:])[:n_out]
            l1 = p1 & np.uint32((1 << l1_bits) - 1)
            c = (p1 >> np.uint32(l1_bits)).astype(np.int64)
            if len(c) and c.max() >= sat:
                cpieces = _slice_pieces_c(planes[2])
                c = np.concatenate(jax.device_get(cpieces[:k]))[:n_out]
                c = c.astype(np.int64)
        else:
            pieces = _slice_pieces(planes[0], planes[1], planes[2])
            flat = jax.device_get(
                pieces[:k] + pieces[npc : npc + k]
                + pieces[2 * npc : 2 * npc + k])
            l1 = np.concatenate(flat[:k])[:n_out]
            l0 = np.concatenate(flat[k : 2 * k])[:n_out]
            c = np.concatenate(flat[2 * k :])[:n_out].astype(np.int64)
        lo = (l1.astype(np.uint64) << 32) | l0
        return lo, np.zeros_like(lo), c

    def _pull_delta(self, planes, n_out: int):
        """Delta-compressed pull; None when exceptions overflow.

        One device_get covers delta pieces + packed counts + the
        estimated exception pieces + the exception count; a rare second
        round trip fetches excess exception rows."""
        cap = planes[0].shape[0]
        pieces, excp, n_exc_dev = _delta_pack(planes[0], planes[1],
                                              planes[2], cap)
        npc = -(-cap // _PIECE)
        k = min(npc, -(-max(n_out, 1) // _PIECE))
        pe = _exc_est_pieces(n_out)
        flat = jax.device_get(pieces[:k] + pieces[npc : npc + k]
                              + excp[:pe] + [n_exc_dev])
        n_exc = int(flat[-1])
        if n_exc > _EXC_CAP:
            return None  # fall back to the exact pull (rare)
        exc = _exc_fetch(excp, n_exc, flat[2 * k : 2 * k + pe])
        lo, c = _delta_unpack(flat[:k], flat[k : 2 * k], exc, n_exc, n_out)
        return lo, np.zeros_like(lo), c.astype(np.int64)


# pull-piece size: 1M lanes = 4MB.  Pieces cover the FULL plane with a
# fixed grid so the slice programs compile exactly once per cap (no
# live-count-dependent shapes); callers device_get only the live-prefix
# pieces, overshooting by at most one piece per plane.
_PIECE = 1 << 20

# ---------------------------------------------------------------------------
# delta-compressed pull: the spectrum is sorted, so consecutive-key
# deltas almost always fit u32 and counts almost always fit u8.  Pull
# (u32 delta plane) + (4x-packed u8 count plane) = 5 B/key instead of
# 8 B/key, with an exception side-buffer of exact (lane, l1, l0, count)
# records for the rare wide delta / huge count / first lane: 1.6x fewer
# device-to-host bytes.
# ---------------------------------------------------------------------------

# Exception capacity & transfer granularity.  Value-canonical spectra
# are SKEWED over the keyspace (the class representative is min(x,
# rc(x)), denser at small values), so u32-delta overflows run ~2-4% of
# keys — far over the old 2^16 single-buffer cap, which silently forced
# the 8 B/key exact pull.  The buffer is now 2^18 rows, cut into 2^14-row
# pieces: pulls fetch an ESTIMATED piece count (plus the n_exc scalar)
# and fetch any remainder in a rare second round trip.
_EXC_CAP = 1 << 18  # exception records; overflow -> exact pull
_EXC_PIECE = 1 << 14  # rows per transferred excbuf piece
_DELTA_MIN = 1 << 19  # below this the exact pull's fixed cost wins


def _exc_pieces(excbuf):
    """Cut a stacked [R, _EXC_CAP] exception buffer into column pieces."""
    return [excbuf[:, i : i + _EXC_PIECE]
            for i in range(0, _EXC_CAP, _EXC_PIECE)]


def _exc_est_pieces(n_keys: int) -> int:
    """Pieces to pull for an expected ~4% exception rate (+1 margin)."""
    est = int(0.04 * max(n_keys, 0)) + _EXC_PIECE
    return min(_EXC_CAP // _EXC_PIECE, -(-est // _EXC_PIECE))


def _exc_fetch(pieces, n_exc: int, flat_head: list):
    """Assemble >= n_exc exception rows from already-pulled pieces
    (``flat_head``) plus a second device_get for any uncovered tail."""
    have = len(flat_head) * _EXC_PIECE
    if n_exc > have:
        extra = jax.device_get(
            pieces[len(flat_head) : -(-n_exc // _EXC_PIECE)])
        flat_head = list(flat_head) + list(extra)
    return np.concatenate(flat_head, axis=1)


@partial(jax.jit, static_argnums=(3,))
def _delta_pack(l1, l0, c, cap: int):
    """-> (delta u32[cap], cpack u32[cap/4], exc u32[4, _EXC_CAP], n_exc).

    Exception lanes (first lane, delta >= 2^32, count >= 255, or any
    sentinel boundary) carry exact values in ``exc`` ordered by lane.
    """
    return _delta_pack_body(l1, l0, c, cap)


def _delta_pack_body(l1, l0, c, cap: int):
    sent = U32(SENT32)
    p1 = jnp.concatenate([jnp.zeros((1,), U32), l1[:-1]])
    p0 = jnp.concatenate([jnp.zeros((1,), U32), l0[:-1]])
    borrow = (l0 < p0).astype(U32)
    dhi = l1 - p1 - borrow
    d = l0 - p0
    lane = jax.lax.broadcasted_iota(jnp.int32, (cap,), 0)
    # sentinel lanes sit beyond the pulled live prefix: no records needed
    is_sent = (l1 == sent) & (l0 == sent)
    exc = ((lane == 0) | (dhi != 0) | (c >= U32(255))) & ~is_sent
    dplane = jnp.where(exc, sent, d)
    cpack = jnp.where(exc, U32(255), jnp.minimum(c, U32(254)))
    cpack = (cpack.reshape(-1, 4)
             * (U32(1) << (U32(8) * jnp.arange(4, dtype=U32)))).sum(
                 axis=1, dtype=U32)
    # compact exception records, lane-ordered (sort-based, gather-free)
    key = jnp.where(exc, lane, jnp.int32(cap))
    _, e_lane, e1, e0, ec = jax.lax.sort(
        (key, lane.astype(U32), l1, l0, c), num_keys=1)
    n_exc = jnp.sum(exc.astype(jnp.int32))
    pad = max(0, _EXC_CAP - cap)
    if pad:
        z = jnp.zeros((pad,), U32)
        e_lane = jnp.concatenate([e_lane, z])
        e1 = jnp.concatenate([e1, z])
        e0 = jnp.concatenate([e0, z])
        ec = jnp.concatenate([ec, z])
    excbuf = jnp.stack([e_lane[:_EXC_CAP], e1[:_EXC_CAP], e0[:_EXC_CAP],
                        ec[:_EXC_CAP]])
    return _cut(dplane) + _cut_c4(cpack), _exc_pieces(excbuf), n_exc


def _cut_c4(p):
    n = p.shape[0]
    q = _PIECE // 4
    return [p[i : min(i + q, n)] for i in range(0, n, q)]


@partial(jax.jit, static_argnums=(3,))
def _count_pack(l1, l0, c, cap: int):
    """Counts alone, 4-per-u32 saturated at 255 with an exception list.

    -> (cpack pieces, exc u32[2, _EXC_CAP] = (lane, count), n_exc).
    Used by the reconciled finish: when the keys were already pulled
    mid-stream, only 1 B/key of final counts has to cross the link.
    """
    sent = U32(SENT32)
    is_sent = (l1 == sent) & (l0 == sent)
    lane = jax.lax.broadcasted_iota(jnp.int32, (cap,), 0)
    exc = (c >= U32(255)) & ~is_sent
    cpack = jnp.where(exc, U32(255), jnp.minimum(c, U32(254)))
    cpack = (cpack.reshape(-1, 4)
             * (U32(1) << (U32(8) * jnp.arange(4, dtype=U32)))).sum(
                 axis=1, dtype=U32)
    key = jnp.where(exc, lane, jnp.int32(cap))
    _, e_lane, ec = jax.lax.sort((key, lane.astype(U32), c), num_keys=1)
    n_exc = jnp.sum(exc.astype(jnp.int32))
    pad = max(0, _EXC_CAP - cap)
    if pad:
        z = jnp.zeros((pad,), U32)
        e_lane = jnp.concatenate([e_lane, z])
        ec = jnp.concatenate([ec, z])
    excbuf = jnp.stack([e_lane[:_EXC_CAP], ec[:_EXC_CAP]])
    return _cut_c4(cpack), _exc_pieces(excbuf), n_exc


def _counts_from_pack(cpieces, excbuf, n_exc: int, n_out: int):
    """Host decode of :func:`_count_pack`'s output; None on overflow."""
    if n_exc > _EXC_CAP:
        return None
    c8 = np.concatenate([np.asarray(p) for p in cpieces]).view(np.uint8)
    c = c8[:n_out].astype(np.int64)
    e_lane = excbuf[0][:n_exc].astype(np.int64)
    e_c = excbuf[1][:n_exc].astype(np.int64)
    keep = e_lane < n_out
    c[e_lane[keep]] = e_c[keep]
    return c


@partial(jax.jit, static_argnums=(4,))
def _reconcile_new_keys(s_l1, s_l0, f_l1, f_l0, cap: int):
    """Keys of the final spectrum absent from the snapshot, as EXACT
    rows.

    The engine only ever *adds* keys between flushes (a batch step sums
    counts of existing keys), so snapshot ⊆ final and the set difference
    is exactly the keys discovered after the snapshot.  Membership via
    one tagged 2-key sort (device u64 compares are avoided throughout).
    -> (pieces, n_new): a [3, _EXC_CAP] (lane, l1, l0) exact-row buffer
    cut into column pieces, ascending by key.  New keys are a small
    fraction of the spectrum (the snapshot has seen most of the input),
    so exact rows beat a cap-sized delta plane on the wire by ~10x; more
    than _EXC_CAP new keys falls back to the exact pull.
    """
    sent = U32(SENT32)
    l1 = jnp.concatenate([s_l1, f_l1])
    l0 = jnp.concatenate([s_l0, f_l0])
    tag = jnp.concatenate([jnp.zeros((cap,), U32), jnp.ones((cap,), U32)])
    l1, l0, tag = jax.lax.sort((l1, l0, tag), num_keys=3)
    n2 = 2 * cap
    same_prev = jnp.zeros((n2,), bool).at[1:].set(
        (l1[1:] == l1[:-1]) & (l0[1:] == l0[:-1]))
    prev_tag = jnp.concatenate([jnp.ones((1,), U32), tag[:-1]])
    is_sent = (l1 == sent) & (l0 == sent)
    is_new = (tag == U32(1)) & ~(same_prev & (prev_tag == U32(0))) & ~is_sent
    lane = jax.lax.broadcasted_iota(jnp.int32, (n2,), 0)
    key = jnp.where(is_new, lane, jnp.int32(n2))
    _, k1o, k0o = jax.lax.sort((key, l1, l0), num_keys=1)
    n_new = jnp.sum(is_new.astype(jnp.int32))
    rows = min(n2, _EXC_CAP)
    lanec = jax.lax.broadcasted_iota(jnp.int32, (rows,), 0)
    keep = lanec < n_new
    e1 = jnp.where(keep, k1o[:rows], sent)
    e0 = jnp.where(keep, k0o[:rows], sent)
    e_lane = jnp.where(keep, lanec.astype(U32), U32(0))
    pad = max(0, _EXC_CAP - rows)
    if pad:
        z = jnp.zeros((pad,), U32)
        e_lane = jnp.concatenate([e_lane, z])
        e1 = jnp.concatenate([e1, z])
        e0 = jnp.concatenate([e0, z])
    excbuf = jnp.stack([e_lane, e1, e0])
    return _exc_pieces(excbuf), n_new


def _delta_unpack(dpieces, cpieces, exc, n_exc: int, n_out: int):
    """Host-side reconstruction of (lo u64, counts i64).

    The native single-pass decoder is used when available; numpy
    cumsum+patch otherwise."""
    d = np.ascontiguousarray(np.concatenate(dpieces)[:n_out])
    cp = np.concatenate(cpieces)
    c8 = cp.view(np.uint8)[:n_out]

    from ..io.native import native_delta_unpack

    out = native_delta_unpack(d, c8, exc[0][:n_exc], exc[1][:n_exc],
                              exc[2][:n_exc], exc[3][:n_exc], n_out)
    if out is not None:
        return out

    d = d.astype(np.uint64)
    c8 = c8.astype(np.int64)
    e_lane = exc[0][:n_exc].astype(np.int64)
    e_lo = (exc[1][:n_exc].astype(np.uint64) << np.uint64(32)) | exc[2][:n_exc]
    e_c = exc[3][:n_exc].astype(np.int64)
    keep = e_lane < n_out
    e_lane, e_lo, e_c = e_lane[keep], e_lo[keep], e_c[keep]
    d[e_lane] = 0
    cs = np.cumsum(d)
    # per-segment rebase: lo[i] = exact(e) + (cs[i] - cs[e]) for the
    # exception lane e governing i
    adj = np.zeros(n_out, np.uint64)
    patch = e_lo - cs[e_lane]
    adj[e_lane] = patch - np.concatenate([np.zeros(1, np.uint64),
                                          patch[:-1]])
    lo = cs + np.cumsum(adj)
    c = c8
    c[e_lane] = e_c
    return lo, c


def _cut(p):
    n = p.shape[0]
    return [p[i : min(i + _PIECE, n)] for i in range(0, n, _PIECE)]


@jax.jit
def _slice_pieces(a, b, c):
    """The three planes cut into 4MB pieces (full fixed grid)."""
    return _cut(a) + _cut(b) + _cut(c)


@partial(jax.jit, static_argnums=(3,))
def _slice_pieces_packed(l1, l0, c, l1_bits: int):
    """Counts packed (saturated) into l1's unused high bits: 2 pulled
    planes, not 3.  Callers re-pull the exact count plane iff any pulled
    count hits the saturation value."""
    mask = U32((1 << l1_bits) - 1) if l1_bits else U32(0)
    sat = U32((1 << (32 - l1_bits)) - 1)
    p1 = (jnp.minimum(c, sat) << U32(l1_bits)) | (l1 & mask)
    return _cut(p1) + _cut(l0)


@jax.jit
def _slice_pieces_c(c):
    """Exact count plane alone (saturated-pack fallback)."""
    return _cut(c)
