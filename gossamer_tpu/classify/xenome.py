"""Xenome-style read classification.

Engine parity with ``src/GossCmdGroupReads.cc``: per-read k-mer lookup in
an annotated union set, 2-bit class per k-mer (``c = lhs<<1 | rhs``,
``GossCmdGroupReads.cc:384-401``), OR-accumulated into a 4-bit one-hot
``blrg``; 16-way class table and output file naming as in
``GossCmdGroupReads.cc:489-577``; summary tables as in
``printStats`` (``:810-850``).

The per-read loops are replaced by batched vectorized classification over
the flat code stream (windows -> normalize -> rank -> class bits ->
segmented OR by read id).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator

import numpy as np

from ..core import kmer as K
from ..io.readers import Read
from ..utils import profile
from .annotated_set import AnnotatedKmerSet

SEP = np.uint8(255)

# blrg -> output stream class (GossCmdGroupReads.cc:606-621)
OUT_CLASS = [
    "neither", "both", "rhs", "rhs", "lhs", "lhs", "ambiguous", "ambiguous",
    "both", "both", "rhs", "rhs", "lhs", "lhs", "ambiguous", "ambiguous",
]


def class_str(lhs_name: str, rhs_name: str, i: int) -> str:
    """``classStr`` (``GossCmdGroupReads.cc:489-527``)."""
    table = {
        0x0: "neither",
        0x1: "both",
        0x2: "definitely " + rhs_name,
        0x3: "probably " + rhs_name,
        0x4: "definitely " + lhs_name,
        0x5: "probably " + lhs_name,
        0x6: "ambiguous",
        0x7: "ambiguous",
        0x8: "both",
        0x9: "probably both",
        0xA: "definitely " + rhs_name,
        0xB: "probably " + rhs_name,
        0xC: "definitely " + lhs_name,
        0xD: "probably " + lhs_name,
        0xE: "ambiguous",
        0xF: "ambiguous",
    }
    return table[i]


def _batch_blrg(codes_list: list[np.ndarray], ann: AnnotatedKmerSet) -> np.ndarray:
    """blrg per read for a batch of encoded reads."""
    k = ann.kset.k
    n_reads = len(codes_list)
    blrg = np.zeros(n_reads, dtype=np.uint8)
    if n_reads == 0:
        return blrg
    # flat stream with separators; read id per window start
    parts = []
    for c in codes_list:
        parts.append(c)
        parts.append(np.array([SEP], dtype=np.uint8))
    flat = np.concatenate(parts)
    if len(flat) < k:
        return blrg
    # read index of a valid window start p = separators before p; since a
    # valid start is never a separator, the inclusive cumsum equals that
    read_id = np.cumsum(flat == SEP)
    n_win = len(flat) - k + 1
    win_read = read_id[:n_win]

    lo = np.zeros(n_win, dtype=np.uint64)
    hi = np.zeros(n_win, dtype=np.uint64)
    valid = np.ones(n_win, dtype=bool)
    for j in range(k):
        b = flat[j : j + n_win]
        valid &= b < 4
        b64 = b.astype(np.uint64) & np.uint64(3)
        hi = (hi << np.uint64(2)) | (lo >> np.uint64(62))
        lo = (lo << np.uint64(2)) | b64
    if not valid.any():
        return blrg
    lo = lo[valid]
    hi = hi[valid]
    win_read = win_read[valid]
    nlo, nhi, _ = K.normalize(lo, hi, k)
    hit, r = ann.kset.access_and_rank(nlo, nhi)
    if not hit.any():
        return blrg
    r = r[hit]
    win_read = win_read[hit]
    c = (ann.lhs[r].astype(np.uint8) << 1) | ann.rhs[r].astype(np.uint8)
    bits = (np.uint8(1) << c).astype(np.uint8)
    np.bitwise_or.at(blrg, win_read, bits)
    return blrg


def ann_slices(ann: AnnotatedKmerSet, passes: int) -> list[AnnotatedKmerSet]:
    """Split the annotated set into rank subranges for multi-pass
    classification (``KmerClassifier`` bounds, ``GossCmdGroupReads.cc:
    416-429``).  The union over slices reproduces single-pass results."""
    if passes <= 1:
        return [ann]
    from ..graph.kmer_set import KmerSet

    z = ann.kset.count
    out = []
    for p in range(passes):
        a = p * z // passes
        b = (p + 1) * z // passes
        out.append(AnnotatedKmerSet(
            KmerSet(ann.kset.k, ann.kset.lo[a:b], ann.kset.hi[a:b]),
            ann.lhs[a:b], ann.rhs[a:b]))
    return out


def classify_reads(
    reads: Iterable[Read], ann: AnnotatedKmerSet, batch_reads: int = 4096,
    passes: int = 1, n_devices: int = 1,
) -> Iterator[tuple[Read, int]]:
    """Yield (read, blrg) preserving input order.

    ``n_devices > 1`` shards the annotated set across a device mesh
    (:mod:`gossamer_tpu.parallel.classify_sharded`: the multipass
    decomposition run in space instead of time)."""
    slices = ann_slices(ann, passes)
    buf: list[Read] = []
    for rd in reads:
        buf.append(rd)
        if len(buf) >= batch_reads:
            yield from _flush(buf, slices, n_devices)
            buf = []
    if buf:
        yield from _flush(buf, slices, n_devices)


def _slice_blrg(codes, s: AnnotatedKmerSet, n_devices: int = 1) -> np.ndarray:
    """One set-slice classification: the device sort-join engine
    (optionally set-sharded over a mesh for narrow keys).  Device errors
    propagate; only an empty set takes the host path."""
    k = s.kset.k
    if 2 * k + 2 <= 62 and s.kset.count:
        import jax.numpy as jnp

        from .device import classify_codes_device, encode_set

        key = (id(s), n_devices)
        cached = _DEVICE_SETS.get(key)
        if n_devices > 1:
            if cached is None:
                from ..parallel.classify_sharded import ShardedClassifier
                from ..parallel.mesh import data_mesh

                cached = ShardedClassifier(
                    data_mesh(n_devices),
                    encode_set(s.kset.lo, s.lhs, s.rhs), k)
                _DEVICE_SETS[key] = cached
            return cached.classify_codes(codes)
        if cached is None:
            cached = jnp.asarray(encode_set(s.kset.lo, s.lhs, s.rhs))
            _DEVICE_SETS[key] = cached
        return classify_codes_device(codes, cached, k)
    if 2 * k + 2 <= 126 and s.kset.count:
        # wide keys (31 < k <= 62): 4-limb device sort-join
        from .device import classify_codes_device_wide, encode_set_wide

        key = (id(s), "wide")
        cached = _DEVICE_SETS.get(key)
        if cached is None:
            cached = encode_set_wide(s.kset.lo, s.kset.hi, s.lhs,
                                     s.rhs, k)
            _DEVICE_SETS[key] = cached
        return classify_codes_device_wide(codes, cached, k)
    return _batch_blrg(codes, s)


_DEVICE_SETS: dict = {}


def _flush(buf: list[Read], slices: list[AnnotatedKmerSet], n_devices: int = 1):
    with profile.context("classify/batch"):
        codes = [K.encode_bases(r.seq) for r in buf]
        blrg = _slice_blrg(codes, slices[0], n_devices)
        for s in slices[1:]:
            blrg = blrg | _slice_blrg(codes, s, n_devices)
    for rd, b in zip(buf, blrg):
        yield rd, int(b)


def classify_pairs(
    pairs: Iterable[tuple[Read, Read]], ann: AnnotatedKmerSet,
    batch_reads: int = 4096, passes: int = 1, n_devices: int = 1,
) -> Iterator[tuple[Read, Read, int]]:
    """Paired classification: blrg = OR of the mates' blrgs."""
    slices = ann_slices(ann, passes)
    buf: list[tuple[Read, Read]] = []
    for pr in pairs:
        buf.append(pr)
        if len(buf) >= batch_reads:
            yield from _flush_pairs(buf, slices, n_devices)
            buf = []
    if buf:
        yield from _flush_pairs(buf, slices, n_devices)


def _flush_pairs(buf, slices, n_devices: int = 1):
    codes = [K.encode_bases(r.seq) for pr in buf for r in pr]
    blrg = _slice_blrg(codes, slices[0], n_devices)
    for s in slices[1:]:
        blrg = blrg | _slice_blrg(codes, s, n_devices)
    for i, (a, b) in enumerate(buf):
        yield a, b, int(blrg[2 * i] | blrg[2 * i + 1])


# -------------------------------------------------------------- reporting
def print_read(out, rd: Read) -> None:
    """Round-trip a read in its original format."""
    if rd.qual is not None:
        out.write(f"@{rd.label}\n{rd.seq.decode()}\n+\n{rd.qual.decode()}\n")
    else:
        out.write(f">{rd.label}\n{rd.seq.decode()}\n")


def fmt6(x: float) -> str:
    """C++ default ostream double formatting."""
    return f"{x:.6g}"


def print_stats(out, counts, lhs_name: str, rhs_name: str, scores_only: bool) -> None:
    """``printStats`` (``GossCmdGroupReads.cc:810-850``)."""
    total = int(np.sum(counts)) or 1
    graft_c = counts[0x4] + counts[0x5] + counts[0xC] + counts[0xD]
    host_c = counts[0x2] + counts[0x3] + counts[0xA] + counts[0xB]
    both_c = counts[0x1] + counts[0x8] + counts[0x9]
    neither_c = counts[0x0]
    ambig_c = counts[0x6] + counts[0x7] + counts[0xE] + counts[0xF]
    if scores_only:
        out.write(
            "\t".join(
                fmt6(100.0 * c / total)
                for c in (graft_c, host_c, both_c, neither_c, ambig_c)
            )
            + "\n"
        )
        return
    out.write("Statistics\n")
    out.write("B\tG\tH\tM\tcount\tpercent\tclass\n")
    for i in range(16):
        out.write(
            f"{(i >> 3) & 1}\t{(i >> 2) & 1}\t{(i >> 1) & 1}\t{i & 1}\t"
            f"{int(counts[i])}\t{fmt6(100.0 * counts[i] / total)}\t"
            f'"{class_str(lhs_name, rhs_name, i)}"\n'
        )
    out.write("\nSummary\n")
    out.write("count\tpercent\tclass\n")
    for c, name in (
        (graft_c, lhs_name),
        (host_c, rhs_name),
        (both_c, "both"),
        (ambig_c, "ambiguous"),
        (neither_c, "neither"),
    ):
        out.write(f"{int(c)}\t{fmt6(100.0 * c / total)}\t{name}\n")


def out_filename(prefix: str, suffix: str, half: str, cls: str) -> str:
    """``filename`` (``GossCmdGroupReads.cc:530-547``)."""
    parts = ""
    if prefix:
        parts += prefix + "_"
    parts += cls
    if half:
        parts += "_" + half
    if suffix:
        parts += "." + suffix
    return parts
