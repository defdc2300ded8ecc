"""ctypes binding for the native IO library (native/gossio.cpp).

Builds the shared library on demand with ``make`` next to the source.
The library is rebuilt whenever its stamp differs from the hash of the
source, the Makefile and this host's CPU flags (the build uses
``-march=native``), so a library built on another machine is never
loaded.  Consumers fall back to the pure-Python parser pipeline only
when no library can be built.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
from typing import Iterator

import numpy as np

_LIB = None
_TRIED = False


def _native_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "native")


def _cpu_flags() -> str:
    """This host's CPU feature flags (what ``-march=native`` compiles
    for)."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.machine() + " " + platform.processor()


def _build_stamp(d: str) -> str:
    """Hash of everything the library is built from on this host."""
    h = hashlib.sha256()
    for name in ("gossio.cpp", "Makefile"):
        with open(os.path.join(d, name), "rb") as f:
            h.update(f.read())
    h.update(_cpu_flags().encode())
    return h.hexdigest()


def _make(d: str, out: str) -> None:
    subprocess.run(["make", "-C", d, "-B", f"LIB={out}"], check=True,
                   capture_output=True, timeout=300)


def ensure_built(d: str, build=_make) -> str:
    """Path of ``libgossio.so`` in ``d``, rebuilt first unless its stamp
    matches :func:`_build_stamp`.  A file lock serializes concurrent
    builders (test workers); the library is built under a temporary
    name and renamed into place, so no process loads a partial file."""
    so = os.path.join(d, "libgossio.so")
    stamp_path = os.path.join(d, "libgossio.stamp")
    with open(os.path.join(d, "libgossio.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        want = _build_stamp(d)
        have = None
        if os.path.exists(so) and os.path.exists(stamp_path):
            with open(stamp_path) as f:
                have = f.read().strip()
        if have != want:
            tmp = os.path.join(d, f".libgossio.{os.getpid()}.so")
            try:
                build(d, tmp)
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            with open(stamp_path + ".tmp", "w") as f:
                f.write(want + "\n")
            os.replace(stamp_path + ".tmp", stamp_path)
    return so


def load_library():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        so = ensure_built(_native_dir())
        lib = ctypes.CDLL(so)
        lib.gossio_open.restype = ctypes.c_void_p
        lib.gossio_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.gossio_next_chunk.restype = ctypes.c_long
        lib.gossio_next_chunk.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_long, ctypes.c_int]
        lib.gossio_next_packed.restype = ctypes.c_long
        lib.gossio_next_packed.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_long, ctypes.c_int]
        lib.gossio_close.argtypes = [ctypes.c_void_p]
        lib.gossio_eac_encode.restype = ctypes.c_long
        lib.gossio_eac_encode.argtypes = [
            ctypes.c_long, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8)]
        lib.gossio_eac_decode.restype = ctypes.c_long
        lib.gossio_eac_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64)]
        lib.gossio_eac_encode128.restype = ctypes.c_long
        lib.gossio_eac_encode128.argtypes = [
            ctypes.c_long, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint8)]
        lib.gossio_eac_decode128.restype = ctypes.c_long
        lib.gossio_eac_decode128.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int64)]
        lib.gossio_expand_symmetric.restype = ctypes.c_long
        lib.gossio_expand_symmetric.argtypes = [
            ctypes.c_long, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64)]
        lib.gossio_expand_order.restype = ctypes.c_long
        lib.gossio_expand_order.argtypes = [
            ctypes.c_long, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint8)]
        lib.gossio_apply_order.restype = None
        lib.gossio_apply_order.argtypes = [
            ctypes.c_long, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
        lib.gossio_insert_merge.restype = None
        lib.gossio_insert_merge.argtypes = [
            ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int64)]
        lib.gossio_split_counts.restype = None
        lib.gossio_split_counts.argtypes = [
            ctypes.c_long, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
        lib.gossio_rank_u64.restype = None
        lib.gossio_rank_u64.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
        lib.gossio_merge_rank_u64.restype = None
        lib.gossio_merge_rank_u64.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int64)]
        lib.gossio_kmerize_u64.restype = None
        lib.gossio_kmerize_u64.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_long, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint8)]
        lib.gossio_chains.restype = ctypes.c_long
        lib.gossio_chains.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
        lib.gossio_next_block.restype = ctypes.c_long
        lib.gossio_next_block.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
        lib.gossio_node_degrees_u64.restype = None
        lib.gossio_node_degrees_u64.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_long, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int]
        lib.gossio_successor_table_u64.restype = None
        lib.gossio_successor_table_u64.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_long, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
        lib.gossio_delta_unpack.restype = None
        lib.gossio_delta_unpack.argtypes = [
            ctypes.c_long, ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_int64)]
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


FMT_CODE = {None: 0, "fasta": 1, "fastq": 2, "line": 3}


def encode_spill_run(lo: np.ndarray, c: np.ndarray):
    """(ascending u64 keys, i64 counts) -> varint-delta bytes, the
    reference's spill-format design (``src/EdgeAndCount.hh:78-112``).
    Returns None without the native library (callers keep raw arrays)."""
    lib = load_library()
    if lib is None:
        return None
    n = len(lo)
    lo = np.ascontiguousarray(lo, dtype=np.uint64)
    c = np.ascontiguousarray(c, dtype=np.int64)
    out = np.empty(20 * max(n, 1), np.uint8)
    m = lib.gossio_eac_encode(
        ctypes.c_long(n),
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out[:m].copy()


def decode_spill_run(buf: np.ndarray, n: int):
    """Inverse of :func:`encode_spill_run` -> (lo u64, c i64)."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable for spill decode")
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    lo = np.empty(n, np.uint64)
    c = np.empty(n, np.int64)
    got = lib.gossio_eac_decode(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_long(len(buf)), ctypes.c_long(n),
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if got != n:
        raise ValueError("truncated spill run")
    return lo, c


def encode_spill_run128(lo: np.ndarray, hi: np.ndarray, c: np.ndarray):
    """128-bit-key spill run -> varint bytes (two delta limbs + count
    per record, the reference codec's shape,
    ``src/EdgeAndCount.hh:86-97``); None without the library."""
    lib = load_library()
    if lib is None:
        return None
    n = len(lo)
    lo = np.ascontiguousarray(lo, dtype=np.uint64)
    hi = np.ascontiguousarray(hi, dtype=np.uint64)
    c = np.ascontiguousarray(c, dtype=np.int64)
    out = np.empty(30 * max(n, 1), np.uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    m = lib.gossio_eac_encode128(
        ctypes.c_long(n), lo.ctypes.data_as(u64p), hi.ctypes.data_as(u64p),
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out[:m].copy()


def decode_spill_run128(buf: np.ndarray, n: int):
    """Inverse of :func:`encode_spill_run128` -> (lo, hi, c)."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable for spill decode")
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    lo = np.empty(n, np.uint64)
    hi = np.empty(n, np.uint64)
    c = np.empty(n, np.int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    got = lib.gossio_eac_decode128(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_long(len(buf)), ctypes.c_long(n),
        lo.ctypes.data_as(u64p), hi.ctypes.data_as(u64p),
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if got != n:
        raise ValueError("truncated spill run")
    return lo, hi, c


def native_expand_symmetric(lo: np.ndarray, c: np.ndarray, rho: int):
    """Canonical spectrum -> symmetric fwd+rc spectrum via the C
    single-pass rc + radix sort + merge, or None without the library.
    ``lo`` ascending uint64 (< 2^62), ``c`` int64."""
    lib = load_library()
    if lib is None:
        return None
    n = len(lo)
    lo = np.ascontiguousarray(lo, dtype=np.uint64)
    c = np.ascontiguousarray(c, dtype=np.int64)
    out_lo = np.empty(2 * n, np.uint64)
    out_c = np.empty(2 * n, np.int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    m = lib.gossio_expand_symmetric(
        ctypes.c_long(n), lo.ctypes.data_as(u64p), c.ctypes.data_as(i64p),
        ctypes.c_int(rho),
        out_lo.ctypes.data_as(u64p), out_c.ctypes.data_as(i64p))
    return out_lo[:m], out_c[:m]


def native_expand_order(lo: np.ndarray, rho: int):
    """Expansion ORDER of a canonical spectrum (keys only): returns
    (out_lo, src, dbl) such that the symmetric spectrum is
    ``(out_lo, where(dbl, 2*c[src], c[src]))`` for any counts ``c``
    aligned with ``lo``; None without the library.  Lets the engine
    compute the order in the background from early-pulled keys."""
    lib = load_library()
    if lib is None:
        return None
    n = len(lo)
    lo = np.ascontiguousarray(lo, dtype=np.uint64)
    out_lo = np.empty(2 * n, np.uint64)
    src = np.empty(2 * n, np.int64)
    dbl = np.empty(2 * n, np.uint8)
    m = lib.gossio_expand_order(
        ctypes.c_long(n),
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_int(rho),
        out_lo.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dbl.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out_lo[:m], src[:m], dbl[:m].astype(bool)


def native_apply_order(src: np.ndarray, dbl: np.ndarray,
                       c: np.ndarray) -> np.ndarray | None:
    """``where(dbl, 2*c[src], c[src])`` as a 2-thread memory-bound C
    loop (numpy fancy indexing measured ~5M elem/s on this host)."""
    lib = load_library()
    if lib is None:
        return None
    m = len(src)
    src = np.ascontiguousarray(src, dtype=np.int64)
    dblc = np.ascontiguousarray(dbl, dtype=np.uint8)
    c = np.ascontiguousarray(c, dtype=np.int64)
    out = np.empty(m, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.gossio_apply_order(
        ctypes.c_long(m), src.ctypes.data_as(i64p),
        dblc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        c.ctypes.data_as(i64p), out.ctypes.data_as(i64p))
    return out


def native_split_counts(idx: np.ndarray, c: np.ndarray, n1: int,
                        n_new: int):
    """Counts aligned with merge(snapshot, new) -> (snapshot-aligned,
    new-key-aligned) planes; ``idx`` = sorted insertion positions.
    None without the library."""
    lib = load_library()
    if lib is None:
        return None
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    c = np.ascontiguousarray(c, dtype=np.int64)
    out_snap = np.empty(n1, np.int64)
    out_new = np.empty(n_new, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.gossio_split_counts(
        ctypes.c_long(n1), ctypes.c_long(n_new),
        idx.ctypes.data_as(i64p), c.ctypes.data_as(i64p),
        out_snap.ctypes.data_as(i64p), out_new.ctypes.data_as(i64p))
    return out_snap, out_new


def native_insert_merge(base_lo, base_c, add_lo, add_c):
    """One-pass merge of a large sorted (lo, c) spectrum with a small
    sorted addition (disjoint keys); None without the library."""
    lib = load_library()
    if lib is None:
        return None
    n, m = len(base_lo), len(add_lo)
    base_lo = np.ascontiguousarray(base_lo, dtype=np.uint64)
    base_c = np.ascontiguousarray(base_c, dtype=np.int64)
    add_lo = np.ascontiguousarray(add_lo, dtype=np.uint64)
    add_c = np.ascontiguousarray(add_c, dtype=np.int64)
    out_lo = np.empty(n + m, np.uint64)
    out_c = np.empty(n + m, np.int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.gossio_insert_merge(
        ctypes.c_long(n), ctypes.c_long(m),
        base_lo.ctypes.data_as(u64p), base_c.ctypes.data_as(i64p),
        add_lo.ctypes.data_as(u64p), add_c.ctypes.data_as(i64p),
        out_lo.ctypes.data_as(u64p), out_c.ctypes.data_as(i64p))
    return out_lo, out_c


def native_rank_u64(a: np.ndarray, q: np.ndarray,
                    threads: int = 2) -> np.ndarray | None:
    """lower_bound ranks of ``q`` in sorted ``a`` (both u64); None when
    the native library is unavailable.  Sorted query streams take the
    O(n+m) linear-merge path automatically."""
    lib = load_library()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, dtype=np.uint64)
    q = np.ascontiguousarray(q, dtype=np.uint64)
    out = np.empty(len(q), dtype=np.int64)
    pa = a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
    pq = q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
    po = out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    # linear merge pays off when q is sorted and a is not much larger
    # (merge scans all of a; binary search costs m*log n probes)
    if (len(q) > 2 and len(a) <= 8 * len(q)
            and bool((q[1:] >= q[:-1]).all())):
        lib.gossio_merge_rank_u64(pa, len(a), pq, len(q), po)
    else:
        lib.gossio_rank_u64(pa, len(a), pq, len(q), po, threads)
    return out


def native_kmerize_u64(codes: np.ndarray, rho: int):
    """255-separated code stream -> (lo u64, valid u8) per window; None
    without the native library.  Narrow keys only (2*rho <= 64)."""
    lib = load_library()
    if lib is None or 2 * rho > 64:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n_win = len(codes) - rho + 1
    if n_win <= 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint8)
    lo = np.empty(n_win, dtype=np.uint64)
    valid = np.empty(n_win, dtype=np.uint8)
    lib.gossio_kmerize_u64(
        codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(codes),
        rho, lo.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return lo, valid


def native_chains(nxt: np.ndarray):
    """Chain decomposition of a successor table: (start, pos, order,
    n_live) with cycle edges start = -1; None without the library."""
    lib = load_library()
    if lib is None:
        return None
    nxt = np.ascontiguousarray(nxt, dtype=np.int64)
    n = len(nxt)
    start = np.empty(n, dtype=np.int64)
    pos = np.zeros(n, dtype=np.int64)
    order = np.empty(n, dtype=np.int64)
    n_live = lib.gossio_chains(
        nxt.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
        start.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return start, pos, order[:n_live], n_live


def native_read_blocks(paths: list[str], fmt: str | None = None,
                       threads: int = 1) -> Iterator[np.ndarray]:
    """Read-aligned 255-separated code blocks (~4MB each) straight from
    the native reader — no Python parsing.  Raises RuntimeError when the
    library can't be loaded (callers fall back to the parsed-Read path).
    """
    lib = load_library()
    if lib is None:
        raise RuntimeError("native gossio library unavailable")
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    handle = lib.gossio_open(arr, len(paths), FMT_CODE.get(fmt, 0),
                             max(int(threads), 1))
    cap = (4 << 20) + (1 << 16)
    try:
        while True:
            buf = np.empty(cap, dtype=np.uint8)
            n = lib.gossio_next_block(
                handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                cap)
            if n == 0:
                break
            if n < 0:
                cap = -n
                continue
            yield buf[:n]
    finally:
        lib.gossio_close(handle)


def native_node_degrees(lo: np.ndarray, rho: int, nodes: np.ndarray,
                        threads: int = 2):
    """(out_degree, in_degree) of node keys against the sorted narrow
    edge array; None when the library is missing or keys are wide."""
    lib = load_library()
    if lib is None or 2 * rho > 64:
        return None
    lo = np.ascontiguousarray(lo, dtype=np.uint64)
    nodes = np.ascontiguousarray(nodes, dtype=np.uint64)
    out_d = np.empty(len(nodes), dtype=np.int64)
    in_d = np.empty(len(nodes), dtype=np.int64)
    lib.gossio_node_degrees_u64(
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(lo), rho,
        nodes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(nodes),
        out_d.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        in_d.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), threads)
    return out_d, in_d


def native_successor_table(lo: np.ndarray, rho: int,
                           threads: int = 2) -> np.ndarray | None:
    """Fused successor table over sorted narrow edges; None when the
    library is missing or keys are wide (2*rho > 64)."""
    lib = load_library()
    if lib is None or 2 * rho > 64:
        return None
    lo = np.ascontiguousarray(lo, dtype=np.uint64)
    nxt = np.empty(len(lo), dtype=np.int64)
    lib.gossio_successor_table_u64(
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(lo), rho,
        nxt.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), threads)
    return nxt


def native_delta_unpack(d: np.ndarray, cpack_u8: np.ndarray,
                        e_lane: np.ndarray, e1: np.ndarray,
                        e0: np.ndarray, ec: np.ndarray, n_out: int):
    """Single-pass C reconstruction of the delta-compressed spectrum
    pull -> (lo u64, counts i64), or None when the library is missing.
    All inputs must be C-contiguous; exception lanes ascending."""
    lib = load_library()
    if lib is None:
        return None
    lo = np.empty(n_out, np.uint64)
    c = np.empty(n_out, np.int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.gossio_delta_unpack(
        ctypes.c_long(n_out),
        d.ctypes.data_as(u32p),
        cpack_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_long(len(e_lane)),
        e_lane.ctypes.data_as(u32p), e1.ctypes.data_as(u32p),
        e0.ctypes.data_as(u32p), ec.ctypes.data_as(u32p),
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return lo, c


def native_flat_chunks(
    paths: list[str], k: int, chunk: int = 1 << 22, fmt: str | None = None,
    threads: int = 1,
) -> Iterator[np.ndarray]:
    """Native equivalent of :func:`gossamer_tpu.io.stream.flat_code_chunks`.

    Only usable with real files on disk (no FileFactory indirection);
    raises RuntimeError if the library can't be loaded.  ``threads``
    parser threads decode whole files concurrently (``-T``); with
    ``threads > 1`` chunks from different files may interleave, so use
    only with order-insensitive consumers (counting).
    """
    lib = load_library()
    if lib is None:
        raise RuntimeError("native gossio library unavailable")
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    handle = lib.gossio_open(arr, len(paths), FMT_CODE.get(fmt, 0),
                             max(int(threads), 1))
    overlap = k - 1
    try:
        while True:
            buf = np.empty(chunk + overlap, dtype=np.uint8)
            n = lib.gossio_next_chunk(
                handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                chunk, overlap)
            if n <= 0:
                break
            yield buf
    finally:
        lib.gossio_close(handle)


def native_packed_chunks(
    paths: list[str], k: int, chunk: int = 1 << 22, fmt: str | None = None,
    threads: int = 1,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Packed-transfer variant of :func:`native_flat_chunks`: yields
    ``(words, inval)`` per :func:`gossamer_tpu.ops.engine.kmerize_packed`
    — 0.375 B/base moved host->device instead of 1 B/base.  Requires
    ``chunk % 16 == 0`` and ``k <= 33``.
    """
    lib = load_library()
    if lib is None:
        raise RuntimeError("native gossio library unavailable")
    assert chunk % 16 == 0 and k <= 33
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    handle = lib.gossio_open(arr, len(paths), FMT_CODE.get(fmt, 0),
                             max(int(threads), 1))
    overlap = k - 1
    n_words = chunk // 16 + 2
    n_inval = (chunk + overlap + 7) // 8
    try:
        while True:
            words = np.empty(n_words, dtype=np.uint32)
            inval = np.empty(n_inval, dtype=np.uint8)
            n = lib.gossio_next_packed(
                handle, words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                inval.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                chunk, overlap)
            if n < 0:
                raise RuntimeError("gossio_next_packed: bad geometry")
            if n == 0:
                break
            yield words, inval
    finally:
        lib.gossio_close(handle)
