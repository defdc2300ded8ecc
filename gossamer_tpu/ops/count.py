"""K-mer counting drivers: route chunk streams into the batched engines.

Device replacement for the reference counting pipeline
(``src/GossCmdBuildGraph.cc:270-491``: BackyardHash insert -> BlendedSort
-> spill runs -> AsyncMerge).  Narrow keys (2*rho <= 62) run on the
u32-plane engine v2 (:mod:`gossamer_tpu.ops.engine`), wide keys
(k <= 62) on the four-limb variant
(:mod:`gossamer_tpu.ops.engine_wide`), multi-chip meshes on the
hash-partitioned sharded engine (:mod:`gossamer_tpu.parallel.
count_sharded`).  Spectra outgrowing the device cap spill to host RAM
(the analog of the reference's disk spill) and k-way merge at finish.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

from ..io.readers import Read
from ..io.stream import flat_code_chunks
from ..utils import profile

U64 = np.uint64


def narrow_keys(rho: int) -> bool:
    """Keys fit the lo u64 plane with headroom below the sentinel."""
    return 2 * rho <= 62


def _expand_symmetric(lo: np.ndarray, c: np.ndarray, rho: int):
    """Canonical classes -> symmetric edge spectrum (both orientations).

    Palindromic rho-mers (x == rc(x)) appear once with doubled count,
    matching the reference's fwd+rc insertion semantics
    (``src/ReverseComplementAdapter.hh``).
    """
    from ..core import kmer as K
    from ..io.native import native_expand_symmetric

    out = native_expand_symmetric(lo, c.astype(np.int64), rho)
    if out is not None:
        out_lo, out_c = out
        return out_lo, np.zeros_like(out_lo), out_c

    hi = np.zeros_like(lo)
    rlo, rhi = K.reverse_complement(lo, hi, rho)
    pal = rlo == lo
    out_lo = np.concatenate([lo, rlo[~pal]])
    out_c = np.concatenate([np.where(pal, c * 2, c), c[~pal]])
    order = np.argsort(out_lo, kind="stable")
    out_lo = out_lo[order]
    out_c = out_c[order]
    return out_lo, np.zeros_like(out_lo), out_c


def _host_merge(a, b):
    """Merge two sorted host runs, summing counts of equal keys."""
    lo = np.concatenate([a[0], b[0]])
    hi = np.concatenate([a[1], b[1]])
    c = np.concatenate([a[2], b[2]])
    order = np.lexsort((lo, hi))
    lo, hi, c = lo[order], hi[order], c[order]
    if len(lo) == 0:
        return lo, hi, c
    new = np.ones(len(lo), dtype=bool)
    new[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
    idx = np.cumsum(new) - 1
    out_c = np.zeros(idx[-1] + 1, dtype=c.dtype)
    np.add.at(out_c, idx, c)
    return lo[new], hi[new], out_c


def count_rho_mers(
    reads: Iterable[Read],
    rho: int,
    *,
    both_strands: bool,
    canonical: bool,
    chunk: int = 1 << 20,
    spill_entries: int = 1 << 26,
    progress=None,
    cap_entries: int | None = None,
    log=None,
    n_devices: int = 1,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Count rho-mers of a read stream -> sorted (lo, hi, counts) host arrays.

    ``both_strands`` inserts every window and its reverse complement
    (build-graph semantics, ``src/ReverseComplementAdapter.hh``);
    ``canonical`` normalizes windows first (build-kmer-set semantics,
    ``src/GossCmdBuildKmerSet.tcc:248-249``).
    """
    return count_chunks(
        flat_code_chunks(reads, rho, chunk=chunk), rho,
        both_strands=both_strands, canonical=canonical,
        spill_entries=spill_entries, progress=progress, chunk=chunk,
        cap_entries=cap_entries, log=log, n_devices=n_devices,
    )


def count_chunks(
    code_chunks,
    rho: int,
    *,
    both_strands: bool,
    canonical: bool,
    spill_entries: int = 1 << 26,
    progress=None,
    chunk: int = 0,
    cap_entries: int | None = None,
    log=None,
    n_devices: int = 1,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Count over pre-encoded flat code chunks (Python or native reader).

    Narrow keys (rho <= 31) go through the batched zero-sync engine;
    wide keys through the four-limb engine.  ``log``
    receives spill telemetry (the reference's load/spill lines during
    counting, ``src/GossCmdBuildGraph.cc:345-377``).

    ``n_devices > 1`` routes through the multi-chip engine
    (:class:`gossamer_tpu.parallel.count_sharded.ShardedSpectrumEngine`):
    data-parallel kmerize + hash-partitioned all_to_all key exchange —
    the device replacement for the reference's spill-and-merge scale
    story (``src/GossCmdBuildKmerSet.tcc:246-328``).
    """
    on_spill = None
    if log is not None:
        on_spill = lambda i, n: log(
            "info", f"spill {i}: {n:,} distinct keys -> host RAM run")
    mode = "ref" if canonical else ("value" if both_strands else "plain")
    if n_devices > 1 and not narrow_keys(rho):
        # wide keys (31 < rho <= 63) on the mesh: 4-limb variant over
        # raw code chunks (``src/Graph.hh:87-89`` k <= 62 on all paths)
        from ..parallel.count_sharded import ShardedSpectrumEngineWide
        from ..parallel.mesh import data_mesh

        if chunk <= 0:
            raise ValueError("--num-devices requires an explicit "
                             "chunk size")
        cap = cap_entries or (1 << 22)
        eng = ShardedSpectrumEngineWide(data_mesh(n_devices), rho, mode,
                                        chunk, cap=cap)
        n_chunks = 0
        for codes in code_chunks:
            codes = np.asarray(codes)
            want = chunk + rho - 1
            if len(codes) < want:  # pad the tail chunk
                codes = np.concatenate(
                    [codes, np.full(want - len(codes), 255, np.uint8)])
            with profile.context("count/add_chunk"):
                eng.add_chunk(codes)
            n_chunks += 1
            if progress is not None:
                progress(n_chunks * chunk)
        with profile.context("count/finish"):
            if both_strands:
                return eng.finish_expanded()
            return eng.finish()
    if n_devices > 1:
        if chunk <= 0 or chunk % 16:
            raise ValueError(
                "--num-devices requires an explicit chunk size divisible "
                "by 16 (packed transfer format)")
        from ..io.stream import pack_chunk
        from ..parallel.count_sharded import ShardedSpectrumEngine
        from ..parallel.mesh import data_mesh

        cap = cap_entries or (1 << 23)
        eng = ShardedSpectrumEngine(data_mesh(n_devices), rho, mode, chunk,
                                    cap=cap)
        n_chunks = 0
        for codes in code_chunks:
            with profile.context("count/add_chunk"):
                if isinstance(codes, tuple):
                    eng.add_chunk_packed(np.asarray(codes[0]),
                                         np.asarray(codes[1]))
                else:
                    eng.add_chunk_packed(*pack_chunk(
                        np.asarray(codes), rho, chunk))
            n_chunks += 1
            if progress is not None:
                progress(n_chunks * chunk)
        with profile.context("count/finish"):
            if both_strands:
                return eng.finish_expanded()
            return eng.finish()
    if narrow_keys(rho):
        # A symmetric edge set is fully determined by canonical-class
        # counts: count(x) == count(rc(x)) == occurrences of the class
        # (palindromes count double).  So the fwd+rc insertion of
        # build-graph is counted canonically at HALF the lane volume and
        # expanded to both orientations once at the end.  The class
        # representative is min-by-value unless the caller asked for
        # canonical output (then the reference's FNV ordering is used so
        # the stored set matches dump-kmer-set byte-for-byte).
        from .engine import SpectrumEngine

        expand = both_strands
        eng = None
        n_chunks = 0
        for codes in code_chunks:
            packed = isinstance(codes, tuple)
            if eng is None:
                if packed and chunk <= 0:
                    raise ValueError(
                        "packed chunk streams need an explicit chunk size "
                        "(lane count is not recoverable from the tuple)")
                lanes = chunk if packed else len(codes) - rho + 1
                cap = cap_entries or min(1 << 25, max(1 << 16, 4 * lanes))
                eng = SpectrumEngine(rho, mode, chunk or len(codes), cap=cap,
                                     on_spill=on_spill)
            with profile.context("count/add_chunk"):
                if packed:
                    eng.add_chunk_packed(np.asarray(codes[0]),
                                         np.asarray(codes[1]))
                else:
                    eng.add_chunk(np.asarray(codes))
            n_chunks += 1
            if progress is not None:
                progress(n_chunks * (chunk or lanes))
        if eng is None:
            z = np.zeros(0, dtype=U64)
            return z, z.copy(), np.zeros(0, dtype=np.int64)
        with profile.context("count/finish"):
            if expand:
                return eng.finish_expanded()
            return eng.finish()
    # wide keys (31 < rho <= 63): engine v2 on four u32 limb planes
    from .engine_wide import SpectrumEngineWide

    eng = None
    n_chunks = 0
    for codes in code_chunks:
        codes = np.asarray(codes)
        if eng is None:
            lanes = len(codes) - rho + 1
            cap = cap_entries or min(1 << 24, max(1 << 16, 4 * lanes))
            eng = SpectrumEngineWide(rho, mode, chunk or len(codes),
                                     cap=cap, on_spill=on_spill)
        with profile.context("count/add_chunk"):
            eng.add_chunk(codes)
        n_chunks += 1
        if progress is not None:
            progress(n_chunks * (chunk or len(codes)))
    if eng is None:
        z = np.zeros(0, dtype=U64)
        return z, z.copy(), np.zeros(0, dtype=np.int64)
    with profile.context("count/finish"):
        if both_strands:
            return eng.finish_expanded()
        return eng.finish()


def count_rho_mers_files(
    paths: list[str],
    rho: int,
    *,
    both_strands: bool,
    canonical: bool,
    chunk: int = 1 << 22,
    spill_entries: int = 1 << 26,
    fmt: str | None = None,
    progress=None,
    cap_entries: int | None = None,
    threads: int = 1,
    log=None,
    n_devices: int = 1,
):
    """Count straight from files through the native reader, or through
    the Python parser chain (with a warning) when the native library
    cannot be built.  ``threads`` feeds the native reader's producer
    pool (``-T``; one parser thread per input file up to the limit — the
    BackgroundLineSource analog, ``src/LineSource.cc``)."""
    from ..io.native import (load_library, native_flat_chunks,
                             native_packed_chunks)

    if load_library() is not None:
        if narrow_keys(rho) and chunk % 16 == 0:
            # packed transfer: 0.375 B/base host->device
            chunks = native_packed_chunks(paths, rho, chunk=chunk, fmt=fmt,
                                          threads=threads)
        else:
            chunks = native_flat_chunks(paths, rho, chunk=chunk, fmt=fmt,
                                        threads=threads)
        return count_chunks(chunks, rho, both_strands=both_strands,
                            canonical=canonical, spill_entries=spill_entries,
                            progress=progress, chunk=chunk,
                            cap_entries=cap_entries, log=log,
                            n_devices=n_devices)
    from ..io.readers import read_files

    if log is not None:
        log("warning", "native reader unavailable (see native/Makefile); "
                       "parsing in Python")
    return count_rho_mers(
        read_files(paths), rho, both_strands=both_strands,
        canonical=canonical, chunk=chunk, spill_entries=spill_entries,
        progress=progress, cap_entries=cap_entries, log=log,
        n_devices=n_devices,
    )
