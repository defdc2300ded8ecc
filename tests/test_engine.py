"""Engine v2 (u32-plane batched counting) parity tests.

Mirrors the reference counting semantics (``src/GossCmdBuildGraph.cc``,
``src/GossCmdBuildKmerSet.tcc``) against the host spec model and the
legacy device path.
"""

import numpy as np
import pytest

from gossamer_tpu.core import kmer as K
from gossamer_tpu.ops.count import _expand_symmetric, count_chunks
from gossamer_tpu.ops.engine import SpectrumEngine, narrow_keys


def _chunks(rng, n_chunks, chunk, rho, sep_every=50):
    out = []
    for _ in range(n_chunks):
        c = rng.integers(0, 4, size=chunk + rho - 1, dtype=np.uint8)
        c[rng.integers(0, len(c), size=len(c) // sep_every)] = 255
        out.append(c)
    return out


def _brute(chunks, rho, canon):
    """Host brute-force spectrum over all valid windows."""
    acc = {}
    for c in chunks:
        n = len(c) - rho + 1
        for i in range(n):
            w = c[i : i + rho]
            if (w >= 4).any():
                continue
            v = 0
            for b in w:
                v = (v << 2) | int(b)
            if canon == "value":
                lo, hi = K.reverse_complement(
                    np.array([v], np.uint64), np.array([0], np.uint64), rho)
                v = min(v, int(lo[0]))
            elif canon == "ref":
                lo, hi, _ = K.normalize(
                    np.array([v], np.uint64), np.array([0], np.uint64), rho)
                v = int(lo[0])
            acc[v] = acc.get(v, 0) + 1
    keys = np.array(sorted(acc), dtype=np.uint64)
    vals = np.array([acc[int(k)] for k in keys], dtype=np.int64)
    return keys, vals


@pytest.mark.parametrize("rho", [5, 26, 31])
def test_plain_mode_brute_force(rho):
    assert narrow_keys(rho)
    rng = np.random.default_rng(3)
    chunks = _chunks(rng, 5, 400, rho)
    eng = SpectrumEngine(rho, "plain", 400, batch=2, cap=1 << 12)
    for c in chunks:
        eng.add_chunk(c)
    lo, hi, c = eng.finish()
    keys, vals = _brute(chunks, rho, None)
    assert np.array_equal(lo, keys)
    assert np.array_equal(c, vals)


def test_value_mode_brute_force():
    rho = 26
    rng = np.random.default_rng(4)
    chunks = _chunks(rng, 3, 500, rho)
    eng = SpectrumEngine(rho, "value", 500, batch=2, cap=1 << 12)
    for c in chunks:
        eng.add_chunk(c)
    lo, hi, c = eng.finish()
    keys, vals = _brute(chunks, rho, "value")
    assert np.array_equal(lo, keys)
    assert np.array_equal(c, vals)


def test_ref_mode_matches_reference_normalize():
    rho = 25
    rng = np.random.default_rng(5)
    chunks = _chunks(rng, 3, 500, rho)
    eng = SpectrumEngine(rho, "ref", 500, batch=2, cap=1 << 12)
    for c in chunks:
        eng.add_chunk(c)
    lo, hi, c = eng.finish()
    keys, vals = _brute(chunks, rho, "ref")
    assert np.array_equal(lo, keys)
    assert np.array_equal(c, vals)


def test_count_chunks_build_graph_symmetry():
    """build-graph mode: symmetric expanded spectrum, rc-closed."""
    rho = 26
    rng = np.random.default_rng(6)
    chunks = _chunks(rng, 4, 600, rho)
    lo, hi, c = count_chunks(iter(chunks), rho, both_strands=True,
                             canonical=False, cap_entries=1 << 12)
    # closed under reverse complement with equal counts
    rlo, rhi = K.reverse_complement(lo, hi, rho)
    order = np.argsort(rlo)
    assert np.array_equal(rlo[order], lo)
    assert np.array_equal(c[order], c)
    # totals: every valid window contributes exactly 2 (fwd + rc)
    n_valid = sum(
        int((np.lib.stride_tricks.sliding_window_view(ch, rho) < 4)
            .all(axis=1).sum())
        for ch in chunks)
    assert c.sum() == 2 * n_valid


def test_host_spill_parity():
    """Spectra larger than the device cap spill to host runs and merge
    back exactly (the HBM->host analog of the reference's disk spill)."""
    rho = 26
    rng = np.random.default_rng(9)
    chunks = _chunks(rng, 12, 500, rho)
    eng = SpectrumEngine(rho, "plain", 500, batch=2, cap=2048, spill=True)
    for c in chunks:
        eng.add_chunk(c)
    lo, hi, c = eng.finish()
    assert len(eng.host_runs) >= 1, "expected at least one spill"
    keys, vals = _brute(chunks, rho, None)
    assert np.array_equal(lo, keys)
    assert np.array_equal(c, vals)


def test_host_spill_expanded_parity():
    rho = 26
    rng = np.random.default_rng(10)
    chunks = _chunks(rng, 12, 500, rho)
    eng = SpectrumEngine(rho, "value", 500, batch=2, cap=2048, spill=True)
    for c in chunks:
        eng.add_chunk(c)
    lo, hi, c = eng.finish_expanded()
    assert len(eng.host_runs) >= 1
    # reference: unspilled engine with a big cap, expanded
    eng2 = SpectrumEngine(rho, "value", 500, batch=2, cap=1 << 14)
    for ch in chunks:
        eng2.add_chunk(ch)
    lo2, hi2, c2 = eng2.finish_expanded()
    assert np.array_equal(lo, lo2)
    assert np.array_equal(c, c2)


def test_overflow_detection():
    """A cap too small for even one batch is a hard error (spill can't
    help when a single sort would drop keys)."""
    rho = 26
    rng = np.random.default_rng(8)
    chunks = _chunks(rng, 4, 2000, rho)
    eng = SpectrumEngine(rho, "plain", 2000, batch=2, cap=256)
    with pytest.raises(RuntimeError, match="exceeded cap"):
        for c in chunks:
            eng.add_chunk(c)
        eng.finish()


def test_empty_stream():
    eng = SpectrumEngine(26, "plain", 100, cap=256)
    lo, hi, c = eng.finish()
    assert len(lo) == 0 and len(c) == 0


# ------------------------------------------------------- packed input path
@pytest.mark.parametrize("rho", [5, 16, 26, 31])
def test_kmerize_packed_matches_planes(rho):
    """Funnel-shift extraction over the packed 2-bit stream produces the
    identical valid-key multiset as the shift-or loop over raw codes
    (covers sh > 32, sh == 32 and sh < 32 key alignments)."""
    import jax.numpy as jnp

    from gossamer_tpu.io.stream import pack_chunk
    from gossamer_tpu.ops.engine import kmerize_packed, kmerize_planes

    rng = np.random.default_rng(13)
    C = 512
    codes = rng.integers(0, 4, size=C + rho - 1, dtype=np.uint8)
    codes[rng.integers(0, len(codes), size=8)] = 255  # separators/Ns
    l1a, l0a, va = kmerize_planes(jnp.asarray(codes), rho)
    words, inval = pack_chunk(codes, rho, C)
    l1b, l0b, vb = kmerize_packed(jnp.asarray(words), jnp.asarray(inval),
                                  rho, C)
    ka = np.sort((np.asarray(l1a).astype(np.uint64) << 32)
                 | np.asarray(l0a).astype(np.uint64), kind="stable")

    def flat_sorted(l1, l0, v):
        k = (np.asarray(l1).reshape(-1).astype(np.uint64) << 32) \
            | np.asarray(l0).reshape(-1).astype(np.uint64)
        return np.sort(k[np.asarray(v).reshape(-1)])

    assert np.asarray(va).sum() == np.asarray(vb).sum()
    np.testing.assert_array_equal(
        flat_sorted(l1a, l0a, va), flat_sorted(l1b, l0b, vb))
    # keys under invalid lanes don't matter; valid count must match the
    # brute separator-window count
    win = np.lib.stride_tricks.sliding_window_view(codes, rho)
    assert np.asarray(va).sum() == int((win < 4).all(axis=1).sum())
    _ = ka  # (planes keys incl. invalid lanes — unused beyond dtype check)


@pytest.mark.parametrize("mode", ["plain", "value", "ref"])
def test_packed_engine_parity(mode):
    """add_chunk_packed == add_chunk spectra."""
    from gossamer_tpu.io.stream import pack_chunk

    rho = 26
    rng = np.random.default_rng(14)
    chunks = _chunks(rng, 6, 512, rho)
    eng = SpectrumEngine(rho, mode, 512, batch=2, cap=1 << 14)
    for c in chunks:
        eng.add_chunk_packed(*pack_chunk(c, rho, 512))
    lo, hi, c = eng.finish()
    eng2 = SpectrumEngine(rho, mode, 512, batch=2, cap=1 << 14)
    for ch in chunks:
        eng2.add_chunk(ch)
    lo2, hi2, c2 = eng2.finish()
    assert np.array_equal(lo, lo2)
    assert np.array_equal(c, c2)


def test_packed_engine_spill_and_expand():
    """Packed path through spills and symmetric expansion."""
    from gossamer_tpu.io.stream import pack_chunk

    rho = 26
    rng = np.random.default_rng(15)
    chunks = _chunks(rng, 12, 512, rho)
    eng = SpectrumEngine(rho, "value", 512, batch=2, cap=2048, spill=True)
    for c in chunks:
        eng.add_chunk_packed(*pack_chunk(c, rho, 512))
    lo, hi, c = eng.finish_expanded()
    assert len(eng.host_runs) >= 1
    eng2 = SpectrumEngine(rho, "value", 512, batch=2, cap=1 << 14)
    for ch in chunks:
        eng2.add_chunk(ch)
    lo2, hi2, c2 = eng2.finish_expanded()
    assert np.array_equal(lo, lo2)
    assert np.array_equal(c, c2)


@pytest.mark.parametrize("hint", [False, True])
def test_early_pull_reconcile_parity(monkeypatch, hint):
    """Mid-stream snapshot + finish reconcile == classic pull exactly.

    The reconciled finish pulls final counts + post-snapshot keys only;
    its output must be bit-identical to the exact pull.  The classic
    pull is disabled on the instance so a silent fallback cannot pass.
    """
    import gossamer_tpu.ops.engine as E

    monkeypatch.setattr(E, "_DELTA_MIN", 16)
    rho = 13  # 2*rho <= 31: dense-delta eligible at any size
    rng = np.random.default_rng(21)
    chunks = _chunks(rng, 8, 2000, rho)
    eng = SpectrumEngine(rho, "value", 2000, batch=2, cap=1 << 14,
                         spill=False, early_pull_flush=1,
                         expected_distinct=6000 if hint else None)
    for c in chunks:
        eng.add_chunk(c)
    assert eng._snap is not None

    def boom(*a, **k):
        raise AssertionError("classic pull used; reconcile fell back")

    monkeypatch.setattr(eng, "_pull_planes", boom)
    lo, hi, c = eng.finish()

    eng2 = SpectrumEngine(rho, "value", 2000, batch=2, cap=1 << 14)
    for ch in chunks:
        eng2.add_chunk(ch)
    lo2, hi2, c2 = eng2.finish()
    assert np.array_equal(lo, lo2)
    assert np.array_equal(c, c2)


def test_early_pull_invalidated_by_spill(monkeypatch):
    """A spill retires the snapshotted spectrum; finish must fall back
    to the spill-merge path and still be exact."""
    import gossamer_tpu.ops.engine as E

    monkeypatch.setattr(E, "_DELTA_MIN", 16)
    rho = 13
    rng = np.random.default_rng(22)
    chunks = _chunks(rng, 10, 2000, rho)
    eng = SpectrumEngine(rho, "value", 2000, batch=2, cap=4096,
                         spill=True, early_pull_flush=1)
    for c in chunks:
        eng.add_chunk(c)
    lo, hi, c = eng.finish()
    assert eng._snap is None
    eng2 = SpectrumEngine(rho, "value", 2000, batch=2, cap=1 << 15)
    for ch in chunks:
        eng2.add_chunk(ch)
    lo2, hi2, c2 = eng2.finish()
    assert np.array_equal(lo, lo2)
    assert np.array_equal(c, c2)


def test_early_pull_expanded_parity(monkeypatch):
    """Reconciled finish under finish_expanded (build-graph semantics):
    must take the background pre-expansion path, no full host expand."""
    import gossamer_tpu.ops.engine as E

    monkeypatch.setattr(E, "_DELTA_MIN", 16)
    rho = 13
    rng = np.random.default_rng(23)
    chunks = _chunks(rng, 6, 2000, rho)
    eng = SpectrumEngine(rho, "value", 2000, batch=2, cap=1 << 14,
                         spill=False, early_pull_flush=2)
    for c in chunks:
        eng.add_chunk(c)
    assert eng._prex is not None

    def boom(*a, **k):
        raise AssertionError("pre-expanded path fell back")

    monkeypatch.setattr(eng, "_finish_planes", boom)
    lo, hi, c = eng.finish_expanded()
    eng2 = SpectrumEngine(rho, "value", 2000, batch=2, cap=1 << 14)
    for ch in chunks:
        eng2.add_chunk(ch)
    lo2, hi2, c2 = eng2.finish_expanded()
    assert np.array_equal(lo, lo2)
    assert np.array_equal(c, c2)


def test_sparse_packed_parity():
    """add_chunk_packed_sparse == add_chunk spectra (incl. a padded
    final partial chunk carried by n_windows and mid-chunk separators)."""
    from gossamer_tpu.io.stream import pack_chunk_sparse

    rho = 26
    chunk = 512
    rng = np.random.default_rng(31)
    chunks = _chunks(rng, 5, chunk, rho)
    # final partial chunk: trailing 255 padding
    tail = chunks[-1].copy()
    tail[300:] = 255
    chunks[-1] = tail
    eng = SpectrumEngine(rho, "value", chunk, batch=2, cap=1 << 14)
    for c in chunks:
        sp = pack_chunk_sparse(c, rho, chunk, max_pos=chunk // 4)
        assert sp is not None
        eng.add_chunk_packed_sparse(*sp)
    lo, hi, cc = eng.finish()
    eng2 = SpectrumEngine(rho, "value", chunk, batch=2, cap=1 << 14)
    for ch in chunks:
        eng2.add_chunk(ch)
    lo2, hi2, cc2 = eng2.finish()
    assert np.array_equal(lo, lo2)
    assert np.array_equal(cc, cc2)


def test_pack_chunk_sparse_overflow_returns_none():
    from gossamer_tpu.io.stream import pack_chunk_sparse

    rho = 26
    chunk = 512
    codes = np.full(chunk + rho - 1, 255, np.uint8)
    codes[::2] = 1
    assert pack_chunk_sparse(codes, rho, chunk, max_pos=8) is None


def test_periodic_packed_parity():
    """add_chunk_packed_periodic (fixed-length reads, words-only wire)
    == add_chunk, incl. a mid-chunk pass boundary and trailing padding."""
    from gossamer_tpu.io.stream import pack_chunk

    rho = 26
    L = 50
    T = L + 1
    chunk = 512
    rng = np.random.default_rng(41)
    # two "passes" of whole reads back to back, then 255 padding
    passes = []
    for rows in (13, 9):
        block = np.full((rows, T), 255, np.uint8)
        block[:, :L] = rng.integers(0, 4, size=(rows, L), dtype=np.uint8)
        passes.append(block.reshape(-1))
    flat = np.concatenate(passes)
    n_chunks = -(-len(flat) // chunk)
    stream = np.full(n_chunks * chunk + rho - 1, 255, np.uint8)
    stream[: len(flat)] = flat

    eng = SpectrumEngine(rho, "value", chunk, batch=2, cap=1 << 14,
                         period=T)
    starts = [0, len(passes[0])]
    data_end = len(flat)
    for i in range(n_chunks):
        p0 = i * chunk
        codes = stream[p0 : p0 + chunk + rho - 1]
        words, _ = pack_chunk(codes, rho, chunk)
        # meta: phase within the current pass; bound = chunk-local start
        # of the next pass (or past-the-end)
        cur = max(s for s in starts if s <= p0)
        ph = (p0 - cur) % T
        nxt = [s for s in starts if s > p0]
        bound = (nxt[0] - p0) if nxt else chunk + rho
        nwin = max(0, min(chunk, data_end - rho + 1 - p0))
        eng.add_chunk_packed_periodic(words, ph, bound, nwin)
    lo, hi, c = eng.finish()

    eng2 = SpectrumEngine(rho, "value", chunk, batch=2, cap=1 << 14)
    for i in range(n_chunks):
        eng2.add_chunk(stream[i * chunk : (i + 1) * chunk + rho - 1])
    lo2, hi2, c2 = eng2.finish()
    assert np.array_equal(lo, lo2)
    assert np.array_equal(c, c2)


# ------------------------------------ every ingestion format vs specmodel
FORMATS = ["raw", "packed", "sparse", "periodic"]


def _read_stream(rho, chunk, n_reads=40, L=50, seed=51):
    """Fixed-length clean reads (the periodic format's contract), one
    separator after each, cut into engine chunks.  -> (reads as str,
    per-chunk (codes, phase, bound, nwin), period)."""
    rng = np.random.default_rng(seed)
    T = L + 1
    block = np.full((n_reads, T), 255, np.uint8)
    block[:, :L] = rng.integers(0, 4, size=(n_reads, L), dtype=np.uint8)
    reads = ["".join("ACGT"[b] for b in row[:L]) for row in block]
    flat = block.reshape(-1)
    n_chunks = -(-len(flat) // chunk)
    stream = np.full(n_chunks * chunk + rho - 1, 255, np.uint8)
    stream[: len(flat)] = flat
    chunks = []
    for i in range(n_chunks):
        p0 = i * chunk
        nwin = max(0, min(chunk, len(flat) - rho + 1 - p0))
        chunks.append((stream[p0 : p0 + chunk + rho - 1], p0 % T,
                       chunk + rho, nwin))
    return reads, chunks, T


def _feed(eng, fmt, chunks, rho, chunk):
    from gossamer_tpu.io.stream import pack_chunk, pack_chunk_sparse

    for codes, ph, bound, nwin in chunks:
        if fmt == "raw":
            eng.add_chunk(codes)
        elif fmt == "packed":
            eng.add_chunk_packed(*pack_chunk(codes, rho, chunk))
        elif fmt == "sparse":
            sp = pack_chunk_sparse(codes, rho, chunk, max_pos=chunk // 4)
            eng.add_chunk_packed_sparse(*sp)
        else:
            eng.add_chunk_packed_periodic(pack_chunk(codes, rho, chunk)[0],
                                          ph, bound, nwin)


@pytest.mark.parametrize("mode", ["plain", "value", "ref"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_ingestion_format_matches_specmodel(fmt, mode):
    """Each ingestion format (raw codes, packed bitmap, packed sparse,
    packed periodic) through the XLA batch step counts exactly the
    brute-force spectrum of ``tests/specmodel.py`` in every mode, across
    several flushes and the padded final batch."""
    from specmodel import spectrum_counts

    rho, chunk = 26, 512
    reads, chunks, T = _read_stream(rho, chunk)
    eng = SpectrumEngine(rho, mode, chunk, batch=2, cap=1 << 14, period=T)
    _feed(eng, fmt, chunks, rho, chunk)
    lo, hi, c = eng.finish()
    want = spectrum_counts(reads, rho, mode)
    keys = sorted(want)
    assert lo.tolist() == keys
    assert not hi.any()
    assert c.tolist() == [want[k] for k in keys]


@pytest.mark.parametrize("fmt", FORMATS)
def test_ingestion_format_expanded_matches_specmodel(fmt):
    """build-graph semantics per format: the expanded fwd+rc spectrum
    equals ``specmodel.spectrum_build_graph``."""
    from specmodel import spectrum_build_graph

    rho, chunk = 26, 512
    reads, chunks, T = _read_stream(rho, chunk, seed=52)
    eng = SpectrumEngine(rho, "value", chunk, batch=2, cap=1 << 14,
                         period=T)
    _feed(eng, fmt, chunks, rho, chunk)
    lo, hi, c = eng.finish_expanded()
    want = spectrum_build_graph(reads, rho)
    keys = sorted(want)
    assert lo.tolist() == keys
    assert c.tolist() == [want[k] for k in keys]
