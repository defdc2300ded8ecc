"""Benchmark: build-graph k-mer counting throughput on one chip.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Workload mirrors BASELINE.md's north-star config: E. coli-scale
build-graph at k=25 (26-mer edges, both strands).  Reads are synthesized
on the host directly as 2-bit code streams so the benchmark measures the
device counting engine (kmerize -> sort -> dedup -> merge), not Python
parsing.  Every line names the platform, device kind and device count
it ran on.

vs_baseline: MEASURED (round 3).  scripts/baseline/bench_backyard.cc
compiles the reference's own BackyardHash+BlendedSort hot loop and
measures 3.00M rho-mers/s per core on this host (insert+sort, parse
excluded, same workload); the denominator is the favorable-to-reference
linear 32-thread extrapolation 96M rho-mers/s (BASELINE.md "Measured
reference baseline").  Rounds 1-2 divided by a 20M/s estimate instead.
"""

import json
import sys
import time

import numpy as np

CPU_BASELINE_KMERS_PER_SEC = 96e6  # measured: 32 x 3.00M/core (BASELINE.md)


def synth_stream(genome_mb: float, coverage: int, read_len: int, rho: int,
                 chunk: int):
    """Flat code stream of synthetic reads over a random genome.

    One vectorized gather builds the whole stream.  Returns (flat,
    n_chunks, pass_starts, data_end): reads are laid out periodically
    (read_len bases + one 255 separator) in ``coverage`` passes, each
    pass starting a fresh period at ``pass_starts[k]`` — the geometry
    the periodic packed-transfer mode consumes.  (This mimics the
    native reader, which parses FASTQ at ~1GB/s — read synthesis must
    not dominate the timed region.)
    """
    rng = np.random.default_rng(42)
    glen = int(genome_mb * 1e6)
    genome = rng.integers(0, 4, size=glen, dtype=np.uint8)
    # coverage passes of read-length tiles at shifted phases: same read
    # count, window count and k-mer spectrum shape as random-start reads,
    # but built by memcpy (random gathers are erratically slow on this
    # host and would pollute a device-throughput benchmark)
    total = coverage * (glen // read_len) * (read_len + 1)  # upper bound
    n_chunks = -(-total // chunk)
    flat = np.full(n_chunks * chunk + rho - 1, 255, np.uint8)
    pos = 0
    pass_starts = []
    for _ in range(coverage):
        off = int(rng.integers(0, read_len))
        rows = (glen - off) // read_len
        pass_starts.append(pos)
        view = flat[pos : pos + rows * (read_len + 1)]
        m = view.reshape(rows, read_len + 1)
        m[:, :read_len] = genome[off : off + rows * read_len].reshape(
            rows, read_len)
        m[:, read_len] = 255
        pos += rows * (read_len + 1)
    return flat, n_chunks, pass_starts, pos


def synth_chunks(genome_mb: float, coverage: int, read_len: int, rho: int,
                 chunk: int):
    """Yield flat code chunks (views) of :func:`synth_stream`."""
    flat, n_chunks, _, _ = synth_stream(genome_mb, coverage, read_len,
                                        rho, chunk)
    for i in range(n_chunks):
        yield flat[i * chunk : (i + 1) * chunk + rho - 1]


# MEASURED (round 4): scripts/baseline/bench_classify.cc compiles the
# reference's own KmerSet+WordyBitVector+normalize and times the exact
# `xenome classify` per-k-mer loop (GossCmdGroupReads.cc:381-468) on
# this workload: 74.8K reads/s/core, 2.01x at 2 threads; denominator is
# the favorable-to-reference linear 32-thread extrapolation (BASELINE.md
# "Measured reference classify baseline").  Rounds 1-3 divided by the
# project's own round-1 Python path (5.6K reads/s) instead.
CPU_BASELINE_CLASSIFY_READS_PER_SEC = 32 * 74.8e3


def bench_xenome(small: bool, to_stdout: bool = False):
    """Xenome classify on the device sort-join engine: reads/s.

    Two synthetic 'genomes' (graft/host), k=25 annotated union set,
    100bp reads drawn from both; the timed region is the classify
    engine over pre-encoded reads (parsing is the native reader's job,
    ~1GB/s).  Emits its JSON line on STDERR so stdout carries exactly
    one driver-parsed metric; the driver tail records both.
    """
    import jax.numpy as jnp
    import numpy as np

    from gossamer_tpu.classify.device import (classify_periodic_stream2,
                                              encode_set)
    from gossamer_tpu.io.stream import pack_chunk

    k = 25
    rng = np.random.default_rng(7)
    glen = int((0.2 if small else 1.0) * 1e6)
    n_reads = 20_000 if small else 200_000
    read_len = 100
    genomes = [rng.integers(0, 4, size=glen, dtype=np.uint8) for _ in range(2)]

    # annotated union set straight from canonical per-genome spectra
    from gossamer_tpu.ops.count import count_chunks

    sets = []
    for g in genomes:
        lo, hi, _ = count_chunks(
            iter([g]), k, both_strands=False, canonical=True,
            chunk=len(g) - k + 1)
        sets.append(lo)
    union = np.union1d(sets[0], sets[1])
    lhs = np.isin(union, sets[0])
    rhs = np.isin(union, sets[1])
    set_E = encode_set(union, lhs, rhs)
    # set prep (host value re-canonicalization + device staging) is
    # part of index LOADING, not per-read classify work — like the
    # reference mmap'ing its KmerSet before the read loop
    from gossamer_tpu.classify.device import prepare_set_value

    prepared = prepare_set_value(set_E, k)

    # reads: half graft, half host, pre-packed into window-sized
    # chunks (the native reader's block format; packing is untimed, as
    # parsing is on both sides — the timed region is H2D + device +
    # blrg pull, the machine-side classify work)
    starts = rng.integers(0, glen - read_len, size=n_reads)
    codes = [genomes[i % 2][s : s + read_len] for i, s in enumerate(starts)]

    window = 1 << 22
    per = window // (read_len + 1)
    packed = []
    for base in range(0, n_reads, per):
        grp = codes[base : base + per]
        parts = []
        for c in grp:
            parts.append(c)
            parts.append(np.array([255], np.uint8))
        flat = np.concatenate(parts)
        pad = window + k - 1 - len(flat)
        flat = np.concatenate([flat, np.full(pad, 255, np.uint8)])
        packed.append((pack_chunk(flat, k, window)[0], len(grp)))

    # warm-up: compile the batch program on one chunk
    classify_periodic_stream2(packed[:1], set_E, k, window, read_len,
                              prepared=prepared)

    t0 = time.time()
    blrg = classify_periodic_stream2(packed, set_E, k, window, read_len,
                                     prepared=prepared)
    dt = time.time() - t0
    rps = n_reads / dt
    assert len(blrg) == n_reads and blrg.max() > 0
    import jax

    print(f"# xenome: {n_reads} reads, {dt:.2f}s", file=sys.stderr)
    print(
        json.dumps(
            {
                "metric": "xenome_classify_reads_per_sec",
                "value": round(rps, 1),
                "unit": "reads/s",
                "vs_baseline": round(
                    rps / CPU_BASELINE_CLASSIFY_READS_PER_SEC, 3),
                **device_tag(),
            }
        ),
        file=sys.stdout if to_stdout else sys.stderr,
    )


def device_tag() -> dict:
    """Where the numbers were taken: platform, device kind and count."""
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices())}


def main():
    small = "--small" in sys.argv
    import gossamer_tpu  # noqa: F401
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    print(f"# device: {dev} ({dev.device_kind})", file=sys.stderr)

    if "--xenome" in sys.argv:
        bench_xenome(small, to_stdout=True)
        return

    from gossamer_tpu.ops.engine import SpectrumEngine, batch_step, _delta_pack

    rho = 26
    chunk = 1 << 18 if small else 1 << 22
    genome_mb = 0.5 if small else 4.6
    coverage = 5 if small else 30
    read_len = 100
    cap = 1 << 20 if small else 1 << 23

    # warm-up/compile the batch + pull programs outside the timed region
    from gossamer_tpu.ops.engine import empty_spec

    # batch width = chunks per flush/program; a smaller first flush
    # moves the early-pull snapshot forward
    import os as _os

    B = int(_os.environ.get("GOSSAMER_BENCH_BATCH", "5" if small else "14"))
    F0 = int(_os.environ.get("GOSSAMER_BENCH_FIRST_BATCH",
                             "5" if small else "6"))
    warm = np.random.default_rng(0).integers(
        0, 4, size=(max(B, F0), chunk + rho - 1), dtype=np.uint8
    )
    w = batch_step(jnp.asarray(warm), *empty_spec(cap), rho, "value", cap)
    np.asarray(w[3])
    # warm the pull programs at the canonical cap (finish pulls the
    # canonical planes and expands on the host): delta-pack + the
    # packed-slice fallback (each is one fixed-grid compile per cap)
    from gossamer_tpu.ops.engine import _slice_pieces_packed

    pieces, excbuf, n_exc = _delta_pack(w[0], w[1], w[2], cap)
    jax.device_get([pieces[0], excbuf, n_exc])
    jax.device_get(_slice_pieces_packed(w[0], w[1], w[2],
                                        max(0, 2 * rho - 32))[:1])
    # warm the reconciled-finish programs (early pull): new-key diff +
    # count-only pack
    from gossamer_tpu.ops.engine import _count_pack, _reconcile_new_keys

    nexcp, nnew_dev = _reconcile_new_keys(w[0], w[1], w[0], w[1], cap)
    cpk, cexcbuf, cnexc = _count_pack(w[0], w[1], w[2], cap)
    jax.device_get([nexcp[0], nnew_dev, cpk[0], cexcbuf, cnexc])

    # build-graph counting semantics: fwd+rc edge spectrum via
    # min-by-value canonical classes + host symmetric expansion.  Input
    # synthesis is untimed: it stands in for the native FASTQ reader.
    flat, n_chunks, _, _ = synth_stream(
        genome_mb, coverage, read_len, rho, chunk)
    chunks = [flat[i * chunk : (i + 1) * chunk + rho - 1]
              for i in range(n_chunks)]

    reps = 1 if small else 3
    best_dt, lo, counts, best_phases = None, None, None, {}
    for _ in range(reps):
        # cap is sized to the workload's distinct-class count, so run
        # the zero-sync path (spill checks would add a device sync per
        # batch; overflow is still hard-checked at finish).  Early pull:
        # snapshot the key planes after the first flush; finish then
        # pulls only final counts + post-snapshot keys (engine.py
        # snapshot_async).  expected_distinct sizes the snapshot without
        # a device sync: distinct canonical classes ~= genome length.
        eng = SpectrumEngine(rho, "value", chunk, cap=cap, spill=False,
                             batch=B, first_batch=F0, early_pull_flush=1,
                             expected_distinct=int(genome_mb * 1.1e6))
        t0 = time.time()
        for codes in chunks:
            eng.add_chunk(codes)
        t_add = time.time() - t0
        lo, hi, counts = eng.finish_expanded()
        dt = time.time() - t0
        phases = dict(eng.phases, add=round(t_add, 3))
        print(f"# run: {dt:.2f}s  phases {phases}", file=sys.stderr)
        if best_dt is None or dt < best_dt:
            best_dt = dt
            best_phases = phases
    dt = best_dt

    total_inserted = int(np.asarray(counts).sum())  # fwd+rc instances
    kps = total_inserted / dt
    print(
        f"# {total_inserted} rho-mers, {len(lo)} distinct, {dt:.2f}s",
        file=sys.stderr,
    )
    if "--no-xenome" not in sys.argv:
        bench_xenome(small)
    print(
        json.dumps(
            {
                "metric": "build_graph_kmers_per_sec",
                "value": round(kps, 1),
                "unit": "rho-mers/s",
                "vs_baseline": round(kps / CPU_BASELINE_KMERS_PER_SEC, 3),
                **device_tag(),
                "best_of": reps,
                # per-phase seconds of the best run.  add = host dispatch
                # loop (H2D + program dispatch); sync = wait for queued
                # device compute; reconcile/pull = finish-time transfer
                # + decode.
                "phases": best_phases,
            }
        )
    )


if __name__ == "__main__":
    main()
