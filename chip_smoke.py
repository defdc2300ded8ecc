#!/usr/bin/env python3
"""Smoke test of the main paths on one NVIDIA GPU, through the CLI.

Usage::

    python chip_smoke.py [--seed N] [--workdir DIR]   # one GPU
    python chip_smoke.py --multi                       # four GPUs

Everything runs in this one process (a second JAX process could not
reserve the card's memory), and the CLI is called in-process.  All
inputs are generated from ``--seed`` under ``--workdir`` (default
``work/smoke``, which ``.gitignore`` lists).

Phases:

0. device: a GPU, its kind and count, ``nvidia-smi``'s name and power
   limit, and the native FASTQ parser loaded;
1. ``goss build-graph -k 27`` on an E. coli-scale read set (a random
   4.6 Mbp genome, 30x of 100 bp reads, substitutions at 0.2% per
   base), compared exactly with a numpy spectrum of every 28-mer of
   every read and its reverse complement;
2. ``gossple -k 27`` on the same reads: contigs of >= 100 bp checked
   against the genome with a 27-mer index;
3. ``xenome index -K 25`` + ``xenome classify`` on 1M reads from two
   4.6 Mbp genomes that share 5% of their sequence, every read's class
   compared with the host reference path (``_batch_blrg``);
4. a ``jax.profiler`` trace of two steady build-graph flushes at the
   phase-1 shapes: the five device operations that took the most time.

``--multi`` runs only ``build-graph``, ``prune-tips`` and ``xenome
classify`` at ``--num-devices 4`` and compares each output byte for
byte with ``--num-devices 1``.

Exits non-zero, printing no result, when JAX finds no GPU or the
package is missing.  The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# phase 1-2: E. coli-scale read set (BASELINE.json configs 1-3)
GENOME_LEN = 4_600_000
COVERAGE = 30
READ_LEN = 100
ERROR_RATE = 0.002  # substitutions per base
K = 27
# phase 3: xenograft classification
XENO_K = 25
XENO_GENOME_LEN = 4_600_000
SHARED_FRAC = 0.05  # of the graft's sequence, copied from the host
SHARED_SEG = 5_000
XENO_READS = 1_000_000
# contig acceptance (0.2% errors can leave a few erroneous edges)
CONTIG_MIN_LEN = 100
CONTIG_IN_GENOME = 0.99
GENOME_COVERED = 0.95

BASES = np.frombuffer(b"ACGT", np.uint8)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card() -> str:
    """``nvidia-smi``'s name and power limit of every card, one per
    line (a child process that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip()


# ------------------------------------------------------------------ inputs
def make_genome(rng, n: int) -> np.ndarray:
    return rng.integers(0, 4, size=n, dtype=np.uint8)


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement along the last axis (A=0 C=1 G=2 T=3)."""
    return 3 - codes[..., ::-1]


def sample_reads(rng, genome, n_reads: int, read_len: int,
                 error_rate: float) -> np.ndarray:
    """uint8[n_reads, read_len]: uniform starts, either strand, then
    substitutions at ``error_rate`` per base (each to another base)."""
    starts = rng.integers(0, len(genome) - read_len + 1, size=n_reads)
    codes = genome[starts[:, None] + np.arange(read_len)]
    flip = rng.random(n_reads) < 0.5
    codes[flip] = revcomp(codes[flip])
    n_err = rng.binomial(codes.size, error_rate)
    pos = rng.integers(0, codes.size, size=n_err)
    flat = codes.reshape(-1)
    flat[pos] = (flat[pos] + rng.integers(1, 4, size=n_err)) % 4
    return codes


def write_fastq(path: str, codes: np.ndarray, prefix: str) -> None:
    """Reads as FASTQ with fixed-width labels ``<prefix><8 digits>``."""
    n, L = codes.shape
    digits = ((np.arange(n)[:, None] // 10 ** np.arange(7, -1, -1)) % 10
              + ord("0")).astype(np.uint8)
    rec = np.empty((n, 1 + len(prefix) + 8 + 1 + L + 3 + L + 1), np.uint8)
    p = len(prefix)
    rec[:, 0] = ord("@")
    rec[:, 1 : 1 + p] = np.frombuffer(prefix.encode(), np.uint8)
    rec[:, 1 + p : 9 + p] = digits
    rec[:, 9 + p] = ord("\n")
    rec[:, 10 + p : 10 + p + L] = BASES[codes]
    rec[:, 10 + p + L : 13 + p + L] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, 13 + p + L : 13 + p + 2 * L] = ord("I")
    rec[:, -1] = ord("\n")
    with open(path, "wb") as f:
        f.write(rec.tobytes())


def write_fasta(path: str, name: str, codes: np.ndarray,
                width: int = 80) -> None:
    seq = BASES[codes].tobytes()
    with open(path, "wb") as f:
        f.write(f">{name}\n".encode())
        for i in range(0, len(seq), width):
            f.write(seq[i : i + width] + b"\n")


def read_fasta(path: str) -> list[np.ndarray]:
    """Sequences of a FASTA file as code arrays (non-ACGT -> 4)."""
    lut = np.full(256, 4, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)
    seqs, cur = [], []
    with open(path, "rb") as f:
        for line in f:
            line = line.strip()
            if line.startswith(b">"):
                if cur:
                    seqs.append(lut[np.frombuffer(b"".join(cur), np.uint8)])
                cur = []
            elif line:
                cur.append(line)
    if cur:
        seqs.append(lut[np.frombuffer(b"".join(cur), np.uint8)])
    return seqs


# -------------------------------------------------------------- references
def windows(codes: np.ndarray, k: int) -> np.ndarray:
    """uint64 keys of every k-window of every row of ``codes`` (2-bit
    codes, first base most significant), flattened row by row."""
    codes = np.atleast_2d(codes)
    w = codes.shape[1] - k + 1
    if w <= 0:
        return np.zeros(0, np.uint64)
    v = np.zeros((codes.shape[0], w), np.uint64)
    for j in range(k):
        v <<= np.uint64(2)
        v |= codes[:, j : j + w].astype(np.uint64)
    return v.reshape(-1)


def spectrum_reference(codes: np.ndarray, rho: int, block: int = 100_000):
    """The build-graph spectrum, independently of the device engine:
    every rho-mer of every read and of its reverse complement, packed
    into uint64 and counted with ``np.unique``.  -> (keys, counts)."""
    parts = []
    for i in range(0, len(codes), block):
        blk = codes[i : i + block]
        parts.append(windows(blk, rho))
        parts.append(windows(revcomp(blk), rho))
    keys, counts = np.unique(np.concatenate(parts), return_counts=True)
    return keys, counts.astype(np.int64)


# ------------------------------------------------------------------ phases
def run_cli(main, argv, capture_stdout: bool = False) -> str:
    """Call a CLI ``main`` in this process; raise on a non-zero exit."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf) if capture_stdout \
            else contextlib.nullcontext():
        rc = main([str(a) for a in argv])
    check(rc == 0, f"{' '.join(map(str, argv[:2]))} exited {rc}")
    return buf.getvalue()


def read_files(prefix: str) -> dict[str, bytes]:
    """Every file of an artifact (``prefix`` + any suffix), by suffix."""
    d, base = os.path.split(prefix)
    out = {}
    for name in sorted(os.listdir(d)):
        if name.startswith(base):
            with open(os.path.join(d, name), "rb") as f:
                out[name[len(base):]] = f.read()
    return out


def phase_count(d: str, codes: np.ndarray, tag: str) -> None:
    import jax

    from gossamer_tpu.cli import goss
    from gossamer_tpu.graph.graph import Graph
    from gossamer_tpu.io.factory import PhysicalFileFactory

    fq = os.path.join(d, "reads.fastq")
    tiny = os.path.join(d, "tiny.fastq")
    write_fastq(tiny, codes[:1000], "t")
    t0 = time.perf_counter()
    run_cli(goss.main, ["build-graph", "-k", K, "-i", tiny,
                        "-O", os.path.join(d, "tiny")])
    t_first = time.perf_counter() - t0
    walls = []
    for _ in range(2):  # the first full run compiles the batch shapes
        t0 = time.perf_counter()
        run_cli(goss.main, ["build-graph", "-k", K, "-i", fq,
                            "-O", os.path.join(d, "graph")])
        walls.append(time.perf_counter() - t0)
    wall = walls[1]
    stats = jax.devices()[0].memory_stats()  # None on the CPU backend
    peak = stats["peak_bytes_in_use"] if stats else 0
    g = Graph.read(os.path.join(d, "graph"), PhysicalFileFactory())
    t0 = time.perf_counter()
    keys, counts = spectrum_reference(codes, K + 1)
    t_ref = time.perf_counter() - t0
    check(not np.asarray(g.hi).any(), "narrow graph has high words")
    check(np.array_equal(np.asarray(g.lo), keys),
          f"edge keys differ from the numpy reference "
          f"({g.count} vs {len(keys)} edges)")
    check(np.array_equal(np.asarray(g.counts).astype(np.int64), counts),
          "edge counts differ from the numpy reference")
    inserted = int(counts.sum())
    print(f"phase 1 build-graph: {g.count} edges == numpy reference "
          f"(exact); first call on 1000 reads {t_first:.3f} s; wall "
          f"{walls[0]:.3f} s (first full run, compiles) then {wall:.3f} s "
          f"for {len(codes)} reads; "
          f"{inserted / wall:,.0f} rho-mers/s ({inserted} fwd+rc "
          f"rho-mers); device peak {peak / 2**30:.2f} GiB; "
          f"reference {t_ref:.1f} s host [{tag}]", flush=True)


def phase_assembly(d: str, genome: np.ndarray, tag: str) -> None:
    import re

    from gossamer_tpu.cli import gossple

    fq = os.path.join(d, "reads.fastq")
    prefix = os.path.join(d, "asm")
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = gossple.main(["-k", str(K), "-i", fq, "-O", prefix])
    wall = time.perf_counter() - t0
    log = err.getvalue()
    if rc != 0:
        print(log[-4000:], file=sys.stderr)
    check(rc == 0, f"gossple exited {rc}")
    stages = re.findall(r"^\[stage \d+\] ([\w-]+): ([\d.]+) s wall$", log,
                        re.M)
    contigs = [c for c in read_fasta(prefix + "-contigs.fa")
               if len(c) >= CONTIG_MIN_LEN]
    check(len(contigs) > 0, "no contigs of >= 100 bp")
    g_fwd = np.unique(windows(genome, K))
    g_both = np.union1d(g_fwd, windows(revcomp(genome), K))
    c_kmers = np.concatenate([windows(c, K) for c in contigs])
    in_genome = float(np.isin(c_kmers, g_both).mean())
    c_both = np.union1d(c_kmers,
                        np.concatenate([windows(revcomp(c), K)
                                        for c in contigs]))
    covered = float(np.isin(g_fwd, c_both).mean())
    lens = sorted((len(c) for c in contigs), reverse=True)
    n50 = next(L for i, L in enumerate(lens)
               if sum(lens[: i + 1]) >= sum(lens) / 2)
    check(in_genome >= CONTIG_IN_GENOME,
          f"{in_genome:.4f} of contig {K}-mers in the genome "
          f"(< {CONTIG_IN_GENOME})")
    check(covered >= GENOME_COVERED,
          f"contigs cover {covered:.4f} of the genome's {K}-mers "
          f"(< {GENOME_COVERED})")
    print(f"phase 2 gossple: {len(contigs)} contigs >= {CONTIG_MIN_LEN} bp "
          f"(N50 {n50}, longest {lens[0]}); {in_genome:.5f} of their "
          f"{K}-mers in the genome; they cover {covered:.5f} of its "
          f"{K}-mers; wall {wall:.3f} s [{tag}]", flush=True)
    for name, secs in stages:
        print(f"  stage {name}: {float(secs):.3f} s [{tag}]")


def xeno_inputs(d: str, rng, scale: float = 1.0):
    """Host and graft genomes (the graft shares SHARED_FRAC of its
    sequence with the host, in SHARED_SEG-long copies), FASTA files and
    the read matrix (half from each genome, either strand, shuffled)."""
    n = int(XENO_GENOME_LEN * scale)
    host = make_genome(rng, n)
    graft = make_genome(rng, n)
    seg = max(200, int(SHARED_SEG * scale))
    n_seg = max(1, int(SHARED_FRAC * n) // seg)
    slots = rng.choice(n // seg, size=n_seg, replace=False)
    for s in slots:
        src = int(rng.integers(0, n - seg))
        graft[s * seg : (s + 1) * seg] = host[src : src + seg]
    write_fasta(os.path.join(d, "host.fa"), "host", host)
    write_fasta(os.path.join(d, "graft.fa"), "graft", graft)
    n_reads = int(XENO_READS * scale)
    reads = np.concatenate([
        sample_reads(rng, graft, n_reads // 2, READ_LEN, 0.0),
        sample_reads(rng, host, n_reads - n_reads // 2, READ_LEN, 0.0)])
    reads = reads[rng.permutation(len(reads))]
    write_fastq(os.path.join(d, "xreads.fastq"), reads, "x")
    return reads


def read_classes(prefix: str, n: int) -> np.ndarray:
    """Class name per read from ``xenome classify``'s output files."""
    got = np.full(n, "", dtype=object)
    for cls in ("graft", "host", "both", "neither", "ambiguous"):
        path = f"{prefix}_{cls}.fastq"
        if not os.path.exists(path):
            continue
        with open(path, "rb") as f:
            labels = f.read().split(b"\n")[0::4]
        for lab in labels:
            if lab:
                i = int(lab[2:])
                check(got[i] == "", f"read {i} written twice")
                got[i] = cls
    return got


def reference_classes(index: str, reads: np.ndarray,
                      block: int = 50_000):
    """Host reference path: ``classify/xenome.py::_batch_blrg`` (numpy
    searchsorted into the index), independent of ``classify/device``."""
    from gossamer_tpu.classify.annotated_set import AnnotatedKmerSet
    from gossamer_tpu.classify.xenome import OUT_CLASS, _batch_blrg
    from gossamer_tpu.io.factory import PhysicalFileFactory

    ann = AnnotatedKmerSet.read(index, PhysicalFileFactory())
    blrg = np.concatenate([_batch_blrg(list(reads[i : i + block]), ann)
                           for i in range(0, len(reads), block)])
    name = {"lhs": "graft", "rhs": "host"}
    cls = np.array([name.get(OUT_CLASS[b], OUT_CLASS[b]) for b in blrg],
                   dtype=object)
    return blrg, cls


def parse_stats(text: str) -> np.ndarray:
    """The 16 per-blrg counts of ``xenome classify``'s Statistics table."""
    lines = text.splitlines()
    i = lines.index("B\tG\tH\tM\tcount\tpercent\tclass")
    return np.array([int(l.split("\t")[4]) for l in lines[i + 1 : i + 17]])


def phase_classify(d: str, reads: np.ndarray, tag: str) -> None:
    from gossamer_tpu.cli import xenome

    index = os.path.join(d, "idx")
    t0 = time.perf_counter()
    run_cli(xenome.main, ["index", "-K", XENO_K,
                          "-G", os.path.join(d, "graft.fa"),
                          "-H", os.path.join(d, "host.fa"), "-P", index,
                          "-v"])
    t_index = time.perf_counter() - t0
    out = os.path.join(d, "cls")
    t0 = time.perf_counter()
    stats = run_cli(xenome.main, ["classify", "-P", index,
                                  "-i", os.path.join(d, "xreads.fastq"),
                                  "--output-filename-prefix", out],
                    capture_stdout=True)
    wall = time.perf_counter() - t0
    got = read_classes(out, len(reads))
    t0 = time.perf_counter()
    blrg, want = reference_classes(index, reads)
    t_ref = time.perf_counter() - t0
    bad = np.flatnonzero(got != want)
    check(len(bad) == 0, f"{len(bad)} reads classified unlike the host "
                         f"reference (first: {bad[:5].tolist()})")
    check(np.array_equal(parse_stats(stats),
                         np.bincount(blrg, minlength=16)),
          "class statistics differ from the host reference")
    share = {c: int((want == c).sum()) for c in
             ("graft", "host", "both", "neither", "ambiguous")}
    print(f"phase 3 xenome: {len(reads)} reads == host reference (exact; "
          f"{share}); index {t_index:.3f} s; classify wall {wall:.3f} s, "
          f"{len(reads) / wall:,.0f} reads/s; reference {t_ref:.1f} s "
          f"host [{tag}]", flush=True)


def hlo_ops(hlo_text: str) -> dict[str, tuple[str, int, str]]:
    """Instruction name (dots and dashes as underscores, as kernels are
    named) -> (opcode, number of results, result shape) from an HLO
    module's text."""
    import re

    out = {}
    for m in re.finditer(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*"
                         r"(\([^=]*?\)|\S+)\s+([a-z][\w\-]*)\(",
                         hlo_text, re.M):
        name, shape, opcode = m.groups()
        n = shape.count("[") if shape.startswith("(") else 1
        out[re.sub(r"[.\-]", "_", name)] = (opcode, n, shape)
    return out


def _category(op: str, hlo: dict) -> tuple[str, str]:
    """(category, HLO description) of one device operation."""
    if op.startswith("Memcpy"):
        return "host<->device copies", op
    best = max((n for n in hlo if op == n or op.startswith(n + "_")),
               key=len, default=None)
    if best is None:
        return "other", "?"
    opcode, n, shape = hlo[best]
    desc = f"{opcode} {shape}"[:120]
    if opcode == "sort":
        return f"sort of {n} operands", desc
    return "fusions and scans", desc


def device_ops(trace_dir: str, hlo: dict, top: int = 5):
    """Reduce a profiler trace of GPU work.

    Device planes are ``/device:GPU:*``; their ``Stream`` lines carry
    the kernels, named after their HLO instruction with ``__N``
    suffixes for several launches of one instruction, and the copies.
    The window spans the first to the last device event; busy is the
    union of event intervals.  -> (top [(op, s, share, category,
    HLO)], per-category seconds, window s, busy s)."""
    import glob
    import re

    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    check(len(paths) == 1, f"expected one trace file, found {len(paths)}")
    pd = ProfileData.from_file(paths[0])
    events, lines_seen = [], set()
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        lines_seen.update(l.name for l in lines)
        for line in lines:
            if not line.name.startswith("Stream"):
                continue
            copy = re.search(r"Memcpy\w+", line.name)
            for e in line.events:
                op = copy.group(0) if copy else re.sub(r"__\d+$", "",
                                                       e.name)
                events.append((op, e.start_ns, e.end_ns))
    check(len(events) > 0, f"no device events (lines: {sorted(lines_seen)})")
    start = min(e[1] for e in events)
    end = max(e[2] for e in events)
    window = (end - start) / 1e9
    busy, cur_s, cur_e = 0, None, None
    for _, s, e in sorted(events, key=lambda e: e[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    per, cats = {}, {}
    for op, s, e in events:
        per[op] = per.get(op, 0) + (e - s)
    for op, t in per.items():
        cat = _category(op, hlo)[0]
        cats[cat] = cats.get(cat, 0) + t / 1e9
    ranked = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    top_ops = [(op, t / 1e9, t / 1e9 / window) + _category(op, hlo)
               for op, t in ranked]
    return top_ops, cats, window, busy / 1e9


def phase_trace(d: str, tag: str) -> None:
    """Two steady build-graph flushes, traced, at the phase-1 shapes:
    the CLI's own engine, chunking and spectrum cap over the phase-1
    FASTQ."""
    import types

    import jax
    import jax.numpy as jnp

    from gossamer_tpu.cli.goss import build_app
    from gossamer_tpu.cmds.basic import _chunk_kwargs
    from gossamer_tpu.io.native import native_packed_chunks
    from gossamer_tpu.ops.engine import SpectrumEngine, batch_step_packed

    ns = build_app().build_parser().parse_args(
        ["build-graph", "-k", str(K), "-O", "x", "-i", "x"])
    kw = _chunk_kwargs(types.SimpleNamespace(opts=ns), K + 1)
    chunk, cap = kw["chunk"], kw["cap_entries"]
    eng = SpectrumEngine(K + 1, "value", chunk, cap=cap)
    stream = native_packed_chunks([os.path.join(d, "reads.fastq")], K + 1,
                                  chunk=chunk)
    chunks = [tuple(map(np.asarray, next(stream)))
              for _ in range(3 * eng.batch)]
    stream.close()
    for w, v in chunks[: eng.batch]:  # warm-up flush (compiles)
        eng.add_chunk_packed(w, v)
    jax.block_until_ready(eng.spec)
    trace_dir = os.path.join(d, "trace")
    t0 = time.perf_counter()
    with jax.profiler.trace(trace_dir):
        for w, v in chunks[eng.batch :]:
            eng.add_chunk_packed(w, v)
        jax.block_until_ready(eng.spec)
    wall = time.perf_counter() - t0
    check(eng._nflush == 3, f"expected 3 flushes, ran {eng._nflush}")
    # the step's optimized HLO names the kernels' instructions
    stack = [jnp.asarray(np.stack([c[i] for c in chunks[: eng.batch]]))
             for i in (0, 1)]
    hlo = hlo_ops(batch_step_packed.lower(
        *stack, *eng.spec, K + 1, "value", eng.cap, chunk).compile()
        .as_text())
    ops, cats, window, busy = device_ops(trace_dir, hlo)
    print(f"phase 4 trace: 2 flushes of {eng.batch} x {chunk} windows "
          f"(spectrum cap {eng.cap}); traced wall {wall:.3f} s; device "
          f"window {window:.4f} s, busy {busy:.4f} s "
          f"(idle share {1 - busy / window:.3f}) [{tag}]", flush=True)
    for cat, secs in sorted(cats.items(), key=lambda kv: -kv[1]):
        print(f"  {cat}: {secs:.4f} s, {secs / window:.3f} of window "
              f"[{tag}]")
    for name, secs, share, cat, desc in ops:
        print(f"  top: {secs:.4f} s  {share:.3f} of window  {name}: "
              f"{desc} [{tag}]")


# ------------------------------------------------------------------ --multi
def run_multi(d: str, rng, tag: str, scale: float = 1.0) -> None:
    import jax

    from gossamer_tpu.cli import goss, xenome

    n = len(jax.devices())
    check(n >= 4, f"--multi needs 4 devices, JAX sees {n}")
    codes = sample_reads(rng, make_genome(rng, int(GENOME_LEN * scale)),
                         int(GENOME_LEN * scale) * COVERAGE // READ_LEN,
                         READ_LEN, ERROR_RATE)
    fq = os.path.join(d, "reads.fastq")
    write_fastq(fq, codes, "r")
    times = {}
    for nd in (4, 1):
        t0 = time.perf_counter()
        run_cli(goss.main, ["build-graph", "-k", K, "-i", fq,
                            "-O", os.path.join(d, f"g{nd}"),
                            "--num-devices", nd])
        times[f"build-graph {nd}"] = time.perf_counter() - t0
    check(read_files(os.path.join(d, "g4")) ==
          read_files(os.path.join(d, "g1")),
          "build-graph --num-devices 4 output differs from 1")
    print(f"multi build-graph: --num-devices 4 == 1 byte for byte [{tag}]")
    for nd in (4, 1):
        t0 = time.perf_counter()
        run_cli(goss.main, ["prune-tips", "-G", os.path.join(d, "g1"),
                            "-O", os.path.join(d, f"p{nd}"),
                            "--iterate", 4, "--num-devices", nd])
        times[f"prune-tips {nd}"] = time.perf_counter() - t0
    check(read_files(os.path.join(d, "p4")) ==
          read_files(os.path.join(d, "p1")),
          "prune-tips --num-devices 4 output differs from 1")
    print(f"multi prune-tips: --num-devices 4 == 1 byte for byte [{tag}]")
    reads = xeno_inputs(d, rng, scale)
    run_cli(xenome.main, ["index", "-K", XENO_K,
                          "-G", os.path.join(d, "graft.fa"),
                          "-H", os.path.join(d, "host.fa"),
                          "-P", os.path.join(d, "idx")])
    outs = {}
    for nd in (4, 1):
        t0 = time.perf_counter()
        outs[nd] = run_cli(
            xenome.main, ["classify", "-P", os.path.join(d, "idx"),
                          "-i", os.path.join(d, "xreads.fastq"),
                          "--output-filename-prefix",
                          os.path.join(d, f"c{nd}"), "--num-devices", nd],
            capture_stdout=True)
        times[f"xenome classify {nd}"] = time.perf_counter() - t0
    check(outs[4] == outs[1], "classify statistics differ")
    check(read_files(os.path.join(d, "c4_")) ==
          read_files(os.path.join(d, "c1_")),
          "xenome classify --num-devices 4 output differs from 1")
    print(f"multi xenome classify: {len(reads)} reads, --num-devices 4 == 1 "
          f"byte for byte [{tag}]")
    for name, secs in times.items():
        print(f"  {name}: {secs:.3f} s wall [{tag}]")


# ------------------------------------------------------------------- main
def run(d: str, seed: int, tag: str) -> None:
    """Phases 1-4."""
    rng = np.random.default_rng(seed)
    t = time.perf_counter()
    genome = make_genome(rng, GENOME_LEN)
    n_reads = len(genome) * COVERAGE // READ_LEN
    codes = sample_reads(rng, genome, n_reads, READ_LEN, ERROR_RATE)
    write_fastq(os.path.join(d, "reads.fastq"), codes, "r")
    print(f"inputs: {len(genome)} bp genome, {n_reads} x {READ_LEN} bp "
          f"reads, {ERROR_RATE} substitutions/base "
          f"({time.perf_counter() - t:.1f} s)", flush=True)
    phase_count(d, codes, tag)
    phase_assembly(d, genome, tag)
    del codes
    phase_classify(d, xeno_inputs(d, rng), tag)
    phase_trace(d, tag)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--workdir", default=os.path.join(ROOT, "work", "smoke"))
    ap.add_argument("--multi", action="store_true",
                    help="four GPUs: --num-devices 4 against 1, no other "
                         "phase")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU: JAX's devices are {devs}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import gossamer_tpu  # noqa: F401  (x64 and the compile cache)
        from gossamer_tpu.io.native import load_library
    except ImportError as e:
        print(f"chip_smoke: the gossamer_tpu package is missing: {e}",
              file=sys.stderr)
        return 1
    name = card()
    tag = name.replace("\n", " | ")
    print(f"device: {devs[0].device_kind} x {len(devs)}; nvidia-smi: {tag}",
          flush=True)
    check(load_library() is not None, "native FASTQ parser did not load")
    shutil.rmtree(args.workdir, ignore_errors=True)
    os.makedirs(args.workdir)
    t0 = time.perf_counter()
    if args.multi:
        run_multi(args.workdir, np.random.default_rng(args.seed), tag)
    else:
        run(args.workdir, args.seed, tag)
    print(f"total {time.perf_counter() - t0:.1f} s [{tag}]")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
