"""Production-scale assembly stage timings (BASELINE.md round-3 table).

2 Mbp synthetic genome, 600K x 100bp reads (30x), k=25, full goss
pipeline.  Artifacts are cached under /tmp/asmbench so stages can be
re-timed individually while optimizing them.

Usage:
  python scripts/bench_assembly.py [--stages thread-reads,pop-bubbles]
  python scripts/bench_assembly.py --fresh      # rebuild everything
"""

import os
import shutil
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DIR = "/tmp/asmbench"
GENOME_MB = 2.0
N_READS = 600_000
READ_LEN = 100
K = 25

STAGES = [
    ("build-graph", ["build-graph", "-k", str(K), "-i", "reads.fastq",
                     "-O", "g0"]),
    ("trim-graph", ["trim-graph", "-G", "g0", "-O", "g1", "-C", "2"]),
    ("prune-tips", ["prune-tips", "-G", "g1", "-O", "g2", "--iterate", "3"]),
    ("pop-bubbles", ["pop-bubbles", "-G", "g2", "-O", "g3"]),
    ("build-entry-edge-set", ["build-entry-edge-set", "-G", "g3"]),
    ("build-supergraph", ["build-supergraph", "-G", "g3"]),
    ("thread-reads", ["thread-reads", "-G", "g3", "-i", "reads.fastq"]),
    ("thread-pairs", ["thread-pairs", "-G", "g3", "-i", "pairs_1.fastq",
                      "-i", "pairs_2.fastq"]),
    ("build-scaffold", ["build-scaffold", "-G", "g3", "-i", "pairs_1.fastq",
                        "-i", "pairs_2.fastq"]),
    ("scaffold", ["scaffold", "-G", "g3"]),
    ("print-contigs", ["print-contigs", "-G", "g3", "--min-length", "100",
                       "-o", "contigs.fa"]),
]

N_PAIRS = 200_000
INSERT = 300


def synth():
    import numpy as np

    rng = np.random.default_rng(33)
    glen = int(GENOME_MB * 1e6)
    genome = rng.integers(0, 4, size=glen, dtype=np.uint8)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    starts = rng.integers(0, glen - READ_LEN, size=N_READS)
    idx = starts[:, None] + np.arange(READ_LEN)[None, :]
    codes = genome[idx]
    # half the reads on the reverse strand
    flip = rng.random(N_READS) < 0.5
    codes[flip] = 3 - codes[flip][:, ::-1]
    txt = bases[codes]
    qual = np.full(READ_LEN, ord("I"), np.uint8)
    with open(os.path.join(DIR, "reads.fastq"), "wb") as f:
        for i in range(N_READS):
            f.write(b"@r%d\n" % i)
            f.write(txt[i].tobytes())
            f.write(b"\n+\n")
            f.write(qual.tobytes())
            f.write(b"\n")
    print(f"# wrote {N_READS} reads over {glen} bp")
    # paired-end library: insert ~INSERT +- 10%, rhs reverse strand
    ins = rng.normal(INSERT, INSERT * 0.1, N_PAIRS).astype(np.int64)
    ins = np.clip(ins, 2 * READ_LEN + 10, INSERT * 2)
    p1 = rng.integers(0, glen - ins.max() - 1, size=N_PAIRS)
    idx1 = p1[:, None] + np.arange(READ_LEN)[None, :]
    lhs = bases[genome[idx1]]
    p2 = p1 + ins - READ_LEN
    idx2 = p2[:, None] + np.arange(READ_LEN)[None, :]
    rhs = bases[(3 - genome[idx2])[:, ::-1]]
    for name, mat in (("pairs_1.fastq", lhs), ("pairs_2.fastq", rhs)):
        with open(os.path.join(DIR, name), "wb") as f:
            for i in range(N_PAIRS):
                f.write(b"@p%d\n" % i)
                f.write(mat[i].tobytes())
                f.write(b"\n+\n")
                f.write(qual.tobytes())
                f.write(b"\n")
    print(f"# wrote {N_PAIRS} pairs (insert ~{INSERT})")


def run_stage(name, args, env):
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "gossamer_tpu.cli.goss"] + args,
        cwd=DIR, env=env)
    dt = time.time() - t0
    ok = "ok" if r.returncode == 0 else f"FAIL rc={r.returncode}"
    print(f"# {name:22s} {dt:8.1f}s  {ok}", flush=True)
    return r.returncode == 0


def main():
    only = None
    for i, a in enumerate(sys.argv):
        if a == "--stages":
            only = sys.argv[i + 1].split(",")
    if "--fresh" in sys.argv and os.path.isdir(DIR):
        shutil.rmtree(DIR)
    os.makedirs(DIR, exist_ok=True)
    if not os.path.exists(os.path.join(DIR, "reads.fastq")):
        synth()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))
    done_marker = os.path.join(DIR, ".done")
    done = set()
    if os.path.exists(done_marker):
        done = set(open(done_marker).read().split())
    for name, args in STAGES:
        if only is not None and name not in only:
            continue
        if only is None and name in done:
            print(f"# {name:22s} (cached)")
            continue
        if not run_stage(name, args, env):
            sys.exit(1)
        if only is None:
            done.add(name)
            with open(done_marker, "w") as f:
                f.write("\n".join(sorted(done)))
    if only is None or "print-contigs" in (only or []):
        p = os.path.join(DIR, "contigs.fa")
        if os.path.exists(p):
            lens = []
            cur = 0
            for line in open(p):
                if line.startswith(">"):
                    if cur:
                        lens.append(cur)
                    cur = 0
                else:
                    cur += len(line.strip())
            if cur:
                lens.append(cur)
            lens.sort(reverse=True)
            print(f"# contigs: {len(lens)}  longest {lens[0] if lens else 0}")


if __name__ == "__main__":
    main()
