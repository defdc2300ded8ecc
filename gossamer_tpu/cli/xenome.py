"""``xenome`` — xenograft read classifier (reference ``src/XenoApp.cc``).

Commands:
  index     build graft/host index (build-kmer-set x2 ->
            merge-and-annotate -> compute-near-kmers, ``XenoApp.cc:49-135``)
  classify  sort reads into graft/host/both/neither/ambiguous
            (``XenoApp.cc:137-254`` -> ``GossCmdGroupReads``)
"""

from __future__ import annotations

import sys

import numpy as np

from ..classify.annotated_set import (
    AnnotatedKmerSet,
    compute_near_kmers,
    merge_and_annotate,
)
from ..classify.xenome import (
    OUT_CLASS,
    classify_pairs,
    classify_reads,
    out_filename,
    print_read,
    print_stats,
)
from ..cli.framework import App, Command, CommandError, Context, add_input_options, gather_read_files
from ..graph.build import build_kmer_set
from ..io.readers import read_file, read_pair_files
from ..utils.logging import Timer


def _index_opts(p):
    p.add_argument("-K", "--kmer-size", type=int, default=25)
    p.add_argument("-G", "--graft", required=True,
                   help="graft reference in FASTA format")
    p.add_argument("-H", "--host", required=True,
                   help="host reference in FASTA format")
    p.add_argument("-P", "--prefix", required=True,
                   help="index filename prefix")
    p.add_argument("-M", "--max-memory", type=int, default=2,
                   help="maximum memory (GB) for counting buffers")
    p.add_argument("--chunk-size", type=int, default=1 << 20)


def _index_run(ctx: Context) -> None:
    k = int(ctx.opts.kmer_size)
    t = Timer()
    chunk = int(ctx.opts.chunk_size)
    # -M bounds the counting working set (~48B device footprint per
    # distinct key; the reference's buffer sizing, XenoApp.cc:103)
    cap = max((int(ctx.opts.max_memory) << 30) // 48, 1 << 20)
    ctx.log("info", "building graft kmer set")
    graft, _ = build_kmer_set(read_file(ctx.opts.graft, ctx.fac), k, chunk=chunk,
                              cap_entries=cap)
    ctx.log("info", f"graft: {graft.count} kmers")
    ctx.log("info", "building host kmer set")
    host, _ = build_kmer_set(read_file(ctx.opts.host, ctx.fac), k, chunk=chunk,
                             cap_entries=cap)
    ctx.log("info", f"host: {host.count} kmers")
    ann, common = merge_and_annotate(graft, host)
    ctx.log("info", f"union: {ann.kset.count} kmers ({common} common)")
    gray = compute_near_kmers(ann)
    ctx.log("info", f"marginal kmers: {gray}")
    ann.write(ctx.opts.prefix, ctx.fac)
    ctx.log("info", f"index built in {t.check():.1f}s")


def _classify_opts(p):
    p.add_argument("-P", "--prefix", required=True)
    add_input_options(p)
    p.add_argument("-M", "--max-memory", type=int, default=None,
                   help="memory budget in GB; larger indexes classify in "
                        "multiple passes over k-mer subranges")
    p.add_argument("--pairs", action="store_true",
                   help="treat inputs as pairs of read files")
    p.add_argument("--graft-name", default="graft")
    p.add_argument("--host-name", default="host")
    p.add_argument("--output-filename-prefix", default="")
    p.add_argument("--dont-write-reads", action="store_true")
    p.add_argument("--num-devices", type=int, default=0,
                   help="shard the index across N devices of the local "
                        "mesh (0 = auto: every visible GPU, else one "
                        "device)")
    p.add_argument("--preserve-read-order", action="store_true",
                   help="accepted for reference compatibility: this "
                        "engine classifies in streaming batches, so "
                        "output order is ALWAYS the input order (the "
                        "reference only guarantees it with this flag in "
                        "multi-pass mode, GossCmdGroupReads.cc:579-686)")


def _classify_run(ctx: Context) -> None:
    o = ctx.opts
    ann = AnnotatedKmerSet.read(o.prefix, ctx.fac)
    n_devices = int(getattr(o, "num_devices", 0) or 0)
    if n_devices == 0:
        from ..parallel.mesh import auto_num_devices

        n_devices = auto_num_devices()
    n_devices = max(1, n_devices)
    passes = 1
    if o.max_memory:
        idx_bytes = ann.kset.lo.nbytes + ann.kset.hi.nbytes + 2 * ann.kset.count
        passes = max(1, -(-idx_bytes // (int(o.max_memory) << 30)))
        if passes > 1:
            ctx.log("info", f"classifying in {passes} passes")
    files = gather_read_files(ctx)
    suffix = "fastq" if any(f == "fastq" for _, f in files) else "fasta"
    counts = np.zeros(16, dtype=np.int64)
    write = not o.dont_write_reads

    if o.pairs:
        if len(files) % 2 != 0:
            raise CommandError("--pairs requires an even number of input files")
        lhs_files = [n for n, _ in files[0::2]]
        rhs_files = [n for n, _ in files[1::2]]
        outs = {}
        if write:
            for cls in ("neither", "both", "ambiguous", o.graft_name, o.host_name):
                for half in ("1", "2"):
                    name = out_filename(o.output_filename_prefix, suffix, half, cls)
                    outs[(cls, half)] = ctx.fac.open_write_text(name)
                    ctx.log("info", f"writing to {name}")
        try:
            for a, b, blrg in classify_pairs(
                read_pair_files(lhs_files, rhs_files, ctx.fac), ann,
                passes=passes, n_devices=n_devices,
            ):
                counts[blrg] += 1
                if write:
                    cls = _cls_name(blrg, o.graft_name, o.host_name)
                    print_read(outs[(cls, "1")], a)
                    print_read(outs[(cls, "2")], b)
        finally:
            for f in outs.values():
                f.close()
    else:
        outs = {}
        if write:
            for cls in ("neither", "both", "ambiguous", o.graft_name, o.host_name):
                name = out_filename(o.output_filename_prefix, suffix, "", cls)
                outs[cls] = ctx.fac.open_write_text(name)
                ctx.log("info", f"writing to {name}")
        try:
            for rd, blrg in classify_reads(
                (r for name, fmt in files for r in read_file(name, ctx.fac, fmt)),
                ann, passes=passes, n_devices=n_devices,
            ):
                counts[blrg] += 1
                if write:
                    print_read(outs[_cls_name(blrg, o.graft_name, o.host_name)], rd)
        finally:
            for f in outs.values():
                f.close()

    print_stats(sys.stdout, counts, o.graft_name, o.host_name, o.dont_write_reads)


def _cls_name(blrg: int, graft: str, host: str) -> str:
    cls = OUT_CLASS[blrg]
    return {"lhs": graft, "rhs": host}.get(cls, cls)


def build_app() -> App:
    app = App("xenome", "xenome — xenograft read classifier (gossamer-tpu)")
    app.register(Command("index", "build an index for classifying reads",
                         _index_opts, _index_run))
    app.register(Command("classify", "classify reads according to index",
                         _classify_opts, _classify_run))
    return app


def main(argv=None) -> int:
    return build_app().main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
