"""goss commands: build/dump/restore/lint for graphs and k-mer sets.

Command names, option names/flags and output formats follow the
reference registrations in ``src/GossApp.cc:101-143``.
"""

from __future__ import annotations

import numpy as np

from ..cli.framework import (
    Command,
    CommandError,
    Context,
    add_input_options,
    gather_read_files,
    iter_reads,
)
from ..graph.build import build_graph, build_kmer_set
from ..graph.graph import Graph
from ..graph.kmer_set import KmerSet
from ..graph.text import dump_graph, restore_graph
from ..utils.logging import Timer
from .. import MAX_K


def _chunk_opts(p):
    p.add_argument("-B", "--buffer-size", type=int, default=2,
                   help="maximum size (in GB) for device buffers; spectra "
                        "outgrowing them spill to host RAM (the reference's "
                        "RAM->disk spill, docs/goss.md:327-338)")
    p.add_argument("--chunk-size", type=int, default=1 << 22,
                   help="device batch size in k-mer windows (each "
                        "distinct size compiles its own programs)")
    p.add_argument("--spectrum-cap", type=int, default=0,
                   help="override the device-resident distinct-key cap")
    p.add_argument("--num-devices", type=int, default=0,
                   help="count across N devices of the local mesh "
                        "(hash-partitioned k-mer space; 0 = auto: every "
                        "visible GPU when their number is a power of two, "
                        "else one device)")
    p.add_argument("--coordinator", default=None,
                   help="multi-host counting: jax.distributed coordinator "
                        "address host:port (run one process per host; the "
                        "reference's analog is per-machine builds + "
                        "merge-graphs, docs/goss.md:52-55)")
    p.add_argument("--num-processes", type=int, default=0)
    p.add_argument("--process-id", type=int, default=0)


def _resolve_num_devices(ctx: Context, rho: int) -> int:
    """--num-devices: explicit N is honored (invalid combos raise in
    count_chunks); 0 = auto, which picks the full local mesh only when
    the sharded engine supports the configuration."""
    from ..ops.count import narrow_keys
    from ..parallel.mesh import auto_num_devices

    n = int(getattr(ctx.opts, "num_devices", 0) or 0)
    if n == 0:
        n = auto_num_devices()
        chunk = int(ctx.opts.chunk_size)
        if (n & (n - 1)) or not narrow_keys(rho) or rho > 33 or chunk % 16:
            n = 1
    return max(1, n)


def _chunk_kwargs(ctx: Context, rho: int) -> dict:
    spill = max((int(ctx.opts.buffer_size) << 30) // 32, 1 << 20)
    # ~48B device footprint per distinct key (3 u32 planes + sort workspace)
    cap = int(getattr(ctx.opts, "spectrum_cap", 0) or 0) or max(
        (int(ctx.opts.buffer_size) << 30) // 48, 1 << 20)
    return {"chunk": int(ctx.opts.chunk_size), "spill_entries": spill,
            "cap_entries": cap, "n_devices": _resolve_num_devices(ctx, rho)}


# ---------------------------------------------------------------- build-graph
def _build_graph_opts(p):
    p.add_argument("-k", "--kmer-size", type=int, required=True)
    p.add_argument("-O", "--graph-out", required=True)
    add_input_options(p)
    _chunk_opts(p)


def _counted_spectrum(ctx: Context, rho: int, *, both, canon):
    """Prefer the native reader for physical files (10x parse speed)."""
    from ..io.factory import PhysicalFileFactory
    from ..ops.count import count_rho_mers, count_rho_mers_files
    from ..utils.logging import UnboundedProgressMonitor

    files = gather_read_files(ctx)
    if getattr(ctx.opts, "coordinator", None):
        from ..parallel import distributed

        files, n_global = distributed.configure(ctx.opts, files, log=ctx.log)
        if n_global and not getattr(ctx.opts, "num_devices", 0):
            ctx.opts.num_devices = n_global
    kw = _chunk_kwargs(ctx, rho)
    mon = UnboundedProgressMonitor(ctx.log, interval=1 << 26, unit="bases",
                                   label="counting")
    kw.update(progress=mon.tick, log=ctx.log)
    if isinstance(ctx.fac, PhysicalFileFactory):
        return count_rho_mers_files(
            [n for n, _ in files], rho, both_strands=both, canonical=canon,
            threads=int(getattr(ctx.opts, "num_threads", 1) or 1), **kw)
    return count_rho_mers(iter_reads(ctx, files), rho, both_strands=both,
                          canonical=canon, **kw)


def _build_graph_run(ctx: Context) -> None:
    import numpy as np

    from ..graph.graph import Graph

    k = int(ctx.opts.kmer_size)
    if k > MAX_K:
        raise CommandError(f"kmer size {k} exceeds maximum {MAX_K}")
    t = Timer()
    lo, hi, counts = _counted_spectrum(ctx, k + 1, both=True, canon=False)
    g = Graph(k, lo, hi, counts.astype(np.int64), asymmetric=False)
    g.write(ctx.opts.graph_out, ctx.fac)
    ctx.log("info", f"build-graph: {g.count} edges in {t.check():.2f}s")
    if ctx.debug("dump-graph-build-stats") or ctx.debug("print-stats"):
        import json

        ctx.log("info", "stats: " + json.dumps(g.stat()))
    if ctx.debug("lint-after-build"):
        errs = g.lint()
        if errs:
            raise CommandError("lint failed: " + "; ".join(errs))


# ------------------------------------------------------------- build-kmer-set
def _build_kmer_set_opts(p):
    p.add_argument("-k", "--kmer-size", type=int, required=True)
    p.add_argument("-O", "--graph-out", required=True)
    add_input_options(p)
    _chunk_opts(p)


def _build_kmer_set_run(ctx: Context) -> None:
    k = int(ctx.opts.kmer_size)
    if k > MAX_K:
        raise CommandError(f"kmer size {k} exceeds maximum {MAX_K}")
    t = Timer()
    lo, hi, _counts = _counted_spectrum(ctx, k, both=False, canon=True)
    ks = KmerSet(k, lo, hi)
    ks.write(ctx.opts.graph_out, ctx.fac)
    ctx.log("info", f"build-kmer-set: {ks.count} kmers in {t.check():.2f}s")


# ----------------------------------------------------------------- dump/restore
def _graph_in_out_opts(p):
    p.add_argument("-G", "--graph-in", required=True)
    p.add_argument("-o", "--output-file", default="-")


def _dump_graph_run(ctx: Context) -> None:
    g = Graph.read(ctx.opts.graph_in, ctx.fac)
    with ctx.fac.open_write_text(ctx.opts.output_file) as out:
        dump_graph(g, out)


def _dump_kmer_set_run(ctx: Context) -> None:
    ks = KmerSet.read(ctx.opts.graph_in, ctx.fac)
    with ctx.fac.open_write_text(ctx.opts.output_file) as out:
        ks.dump_text(out)


def _restore_graph_opts(p):
    p.add_argument("-f", "--input-file", required=True)
    p.add_argument("-O", "--graph-out", required=True)


def _restore_graph_run(ctx: Context) -> None:
    with ctx.fac.open_read_text(ctx.opts.input_file) as inp:
        g = restore_graph(inp)
    g.write(ctx.opts.graph_out, ctx.fac)


# -------------------------------------------------------------------- lint
def _lint_graph_opts(p):
    p.add_argument("-G", "--graph-in", required=True)


def _lint_graph_run(ctx: Context) -> None:
    g = Graph.read(ctx.opts.graph_in, ctx.fac)
    errs = g.lint()
    for e in errs:
        ctx.log("error", f"lint-graph: {e}")
    if errs:
        raise CommandError(f"lint-graph: {len(errs)} invariant(s) violated")
    ctx.log("info", "lint-graph: ok")


# ------------------------------------------------------------- graph-to-kmer-set
def _graph_to_kmer_set_opts(p):
    p.add_argument("-G", "--graph-in", required=True)
    p.add_argument("-O", "--graph-out", required=True)


def _graph_to_kmer_set_run(ctx: Context) -> None:
    """Project a graph's edge set to the canonical k-mer set of its
    (k+1)-mers (``src/GossCmdGraphToKmerSet.cc``)."""
    from ..core import kmer as KK

    g = Graph.read(ctx.opts.graph_in, ctx.fac)
    lo, hi, _ = KK.normalize(g.lo, g.hi, g.rho)
    order = np.lexsort((lo, hi))
    lo, hi = lo[order], hi[order]
    if len(lo):
        keep = np.ones(len(lo), dtype=bool)
        keep[1:] = (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])
        lo, hi = lo[keep], hi[keep]
    KmerSet(g.rho, lo, hi).write(ctx.opts.graph_out, ctx.fac)


COMMANDS = [
    Command("build-graph", "create a new graph", _build_graph_opts, _build_graph_run),
    Command("build-kmer-set", "create a set of canonical k-mers",
            _build_kmer_set_opts, _build_kmer_set_run),
    Command("dump-graph", "dump a graph as text", _graph_in_out_opts, _dump_graph_run),
    Command("dump-kmer-set", "dump a k-mer set as text",
            _graph_in_out_opts, _dump_kmer_set_run),
    Command("restore-graph", "restore a graph from text",
            _restore_graph_opts, _restore_graph_run),
    Command("lint-graph", "check graph invariants", _lint_graph_opts, _lint_graph_run),
    Command("graph-to-kmer-set", "project a graph to a k-mer set",
            _graph_to_kmer_set_opts, _graph_to_kmer_set_run),
]
