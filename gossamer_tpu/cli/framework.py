"""Command/CLI framework.

Re-creates the reference's three-tier App/registry design
(``src/App.cc:176-419``, ``src/GossCmdReg.hh:26``, ``src/GossOption.cc``):
global options + common options + per-command whitelists, a command
registry per application, option validation before dispatch, and rich
error rendering.  Option names and short flags mirror
``src/GossApp.cc:145-203`` so existing goss invocations keep working.
"""

from __future__ import annotations

import argparse
import sys
import traceback
from dataclasses import dataclass, field
from typing import Callable

from ..io.factory import FileFactory, PhysicalFileFactory
from ..utils.logging import Logger


class CommandError(Exception):
    """User-facing command failure (bad options, bad input...)."""


@dataclass
class Context:
    """Per-invocation context (``src/GossCmdContext.hh:25``)."""

    fac: FileFactory
    log: Logger
    opts: argparse.Namespace
    debug_flags: set = field(default_factory=set)

    def debug(self, flag: str) -> bool:
        # hidden feature-flag system (reference ``src/Debug.cc``)
        return flag in self.debug_flags


@dataclass
class Command:
    name: str
    help: str
    add_options: Callable[[argparse.ArgumentParser], None]
    run: Callable[[Context], None]


class App:
    def __init__(self, prog: str, description: str):
        self.prog = prog
        self.description = description
        self.commands: dict[str, Command] = {}

    def register(self, cmd: Command) -> None:
        self.commands[cmd.name] = cmd

    def build_parser(self) -> argparse.ArgumentParser:
        p = argparse.ArgumentParser(prog=self.prog, description=self.description)
        sub = p.add_subparsers(dest="command", metavar="command")
        for name in sorted(self.commands):
            cmd = self.commands[name]
            sp = sub.add_parser(name, help=cmd.help)
            add_global_options(sp)
            cmd.add_options(sp)
        return p

    def main(self, argv=None) -> int:
        argv = list(sys.argv[1:] if argv is None else argv)
        if argv and argv[0] in ("--version", "-V"):
            from .. import __version__

            print(f"{self.prog} version {__version__} (gossamer-tpu)")
            return 0
        parser = self.build_parser()
        ns = parser.parse_args(argv)
        if not ns.command:
            parser.print_help()
            return 1
        fac = PhysicalFileFactory(tmp_dir=(ns.tmp_dir[0] if ns.tmp_dir else None))
        log = Logger(ns.log_file, verbose=ns.verbose, fac=None)
        if getattr(ns, "kill_signal", None):
            from ..utils.batch_task import KillSignal

            KillSignal.register(ns.kill_signal)
        # a backend that fails to start raises: commands never switch
        # platforms behind the user's back (JAX_PLATFORMS picks one)
        import jax

        log("debug", f"jax backend: {jax.devices()[0].platform}")
        ctx = Context(fac=fac, log=log, opts=ns, debug_flags=set(ns.debug or []))
        # hidden profiler (reference Profile.hh scopes): -D print-profile
        from ..utils import profile

        if ctx.debug("print-profile"):
            profile.enable()
        try:
            self.commands[ns.command].run(ctx)
            return 0
        except CommandError as e:
            print(f"{self.prog}: {e}", file=sys.stderr)
            return 1
        except FileNotFoundError as e:
            print(f"{self.prog}: file not found: {e}", file=sys.stderr)
            return 1
        except Exception:
            traceback.print_exc()
            return 1
        finally:
            if ctx.debug("print-profile"):
                profile.report()
            log.close()


def add_global_options(p: argparse.ArgumentParser) -> None:
    """Global tier (``src/GossApp.cc:145-152``)."""
    p.add_argument("-D", "--debug", action="append", default=[],
                   help="enable particular debugging output")
    p.add_argument("-l", "--log-file", default=None,
                   help="place to write messages")
    p.add_argument("--tmp-dir", action="append", default=[],
                   help="a directory to use for temporary files")
    p.add_argument("-T", "--num-threads", type=int, default=4,
                   help="maximum number of worker threads (host pipeline)")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="show progress messages")
    p.add_argument("--kill-signal", default=None, metavar="FILE",
                   help="exit when FILE appears (cooperative kill for "
                        "pipeline drivers; src/GossKillSignal.hh)")


def add_input_options(p: argparse.ArgumentParser) -> None:
    """Read-source tier (``src/GossApp.cc:154-160``)."""
    p.add_argument("-I", "--fasta-in", action="append", default=[],
                   help="input file in FASTA format")
    p.add_argument("-F", "--fastas-in", action="append", default=[],
                   help="file containing FASTA filenames")
    p.add_argument("-i", "--fastq-in", action="append", default=[],
                   help="input file in FASTQ format")
    p.add_argument("-f", "--fastqs-in", action="append", default=[],
                   help="file containing FASTQ filenames")
    p.add_argument("--line-in", action="append", default=[],
                   help="input file with one sequence per line")


def gather_read_files(ctx: Context) -> list[tuple[str, str]]:
    """Expand input options to [(filename, format)] in option order."""
    o = ctx.opts
    out: list[tuple[str, str]] = []
    for name in o.fasta_in:
        out.append((name, "fasta"))
    for name in o.fastq_in:
        out.append((name, "fastq"))
    for name in getattr(o, "line_in", []):
        out.append((name, "line"))
    for listfile in o.fastas_in:
        for line in ctx.fac.read_text(listfile).splitlines():
            if line.strip():
                out.append((line.strip(), "fasta"))
    for listfile in o.fastqs_in:
        for line in ctx.fac.read_text(listfile).splitlines():
            if line.strip():
                out.append((line.strip(), "fastq"))
    if not out:
        raise CommandError("no input files given (use -I/-i/-F/-f/--line-in)")
    return out


def iter_reads(ctx: Context, files=None):
    from ..io.readers import read_file

    for name, fmt in files if files is not None else gather_read_files(ctx):
        yield from read_file(name, ctx.fac, fmt)
