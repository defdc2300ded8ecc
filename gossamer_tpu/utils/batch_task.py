"""Host-pass concurrency kit.

Analog of the reference's shared-memory batch machinery:

* :class:`BatchTask` — ``MultithreadedBatchTask``
  (``src/MultithreadedBatchTask.hh:51``): T worker threads over blocks
  of work with progress reporting and cooperative abort propagation
  (``WorkThread::reportWorkDone`` returning false aborts every thread).
  Here the blocks are numpy-vectorized batches (which release the GIL
  in their hot ops), workers return per-block partial results, and the
  caller merges them on the main thread — the "dedup after sort"
  pattern the reference uses for thread-safety by construction
  (SURVEY.md §5 race detection note).

* :class:`KillSignal` — ``GossKillSignal``
  (``src/GossKillSignal.hh``): optional kill-file polling registered
  from the CLI (``--kill-signal FILE``); a daemon thread polls every
  second and exits the process when the file appears (the reference
  calls ``exit(1)``), while :meth:`KillSignal.requested` offers the
  cooperative check used between batch blocks.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
R = TypeVar("R")


class AbortRequested(RuntimeError):
    """Raised on the caller when a batch task is cooperatively aborted."""


class KillSignal:
    """Kill-file watcher (``src/GossKillSignal.hh:74-83``)."""

    _instance: "KillSignal | None" = None

    def __init__(self, path: str, check_every_s: float = 1.0,
                 hard_exit: bool = True):
        self.path = path
        self.check_every_s = check_every_s
        self.hard_exit = hard_exit
        self._stop = False
        self._requested = False
        self._thread: threading.Thread | None = None

    def start(self) -> "KillSignal":
        t = threading.Thread(target=self._run, daemon=True,
                             name="goss-kill-signal")
        self._thread = t
        t.start()
        return self

    def _run(self) -> None:
        while not self._stop:
            time.sleep(self.check_every_s)
            if os.path.exists(self.path):
                self._requested = True
                if self.hard_exit:  # reference: exit(1)
                    os._exit(1)
                return

    def requested(self) -> bool:
        return self._requested

    def stop(self) -> None:
        self._stop = True

    @classmethod
    def register(cls, path: str, check_every_s: float = 1.0,
                 hard_exit: bool = True) -> "KillSignal":
        """CLI entry (``GossKillSignal::Register``)."""
        cls._instance = KillSignal(path, check_every_s, hard_exit).start()
        return cls._instance

    @classmethod
    def current(cls) -> "KillSignal | None":
        return cls._instance


class BatchTask:
    """Run ``worker`` over blocks on ``num_threads`` threads.

    * results are yielded to ``merge`` on the MAIN thread (no worker
      ever mutates shared state), in completion order — callers must
      merge commutatively, the same contract the reference's shared
      trim-bitmap + dedup-on-flush passes rely on;
    * in-flight blocks are bounded (2 per thread) so a streaming block
      source is never fully materialized;
    * a worker exception or a pending :class:`KillSignal` aborts the
      task cooperatively: no new blocks start, the first error is
      re-raised (``MultithreadedBatchTask`` abort propagation).
    """

    def __init__(self, num_threads: int = 1,
                 kill: KillSignal | None = None,
                 on_progress: Callable[[int], None] | None = None):
        self.num_threads = max(1, int(num_threads))
        self.kill = kill or KillSignal.current()
        self.on_progress = on_progress

    def run(self, blocks: Iterable[T], worker: Callable[[T], R],
            merge: Callable[[R], None] | None = None) -> None:
        if self.num_threads == 1:
            for i, b in enumerate(blocks):
                if self.kill is not None and self.kill.requested():
                    raise AbortRequested("kill signal")
                r = worker(b)
                if merge is not None:
                    merge(r)
                if self.on_progress:
                    self.on_progress(i + 1)
            return
        done = 0
        it: Iterator[T] = iter(blocks)
        with ThreadPoolExecutor(self.num_threads,
                                thread_name_prefix="goss-batch") as ex:
            pending = set()
            exhausted = False
            while pending or not exhausted:
                while not exhausted and len(pending) < 2 * self.num_threads:
                    try:
                        b = next(it)
                    except StopIteration:
                        exhausted = True
                        break
                    pending.add(ex.submit(worker, b))
                if not pending:
                    break
                fin, pending = wait(pending, return_when=FIRST_COMPLETED)
                for f in fin:
                    err = f.exception()
                    if err is not None:
                        for p in pending:
                            p.cancel()
                        raise err
                    if merge is not None:
                        merge(f.result())
                    done += 1
                    if self.on_progress:
                        self.on_progress(done)
                if self.kill is not None and self.kill.requested():
                    for p in pending:
                        p.cancel()
                    raise AbortRequested("kill signal")
