"""KmerSet: a sorted set of canonical k-mers.

Replaces the reference's Elias-Fano ``KmerSet`` (``src/KmerSet.hh:20-257``)
with a sorted pair of uint64 planes; ``rank`` is a vectorized
``searchsorted`` and ``select`` a gather — the vectorized equivalents of
the succinct SparseArray operations.

Files: ``<p>.header`` (version/K/count), ``<p>.kmers-lo``, ``<p>.kmers-hi``.
Text dump format matches ``src/GossCmdDumpKmerSet.cc:43-53``:
``#<version>\\nK\\tcount\\n<kmer>`` per line.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import KMER_SET_VERSION
from ..core import kmer as K
from ..io.artifacts import read_array, read_header, write_array, write_header
from ..io.factory import FileFactory

U64 = np.uint64


@dataclass
class KmerSet:
    k: int
    lo: np.ndarray  # uint64[n], sorted ascending by (hi, lo)
    hi: np.ndarray

    @property
    def count(self) -> int:
        return len(self.lo)

    # -- persistence -------------------------------------------------------
    def write(self, basename: str, fac: FileFactory) -> None:
        write_header(
            fac,
            basename,
            {"version": KMER_SET_VERSION, "K": self.k, "count": self.count,
             "kind": "kmer-set"},
        )
        write_array(fac, basename + ".kmers-lo", self.lo)
        write_array(fac, basename + ".kmers-hi", self.hi)

    @classmethod
    def read(cls, basename: str, fac: FileFactory) -> "KmerSet":
        try:
            h = read_header(fac, basename, KMER_SET_VERSION)
        except (ValueError, UnicodeDecodeError):
            # reference binary format (interop, src/KmerSet.hh:32-45)
            from ..io.reference_format import (is_reference_graph,
                                               read_reference_kmer_set)

            if is_reference_graph(fac, basename):
                return read_reference_kmer_set(fac, basename)
            raise
        lo = read_array(fac, basename + ".kmers-lo")
        hi = read_array(fac, basename + ".kmers-hi")
        return cls(h["K"], lo, hi)

    # -- queries -----------------------------------------------------------
    def _packed(self) -> np.ndarray:
        """128-bit keys as structured sort key: returns (n,) object only for
        tests; internal queries use (hi, lo) pairs directly."""
        return (self.hi.astype(object) * (1 << 64)) + self.lo.astype(object)

    def rank(self, lo, hi) -> np.ndarray:
        """Number of set elements < query (``SparseArray::rank``)."""
        return rank128(self.lo, self.hi, lo, hi)

    def access_and_rank(self, lo, hi):
        """(present?, rank) per query (``KmerSet::accessAndRank``)."""
        r = self.rank(lo, hi)
        inside = r < self.count
        ridx = np.minimum(r, max(self.count - 1, 0))
        if self.count == 0:
            return np.zeros(len(np.atleast_1d(lo)), dtype=bool), r
        hit = inside & (self.lo[ridx] == lo) & (self.hi[ridx] == hi)
        return hit, r

    def select(self, ranks) -> tuple[np.ndarray, np.ndarray]:
        return self.lo[ranks], self.hi[ranks]

    def stat(self) -> dict:
        return {
            "K": self.k,
            "count": self.count,
            "storage-bytes": int(self.lo.nbytes + self.hi.nbytes),
        }

    # -- text dump ---------------------------------------------------------
    def dump_text(self, out) -> None:
        out.write(f"#{KMER_SET_VERSION}\n")
        out.write(f"{self.k}\t{self.count}\n")
        if self.count:
            mat = K.kmers_to_strings(self.k, self.lo, self.hi)
            nl = np.full((self.count, 1), ord("\n"), dtype=np.uint8)
            out.write(np.hstack([mat, nl]).tobytes().decode())


def rank128(set_lo: np.ndarray, set_hi: np.ndarray, qlo, qhi) -> np.ndarray:
    """searchsorted over 128-bit keys held as sorted (lo, hi) planes."""
    qlo = np.atleast_1d(np.asarray(qlo, dtype=U64))
    qhi = np.atleast_1d(np.asarray(qhi, dtype=U64))
    n = len(set_lo)
    if n == 0:
        return np.zeros(len(qlo), dtype=np.int64)
    if set_hi[-1] == 0:
        # common fast path: all keys fit in 64 bits (k <= 31).  Large
        # query batches go through the native prefetching kernel —
        # np.searchsorted measured ~440ns/query cache-miss-bound on 4M
        # keys; the blocked native search is ~5x (io/native.py).
        if len(qlo) >= (1 << 15):
            from ..io.native import native_rank_u64

            r = native_rank_u64(set_lo, qlo)
            if r is not None:
                return np.where(qhi > 0, np.int64(n), r)
        r = np.searchsorted(set_lo, qlo, side="left")
        return np.where(qhi > 0, np.int64(n), r)
    # vectorized 128-bit binary search (log2 n rounds over all queries)
    lo_idx = np.zeros(len(qlo), dtype=np.int64)
    hi_idx = np.full(len(qlo), n, dtype=np.int64)
    rounds = int(np.ceil(np.log2(n + 1))) + 1
    for _ in range(rounds):
        active = lo_idx < hi_idx
        mid = (lo_idx + hi_idx) >> 1
        m = np.minimum(mid, n - 1)
        mlo = set_lo[m]
        mhi = set_hi[m]
        less = (mhi < qhi) | ((mhi == qhi) & (mlo < qlo))
        lo_idx = np.where(active & less, mid + 1, lo_idx)
        hi_idx = np.where(active & ~less, mid, hi_idx)
    return lo_idx
