"""Pure-Python-int brute-force model of the reference k-mer semantics.

Independent implementation of the algorithms documented in SURVEY.md §2.1
(``src/BigInteger.hh``, ``src/RankSelect.hh``, ``src/Utils.hh:377-396``),
used as the oracle for the vectorized host/device implementations.
"""

M64 = (1 << 64) - 1
M128 = (1 << 128) - 1


def py_rev2_64(x: int) -> int:
    """Base-4 reverse of a 64-bit value, bit by bit pair."""
    r = 0
    for i in range(32):
        r = (r << 2) | ((x >> (2 * i)) & 3)
    return r


def py_revcomp(v: int, k: int) -> int:
    """reverseComplement of a 128-bit value with k bases."""
    w0 = v & M64
    w1 = v >> 64
    nw0 = py_rev2_64((~w1) & M64)
    nw1 = py_rev2_64((~w0) & M64)
    full = (nw1 << 64) | nw0
    return (full >> (128 - 2 * k)) & M128


def py_fnv(v: int) -> int:
    """FNV-1a over 16 little-endian bytes of the 128-bit value."""
    seed = 14695981039346656037
    for i in range(16):
        b = (v >> (8 * i)) & 0xFF
        seed = ((seed ^ b) * 1099511628211) & M64
    return seed


def py_normalize(v: int, k: int) -> int:
    rc = py_revcomp(v, k)
    h0 = py_fnv(v)
    h1 = py_fnv(rc)
    if h0 > h1 or (h0 == h1 and rc < v):
        return rc
    return v


def py_is_normal(v: int, k: int) -> bool:
    return py_normalize(v, k) == v


def py_encode(s: str) -> int:
    v = 0
    for c in s:
        v = (v << 2) | "ACGT".index(c.upper())
    return v


def py_decode(v: int, k: int) -> str:
    return "".join("ACGT"[(v >> (2 * (k - 1 - i))) & 3] for i in range(k))


def read_kmers(seq: str, k: int):
    """All valid k-mer windows of a read (windows with non-ACGT skipped)."""
    out = []
    s = seq.upper()
    for i in range(len(s) - k + 1):
        w = s[i : i + k]
        if all(c in "ACGT" for c in w):
            out.append(py_encode(w))
    return out


def spectrum_build_graph(reads, rho):
    """Counted (rho)-mer spectrum with fwd+rc insertion (build-graph model)."""
    from collections import Counter

    c = Counter()
    for r in reads:
        for v in read_kmers(r, rho):
            c[v] += 1
            c[py_revcomp(v, rho)] += 1
    return dict(c)


def spectrum_kmer_set(reads, k):
    """Canonical k-mer set (build-kmer-set model)."""
    s = set()
    for r in reads:
        for v in read_kmers(r, k):
            s.add(py_normalize(v, k))
    return s


def spectrum_counts(reads, rho, mode):
    """Counted rho-mer spectrum of the forward windows, each window
    replaced by its class representative: ``plain`` (as read), ``value``
    (min of the window and its reverse complement) or ``ref`` (the
    reference's FNV normalization).  {key: count}."""
    from collections import Counter

    rep = {
        "plain": lambda v: v,
        "value": lambda v: min(v, py_revcomp(v, rho)),
        "ref": lambda v: py_normalize(v, rho),
    }[mode]
    return dict(Counter(rep(v) for r in reads for v in read_kmers(r, rho)))
