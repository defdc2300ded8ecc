"""Device-side (jax.numpy) 128-bit k-mer arithmetic.

Mirrors :mod:`gossamer_tpu.core.kmer` (host NumPy) with identical
semantics; see citations there.  K-mers travel as parallel ``uint64``
``(lo, hi)`` lanes.  The
hot kernels (sort, hash) additionally expose explicit u32-limb forms so
the compiler never materializes emulated 64-bit multiplies where a
16-bit-digit formulation is cheaper.
"""

from __future__ import annotations

import jax.numpy as jnp

U64 = jnp.uint64

FNV_OFFSET = 14695981039346656037
FNV_PRIME = 1099511628211


def rev2(x):
    """Base-4 reverse of each uint64 lane (``src/Utils.hh:377-396``)."""
    m2 = U64(0x3333333333333333)
    m4 = U64(0x0F0F0F0F0F0F0F0F)
    m8 = U64(0x00FF00FF00FF00FF)
    m16 = U64(0x0000FFFF0000FFFF)
    m32 = U64(0x00000000FFFFFFFF)
    x = ((x & m2) << 2) | ((x >> 2) & m2)
    x = ((x & m4) << 4) | ((x >> 4) & m4)
    x = ((x & m8) << 8) | ((x >> 8) & m8)
    x = ((x & m16) << 16) | ((x >> 16) & m16)
    x = ((x & m32) << 32) | ((x >> 32) & m32)
    return x


def reverse_complement(lo, hi, k: int):
    """``BigInteger<2>::reverseComplement`` (``src/BigInteger.hh:193-216``)."""
    nlo = rev2(~hi)
    nhi = rev2(~lo)
    s = 128 - 2 * k  # static python int
    if s == 0:
        return nlo, nhi
    if s < 64:
        return (nlo >> s) | (nhi << (64 - s)), nhi >> s
    if s == 64:
        return nhi, jnp.zeros_like(nhi)
    return nhi >> (s - 64), jnp.zeros_like(nhi)


def fnv_hash(lo, hi):
    """FNV-1a over 16 LE bytes (``src/BigInteger.hh:528-536,572-582``).

    The mod-2**64 multiply by the FNV prime (0x100000001B3) is decomposed
    as ``(seed << 40) + seed * 0x1B3`` over four 16-bit digits held in
    uint32 lanes, so the device never needs a 64x64 multiply.
    """
    # state digits d0..d3, 16 bits each in uint32 lanes
    shape = jnp.shape(lo)
    d = [jnp.full(shape, v, dtype=jnp.uint32) for v in (
        FNV_OFFSET & 0xFFFF,
        (FNV_OFFSET >> 16) & 0xFFFF,
        (FNV_OFFSET >> 32) & 0xFFFF,
        (FNV_OFFSET >> 48) & 0xFFFF,
    )]
    m16 = jnp.uint32(0xFFFF)
    c1b3 = jnp.uint32(0x1B3)

    def step(d, byte):
        d0 = d[0] ^ byte
        # t = state * 0x1B3 (each product <= 0xFFFF*0x1B3 < 2^25)
        t0 = d0 * c1b3
        t1 = d[1] * c1b3
        t2 = d[2] * c1b3
        t3 = d[3] * c1b3
        # r = state << 40 = (2.5 digits): contributes to digits 2 and 3
        r2 = (d0 << 8) & m16
        r3 = ((d0 >> 8) | (d[1] << 8)) & m16
        s0 = t0
        s1 = t1 + (s0 >> 16)
        s2 = t2 + r2 + (s1 >> 16)
        s3 = t3 + r3 + (s2 >> 16)
        return [s0 & m16, s1 & m16, s2 & m16, s3 & m16]

    for word in (lo, hi):
        for i in range(8):
            byte = jnp.uint32((word >> (8 * i)) & U64(0xFF))
            d = step(d, byte)
    out = (
        d[0].astype(U64)
        | (d[1].astype(U64) << 16)
        | (d[2].astype(U64) << 32)
        | (d[3].astype(U64) << 48)
    )
    return out


def less128(alo, ahi, blo, bhi):
    return (ahi < bhi) | ((ahi == bhi) & (alo < blo))


def normalize(lo, hi, k: int):
    """Canonical min-by-(hash, value) (``src/RankSelect.hh:126-140``)."""
    rlo, rhi = reverse_complement(lo, hi, k)
    h0 = fnv_hash(lo, hi)
    h1 = fnv_hash(rlo, rhi)
    take_rc = (h0 > h1) | ((h0 == h1) & less128(rlo, rhi, lo, hi))
    return jnp.where(take_rc, rlo, lo), jnp.where(take_rc, rhi, hi), take_rc


def kmerize_flat(codes, k: int):
    """Extract all k-windows of a flat code chunk.

    ``codes``: uint8[(C + k - 1)] with 255 separators/invalid bases.
    Returns (lo, hi, valid) with C = len(codes) - k + 1 windows.
    """
    C = codes.shape[0] - k + 1
    lo = jnp.zeros((C,), dtype=U64)
    hi = jnp.zeros((C,), dtype=U64)
    valid = jnp.ones((C,), dtype=bool)
    for j in range(k):
        b = codes[j : j + C]
        valid = valid & (b < 4)
        b64 = b.astype(U64) & U64(3)
        hi = (hi << 2) | (lo >> 62)
        lo = (lo << 2) | b64
    return lo, hi, valid
