"""``spectra_merge``: two packed spectra in, one out, counts summed.

The merge-and-sum semantics the XLA counting path keeps (the reference's
AsyncMerge sum-on-equal-keys drain, ``src/AsyncMerge.tcc:190-211``):
sorted sentinel-padded runs merge into packed ascending unique keys, the
counts of ALL equal keys summed (within-run duplicates included) mod
2^32, plus the number of live (non-sentinel) keys.  Covers cross-run
collisions, a single key spanning many blocks, an empty side and heavy
duplication.
"""

import numpy as np
import pytest

from gossamer_tpu.ops.engine import SENT32, spectra_merge

BLOCK = 1 << 14  # runs are sentinel-padded to a multiple of this

rng = np.random.default_rng(7)


def mk_run(n_real, key_space=1 << 52, dup=False):
    keys = rng.integers(0, key_space, size=n_real, dtype=np.uint64)
    if dup and n_real:
        # force heavy duplication, including runs of equal keys
        keys = keys[rng.integers(0, max(1, n_real // 7), size=n_real)]
    keys = np.sort(keys)
    total = max(BLOCK, -(-max(n_real, 1) // BLOCK) * BLOCK)
    l1 = np.full(total, SENT32, np.uint32)
    l0 = np.full(total, SENT32, np.uint32)
    c = np.zeros(total, np.uint32)
    l1[:n_real] = (keys >> 32).astype(np.uint32)
    l0[:n_real] = keys.astype(np.uint32)
    c[:n_real] = rng.integers(1, 100, n_real)
    return l1, l0, c, keys, c[:n_real].copy()


def fold_expect(runs):
    """Brute force: unique keys of the union, counts summed."""
    keys = np.concatenate([r[0] for r in runs])
    cnts = np.concatenate([r[1] for r in runs]).astype(np.uint64)
    order = np.argsort(keys, kind="stable")
    keys, cnts = keys[order], cnts[order]
    if not len(keys):
        return keys, cnts
    new = np.ones(len(keys), bool)
    new[1:] = keys[1:] != keys[:-1]
    idx = np.cumsum(new) - 1
    out = np.zeros(int(idx[-1]) + 1, np.uint64)
    np.add.at(out, idx, cnts)
    return keys[new], out


def run_merge(a, b):
    cap = len(a[0]) + len(b[0])
    o1, o0, oc, live = spectra_merge(a[0], a[1], a[2], b[0], b[1], b[2],
                                     cap)
    o1, o0, oc = map(np.asarray, (o1, o0, oc))
    live = int(live)
    keys = (o1.astype(np.uint64) << 32) | o0
    sent = (np.uint64(SENT32) << np.uint64(32)) | np.uint64(SENT32)
    assert (keys[live:] == sent).all() and (oc[live:] == 0).all()
    return keys, oc, live


def check(a, b, runs):
    keys, oc, live = run_merge(a, b)
    ek, ec = fold_expect(runs)
    assert live == len(ek)
    assert np.array_equal(keys[:live], ek)
    assert np.array_equal(oc[:live].astype(np.uint64), ec % (1 << 32))


@pytest.mark.parametrize("na,nb", [
    (BLOCK, BLOCK), (3000, 5000), (0, BLOCK), (BLOCK * 4, 100),
])
def test_merge_sorted_runs(na, nb):
    a = mk_run(na)
    b = mk_run(nb)
    check(a, b, [(a[3], a[4]), (b[3], b[4])])


def test_merge_equal_keys_sum_payloads():
    """Equal keys with distinct counts sum to one entry; no count is
    dropped or counted twice (the total is conserved)."""
    a = mk_run(3000, key_space=64)
    b = mk_run(5000, key_space=64)
    check(a, b, [(a[3], a[4]), (b[3], b[4])])
    keys, oc, live = run_merge(a, b)
    assert int(oc[:live].sum()) == int(a[4].sum()) + int(b[4].sum())


@pytest.mark.parametrize("na,nb,dup", [
    (BLOCK, BLOCK, False),
    (3000, 5000, True),
    (BLOCK * 3, 100, True),
    (17, BLOCK * 2 + 11, True),
])
def test_merge_fold(na, nb, dup):
    a = mk_run(na, dup=dup)
    b = mk_run(nb, dup=dup)
    check(a, b, [(a[3], a[4]), (b[3], b[4])])


def test_merge_cross_run_collisions():
    """Equal keys split across the two runs must sum across runs."""
    a = mk_run(2000, key_space=512, dup=True)
    b = mk_run(3000, key_space=512, dup=True)
    check(a, b, [(a[3], a[4]), (b[3], b[4])])


def test_merge_single_key():
    """All lanes one key: the group spans many blocks; the count wraps
    mod 2^32."""
    n = BLOCK * 2
    l1 = np.zeros(n, np.uint32)
    l0 = np.full(n, 42, np.uint32)
    c = np.full(n, 1 << 20, np.uint32)
    keys, oc, live = run_merge((l1, l0, c), (l1.copy(), l0.copy(), c.copy()))
    assert live == 1
    assert keys[0] == 42
    assert int(oc[0]) == (2 * n * (1 << 20)) % (1 << 32)


def test_merge_empty_side():
    """One run entirely sentinel (zero real lanes)."""
    a = mk_run(0)
    b = mk_run(5000, dup=True)
    check(a, b, [(b[3], b[4])])
