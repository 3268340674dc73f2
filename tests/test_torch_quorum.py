"""``tests/test_quorum.py``'s cases on both packages' QuorumCollector.

Every case of the reference's property/fuzz tests runs once per package
(``repro`` and ``repro_torch``): the port keeps its own numpy copy of the
collector, and the applied update must equal the reference weighted mean

    (sum(fresh) + d * sum(stale)) / (n_fresh + d * n_stale)

whatever the arrival order.  Tolerances are the reference file's.
"""
import random

import pytest

pytest.importorskip("torch")

import numpy as np                                           # noqa: E402

from _hypothesis_optional import given, settings, st        # noqa: E402
from repro.runtime_dist import QuorumCollector as JQC        # noqa: E402
from repro_torch.runtime_dist import QuorumCollector as TQC  # noqa: E402

PACKAGES = pytest.mark.parametrize("QC", [JQC, TQC],
                                   ids=["repro", "repro_torch"])

RNG_TREE_KEYS = ("w", "b", "emb")


def _tree(rng, scale=1.0):
    """A small parameter-tree-shaped pytree of float32 arrays."""
    return {k: np.asarray(rng.standard_normal((3, 2)) * scale, np.float32)
            for k in RNG_TREE_KEYS}


def _reference_mean(fresh, stale, discount):
    """Independent computation of the invariant (no tree.map, no fold
    order): element-wise over each leaf."""
    weight = len(fresh) + discount * len(stale)
    out = {}
    for k in RNG_TREE_KEYS:
        acc = np.zeros((3, 2), np.float64)
        for g in fresh.values():
            acc += g[k].astype(np.float64)
        for g in stale:
            acc += discount * g[k].astype(np.float64)
        out[k] = acc / weight
    return out


def _payload(rank, step, epoch, grads):
    return {"rank": rank, "step": step, "epoch": epoch, "grads": grads}


def _check_reduce(coll, fresh, stale, discount, rtol=1e-5):
    gavg, n_got, n_stale = coll.reduce()
    assert n_got == len(fresh) and n_stale == len(stale)
    ref = _reference_mean(fresh, stale, discount)
    for k in RNG_TREE_KEYS:
        np.testing.assert_allclose(np.asarray(gavg[k]), ref[k], rtol=rtol,
                                   atol=1e-6)


@PACKAGES
@pytest.mark.parametrize("seed", range(6))
def test_fuzz_arrival_orders_match_reference_mean(QC, seed):
    """Random fresh/stale/garbage payloads offered in a random order:
    the reduction equals the reference weighted mean, and garbage
    (other epochs, future steps) is rejected."""
    rng = np.random.default_rng(seed)
    pyrng = random.Random(seed)
    n_ranks = pyrng.randrange(2, 7)
    step = pyrng.randrange(1, 50)
    epoch = pyrng.randrange(0, 3)
    discount = pyrng.choice([0.0, 0.25, 0.5, 1.0])

    fresh = {r: _tree(rng) for r in range(n_ranks)}
    stale = [_tree(rng) for _ in range(pyrng.randrange(0, 4))]
    # (payload, should_be_accepted)
    payloads = [(_payload(r, step, epoch, g), True)
                for r, g in fresh.items()]
    payloads += [(_payload(pyrng.randrange(n_ranks), step - 1 - i, epoch, g),
                  True) for i, g in enumerate(stale)]
    payloads += [
        (_payload(0, step, epoch + 1, _tree(rng)), False),  # wrong epoch
        (_payload(1, step, epoch - 1, _tree(rng)), False),  # pre-recovery
        (_payload(2, step + 1, epoch, _tree(rng)), False),  # future step
    ]
    pyrng.shuffle(payloads)

    coll = QC(step=step, epoch=epoch, need=n_ranks,
                           stale_discount=discount)
    for p, expect in payloads:
        assert coll.offer(p) == expect, p
    assert coll.complete
    _check_reduce(coll, fresh, stale, discount)


@PACKAGES
@pytest.mark.parametrize("n_ranks,quorum", [(4, 1.0), (5, 0.5), (3, 0.34),
                                            (6, 0.01)])
def test_k_of_n_quorum_boundary(QC, n_ranks, quorum):
    """complete flips exactly at K = max(1, ceil(quorum * N)) fresh
    gradients; stale gradients never count toward the quorum."""
    rng = np.random.default_rng(0)
    need = max(1, int(np.ceil(quorum * n_ranks)))
    coll = QC(step=5, epoch=0, need=need, stale_discount=0.5)
    coll.offer(_payload(0, 4, 0, _tree(rng)))          # stale: no credit
    assert not coll.complete
    for i in range(need):
        assert not coll.complete
        coll.offer(_payload(i, 5, 0, _tree(rng)))
    assert coll.complete
    # a duplicate from the same rank must not inflate the count
    n_before = len(coll.got)
    coll.offer(_payload(0, 5, 0, _tree(rng)))
    assert len(coll.got) == n_before


@PACKAGES
def test_stale_discount_weighting_explicit(QC):
    """Hand-checked bounded-staleness case: 2 fresh + 1 stale at
    discount 0.5 -> (a + b + 0.5*c) / 2.5."""
    ones = {k: np.ones((3, 2), np.float32) for k in RNG_TREE_KEYS}
    twos = {k: 2 * np.ones((3, 2), np.float32) for k in RNG_TREE_KEYS}
    eights = {k: 8 * np.ones((3, 2), np.float32) for k in RNG_TREE_KEYS}
    coll = QC(step=3, epoch=1, need=2, stale_discount=0.5)
    coll.offer(_payload(1, 2, 1, eights))              # late: discounted
    coll.offer(_payload(0, 3, 1, ones))
    coll.offer(_payload(2, 3, 1, twos))
    gavg, n_got, n_stale = coll.reduce()
    assert (n_got, n_stale) == (2, 1)
    expect = (1.0 + 2.0 + 0.5 * 8.0) / 2.5
    for k in RNG_TREE_KEYS:
        np.testing.assert_allclose(np.asarray(gavg[k]), expect, rtol=1e-6)


@PACKAGES
def test_ensure_own_only_fills_missing(QC):
    rng = np.random.default_rng(1)
    mine, theirs = _tree(rng), _tree(rng)
    coll = QC(step=0, epoch=0, need=1, stale_discount=0.5)
    coll.ensure_own(0, mine)
    assert coll.got[0] is mine
    coll2 = QC(step=0, epoch=0, need=1, stale_discount=0.5)
    coll2.offer(_payload(0, 0, 0, theirs))
    coll2.ensure_own(0, mine)                          # loopback won: no-op
    assert coll2.got[0] is theirs


@PACKAGES
def test_reduce_deterministic_across_arrival_orders(QC):
    """Same payload set, two shuffles -> bit-identical reduction (fresh
    gradients fold in rank order, not arrival order) — the property the
    distributed-vs-in-proc equivalence test leans on."""
    rng = np.random.default_rng(3)
    fresh = {r: _tree(rng) for r in range(5)}
    stale = [(s, r, _tree(rng)) for s, r in ((1, 0), (2, 3), (1, 4))]
    payloads = ([_payload(r, 3, 0, g) for r, g in fresh.items()]
                + [_payload(r, s, 0, g) for s, r, g in stale])
    results = []
    for order in (payloads, list(reversed(payloads))):
        coll = QC(step=3, epoch=0, need=5, stale_discount=0.5)
        for p in order:
            coll.offer(p)
        results.append(coll.reduce()[0])
    for k in RNG_TREE_KEYS:
        a = np.asarray(results[0][k])
        b = np.asarray(results[1][k])
        assert np.array_equal(a, b), "fold order leaked into the mean"


@PACKAGES
@settings(max_examples=50, deadline=None)
@given(st.data())
def test_hypothesis_permutation_invariance(QC, data):
    """Property: for any fresh/stale multiset and any arrival
    permutation, reduce() equals the reference weighted mean."""
    n_ranks = data.draw(st.integers(2, 6), label="n_ranks")
    n_stale = data.draw(st.integers(0, 3), label="n_stale")
    discount = data.draw(st.sampled_from([0.0, 0.25, 0.5, 1.0]),
                         label="discount")
    seed = data.draw(st.integers(0, 2 ** 16), label="seed")
    rng = np.random.default_rng(seed)
    fresh = {r: _tree(rng) for r in range(n_ranks)}
    stale = [_tree(rng) for _ in range(n_stale)]
    payloads = [_payload(r, 7, 2, g) for r, g in fresh.items()]
    payloads += [_payload(0, 6, 2, g) for g in stale]
    payloads = data.draw(st.permutations(payloads), label="arrival")
    coll = QC(step=7, epoch=2, need=n_ranks,
                           stale_discount=discount)
    for p in payloads:
        assert coll.offer(p)
    _check_reduce(coll, fresh, stale, discount)
