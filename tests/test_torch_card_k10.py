"""K10's log-prob entry against the composed kernel path and the plain
versions on a card, with no jax: on a card run

    python -m pytest --noconftest -m cuda tests/test_torch_card_k10.py

The test is marked ``cuda`` and skips where no card is.  The inputs are
:func:`log_prob_case`'s, made from numpy seeds: short segments, as a
node's out-edges are, with empty segments, +-inf, a segment of only -inf,
NaN and exact ties; at temperatures 1 and 0.7; and :func:`action_for`'s
multi-hot actions, valid and invalid.  ``tests/test_torch_log_prob.py``
holds the plain versions on the same cases against the reference's
``GraphDistribution`` on the CPU.

* ``segment_log_prob`` (with an action) and ``segment_log_probs`` (the
  log-softmax) bitwise against ``segment_log_prob_plain`` /
  ``segment_log_probs_plain`` with ``ops=KERNELS`` (the parent's
  composition, its max and sums through K10 and K9, which add in element
  order as the entry does), one launch a call and no K9;
* and against the plain versions (``PLAIN``) on the card and on a CPU
  copy at rtol 1e-6, atol 1e-6 for the per-element log-softmax and rtol
  1e-5, atol 1e-5 for the joint log-prob: ``index_add_`` on the card adds
  with atomics, ``exp``/``log`` may round an ulp apart between the CPU's
  and the card's libm, and the joint sum runs in another order on the
  CPU.
"""
import numpy as np
import pytest
import torch

from tarl_tpu_torch.ops import segment as seg

CASES = ["random", "inf", "neg_inf_group", "nan", "empty", "ties"]
ACTIONS = ["valid", "two_hot", "none_hot", "one_missing", "hot_neg_inf"]
TEMPERATURES = [1.0, 0.7]


def log_prob_case(name: str):
    """``(logits float32[E], ids int32[E], num_segments)`` from a seed:
    short segments, every id in range."""
    g = np.random.default_rng(CASES.index(name) + 90)
    e, n = 900, 250
    logits = (g.normal(size=e) * 3.0).astype(np.float32)
    ids = g.permutation(np.sort(g.integers(0, n, size=e))).astype(np.int32)
    if name == "inf":
        logits[::13] = np.inf
        logits[5::17] = -np.inf
    elif name == "neg_inf_group":
        for s in (5, 6, 7):
            logits[ids == s] = -np.inf
        logits[::11] = -np.inf
    elif name == "nan":
        logits[::29] = np.nan
    elif name == "empty":
        ids[np.isin(ids, [3, 4, 20, 249])] = 8
    elif name == "ties":
        logits = (np.round(logits * 2.0) / 2.0).astype(np.float32)
    # A few -inf logits, each in a segment of two or more.
    k = np.arange(7, e, 41)
    logits[k[np.bincount(ids, minlength=n)[ids[k]] >= 2]] = -np.inf
    return logits, ids, n


def action_for(kind: str, logits, ids, n: int):
    """A multi-hot bool[E] over ``ids``: ``valid`` one element of every
    non-empty segment (seeded; a finite logit where the segment has one,
    as the sampler picks); ``two_hot`` every element of a segment of two
    or more; ``none_hot`` nothing; ``one_missing`` every segment but one;
    ``hot_neg_inf`` valid, with a -inf logit active in place of a finite
    one in a segment of finite and -inf logits (a zero-probability
    choice: the joint is -inf)."""
    g = np.random.default_rng(ACTIONS.index(kind) + 70)
    hot = np.zeros(ids.shape[0], dtype=bool)
    if kind == "none_hot":
        return hot
    runs = [np.nonzero(ids == s)[0] for s in range(n)]
    for run in runs:
        finite = run[np.isfinite(logits[run])]
        if run.size:
            hot[g.choice(finite if finite.size else run)] = True
    big = next(r for r in runs if r.size >= 2)
    if kind == "two_hot":
        hot[big] = True
    elif kind == "one_missing":
        hot[big] = False
    elif kind == "hot_neg_inf":
        run = next(r for r in runs if (logits[r] == -np.inf).any()
                   and np.isfinite(logits[r]).any()
                   and (np.isfinite(logits[r]) | (logits[r] < 0)).all())
        hot[run] = False
        hot[run[logits[run] == -np.inf][0]] = True
    return hot


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py phase 11 "
                    "checks K10's entry on the card")
    return torch.device("cuda", 0)


def _bits(t):
    return t.detach().cpu().contiguous().view(torch.int32)


@pytest.mark.cuda
def test_log_prob_entry_matches_composed_and_plain_on_card():
    dev = _card()
    for name in CASES:
        logits, ids, n = log_prob_case(name)
        cl, ci = torch.as_tensor(logits), torch.as_tensor(ids)
        tl, ti = cl.to(dev), ci.to(dev)
        lay = seg.segment_layout(ti, n)
        for t in TEMPERATURES:
            before = (seg.MAX_LAUNCHES, seg.SUM_LAUNCHES)
            got = seg.segment_log_probs(tl, ti, n, lay, t)
            torch.cuda.synchronize()
            assert (seg.MAX_LAUNCHES, seg.SUM_LAUNCHES) == (
                before[0] + 1, before[1])
            composed = seg.segment_log_probs_plain(tl, ti, n, lay, t,
                                                   seg.KERNELS)
            assert torch.equal(_bits(got), _bits(composed)), (name, t)
            for want in (seg.segment_log_probs_plain(tl, ti, n, None, t),
                         seg.segment_log_probs_plain(cl, ci, n, None, t)):
                assert torch.allclose(got.cpu(), want.cpu(), rtol=1e-6,
                                      atol=1e-6, equal_nan=True), (name, t)
            for kind in ACTIONS:
                act = torch.as_tensor(action_for(kind, logits, ids, n))
                ta = act.to(dev)
                before = (seg.MAX_LAUNCHES, seg.SUM_LAUNCHES)
                got = seg.segment_log_prob(tl, ta, ti, n, lay, t)
                torch.cuda.synchronize()
                assert (seg.MAX_LAUNCHES, seg.SUM_LAUNCHES) == (
                    before[0] + 1, before[1])
                composed = seg.segment_log_prob_plain(tl, ta, ti, n, lay, t,
                                                      seg.KERNELS)
                assert torch.equal(_bits(got), _bits(composed)), (
                    name, t, kind)
                for want in (
                        seg.segment_log_prob_plain(tl, ta, ti, n, None, t),
                        seg.segment_log_prob_plain(cl, act, ci, n, None, t)):
                    assert torch.allclose(got.cpu(), want.cpu(), rtol=1e-5,
                                          atol=1e-5, equal_nan=True), (
                        name, t, kind)
