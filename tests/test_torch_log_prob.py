"""K10's log-prob entries (``tarl_tpu_torch/ops/segment.py``:
``segment_log_prob``, ``segment_log_probs`` and their plain versions)
against the reference, on the CPU.

* The plain versions, and the entries' CPU path, against the reference's
  ``GraphDistribution.log_prob`` and ``ops.segment.segment_log_softmax``
  of the scaled logits (XLA on the CPU) at rtol 1e-6 (``exp``/``log`` may
  round an ulp apart), on ``tests/test_torch_card_k10.py``'s seeded cases:
  temperatures 1 and 0.7; +-inf, a segment of only -inf, NaN, empty
  segments, exact ties; valid actions and invalid ones (two hot in a
  segment, none hot, one segment missing) and a valid one with a
  zero-probability element active.
* On the CPU the plain versions equal the parent's composition (the
  distribution's ``log_prob`` and ``log_probs`` as they were written out
  before the entry, kept below) bitwise, and so does the distribution.
* ``GraphDistribution.log_prob`` is one ``ops.log_prob`` call and
  ``log_probs`` one ``ops.log_probs`` call, with no sum or max.
* The entries refuse a layout that dropped an id, logits that require
  grad while grad is enabled, and an action that is not bool; the layout
  reads whether it dropped an id with one counted host read, the first
  time it is asked, and none where it is built.
* ``segment_log_softmax`` keeps the reference's generic contract for other
  dtypes and ranks (the composition, plain on every device, as before the
  entry) and refuses float32 1-D logits that require grad with
  ``KERNELS``; with ``PLAIN`` it is differentiable.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tarl_tpu.ops import segment as ref_seg
from tarl_tpu.rl.distribution import GraphDistribution

from tarl_tpu_torch.core import sync
from tarl_tpu_torch.ops import segment as seg
from tarl_tpu_torch.rl.distribution import (
    GraphDistribution as PortGraphDistribution,
)

from test_torch_card_k10 import (ACTIONS, CASES, TEMPERATURES, action_for,
                                 log_prob_case)

torch.set_num_threads(1)


def _parent_log_probs(logits, ids, n, temperature):
    """The parent's ``GraphDistribution.log_probs`` with ``PLAIN``: the
    scale, then ``segment_log_softmax``'s composition."""
    x = seg.scale_logits(logits, temperature)
    m = seg.segment_max_plain(x, ids, n)
    m = torch.where(torch.isfinite(m), m, 0.0)
    shifted = x - m[ids.long()]
    denom = seg.segment_sum_plain(torch.exp(shifted), ids, n)
    return shifted - torch.log(torch.clamp(denom, min=1e-30))[ids.long()]


def _parent_log_prob(logits, action, ids, n, temperature):
    """The parent's ``GraphDistribution.log_prob`` with ``PLAIN``."""
    act = action.to(torch.float32)
    lp = _parent_log_probs(logits, ids, n, temperature)
    per_group = seg.segment_sum_plain(act, ids, n)
    group_sizes = seg.segment_sum_plain(torch.ones_like(act), ids, n)
    valid = torch.all(torch.where(group_sizes > 0, per_group == 1.0,
                                  per_group == 0.0))
    total = torch.sum(torch.where(act > 0, lp, 0.0))
    return torch.where(valid, total, float("-inf"))


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("temperature", TEMPERATURES)
@pytest.mark.parametrize("name", CASES)
def test_log_probs_against_reference(name, temperature):
    logits, ids, n = log_prob_case(name)
    tl, ti = torch.as_tensor(logits), torch.as_tensor(ids)
    lay = seg.segment_layout(ti, n)
    ref = GraphDistribution(jnp.asarray(logits), jnp.asarray(ids), n,
                            temperature=temperature)
    want = np.asarray(ref.log_probs())
    np.testing.assert_array_equal(
        want, np.asarray(ref_seg.segment_log_softmax(
            jnp.asarray(logits) / temperature, jnp.asarray(ids), n)))
    before = seg.MAX_LAUNCHES
    for got in (seg.segment_log_probs_plain(tl, ti, n, None, temperature),
                seg.segment_log_probs(tl, ti, n, lay, temperature),
                PortGraphDistribution(tl, ti, n, temperature,
                                      lay).log_probs()):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert seg.MAX_LAUNCHES == before
    if name == "nan":
        # A NaN denominator stays NaN through the clamp: the whole
        # segment's log-probs are NaN, as the reference's.
        nan_seg = np.unique(ids[np.isnan(logits)])
        got = seg.segment_log_probs(tl, ti, n, lay, temperature).numpy()
        assert np.isnan(got[np.isin(ids, nan_seg)]).all()
        assert np.isnan(want[np.isin(ids, nan_seg)]).all()


@pytest.mark.parametrize("kind", ACTIONS)
@pytest.mark.parametrize("temperature", TEMPERATURES)
@pytest.mark.parametrize("name", CASES)
def test_log_prob_against_reference(name, temperature, kind):
    logits, ids, n = log_prob_case(name)
    hot = action_for(kind, logits, ids, n)
    tl, ti, ta = (torch.as_tensor(logits), torch.as_tensor(ids),
                  torch.as_tensor(hot))
    lay = seg.segment_layout(ti, n)
    ref = GraphDistribution(jnp.asarray(logits), jnp.asarray(ids), n,
                            temperature=temperature)
    want = float(ref.log_prob(jnp.asarray(hot)))
    before = seg.MAX_LAUNCHES
    for got in (seg.segment_log_prob_plain(tl, ta, ti, n, None, temperature),
                seg.segment_log_prob(tl, ta, ti, n, lay, temperature),
                PortGraphDistribution(tl, ti, n, temperature,
                                      lay).log_prob(ta)):
        assert got.shape == () and got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6)
    assert seg.MAX_LAUNCHES == before
    if kind in ("two_hot", "none_hot", "one_missing"):
        assert want == -np.inf
    elif kind == "hot_neg_inf":     # NaN where a NaN segment is active
        assert not np.isfinite(want)


@pytest.mark.parametrize("temperature", TEMPERATURES)
@pytest.mark.parametrize("name", CASES)
def test_plain_equals_the_parent_composition_bitwise(name, temperature):
    logits, ids, n = log_prob_case(name)
    tl, ti = torch.as_tensor(logits), torch.as_tensor(ids)
    lay = seg.segment_layout(ti, n)
    dist = PortGraphDistribution(tl, ti, n, temperature, lay)
    want = _bits(_parent_log_probs(tl, ti, n, temperature))
    for got in (seg.segment_log_probs_plain(tl, ti, n, lay, temperature),
                seg.segment_log_probs(tl, ti, n, lay, temperature),
                dist.log_probs()):
        assert torch.equal(_bits(got), want)
    for kind in ACTIONS:
        ta = torch.as_tensor(action_for(kind, logits, ids, n))
        want = _bits(_parent_log_prob(tl, ta, ti, n, temperature))
        for got in (seg.segment_log_prob_plain(tl, ta, ti, n, lay,
                                               temperature),
                    seg.segment_log_prob(tl, ta, ti, n, lay, temperature),
                    dist.log_prob(ta)):
            assert torch.equal(_bits(got), want), kind


def test_distribution_log_prob_is_one_ops_call():
    logits, ids, n = log_prob_case("random")
    tl, ti = torch.as_tensor(logits), torch.as_tensor(ids)
    ta = torch.as_tensor(action_for("valid", logits, ids, n))
    lay = seg.segment_layout(ti, n)
    calls = []

    def refuse(*args):
        raise AssertionError("log_prob called a bare sum or max")

    def log_prob(*args):
        calls.append(("log_prob",) + args)
        return seg.PLAIN.log_prob(*args)

    def log_probs(*args):
        calls.append(("log_probs",) + args)
        return seg.PLAIN.log_probs(*args)

    ops = seg.PLAIN._replace(sum=refuse, max=refuse, log_prob=log_prob,
                             log_probs=log_probs)
    dist = PortGraphDistribution(tl, ti, n, 0.7, lay, ops)
    total, lp = dist.log_prob(ta), dist.log_probs()
    assert [(c[0], c[1] is tl) for c in calls] == [("log_prob", True),
                                                   ("log_probs", True)]
    assert calls[0][2] is ta and calls[0][3:] == (ti, n, lay, 0.7)
    assert calls[1][2:] == (ti, n, lay, 0.7)
    assert torch.equal(_bits(total),
                       _bits(_parent_log_prob(tl, ta, ti, n, 0.7)))
    assert torch.equal(_bits(lp), _bits(_parent_log_probs(tl, ti, n, 0.7)))


def test_entries_refuse_dropped_ids_grad_and_a_non_bool_action():
    logits, ids, n = log_prob_case("random")
    tl, ti = torch.as_tensor(logits), torch.as_tensor(ids)
    ta = torch.as_tensor(action_for("valid", logits, ids, n))
    reads = sync.HOST_READS
    lay = seg.segment_layout(ti, n)
    assert sync.HOST_READS == reads
    assert lay.dropped is False
    assert lay.dropped is False
    assert sync.HOST_READS == reads + 1
    bad_ids = ti.clone()
    bad_ids[::50] = n
    bad = seg.segment_layout(bad_ids, n)
    assert bad.dropped is True
    neg_ids = ti.clone()
    neg_ids[3] = -1
    for ids_x, lay_x in ((bad_ids, bad), (bad_ids, None), (neg_ids, None)):
        with pytest.raises(ValueError, match="outside"):
            seg.segment_log_probs(tl, ids_x, n, lay_x)
        with pytest.raises(ValueError, match="outside"):
            seg.segment_log_prob(tl, ta, ids_x, n, lay_x)
    grad = tl.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        seg.segment_log_probs(grad, ti, n, lay)
    with pytest.raises(RuntimeError, match="no backward"):
        PortGraphDistribution(grad, ti, n, 1.0, lay).log_prob(ta)
    with torch.no_grad():
        assert torch.equal(seg.segment_log_prob(grad, ta, ti, n, lay),
                           seg.segment_log_prob(tl, ta, ti, n, lay))
    with pytest.raises(TypeError):
        seg.segment_log_prob(tl, ta.to(torch.float32), ti, n, lay)
    with pytest.raises(ValueError):
        seg.segment_log_prob(tl, ta[1:], ti, n, lay)
    with pytest.raises(TypeError):
        seg.segment_log_prob(tl.double(), ta, ti, n, lay)
    # A layout of another id tensor, as the other wrappers refuse it.
    with pytest.raises(ValueError, match="another id tensor"):
        seg.segment_log_prob(tl, ta, ti.clone(), n, lay)
    # The plain versions take any action dtype and need no layout.
    assert torch.equal(
        seg.segment_log_prob_plain(tl, ta.to(torch.float32), ti, n),
        seg.segment_log_prob_plain(tl, ta, ti, n))


@pytest.mark.parametrize("name", CASES)
def test_log_softmax_keeps_the_generic_contract(name):
    logits, ids, n = log_prob_case(name)
    tl, ti = torch.as_tensor(logits), torch.as_tensor(ids)
    # Other dtypes and ranks: the parent's composition, plain on every
    # device, with no layout check.
    for x in (tl.double(), torch.stack([tl, tl.flip(0)], 1),
              tl.double().requires_grad_()):
        m = seg.segment_max(x, ti, n)
        shifted = x - torch.where(torch.isfinite(m), m, 0.0)[ti.long()]
        denom = seg.segment_sum(torch.exp(shifted), ti, n)
        want = shifted - torch.log(torch.clamp(denom, min=1e-30))[ti.long()]
        got = seg.segment_log_softmax(x, ti, n)
        assert got.dtype == x.dtype and got.shape == x.shape
        assert torch.equal(got.detach().isnan(), want.detach().isnan())
        ok = ~want.detach().isnan()
        assert torch.equal(got.detach()[ok], want.detach()[ok])
        assert got.requires_grad == x.requires_grad
    # Float32 1-D logits that require grad: refused with KERNELS (K10's
    # entry has no backward), differentiable with PLAIN.
    grad = tl.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        seg.segment_log_softmax(grad, ti, n)
    lp = seg.segment_log_softmax(grad, ti, n, ops=seg.PLAIN)
    torch.where(torch.isfinite(lp), lp, 0.0).sum().backward()
    assert grad.grad is not None and grad.grad.shape == tl.shape
    with torch.no_grad():
        assert torch.equal(_bits(seg.segment_log_softmax(grad, ti, n)),
                           _bits(_parent_log_probs(tl, ti, n, 1.0)))
