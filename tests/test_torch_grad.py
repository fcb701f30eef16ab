"""The segment kernels' wrappers and gradients, on the CPU (no jax).

K9-K11 have no backward.  On every device, ``segment_sum``,
``segment_max``, ``segment_argmax`` and ``segment_action``, and every
composite op on ``KERNELS`` (``segment_softmax``, ``segment_log_softmax``,
``GraphDistribution``'s methods, ``MPNNValueNet``'s segment sums), refuse
float32 1-D data that requires grad while grad is enabled; the CPU refuses
the same calls as the card, so these tests see it.  Under
``torch.no_grad()`` the calls go through, and inside ``plain_segments()``
(the counterpart of the reference's ``no_pallas()``) the wrappers take
their plain versions, whose gradients equal ``PLAIN``'s bitwise.
``tests/test_torch_card_train.py`` holds the same refusals on the card.
"""
import numpy as np
import pytest
import torch

from tarl_tpu_torch.core import rng
from tarl_tpu_torch.models.mpnn import MPNNValueNet
from tarl_tpu_torch.ops import segment as seg
from tarl_tpu_torch.rl.distribution import GraphDistribution

torch.set_num_threads(1)


def grad_case(device="cpu"):
    """``(logits float32[E], ids int32[E], n, layout)`` from a seed: short
    segments, every id in range."""
    g = np.random.default_rng(17)
    e, n = 300, 90
    ids = g.permutation(np.sort(g.integers(0, n, size=e))).astype(np.int32)
    logits = torch.as_tensor((g.normal(size=e) * 2.0).astype(np.float32),
                             device=device)
    tids = torch.as_tensor(ids, device=device)
    return logits, tids, n, seg.segment_layout(tids, n)


def _sum(x, ids, n, lay):
    return seg.segment_sum(x, ids, n, lay)


def _max(x, ids, n, lay):
    return seg.segment_max(x, ids, n, lay)


def _argmax(x, ids, n, lay):
    return seg.segment_argmax(x, ids, n, lay)


def _action(x, ids, n, lay):
    return seg.segment_action(x, ids, n, lay, 0.8, rng.prng_key(3))


def _softmax(x, ids, n, lay, ops=seg.KERNELS):
    return seg.segment_softmax(x, ids, n, lay, ops)


def _log_softmax(x, ids, n, lay, ops=seg.KERNELS):
    return seg.segment_log_softmax(x, ids, n, lay, ops)


def _entropy(x, ids, n, lay, ops=seg.KERNELS):
    return GraphDistribution(x, ids, n, 1.0, lay, ops).entropy()


OPS = {"sum": _sum, "max": _max, "argmax": _argmax, "action": _action,
       "softmax": _softmax, "log_softmax": _log_softmax,
       "entropy": _entropy}
PLAIN_OF = {
    "sum": lambda x, ids, n, lay: seg.segment_sum_plain(x, ids, n),
    "max": lambda x, ids, n, lay: seg.segment_max_plain(x, ids, n),
    "argmax": lambda x, ids, n, lay: seg.segment_argmax_plain(x, ids, n),
    "action": lambda x, ids, n, lay: seg.segment_action_plain(
        x, ids, n, None, 0.8, rng.prng_key(3)),
    "softmax": lambda x, ids, n, lay: _softmax(x, ids, n, lay, seg.PLAIN),
    "log_softmax": lambda x, ids, n, lay: _log_softmax(x, ids, n, lay,
                                                       seg.PLAIN),
    "entropy": lambda x, ids, n, lay: _entropy(x, ids, n, lay, seg.PLAIN),
}


def _loss(out):
    """A scalar that reads every output element (none for integer
    outputs)."""
    if not out.dtype.is_floating_point:
        return None
    return torch.where(torch.isfinite(out), out, 0.0).square().sum()


@pytest.mark.parametrize("name", sorted(OPS))
def test_wrappers_refuse_grad_and_pass_without_it(name):
    logits, ids, n, lay = grad_case()
    op = OPS[name]
    x = logits.clone().requires_grad_()
    for layout in (lay, None):
        with pytest.raises(RuntimeError, match="no backward"):
            op(x, ids, n, layout)
    with torch.no_grad():
        got = op(x, ids, n, lay)
    assert torch.equal(got, PLAIN_OF[name](logits, ids, n, lay))
    # Data that does not require grad passes with grad enabled.
    assert torch.equal(op(logits, ids, n, lay),
                       PLAIN_OF[name](logits, ids, n, lay))


@pytest.mark.parametrize("name", sorted(OPS))
def test_plain_segments_takes_the_plain_versions(name):
    logits, ids, n, lay = grad_case()
    op, plain = OPS[name], PLAIN_OF[name]
    x = logits.clone().requires_grad_()
    with seg.plain_segments():
        got = op(x, ids, n, lay)
        # The layout checks still hold inside.
        with pytest.raises(ValueError, match="another id tensor"):
            op(x, ids.clone(), n, lay)
    y = logits.clone().requires_grad_()
    want = plain(y, ids, n, lay)
    assert torch.equal(got.detach(), want.detach())
    loss = _loss(got)
    if loss is None:
        return
    loss.backward()
    _loss(want).backward()
    assert x.grad is not None and torch.equal(x.grad, y.grad)
    assert float(x.grad.abs().sum()) > 0
    # The context ends with its block: the refusal is back.
    with pytest.raises(RuntimeError, match="no backward"):
        op(x, ids, n, lay)


def test_plain_segments_nests_and_resets_on_error():
    logits, ids, n, lay = grad_case()
    x = logits.clone().requires_grad_()
    with pytest.raises(KeyError):
        with seg.plain_segments():
            with seg.plain_segments():
                seg.segment_sum(x, ids, n, lay)
            seg.segment_max(x, ids, n, lay)
            raise KeyError("leave")
    with pytest.raises(RuntimeError, match="no backward"):
        seg.segment_sum(x, ids, n, lay)


def test_value_net_segment_sums_need_plain_segments():
    """``MPNNValueNet`` calls ``segment_sum`` itself: with parameters that
    require grad its message sum is refused outside ``plain_segments``,
    and inside it the gradients flow to every parameter."""
    g = np.random.default_rng(4)
    n, e, c = 12, 40, 16
    src = torch.as_tensor(np.sort(g.integers(0, n, size=e)).astype(np.int32))
    dst = torch.as_tensor(g.integers(0, n, size=e).astype(np.int32))
    x = torch.as_tensor(g.normal(size=(n, c)).astype(np.float32))
    ef = torch.as_tensor(g.random((e, 1)).astype(np.float32))
    t = torch.tensor([22000.0])
    net = MPNNValueNet(n)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in net.state_dict().items()}
    args = (x, ef, src, dst, t)
    with pytest.raises(RuntimeError, match="no backward"):
        torch.func.functional_call(net, params, args)
    with torch.no_grad():
        want = torch.func.functional_call(net, params, args)
    with seg.plain_segments():
        v = torch.func.functional_call(net, params, args)
    assert torch.equal(v.detach(), want)
    v.backward()
    assert all(p.grad is not None for p in params.values())
    assert float(params["message_fc.weight"].grad.abs().sum()) > 0
