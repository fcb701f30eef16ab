"""The port's segment ops (``tarl_tpu_torch/ops/segment.py``) against the
reference, on the CPU.

* The plain versions of K9-K11 against the Pallas kernels of
  ``tarl_tpu/ops/pallas_segment.py`` in interpret mode (as
  ``tests/test_pallas_segment.py`` runs them): max and argmax bitwise (NaN
  where the segment holds one); sum at rtol 1e-6, because the TPU kernel
  sums in the matrix unit's order, and bitwise against
  ``jax.ops.segment_sum``, which adds in element order as the port does.
  Cases: random, empty segments, a segment of only -inf, out-of-range ids,
  more segments than the TPU's SEG_TILE (2,048), unsorted ids, exact ties.
* ``segment_min``, the softmaxes and ``segment_sample`` against
  ``tarl_tpu/ops/segment.py`` (XLA on the CPU): min and the sample
  exactly, the softmaxes at 1e-6 (``exp``/``log`` may round an ulp apart).
  JAX's XLA max gives -inf for an empty segment where the port (like the
  TPU kernel) gives NEG_LARGE; the softmaxes read only non-empty segments,
  so they agree.
* K11's action entry: ``segment_action_plain`` (and the wrapper's CPU
  path) against the reference's ``GraphDistribution.mode()`` and
  ``.sample(key)`` (XLA on the CPU), bitwise on the multi-hot action:
  random logits at temperature 1 and 0.7, -inf logits, empty segments,
  out-of-range ids, exact ties.  The sample's noise is the same threefry
  stream; only ``log`` may round an ulp apart, which moves no winner here.
* The layout, the wrappers' CPU path (no launch counted) and what they
  reject, the kernel source; on a card, each kernel against its plain
  version (marked ``cuda``; skipped here; the action entry's card test is
  in ``tests/test_torch_card_k2_k11.py``, which needs no jax).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tarl_tpu.ops import pallas_segment as ps
from tarl_tpu.ops import segment as ref_seg
from tarl_tpu.rl.distribution import GraphDistribution

import tarl_tpu_torch
from tarl_tpu_torch.core import rng
from tarl_tpu_torch.ops import segment as seg

from test_torch_card_k2_k11 import ACTION_CASES, action_case

torch.set_num_threads(1)

CASES = ["random", "empty", "all_neg_inf", "out_of_range", "many_segments",
         "unsorted", "ties"]


def _case(name: str):
    """``(data float32[E], ids int32[E], num_segments)`` from a seed."""
    g = np.random.default_rng(CASES.index(name))
    e, n = 700, 37
    if name == "many_segments":
        e, n = 3000, 5000
    data = g.normal(size=e).astype(np.float32)
    ids = np.sort(g.integers(0, n, size=e)).astype(np.int32)
    if name != "random":
        ids = g.permutation(ids).astype(np.int32)
    if name == "empty":
        ids[np.isin(ids, [3, 4, 20])] = 5
    elif name == "all_neg_inf":
        data[ids == 7] = -np.inf
        data[ids == 8] = np.inf
    elif name == "out_of_range":
        ids[::7] = -1
        ids[3::11] = n + 4
    elif name == "ties":
        data = np.round(data * 2.0) / 2.0
    data[g.integers(0, e, 3)] = [np.nan, np.inf, -np.inf]
    return data, ids, n


def _pallas(fn, data, ids, n):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(jnp.asarray(data), jnp.asarray(ids), n))


def _t(a):
    return torch.as_tensor(a)


@pytest.mark.parametrize("name", CASES)
def test_plain_kernels_against_pallas(name):
    data, ids, n = _case(name)
    finite = np.where(np.isfinite(data), data, 0.0).astype(np.float32)

    got = seg.segment_argmax(_t(data), _t(ids), n).numpy()
    np.testing.assert_array_equal(
        got, _pallas(ps.segment_argmax_pallas, data, ids, n))
    assert got.dtype == np.int32

    got = seg.segment_max(_t(data), _t(ids), n).numpy()
    want = _pallas(ps.segment_max_pallas, data, ids, n)
    assert np.array_equal(got.view(np.int32)[~np.isnan(want)],
                          want.view(np.int32)[~np.isnan(want)])
    assert np.array_equal(np.isnan(got), np.isnan(want))

    got = seg.segment_sum(_t(finite), _t(ids), n).numpy()
    np.testing.assert_allclose(
        got, _pallas(ps.segment_sum_pallas, finite, ids, n), rtol=1e-6,
        atol=1e-6)
    np.testing.assert_array_equal(
        got, np.asarray(jax.ops.segment_sum(jnp.asarray(finite),
                                            jnp.asarray(ids), n)))
    if name == "empty":
        assert got[3] == 0.0 and seg.segment_max(
            _t(data), _t(ids), n)[3] == seg.NEG_LARGE


@pytest.mark.parametrize("name", ["random", "empty", "out_of_range"])
def test_min_softmax_and_sample_against_reference(name):
    data, ids, n = _case(name)
    data = np.where(np.isnan(data), 0.0, data).astype(np.float32)
    jd, ji = jnp.asarray(data), jnp.asarray(ids)
    np.testing.assert_array_equal(
        seg.segment_min(_t(data), _t(ids), n).numpy(),
        np.asarray(ref_seg.segment_min(jd, ji, n)))
    iv = (ids * 3 % 11).astype(np.int32)
    np.testing.assert_array_equal(
        seg.segment_min(_t(iv), _t(ids), n).numpy(),
        np.asarray(ref_seg.segment_min(jnp.asarray(iv), ji, n)))

    valid = (ids >= 0) & (ids < n)
    logits = np.where(valid, data, 0.0).astype(np.float32)
    ids_v = np.where(valid, ids, 0).astype(np.int32)
    jl, jv = jnp.asarray(logits), jnp.asarray(ids_v)
    for port_fn, ref_fn in ((seg.segment_softmax, ref_seg.segment_softmax),
                            (seg.segment_log_softmax,
                             ref_seg.segment_log_softmax)):
        np.testing.assert_allclose(
            port_fn(_t(logits), _t(ids_v), n).numpy(),
            np.asarray(ref_fn(jl, jv, n)), rtol=1e-6, atol=1e-6)
    for s in range(3):
        np.testing.assert_array_equal(
            seg.segment_sample(rng.prng_key(s), _t(logits), _t(ids_v),
                               n).numpy(),
            np.asarray(ref_seg.segment_sample(jax.random.PRNGKey(s), jl, jv,
                                              n)))


@pytest.mark.parametrize("name,temperature", ACTION_CASES)
def test_action_plain_against_reference_distribution(name, temperature):
    logits, ids, n = action_case(name)
    ref = GraphDistribution(jnp.asarray(logits), jnp.asarray(ids), n,
                            temperature=temperature)
    tl, ti = _t(logits), _t(ids)
    lay = seg.segment_layout(ti, n)
    before = seg.ARGMAX_LAUNCHES
    for s in (None, 0, 1, 2):
        if s is None:
            want = np.asarray(ref.mode())
            key = None
        else:
            want = np.asarray(ref.sample(jax.random.PRNGKey(s)))
            key = rng.prng_key(s)
        got = seg.segment_action_plain(tl, ti, n, None, temperature, key)
        assert got.dtype == torch.bool and got.shape == (logits.shape[0],)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(s))
        wrapped = seg.segment_action(tl, ti, n, lay, temperature, key)
        assert torch.equal(wrapped, got)
    # One edge per segment with a finite logit, none elsewhere.
    valid = (ids >= 0) & (ids < n) & np.isfinite(logits)
    hot = seg.segment_action_plain(tl, ti, n, None, temperature).numpy()
    assert hot.sum() == len(np.unique(ids[valid]))
    assert seg.ARGMAX_LAUNCHES == before
    with pytest.raises(TypeError):
        seg.segment_action(tl.double(), ti, n)


def test_layout_is_a_stable_csr_without_dropped_ids():
    data, ids, n = _case("out_of_range")
    lay = seg.segment_layout(_t(ids), n)
    offsets, order = lay.offsets.numpy(), lay.order.numpy()
    assert offsets.dtype == np.int32 and order.dtype == np.int32
    assert offsets[0] == 0 and offsets[-1] == ((ids >= 0) & (ids < n)).sum()
    for s in range(n):
        run = order[offsets[s]:offsets[s + 1]]
        np.testing.assert_array_equal(run, np.nonzero(ids == s)[0])
    dropped = np.nonzero((ids < 0) | (ids >= n))[0]
    assert set(order[offsets[-1]:]) == set(dropped)


def test_wrappers_take_plain_versions_on_cpu_and_reject_bad_inputs():
    data, ids, n = _case("random")
    before = (seg.SUM_LAUNCHES, seg.MAX_LAUNCHES, seg.ARGMAX_LAUNCHES)
    tids = _t(ids)
    lay = seg.segment_layout(tids, n)
    for wrapped, plain in ((seg.segment_sum, seg.segment_sum_plain),
                           (seg.segment_max, seg.segment_max_plain),
                           (seg.segment_argmax, seg.segment_argmax_plain)):
        a = wrapped(_t(data), tids, n, lay)
        b = plain(_t(data), tids, n)
        assert a.dtype == b.dtype and torch.equal(a.view(torch.int32),
                                                  b.view(torch.int32))
        # A layout of another id tensor, even one equal to this one.
        with pytest.raises(ValueError, match="another id tensor"):
            wrapped(_t(data), _t(ids), n, lay)
    assert (seg.SUM_LAUNCHES, seg.MAX_LAUNCHES,
            seg.ARGMAX_LAUNCHES) == before
    # Other dtypes and ranks are plain on every device, as in XLA.
    two = seg.segment_sum(_t(np.stack([data, data], 1)), _t(ids), n)
    assert two.shape == (n, 2)
    with pytest.raises(ValueError):
        seg.segment_argmax(_t(np.stack([data, data], 1)), _t(ids), n)
    with pytest.raises(ValueError):
        seg.segment_sum(torch.zeros(4, device="meta"),
                        torch.zeros(4, dtype=torch.int32, device="meta"), 2)


def test_kernel_source():
    text = open(tarl_tpu_torch.__path__[0] + "/csrc/segment.cu").read()
    for entry in ("tarl_segment_sum", "tarl_segment_max",
                  "tarl_segment_argmax", "tarl_segment_action",
                  "tarl_segment_log_prob"):
        assert f'extern "C" int {entry}(' in text
    for kernel in ("_segment_sum_kernel", "_segment_max_kernel",
                   "_segment_argmax_kernel"):
        assert kernel in text


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py checks the "
                    "segment kernels on the card")
    dev = torch.device("cuda", 0)
    for name in CASES:
        data, ids, n = _case(name)
        finite = np.where(np.isfinite(data), data, 0.0).astype(np.float32)
        for fn, plain, x in ((seg.segment_sum, seg.segment_sum_plain, finite),
                             (seg.segment_max, seg.segment_max_plain, data),
                             (seg.segment_argmax, seg.segment_argmax_plain,
                              data)):
            got = fn(_t(x).to(dev), _t(ids).to(dev), n).cpu()
            want = plain(_t(x), _t(ids), n)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))

