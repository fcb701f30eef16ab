"""Segment reductions over edge lists (ports ``tarl_tpu/ops/segment.py``:
``segment_sum``, ``segment_max``, ``segment_min``, ``segment_argmax``,
``segment_softmax``, ``segment_log_softmax`` and ``segment_sample``).

Float32 1-D ``segment_sum``, ``segment_max`` and ``segment_argmax`` are the
TPU kernels K9-K11 of ``tarl_tpu/ops/pallas_segment.py``.  On a CUDA
tensor they launch the hand-written kernels of ``csrc/segment.cu`` (nvcc
into a shared library with a C interface, loaded with ctypes) at any
segment count; on a CPU tensor they take the plain PyTorch versions
(``*_plain``), which compute the same function.  They never fall back
from a kernel to its plain version.  Other dtypes and ranks, and
``segment_min``, are plain PyTorch on every device, as the reference leaves
them to XLA.  :func:`segment_action` is K11's second entry: the learned
policy's multi-hot action from its raw logits (the scale, the Gumbel noise
drawn in the kernel from a key, the argmax, the hot vector) in one launch,
for ``GraphDistribution.mode`` and ``sample``.  :func:`segment_log_prob`
and :func:`segment_log_probs` are K10's entry: the log-probability of a
multi-hot action (``GraphDistribution.log_prob``: the scale, the segment
max, the log-softmax, the action's validity and its masked log-probs) and
the log-softmax alone (``log_probs``), each in one launch.  The kernels
have no backward: on every device, every wrapper of K9-K11 refuses float32
1-D data that requires grad while grad is enabled (it neither detaches nor
takes its plain version), and so does every composite op on
:data:`KERNELS`.  Differentiable code runs inside :func:`plain_segments`,
where the wrappers take their plain versions, or calls :data:`PLAIN`.

Semantics follow the TPU kernels: an id outside ``[0, num_segments)`` is
dropped; an empty segment's max is ``NEG_LARGE`` (JAX's XLA path gives
``-inf``; callers only read non-empty segments); argmax treats a
non-finite score as ``NEG_LARGE``, keeps the lowest index among ties and
returns ``len(scores)`` for a segment with no finite score above
``NEG_LARGE``; a segment holding a NaN has max NaN.

The kernels read a :class:`SegmentLayout`, a CSR of the id vector built
once per vector (for the learned policy, once per ``network.full_src``)
and checked once, where it is built, for what the kernels take.  Callers
that repeat an id vector pass its layout, and a wrapper given a layout
raises unless it was built from the very id tensor it is given, for as
many segments; a call then checks only its data before the launch.  The
composite ops (softmax, log-softmax, sample) take ``ops``:
:data:`KERNELS` by default, :data:`PLAIN` to force the plain versions on
the card.
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import dataclasses
import functools
from typing import Callable, NamedTuple

import torch

from .._build import check_tensor, current_stream
from ..core import rng, sync
from .scatter import scatter_set

# The TPU kernels' empty-segment value, as a float32.
NEG_LARGE = float(torch.tensor(-3.4e38, dtype=torch.float32))

# Kernel launches through the wrappers (one per call on a CUDA tensor; both
# of K11's entries count in ARGMAX_LAUNCHES, K10's log-prob entries in
# MAX_LAUNCHES); the plain versions do not count.
SUM_LAUNCHES = 0
MAX_LAUNCHES = 0
ARGMAX_LAUNCHES = 0

_FNS = None

_PLAIN_SEGMENTS = contextvars.ContextVar("tarl_plain_segments",
                                         default=False)


def reset_launches() -> None:
    global SUM_LAUNCHES, MAX_LAUNCHES, ARGMAX_LAUNCHES
    SUM_LAUNCHES = MAX_LAUNCHES = ARGMAX_LAUNCHES = 0


@contextlib.contextmanager
def plain_segments():
    """Route every segment wrapper called inside this context to its plain
    version, on every device: the counterpart of the reference's
    ``no_pallas()`` (``tarl_tpu/ops/segment.py``), which PPO's loss runs
    under.  The plain versions are differentiable and launch no kernel."""
    token = _PLAIN_SEGMENTS.set(True)
    try:
        yield
    finally:
        _PLAIN_SEGMENTS.reset(token)


@dataclasses.dataclass(frozen=True, eq=False)
class SegmentLayout:
    """CSR of an id vector: segment ``s`` holds the elements
    ``order[offsets[s]:offsets[s + 1]]``, in ascending element order.
    Elements with an out-of-range id sort past ``offsets[N]``.  ``ids``
    is the 1-D id tensor it was built from.  Built only as the kernels
    take it: ``offsets`` int32 ``[N + 1]`` and ``order`` int32 ``[E]``,
    contiguous, on the ids' device (raises otherwise); ``pointers`` keeps
    their addresses for the launches."""

    offsets: torch.Tensor  # int32[N + 1]
    order: torch.Tensor    # int32[E]
    num_segments: int
    ids: torch.Tensor
    pointers: tuple[int, int] = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        if self.ids.dim() != 1:
            raise ValueError(f"segment ids have rank {self.ids.dim()}, "
                             "expected 1")
        dev = self.ids.device
        check_tensor("offsets", self.offsets, torch.int32,
                     (self.num_segments + 1,), dev)
        check_tensor("order", self.order, torch.int32, (self.ids.shape[0],),
                     dev)
        object.__setattr__(self, "pointers", (self.order.data_ptr(),
                                              self.offsets.data_ptr()))

    @functools.cached_property
    def dropped(self) -> bool:
        """Whether an id lay out of range: one counted host read
        (:func:`sync.host_read`), the first time it is asked."""
        (end,) = sync.host_read(self.offsets[-1])
        return end != self.ids.shape[0]


def segment_layout(segment_ids: torch.Tensor,
                   num_segments: int) -> SegmentLayout:
    """The :class:`SegmentLayout` of ``segment_ids`` (on its device, with
    no host read)."""
    key = _drop_key(segment_ids, num_segments)
    order = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=num_segments + 1)[:num_segments]
    offsets = torch.zeros(num_segments + 1, dtype=torch.int64,
                          device=key.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return SegmentLayout(offsets.to(torch.int32), order.to(torch.int32),
                         num_segments, segment_ids)


def _drop_key(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """int64 ids with every out-of-range id sent to the spare segment
    ``num_segments``."""
    ids = segment_ids.to(torch.int64)
    ok = (ids >= 0) & (ids < num_segments)
    return torch.where(ok, ids, num_segments)


# ---------------------------------------------------------------------------
# Plain versions (CPU path; the kernels' references on the card)
# ---------------------------------------------------------------------------
def segment_sum_plain(data, segment_ids, num_segments: int,
                      layout=None):
    """Scatter-add with out-of-range ids dropped.  On a CPU tensor the adds
    run in element order, as the kernel's do."""
    key = _drop_key(segment_ids, num_segments)
    out = torch.zeros((num_segments + 1,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, key, data)[:num_segments]


def segment_max_plain(data, segment_ids, num_segments: int,
                      layout=None):
    """Max per segment from ``NEG_LARGE``; NaN where the segment holds
    one.  Float ``data[E, ...]`` (float32 on every path; float64 for a
    reference gradient): trailing axes reduce independently."""
    key = _drop_key(segment_ids, num_segments)
    index = key.reshape((-1,) + (1,) * (data.dim() - 1)).expand(data.shape)
    isnan = torch.isnan(data)
    out = torch.full((num_segments + 1,) + tuple(data.shape[1:]), NEG_LARGE,
                     dtype=data.dtype, device=data.device)
    out.scatter_reduce_(0, index, torch.where(isnan, NEG_LARGE, data),
                        "amax")
    nans = torch.zeros(out.shape, dtype=torch.int32,
                       device=data.device).index_add_(
        0, key, isnan.to(torch.int32))
    return torch.where(nans > 0, float("nan"), out)[:num_segments]


def segment_argmax_plain(scores, segment_ids, num_segments: int,
                         layout=None):
    """Lowest index of the segment max over finite scores above
    ``NEG_LARGE``; ``len(scores)`` where there is none.  int32."""
    e = scores.shape[0]
    key = _drop_key(segment_ids, num_segments)
    s = torch.where(torch.isfinite(scores), scores, NEG_LARGE)
    best = torch.full((num_segments + 1,), NEG_LARGE, dtype=scores.dtype,
                      device=scores.device)
    best.scatter_reduce_(0, key, s, "amax")
    is_best = (s == best[key]) & (s > NEG_LARGE)
    idx = torch.where(is_best, torch.arange(e, device=scores.device), e)
    arg = torch.full((num_segments + 1,), e, dtype=torch.int64,
                     device=scores.device)
    arg.scatter_reduce_(0, key, idx, "amin")
    return arg[:num_segments].to(torch.int32)


def scale_logits(logits, temperature: float):
    """``logits / temperature`` as an IEEE float32 division on every
    device, as the reference's ``_scaled`` and K11's action entry compute
    it (a CUDA tensor divided by a Python float is multiplied by the
    reciprocal instead)."""
    return logits / torch.full((), temperature, dtype=logits.dtype,
                               device=logits.device)


def segment_action_plain(logits, segment_ids, num_segments: int,
                         layout=None, temperature: float = 1.0,
                         key: rng.Key | None = None):
    """The plain version of :func:`segment_action`: the scale, then the
    argmax (no key) or :func:`segment_sample` (a key), then the hot
    vector with the no-winner index dropped."""
    x = scale_logits(logits, temperature)
    if key is None:
        chosen = segment_argmax_plain(x, segment_ids, num_segments)
    else:
        chosen = segment_sample(key, x, segment_ids, num_segments, ops=PLAIN)
    e = logits.shape[0]
    hot = torch.zeros(e, dtype=torch.bool, device=logits.device)
    return scatter_set(hot, chosen, True, chosen < e)


def segment_log_probs_plain(logits, segment_ids, num_segments: int,
                            layout=None, temperature: float = 1.0,
                            ops: SegmentOps | None = None):
    """The plain version of :func:`segment_log_probs`: the scale, then the
    log-softmax stabilised by the segment max (``ops.max``, where finite)
    with ``ops.sum`` of the exponentials (:data:`PLAIN` unless given;
    :data:`KERNELS` gives the composed kernel path, K10 and K9 with the
    steps between them)."""
    ops = PLAIN if ops is None else ops
    x = scale_logits(logits, temperature)
    shifted = _shifted(x, segment_ids, num_segments, layout, ops)
    denom = ops.sum(torch.exp(shifted), segment_ids, num_segments, layout)
    return shifted - torch.log(torch.clamp(denom, min=1e-30))[
        segment_ids.long()]


def segment_log_prob_plain(logits, action, segment_ids, num_segments: int,
                           layout=None, temperature: float = 1.0,
                           ops: SegmentOps | None = None):
    """The plain version of :func:`segment_log_prob`, the reference's
    ``GraphDistribution.log_prob`` composed of ``ops.max`` and ``ops.sum``
    (:data:`PLAIN` unless given, as in :func:`segment_log_probs_plain`):
    the joint log-probability of the multi-hot ``action``, ``-inf``
    unless every segment with elements activates exactly one."""
    ops = PLAIN if ops is None else ops
    act = action.to(torch.float32)
    lp = segment_log_probs_plain(logits, segment_ids, num_segments, layout,
                                 temperature, ops)
    per_group = ops.sum(act, segment_ids, num_segments, layout)
    group_sizes = ops.sum(torch.ones_like(act), segment_ids, num_segments,
                          layout)
    valid = torch.all(torch.where(group_sizes > 0, per_group == 1.0,
                                  per_group == 0.0))
    # Mask by activation: a chosen zero-probability edge gives -inf.
    total = torch.sum(torch.where(act > 0, lp, 0.0))
    return torch.where(valid, total, float("-inf"))


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------
def _kernel_fns():
    global _FNS
    if _FNS is None:
        from .._build import load_library

        lib = load_library("segment")
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.tarl_segment_sum, lib.tarl_segment_max):
            fn.argtypes = [p, p, p, i, p, p]
            fn.restype = ctypes.c_int
        lib.tarl_segment_argmax.argtypes = [p, p, p, i, i, p, p]
        lib.tarl_segment_argmax.restype = ctypes.c_int
        u = ctypes.c_uint32
        lib.tarl_segment_action.argtypes = [p, p, p, i, i, ctypes.c_float,
                                            i, u, u, p, p]
        lib.tarl_segment_action.restype = ctypes.c_int
        lib.tarl_segment_log_prob.argtypes = [p, p, p, i, ctypes.c_float,
                                              p, p, p, p]
        lib.tarl_segment_log_prob.restype = ctypes.c_int
        _FNS = (lib.tarl_segment_sum, lib.tarl_segment_max,
                lib.tarl_segment_argmax, lib.tarl_segment_action,
                lib.tarl_segment_log_prob)
    return _FNS


def _kernel_ok(data) -> bool:
    return data.dim() == 1 and data.dtype == torch.float32


def _route(name: str, data, segment_ids, num_segments, layout):
    """``None`` for the plain path (a CPU tensor, or inside
    :func:`plain_segments`), else the layout to launch with.  Raises on a
    device that is neither and, on every device (so that the CPU and the
    card reject the same calls), on a layout built from another id tensor
    or for another segment count, and outside :func:`plain_segments` on
    data that requires grad while grad is enabled: the kernels have no
    backward.  The layout was checked where it was built; the data is
    checked here in one test, its message built only on failure."""
    if layout is not None:
        if layout.ids is not segment_ids:
            raise ValueError(f"{name}: the layout was built from another id "
                             "tensor")
        if layout.num_segments != num_segments:
            raise ValueError(f"{name}: layout has {layout.num_segments} "
                             f"segments, expected {num_segments}")
    if _PLAIN_SEGMENTS.get():
        return None
    if data.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f"{name} has no backward: call it under "
                           "torch.no_grad() or inside plain_segments(), or "
                           "use the plain version")
    if not data.is_cuda:
        if data.is_cpu:
            return None
        raise ValueError(f"{name}: unsupported device {data.device}")
    if layout is None:
        layout = segment_layout(segment_ids, num_segments)
    ids = layout.ids
    if not (data.shape == ids.shape and data.device == ids.device
            and data.is_contiguous()):
        check_tensor("data", data, torch.float32, tuple(ids.shape),
                     ids.device)
    return layout


def _check_err(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def segment_sum(data, segment_ids, num_segments: int,
                layout: SegmentLayout | None = None):
    """Sum per segment (K9 for float32 1-D data on a CUDA tensor)."""
    global SUM_LAUNCHES
    if not _kernel_ok(data):
        return segment_sum_plain(data, segment_ids, num_segments)
    layout = _route("segment_sum", data, segment_ids, num_segments, layout)
    if layout is None:
        return segment_sum_plain(data, segment_ids, num_segments)
    out = data.new_empty(num_segments)
    _check_err("segment_sum", _kernel_fns()[0](
        data.data_ptr(), *layout.pointers, num_segments, out.data_ptr(),
        current_stream(data.device)))
    SUM_LAUNCHES += 1
    return out


def segment_max(data, segment_ids, num_segments: int,
                layout: SegmentLayout | None = None):
    """Max per segment, ``NEG_LARGE`` when empty (K10 for float32 1-D
    data on a CUDA tensor).  Other dtypes and ranks: the reduction with the
    dtype's lowest value for an empty segment, as XLA's."""
    global MAX_LAUNCHES
    if not _kernel_ok(data):
        return _reduce(data, segment_ids, num_segments, "amax")
    layout = _route("segment_max", data, segment_ids, num_segments, layout)
    if layout is None:
        return segment_max_plain(data, segment_ids, num_segments)
    out = data.new_empty(num_segments)
    _check_err("segment_max", _kernel_fns()[1](
        data.data_ptr(), *layout.pointers, num_segments, out.data_ptr(),
        current_stream(data.device)))
    MAX_LAUNCHES += 1
    return out


def segment_argmax(scores, segment_ids, num_segments: int,
                   layout: SegmentLayout | None = None):
    """Lowest index of each segment's max score, ``len(scores)`` for a
    segment without a finite one (K11 on a CUDA tensor).  int32."""
    global ARGMAX_LAUNCHES
    if scores.dim() != 1:
        raise ValueError(f"segment_argmax takes 1-D scores, got rank "
                         f"{scores.dim()}")
    if not _kernel_ok(scores):
        return segment_argmax_plain(scores, segment_ids, num_segments)
    layout = _route("segment_argmax", scores, segment_ids, num_segments,
                    layout)
    if layout is None:
        return segment_argmax_plain(scores, segment_ids, num_segments)
    out = scores.new_empty(num_segments, dtype=torch.int32)
    _check_err("segment_argmax", _kernel_fns()[2](
        scores.data_ptr(), *layout.pointers, num_segments, scores.shape[0],
        out.data_ptr(), current_stream(scores.device)))
    ARGMAX_LAUNCHES += 1
    return out


def segment_action(logits, segment_ids, num_segments: int,
                   layout: SegmentLayout | None = None,
                   temperature: float = 1.0, key: rng.Key | None = None):
    """The multi-hot bool[E] of one element per segment: the argmax of
    ``logits / temperature`` (no key; ``GraphDistribution.mode``) or of
    that plus ``jax.random.gumbel(key, (E,))`` where it is finite
    (``sample``), ties to the lowest index; a segment without a finite
    score selects nothing.  K11's action entry on a CUDA tensor (one
    launch, the noise drawn inside), :func:`segment_action_plain` on a CPU
    tensor.  Float32 1-D logits only."""
    global ARGMAX_LAUNCHES
    if not _kernel_ok(logits):
        raise TypeError(f"segment_action takes float32 1-D logits, got "
                        f"{logits.dtype} of rank {logits.dim()}")
    layout = _route("segment_action", logits, segment_ids, num_segments,
                    layout)
    if layout is None:
        return segment_action_plain(logits, segment_ids, num_segments,
                                    None, temperature, key)
    k1, k2 = (0, 0) if key is None else rng.key_words(key)
    e = logits.shape[0]
    out = torch.empty(e, dtype=torch.bool, device=logits.device)
    _check_err("segment_action", _kernel_fns()[3](
        logits.data_ptr(), *layout.pointers, num_segments, e, temperature,
        key is not None, k1, k2, out.data_ptr(),
        current_stream(logits.device)))
    ARGMAX_LAUNCHES += 1
    return out


def _log_prob_route(name: str, logits, segment_ids, num_segments: int,
                    layout):
    """:func:`_route` for K10's log-prob entries and float32 1-D logits,
    which outside :func:`plain_segments` also refuse, on every device, a
    layout that dropped an id (built here when not given)."""
    if _PLAIN_SEGMENTS.get():
        return _route(name, logits, segment_ids, num_segments, layout)
    if layout is None:
        layout = segment_layout(segment_ids, num_segments)
    routed = _route(name, logits, segment_ids, num_segments, layout)
    if layout.dropped:
        raise ValueError(f"{name}: a segment id lies outside "
                         f"[0, {num_segments})")
    return routed


def segment_log_probs(logits, segment_ids, num_segments: int,
                      layout: SegmentLayout | None = None,
                      temperature: float = 1.0):
    """The log-softmax of ``logits / temperature`` within each segment
    (``GraphDistribution.log_probs``): K10's entry without an action on a
    CUDA tensor (one launch), :func:`segment_log_probs_plain` on a CPU
    tensor, for float32 1-D logits with every id in range.  Other dtypes
    and ranks take the composition on every device, whose max and sum are
    then plain PyTorch, as at the reference's generic op."""
    global MAX_LAUNCHES
    if not _kernel_ok(logits):
        return segment_log_probs_plain(logits, segment_ids, num_segments,
                                       layout, temperature, KERNELS)
    layout = _log_prob_route("segment_log_probs", logits, segment_ids,
                             num_segments, layout)
    if layout is None:
        return segment_log_probs_plain(logits, segment_ids, num_segments,
                                       None, temperature)
    out = torch.empty_like(logits)
    _check_err("segment_log_probs", _kernel_fns()[4](
        logits.data_ptr(), *layout.pointers, num_segments, temperature,
        None, out.data_ptr(), None, current_stream(logits.device)))
    MAX_LAUNCHES += 1
    return out


def segment_log_prob(logits, action, segment_ids, num_segments: int,
                     layout: SegmentLayout | None = None,
                     temperature: float = 1.0):
    """The joint log-probability of the multi-hot bool ``action`` under
    the per-segment softmax of ``logits / temperature``, ``-inf`` unless
    every segment with elements activates exactly one
    (``GraphDistribution.log_prob``).  On a CUDA tensor K10's entry writes
    each element's masked log-prob and an invalid-action flag in one
    launch after a memset; ``torch.sum`` of those, as
    :func:`segment_log_prob_plain` (which a CPU tensor takes) sums its
    masked vector, with ``-inf`` filled where the flag is set, is the
    result.  Float32 1-D logits (raises otherwise); every id in range."""
    global MAX_LAUNCHES
    if not _kernel_ok(logits):
        raise TypeError(f"segment_log_prob takes float32 1-D logits, got "
                        f"{logits.dtype} of rank {logits.dim()}")
    layout = _log_prob_route("segment_log_prob", logits, segment_ids,
                             num_segments, layout)
    if not (action.dtype == torch.bool and action.shape == logits.shape
            and action.device == logits.device and action.is_contiguous()):
        check_tensor("action", action, torch.bool, tuple(logits.shape),
                     logits.device)
    if layout is None:
        return segment_log_prob_plain(logits, action, segment_ids,
                                      num_segments, None, temperature)
    dev = logits.device
    contrib = torch.empty_like(logits)
    invalid = torch.empty((), dtype=torch.bool, device=dev)
    _check_err("segment_log_prob", _kernel_fns()[4](
        logits.data_ptr(), *layout.pointers, num_segments, temperature,
        action.data_ptr(), contrib.data_ptr(), invalid.data_ptr(),
        current_stream(dev)))
    MAX_LAUNCHES += 1
    # masked_fill_ takes its scalar by value; torch.where would first
    # fill a device tensor with it (one more kernel).
    return torch.sum(contrib).masked_fill_(invalid, float("-inf"))


def _identity(dtype, reduce: str):
    if dtype.is_floating_point:
        return float("inf") if reduce == "amin" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if reduce == "amin" else info.min


def _reduce(data, segment_ids, num_segments: int, reduce: str):
    """XLA's segment min/max: out-of-range ids dropped, an empty segment
    holds the reduction's identity."""
    key = _drop_key(segment_ids, num_segments)
    shape = (num_segments + 1,) + tuple(data.shape[1:])
    out = torch.full(shape, _identity(data.dtype, reduce), dtype=data.dtype,
                     device=data.device)
    index = key.reshape((-1,) + (1,) * (data.dim() - 1)).expand(data.shape)
    out.scatter_reduce_(0, index, data, reduce, include_self=False)
    return out[:num_segments]


def segment_min(data, segment_ids, num_segments: int):
    """Min per segment (plain on every device; +inf or the dtype's max for
    an empty segment)."""
    return _reduce(data, segment_ids, num_segments, "amin")


class SegmentOps(NamedTuple):
    """The sum, max, argmax, action, log-softmax and log-prob that the
    composite ops below and ``GraphDistribution`` call: :data:`KERNELS`
    (the wrappers) or :data:`PLAIN` (the plain versions on any device, the
    override for comparing a run with the kernels' against one without
    them).  Each takes ``(data, segment_ids, num_segments, layout)``, the
    action also ``(temperature, key)``, ``log_probs`` also
    ``temperature``; ``log_prob`` takes ``(logits, action, segment_ids,
    num_segments, layout, temperature)``.  The plain versions ignore the
    layout."""

    sum: Callable
    max: Callable
    argmax: Callable
    action: Callable
    log_probs: Callable
    log_prob: Callable


KERNELS = SegmentOps(segment_sum, segment_max, segment_argmax,
                     segment_action, segment_log_probs, segment_log_prob)
PLAIN = SegmentOps(segment_sum_plain, segment_max_plain, segment_argmax_plain,
                   segment_action_plain, segment_log_probs_plain,
                   segment_log_prob_plain)


def _shifted(logits, segment_ids, num_segments, layout, ops):
    seg_max = ops.max(logits, segment_ids, num_segments, layout)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    return logits - seg_max[segment_ids.long()]


def segment_softmax(logits, segment_ids, num_segments: int,
                    layout: SegmentLayout | None = None,
                    ops: SegmentOps = KERNELS):
    """Softmax within each segment, stabilised by the segment max."""
    expd = torch.exp(_shifted(logits, segment_ids, num_segments, layout, ops))
    denom = ops.sum(expd, segment_ids, num_segments, layout)
    return expd / torch.clamp(denom[segment_ids.long()], min=1e-30)


def segment_log_softmax(logits, segment_ids, num_segments: int,
                        layout: SegmentLayout | None = None,
                        ops: SegmentOps = KERNELS):
    """Log-softmax within each segment: ``ops.log_probs`` at temperature
    1 (with :data:`KERNELS` one launch of K10's entry on the card for
    float32 1-D logits, which it refuses where they require grad: pass
    :data:`PLAIN`, or call it inside :func:`plain_segments`, for a
    differentiable one)."""
    return ops.log_probs(logits, segment_ids, num_segments, layout, 1.0)


def segment_sample(key: rng.Key, logits, segment_ids, num_segments: int,
                   layout: SegmentLayout | None = None,
                   ops: SegmentOps = KERNELS):
    """One element per segment with probability ``softmax(logits)`` by the
    Gumbel-max trick; the noise is ``jax.random.gumbel(key, logits.shape)``
    (threefry, bit for bit but for ``log``'s last ulp).  ``len(logits)``
    for a segment with no finite logit.  int32."""
    g = rng.gumbel(key, tuple(logits.shape), logits.device)
    scores = torch.where(torch.isfinite(logits), logits + g, float("-inf"))
    return ops.argmax(scores, segment_ids, num_segments, layout)
