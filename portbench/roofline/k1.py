"""K1's counts (``csrc/fused_winner.cu``: the direction winner and confirm
in one launch, its Gumbel noise drawn inside), on one tick's inputs.

Bytes: each road's count and capacity (8) and each in-slot's valid flag
(1); each valid slot's source (4), and each distinct source's head,
selection and ring departure once (12); each eligible slot's logit (4)
and, once per road with one, its canonical position (4); each winner's id
and dest (8); the clock (4); the five outputs written (14 a road).
Operations: ``OPS_PER_SLOT`` for each valid slot's eligibility and score,
``OPS_PER_DRAW`` for each eligible slot's noise.  The data-dependent terms
(eligible slots, winners) come from the benchmark's reference, evaluated
on the program's inputs.
"""
from __future__ import annotations

from .peaks import least_seconds

# The eligibility's decode and compares, the score's add and the running
# max, for each valid in-slot.
OPS_PER_SLOT = 20
# One draw: the threefry block's 117 integer operations (key schedule, 20
# rounds of add, rotate and xor), the xor, shift and scale of the uniform,
# and the Gumbel transform and compare, each log counted as one.
OPS_PER_DRAW = 130


def least(net, road, selected_road, time: float, key,
          physics) -> tuple[float, str]:
    """K1's least seconds on this tick's inputs (reference types), and
    what bounds it; ``key`` is the tick's direction key."""
    from ..reference.core import direction_confirm_plain, eligible_slots

    r = net.num_roads
    ok = net.in_edge_ok
    valid = int(ok.sum())
    sources = int(net.in_src_tab[ok].unique().numel())
    eligible = eligible_slots(road, selected_road, net, time, physics)
    drawn = int(eligible.sum())
    roads_drawing = int(eligible.any(dim=0).sum())
    wins = int(direction_confirm_plain(road, selected_road, net, time, key,
                                       physics)[0].sum())
    moved = (8 * r + ok.numel() + 4 * valid + 12 * sources + 4 * drawn
             + 4 * roads_drawing + 8 * wins + 4 + 14 * r)
    return least_seconds(moved, OPS_PER_SLOT * valid + OPS_PER_DRAW * drawn)


def share_pct(run) -> float | None:
    """K1's mean least time over the kept inputs, over its mean device
    time a call in the traced span, in percent; None where the span holds
    no K1 launch or no input was kept."""
    from ..reference.rng import split
    from ..trace import device_time_ns

    if run.trace is None or not run.tick_inputs:
        return None
    times = device_time_ns(run.trace, "fw_winner_kernel")
    if not times:
        return None
    ref = run.ref
    bounds = [least(ref.net, ref.adopt(road), sel, time, split(key)[1],
                    ref.physics)[0]
              for road, sel, time, key in run.tick_inputs]
    return 100.0 * (sum(bounds) / len(bounds)) / (sum(times) / len(times)
                                                  / 1e9)
