"""The comparison that decides ``correct`` fails where it must: its
control (the reference in bfloat16 time stamps, in the program's place)
and runs whose timed path is broken underneath come out not correct, and a
sound run comes out correct, in every cell, at a tiny size on the CPU.

The faults planted in the program: a tick that returns its state
unchanged; the direction winner computed for half of the roads only; the
arrival stamps altered where the withdraw produces them.  A cell on one
chip has no exchange between chips to leave out.
"""
import pytest
import torch

CELLS = ["grid128_1m.sp", "grid128_1m.random", "city9k_250k.sp",
         "city9k_250k.random"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, run_tiny, cell):
    res = run_tiny(tiny_root, cell, seed=2 ** 31 + 11)
    assert res["correct"], res["checks"]
    assert all(c["value"] == 0 for c in res["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_comes_out_not_correct(tiny_root, cell):
    from portbench.control import control_readings

    out = control_readings(tiny_root, cell, 4, torch.device("cpu"))
    assert not out["correct"]
    assert out["start_mismatch"]["value"] > 0


def _unchanged_step(monkeypatch):
    from tarl_tpu_torch.core import step

    real = step.tick

    def tick(state, *args, **kw):
        _, log = real(state, *args, **kw)
        return state, log

    monkeypatch.setattr(step, "tick", tick)


def _half_the_roads(monkeypatch):
    from tarl_tpu_torch.core import fused_winner
    from tarl_tpu_torch.core.response import popped_mask

    real = fused_winner.direction_confirm_plain

    def confirm(road, *args, **kw):
        accept, win, agent, dest, _ = real(road, *args, **kw)
        accept = accept.clone()
        accept[accept.shape[0] // 2:] = False
        return accept, win, agent, dest, popped_mask(accept, win)

    monkeypatch.setattr(fused_winner, "direction_confirm_plain", confirm)


def _altered_arrival(monkeypatch):
    from tarl_tpu_torch.core import step

    real = step.withdraw_agents

    def withdraw(road, agents, *args, **kw):
        road2, agents2, wcount = real(road, agents, *args, **kw)
        moved = agents2.arrival != agents.arrival
        return road2, agents2._replace(
            arrival=torch.where(moved, agents2.arrival + 1.0,
                                agents2.arrival)), wcount

    monkeypatch.setattr(step, "withdraw_agents", withdraw)


@pytest.mark.parametrize("fault,cell", [
    (_unchanged_step, "grid128_1m.sp"),
    (_unchanged_step, "city9k_250k.random"),
    (_half_the_roads, "grid128_1m.random"),
    (_half_the_roads, "city9k_250k.sp"),
    (_altered_arrival, "grid128_1m.sp"), (_altered_arrival, "city9k_250k.sp"),
])
def test_broken_timed_path_is_not_correct(tiny_root, run_tiny, monkeypatch,
                                          fault, cell):
    fault(monkeypatch)
    res = run_tiny(tiny_root, cell, seed=77)
    assert not res["correct"], res["checks"]
