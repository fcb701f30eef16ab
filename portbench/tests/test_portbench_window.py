"""The window's calls of the program: the first replay is cut into the
same four calls whatever the seed (the comparison keeps states at their
bounds), a traced one also where the traced spans begin and end, and
every later replay is one call of the episode, as a user makes it."""
import pytest


@pytest.fixture
def calls(monkeypatch):
    from portbench.drivers import episode

    seen = []
    real = episode.Program.run

    def run(self, state, ticks):
        seen.append(ticks)
        return real(self, state, ticks)

    monkeypatch.setattr(episode.Program, "run", run)
    return seen


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5])
def test_first_replay_is_four_calls(tiny_root, run_tiny, calls, seed):
    from portbench import harness

    res = run_tiny(tiny_root, "grid128_1m.random", seed=seed)
    sp = harness.spans(harness.find_cell(tiny_root, "grid128_1m.random",
                                         False), seed)
    assert res["correct"]
    assert calls == [sp.warmup, sp.span, sp.k0 - sp.span, sp.span,
                     sp.ticks - sp.k0 - sp.span]


def test_later_replays_are_one_call_each(tiny_root, run_tiny, calls):
    first = run_tiny(tiny_root, "city9k_250k.sp", trace=True)
    calls.clear()
    res = run_tiny(tiny_root, "city9k_250k.sp",
                   seconds=2.5 * first["replay_s"][0])
    assert len(res["replay_s"]) >= 2
    assert calls[5:] == [res["attempted"] // len(res["replay_s"])] * (
        len(res["replay_s"]) - 1)
