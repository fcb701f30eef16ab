"""Agent rows (the population and the dummy row 0) times the ticks run in
the window, over the window's seconds to a synchronise: ``bench.py``'s
agent-steps per second."""


def read(run):
    return run.agent_rows * run.ticks / run.window_s
