"""The benchmark's plain reference of the simulator: a frozen copy, in plain
PyTorch and numpy, of the plain code paths of ``tarl_tpu_torch`` that the
benchmark's cells drive (network build with its road renumbering, agent
and road state, windowed and backlog inserts, withdraw, the direction
winner and confirm, the random choice, the destination-restricted
shortest-path policy with its Bellman-Ford relax, and the episode loops).

It imports nothing of the program and no kernel: every step is the plain
version that the program's kernels are held bitwise to.  The harness
builds it from the same generated arrays as the program and compares the
program's states and tick logs with it, element for element.
"""
