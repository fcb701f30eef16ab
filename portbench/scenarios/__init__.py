"""Network and population generators, one module per network kind, each
with ``network(cfg)`` and ``population(cfg, net, seed)``."""
