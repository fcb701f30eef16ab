"""TARL-TPU on PyTorch and CUDA: the port of ``tarl_tpu`` to an NVIDIA
Hopper GPU.

The package mirrors the reference's layout (``tarl_tpu_torch/core/
withdraw.py`` answers to ``tarl_tpu/core/withdraw.py``), imports torch and
numpy only, and does what the reference does: scenario ingestion (the
Python and the native MATSim parsers, the builtin and city generators),
the classical tick (backlog, windowed and whole-population inserts,
withdraw, the direction winner and confirm, or the fused core) under the
random, shortest-path (primal and dual, with ``strict_compat``) and
learned (MPNN and Graph Transformer) policies, the simulator facade and
its reports, the CLI (``main_torch.py``), MSA and the equilibrium
metrics, PPO training (single, batched, node-sharded and spatially
sharded), the road-block episodes across processes, and the upstream
simulator's packed state view (:func:`~tarl_tpu_torch.schema.pack_state`).
Its TPU kernels are hand-written CUDA under ``csrc/`` (the direction
winner and confirm, the road-block winner, the Bellman-Ford relax, the
segment sum, max and argmax, and the fused core), built at first use.
Tensors go to the card (``cuda``) unless the caller passes a device.
Importing the package builds no kernel.
"""

from .config import (
    MSAConfig,
    PhysicsConfig,
    RLConfig,
    RoutingConfig,
    SimConfig,
)
from .network import Network, build_network, default_selected_road
from .schema import (
    AgentFeatureHelpers,
    FeatureHelpers,
    ObservationFeatureHelpers,
)
from .state import (
    AgentState,
    MetricState,
    RoadState,
    SimState,
    init_agent_state,
)

__version__ = "0.1.0"
