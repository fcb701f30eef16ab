"""TARL-TPU on PyTorch and CUDA: the port of ``tarl_tpu`` to an NVIDIA
Hopper GPU.

The package mirrors the reference's layout (``tarl_tpu_torch/core/
withdraw.py`` answers to ``tarl_tpu/core/withdraw.py``) and imports torch
and numpy only.  It runs the headline episode (scenario ingestion, the
per-SRC backlog insert, withdraw, random route choice and the
direction+confirm core), the shortest-path row (primal routing) and the
learned MPNN policy's rollouts.  Their TPU kernels are hand-written CUDA
under ``csrc/`` (winner+confirm, Bellman-Ford relax, segment sum, max and
argmax), built at first use.  Tensors go to the card (``cuda``) unless
the caller passes a device.
"""

from .config import PhysicsConfig, SimConfig
from .network import Network, build_network, default_selected_road
from .state import AgentState, MetricState, RoadState, SimState

__version__ = "0.1.0"
