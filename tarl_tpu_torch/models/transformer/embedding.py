"""Positional and structural encodings for the graph transformer (ports
``tarl_tpu/models/transformer/embedding.py``).

:func:`laplacian_positional_encoding` and :func:`degree_structural_encoding`
run on the host, once per network, in numpy and scipy, as the reference's
do; the port keeps its own copy.  :class:`EmbeddingMixer` fuses node
features with both encodings.

The Laplacian encoding is not a function of the network alone (the
reference's fault R4): ``eigsh`` starts ARPACK from a random vector, so two
calls may return columns of other signs and, where an eigenvalue repeats,
another basis of its eigenspace.  Only the eigenvalues and the projector
onto each whole eigenspace are reproducible.  A trained policy must be
evaluated with the encoding it was trained with; the committed Braess
weights carry theirs.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn


def laplacian_positional_encoding(
    edge_src: np.ndarray,
    edge_dst: np.ndarray,
    num_nodes: int,
    positional_dim: int,
    total_num_nodes: Optional[int] = None,
) -> np.ndarray:
    """float32 ``[total_num_nodes, positional_dim]``: the first
    ``positional_dim`` eigenvectors of the symmetrised normalised
    Laplacian with eigenvalue above 1e-5 (``eigsh(..., which="SM")``, the
    dense ``eigh`` where ARPACK fails), each column scaled to unit norm,
    zero columns where there are too few, and zero rows for the virtual
    SRC/DEST nodes past ``num_nodes``."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph
    from scipy.sparse.linalg import eigsh

    a = sp.coo_matrix(
        (np.ones(len(edge_src)), (np.asarray(edge_src), np.asarray(edge_dst))),
        shape=(num_nodes, num_nodes),
    ).tocsr()
    a = (a + a.T) / 2
    lap = csgraph.laplacian(a, normed=True)
    k = min(positional_dim + 5, num_nodes - 1)
    try:
        eigvals, eigvecs = eigsh(lap, k=k, which="SM")
    except Exception:
        # ARPACK cannot take k >= n - 1 or may not converge on tiny graphs.
        eigvals, eigvecs = np.linalg.eigh(lap.toarray())
    order = np.argsort(eigvals)
    eigvals, eigvecs = eigvals[order], eigvecs[:, order]
    nontrivial = eigvals > 1e-5
    eigvecs = eigvecs[:, nontrivial][:, :positional_dim]

    norms = np.linalg.norm(eigvecs, axis=0, keepdims=True)
    eigvecs = eigvecs / np.maximum(norms, 1e-12)

    if eigvecs.shape[1] < positional_dim:
        eigvecs = np.pad(
            eigvecs, ((0, 0), (0, positional_dim - eigvecs.shape[1])))

    total = total_num_nodes or num_nodes
    pe = np.zeros((total, positional_dim), dtype=np.float32)
    pe[:num_nodes] = eigvecs
    return pe


def degree_structural_encoding(
    edge_src: np.ndarray, num_nodes: int,
    total_num_nodes: Optional[int] = None,
) -> np.ndarray:
    """float32 ``[total_num_nodes, 1]`` out-degree, zero past
    ``num_nodes``."""
    deg = np.bincount(np.asarray(edge_src),
                      minlength=num_nodes).astype(np.float32)
    total = total_num_nodes or num_nodes
    out = np.zeros((total, 1), dtype=np.float32)
    out[:num_nodes] = deg[:, None]
    return out


class EmbeddingMixer(nn.Module):
    """Node features, positional and structural encodings through three
    linear maps (``linear``, ``linear_positional``, ``linear_structural``),
    summed."""

    def __init__(self, in_dim: int, pe_dim: int, out_dim: int,
                 se_dim: int = 1):
        super().__init__()
        self.linear = nn.Linear(in_dim, out_dim)
        self.linear_positional = nn.Linear(pe_dim, out_dim)
        self.linear_structural = nn.Linear(se_dim, out_dim)

    def forward(self, x: torch.Tensor, pe: torch.Tensor,
                se: torch.Tensor) -> torch.Tensor:
        return (self.linear(x) + self.linear_positional(pe)
                + self.linear_structural(se))
