"""The port's node-sharded PPO updates (``parallel/sharded_ppo.py``)
against the JAX reference's ``ShardedPPO`` on its 8-device CPU mesh.

Braess, 8 collection steps, two epochs of two minibatches of 4, the
reference's ``tests/test_sharded_ppo.py`` settings, for the MPNN with its
distance prior and for the Graph Transformer (``hidden 8``, 2 layers of 2
heads, the graph critic), each on S = 2 and 4 node-column blocks (Braess's
14 nodes padded to 16 on 4 blocks).  Parameters, state and key are
carried from the reference's ``init`` with ``convert``.  The transformer's
node encoding is a seeded normal draw, the same in every run: the
Laplacian encoding is another basis at each call (fault R4), and this
untrained net's gradients reach ~1e11 on Braess's near-uniform edge
features, where the reference's elementwise bar sits within a small
factor of float32's reordering noise and that factor depends on the
draw (on one Laplacian draw both packages' own sharded and unsharded
gradients differed by 0.87 of the bar).

* ``_grads`` on the reference's own trajectory: the gradients against the
  reference's sharded gradients and against the port's unsharded
  ``PPO._loss_and_grads`` at the reference's bars (rtol 2e-5, atol 1e-6
  for the MPNN; rtol 1e-4, atol 1e-5 for the transformer, whose twin
  reorders the softmax sums), the loss and aux terms at rtol 1e-4.
* One ``train_iteration`` from the same state: the trajectory bitwise the
  reference's (actions, dones, rewards, contexts), the keys and the
  environment's clock and arrivals equal, the loss at rtol 1e-4 (1e-3)
  and atol 1e-5 (the updates after the first start from parameters that
  Adam's noise moved apart),
  the parameters at rtol 1e-3, atol 5e-3 (Adam steps an element whose
  gradient is rounding noise by up to the rate either way).
* A float64 witness on a Laplacian draw (ARPACK seeded), where the
  port's float32 sharded gradients miss the reference's bar at an element:
  in float64 the sharded gradients equal the unsharded ones to rtol
  1e-10, and each element beyond the bar is a cancellation-dominated
  edge-branch bias.
"""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from tarl_tpu.config import RLConfig
from tarl_tpu.core.step import Policy, init_sim_state
from tarl_tpu.models import mpnn as r_mpnn
from tarl_tpu.models.transformer import agent as r_agent
from tarl_tpu.parallel.sharded_ppo import ShardedPPO as RefShardedPPO
from tarl_tpu.parallel.sharded_ppo import make_node_mesh as ref_node_mesh
from tarl_tpu.rl.gae import gae, normalize
from tarl_tpu.rl.ppo import PPO
from tarl_tpu.routing.policies import random_choice

from tarl_tpu_torch import convert
from tarl_tpu_torch.config import RLConfig as PortRLConfig
from tarl_tpu_torch.core import rng as p_rng
from tarl_tpu_torch.core import step as p_step
from tarl_tpu_torch.models import mpnn as p_mpnn
from tarl_tpu_torch.models.transformer import agent as p_agent
from tarl_tpu_torch.parallel.sharded_ppo import ShardedPPO, make_node_mesh
from tarl_tpu_torch.rl.ppo import PPO as PortPPO
from tarl_tpu_torch.rl.ppo import Transition as PortTransition
from tarl_tpu_torch.routing.policies import random_choice as p_random_choice

from test_torch_network import load_both

torch.set_num_threads(1)

RL_KW = dict(rollout_steps=8, minibatch_size=4, num_epochs=2,
             entropy_coef=0.01)
# net: (gradient rtol, atol, loss rtol)
BARS = {"mpnn": (2e-5, 1e-6, 1e-4), "transformer": (1e-4, 1e-5, 1e-3)}
PARAM_RTOL, PARAM_ATOL = 1e-3, 5e-3


def _key(k) -> tuple:
    return tuple(int(w) for w in np.asarray(k))


def _port_tree(tree) -> dict:
    return convert.mpnn_params_from_numpy(jax.tree.map(np.asarray, tree),
                                          device="cpu")


def _close(want: dict, got: dict, rtol, atol, what: str) -> None:
    for part in want:
        assert sorted(want[part]) == sorted(got[part]), what
        for k in want[part]:
            np.testing.assert_allclose(got[part][k].numpy(),
                                       want[part][k].numpy(), rtol=rtol,
                                       atol=atol, err_msg=f"{what} {part} {k}")


def _both(scen, kind: str, pe=None):
    """The reference's and the port's PPO, and the reference's ``init``
    state with the port's carried from it; the transformer's encoding
    ``pe`` (default: the seeded normal draw)."""
    net, agents, pnet, pagents = scen
    st = init_sim_state(net, agents, policy=Policy(choice=random_choice))
    pst = p_step.init_sim_state(pnet, pagents,
                                policy=p_step.Policy(choice=p_random_choice))
    if kind == "transformer":
        if pe is None:
            pe = np.random.default_rng(8).standard_normal(
                (net.num_nodes, 8)).astype(np.float32)
        nets = dict(hidden_dim=8, num_heads=2)
        ref = PPO(net, r_agent.TransformerRoutePolicy(pe=pe, num_layers=2,
                                                      **nets),
                  r_agent.TransformerValueNet(pe=pe, num_layers=1, **nets),
                  rl=RLConfig(**RL_KW), value_uses_graph=True)
        port = PortPPO(pnet, p_agent.TransformerRoutePolicy(
            pe, num_layers=2, **nets),
            p_agent.TransformerValueNet(pe, num_layers=1, **nets),
            rl=PortRLConfig(**RL_KW), value_uses_graph=True)
    else:
        ref = PPO(net, r_mpnn.MPNNPolicyNet(
            num_nodes=net.num_nodes, num_node_embeddings=net.num_roads + 1,
            use_distance_prior=True, prior_scale=30.0),
            r_mpnn.MPNNValueNetSimple(), rl=RLConfig(**RL_KW))
        port = PortPPO(pnet, p_mpnn.MPNNPolicyNet(
            pnet.num_nodes, pnet.num_roads + 1, use_distance_prior=True,
            prior_scale=30.0), p_mpnn.MPNNValueNetSimple(pnet.num_nodes),
            rl=PortRLConfig(**RL_KW))
    ts = ref.init(st, jax.random.PRNGKey(0))
    params = _port_tree(ts.params)
    pts = port.init(pst, p_rng.prng_key(0), torch.Generator())
    pts = pts._replace(params=params, opt_state=port.optimizer.init(params),
                       key=_key(ts.key))
    return ref, port, ts, pts


@pytest.fixture(scope="module")
def braess(tmp_path_factory):
    return load_both(str(tmp_path_factory.mktemp("torch_sppo")), "Braess")


def _batches(ref, ts):
    """The reference's rollout from ``ts`` with its normalised advantages
    and returns, and the same as the port's tensors."""
    _, _, _, traj, last = jax.jit(ref._rollout)(ts.params, ts.env, ts.obs,
                                                ts.key)
    adv, ret = gae(traj.reward, traj.value, last, traj.done, ref.rl.gamma,
                   ref.rl.gae_lambda)
    adv = normalize(adv)
    pbatch = (PortTransition(*(torch.tensor(np.asarray(a)) for a in traj)),
              torch.tensor(np.asarray(adv)), torch.tensor(np.asarray(ret)))
    return (traj, adv, ret), pbatch


@pytest.fixture(scope="module", params=["mpnn", "transformer"])
def setup(request, braess):
    kind = request.param
    ref, port, ts, pts = _both(braess, kind)
    batch, pbatch = _batches(ref, ts)
    (_, _), want = jax.value_and_grad(ref._loss, has_aux=True)(
        ts.params, *batch)
    (_, _), pwant = port._loss_and_grads(pts.params, *pbatch)
    return dict(kind=kind, ref=ref, port=port, ts=ts, pts=pts, batch=batch,
                pbatch=pbatch, unsharded=_port_tree(want),
                port_unsharded=pwant)


@pytest.mark.parametrize("blocks", [2, 4])
def test_sharded_grads_match_the_reference(setup, blocks):
    rtol, atol, loss_rtol = BARS[setup["kind"]]
    ref_sh = RefShardedPPO(setup["ref"], ref_node_mesh(blocks))
    (loss, aux), grads = jax.jit(ref_sh._grads)(setup["ts"].params,
                                                *setup["batch"])
    port_sh = ShardedPPO(setup["port"], make_node_mesh(blocks, "cpu"))
    assert port_sh._attention == (setup["kind"] == "transformer")
    (ploss, paux), pgrads = port_sh._grads(setup["pts"].params,
                                           *setup["pbatch"])
    np.testing.assert_allclose(float(ploss), float(loss), rtol=loss_rtol)
    for a, b in zip(aux, paux):
        np.testing.assert_allclose(float(b), float(a), rtol=loss_rtol,
                                   atol=1e-5)
    _close(_port_tree(grads), pgrads, rtol, atol, "reference sharded")
    _close(setup["unsharded"], pgrads, rtol, atol, "reference unsharded")
    _close(setup["port_unsharded"], pgrads, rtol, atol, "port unsharded")


@pytest.mark.parametrize("blocks", [2, 4])
def test_sharded_train_iteration_matches_the_reference(setup, blocks):
    _, _, loss_rtol = BARS[setup["kind"]]
    ts, pts = setup["ts"], setup["pts"]
    ref_sh = RefShardedPPO(setup["ref"], ref_node_mesh(blocks))
    ts1, metrics = ref_sh.train_iteration(ts)
    trajs = []
    port = setup["port"]
    collect = port.collect_rollout

    def keep(*args, **kw):
        out = collect(*args, **kw)
        trajs.append(out[3])
        return out

    port.collect_rollout = keep
    try:
        pts1, pmetrics = ShardedPPO(
            port, make_node_mesh(blocks, "cpu")).train_iteration(pts)
    finally:
        port.collect_rollout = collect
    _, _, _, traj, _ = jax.jit(setup["ref"]._rollout)(ts.params, ts.env,
                                                      ts.obs, ts.key)
    for f in ("action", "done", "reward", "x", "time", "on_network"):
        np.testing.assert_array_equal(getattr(trajs[0], f).numpy(),
                                      np.asarray(getattr(traj, f)), f)
    assert pts1.key == _key(ts1.key)
    assert pts1.iteration == int(ts1.iteration) == 1
    assert pts1.opt_state.count == 4
    assert float(pts1.env.sim.time) == float(ts1.env.sim.time)
    np.testing.assert_array_equal(pts1.env.sim.agents.arrival.numpy(),
                                  np.asarray(ts1.env.sim.agents.arrival))
    # The later updates start from parameters Adam's noise moved apart.
    np.testing.assert_allclose(float(pmetrics.loss_total),
                               float(metrics.loss_total), rtol=loss_rtol,
                               atol=1e-5)
    _close(_port_tree(ts1.params), pts1.params, PARAM_RTOL, PARAM_ATOL,
           "parameters")


def _laplacian(pnet, dim: int, seed: int) -> np.ndarray:
    """Braess's Laplacian encoding as ``embedding.
    laplacian_positional_encoding`` draws it, with ARPACK started from a
    seeded vector, so the draw is the same in every run."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph
    from scipy.sparse.linalg import eigsh

    src, dst, n = pnet.edge_src.numpy(), pnet.edge_dst.numpy(), pnet.num_roads
    a = sp.coo_matrix((np.ones(len(src)), (src, dst)), shape=(n, n)).tocsr()
    lap = csgraph.laplacian((a + a.T) / 2, normed=True)
    w, v = eigsh(lap, k=min(dim + 5, n - 1), which="SM",
                 v0=np.random.default_rng(seed).standard_normal(n))
    order = np.argsort(w)
    v = v[:, order][:, w[order] > 1e-5][:, :dim]
    pe = np.zeros((pnet.num_nodes, dim), dtype=np.float32)
    pe[:n, :v.shape[1]] = v / np.linalg.norm(v, axis=0, keepdims=True)
    return pe


def _float64(port, pnet):
    """A float64 copy of the transformer ``port``'s PPO: its nets and its
    edge features."""
    net64 = dataclasses.replace(pnet, full_attr=pnet.full_attr.double())
    return PortPPO(net64, copy.deepcopy(port.policy_net).double(),
                   copy.deepcopy(port.value_net).double(), rl=port.rl,
                   value_uses_graph=True)


def test_sharded_transformer_grads_float64_witness(braess, monkeypatch):
    """On a Laplacian encoding (ARPACK seeded; R4), the float32 gradients
    of this untrained net sit at the reference's elementwise bar: on this
    draw the port's sharded gradients miss the reference's by more than
    rtol 1e-4, atol 1e-5 at one element.  Two witnesses that this is
    float32 rounding and not a fault of the twin's padding or of the
    gather's backward:

    * in float64 the port's sharded gradients (S = 2 and 4) equal the
      float64 unsharded gradients to rtol 1e-10, atol 1e-11;
    * every element beyond the reference's bar (the port's float32
      sharded gradients against the reference's sharded or unsharded
      ones) is cancellation-dominated: an edge-branch bias (a sum over
      every edge of every row) whose float64 value is below 1e-2 of its
      tensor's largest.

    ``pytest -s`` prints each such element with its float64 value, the
    tensor's largest, and how far each float32 gradient (the reference's
    unsharded and sharded, the port's unsharded and sharded) lies from
    the float64 one, in units of the bar."""
    from tarl_tpu_torch.models.transformer import slot_forward

    _, _, pnet, _ = braess
    pe = _laplacian(pnet, 8, seed=1)
    ref, port, ts, pts = _both(braess, "transformer", pe=pe)
    batch, pbatch = _batches(ref, ts)
    rtol, atol, _ = BARS["transformer"]

    def bars(got, want):
        """``|got - want|`` in units of the bar at ``want``."""
        return {p: {k: ((got[p][k].double() - want[p][k]).abs()
                        / (atol + rtol * want[p][k].abs()))
                    for k in want[p]} for p in want}

    # The float32 gradients.
    _, ref_u = jax.value_and_grad(ref._loss, has_aux=True)(ts.params, *batch)
    f32 = {"reference": _port_tree(ref_u),
           "port": port._loss_and_grads(pts.params, *pbatch)[1]}
    for blocks in (2, 4):
        _, ref_s = jax.jit(RefShardedPPO(ref, ref_node_mesh(blocks))._grads)(
            ts.params, *batch)
        f32[f"reference S={blocks}"] = _port_tree(ref_s)
        f32[f"port S={blocks}"] = ShardedPPO(
            port, make_node_mesh(blocks, "cpu"))._grads(pts.params,
                                                        *pbatch)[1]

    # The float64 gradients: the twin and its tables (float32 by
    # construction) lifted with the nets.
    tables = slot_forward.slot_edge_tables
    twin = slot_forward.slot_twin
    monkeypatch.setattr(slot_forward, "slot_edge_tables", lambda net: type(
        tables(net))(*(t.double() if t.is_floating_point() else t
                       for t in tables(net))))
    monkeypatch.setattr(slot_forward, "slot_twin",
                        lambda *a, **kw: twin(*a, **kw).double())
    p64 = _float64(port, pnet)
    params64 = {p: {k: v.double() for k, v in sub.items()}
                for p, sub in pts.params.items()}
    batch64 = (PortTransition(*(a.double() if a.is_floating_point() else a
                                for a in pbatch[0])),
               pbatch[1].double(), pbatch[2].double())
    _, want64 = p64._loss_and_grads(params64, *batch64)
    for blocks in (2, 4):
        _, got64 = ShardedPPO(p64, make_node_mesh(blocks, "cpu"))._grads(
            params64, *batch64)
        _close(want64, got64, 1e-10, 1e-11, f"float64, S = {blocks}")

    to64 = {name: bars(g, want64) for name, g in f32.items()}
    flagged = set()
    for blocks in (2, 4):
        got = f32[f"port S={blocks}"]
        for want in (f32[f"reference S={blocks}"], f32["reference"]):
            for p, sub in bars(got, want).items():
                for k, b in sub.items():
                    flagged |= {(p, k, j) for j in
                                (b.flatten() > 1).nonzero().flatten().tolist()}
    for p, k, j in sorted(flagged):
        value = float(want64[p][k].flatten()[j])
        largest = float(want64[p][k].abs().max())
        print(f"{p}.{k}[{j}]: float64 {value:.4g}, its tensor's largest "
              f"{largest:.4g}; float32 from float64 in bars: " + ", ".join(
                  f"{name} {float(e[p][k].flatten()[j]):.2f}"
                  for name, e in to64.items()))
        edge_bias = k.endswith(".bias") and any(
            f".{m}." in k for m in ("WE", "WOe", "ffn_e", "norm1e"))
        assert edge_bias and abs(value) < 1e-2 * largest, (p, k, j, value,
                                                           largest)
