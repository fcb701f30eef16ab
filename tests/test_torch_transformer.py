"""The port's Graph Transformer stack (``tarl_tpu_torch/models/transformer``)
against the JAX reference, on the CPU (Grid4x4: N = 80, E = 248; Braess).

Each test feeds one positional encoding and one parameter set, carried
from a Flax ``init`` through ``convert.mpnn_params_from_numpy``, to
both packages, with inputs made by numpy from a seed.

* Forwards at atol/rtol 2e-5 (float32 products summed in another order,
  and torch's two-pass LayerNorm variance against Flax's ``E[x^2] -
  E[x]^2``): ``MLP`` with each activation; ``GTConv`` with the gate on and
  off under ``sum``, ``sum+mean`` and ``sum+mean+max``; the raw
  ``GraphTransformerNet`` and its heads (``zero_var`` and the log-variance
  ``std``); ``TransformerRoutePolicy``, ``TransformerValueNet`` and the
  slot-major twin against Flax's and against the port's flat forward.
* The batched pass: ``x[B, N, C]`` equals B single passes, the logits
  bitwise, the values (a pooled sum over nodes) at rtol 1e-6.
* The positional encoding against the reference's (R4: ARPACK's random
  start makes the columns themselves irreproducible): shapes, the zero
  rows, the columns' Rayleigh quotients within 1e-5 and the projector
  ``V V^T`` of every eigenvalue cluster lying whole inside the columns.
* ``init_params`` against Flax's ``init``: the same names and shapes, and
  the law as ``test_torch_train.py::test_init_draws_the_references_law``
  holds it (kernels ``lecun_normal``, biases 0, LayerNorm scale 1).
* The committed ``braess_transformer_best.npz`` through ``convert``, both
  ways, and against the Orbax restore of the recorded checkpoint.
* One ``train_iteration`` (32 steps, 2 epochs, minibatch 16: four
  updates) against the reference's at ``test_torch_train.py``'s
  tolerances: the trajectory's key, clock and done flags equal, the
  metrics at rtol 1e-5, the parameters within 1e-5 in at least 99% of the
  elements and every element within Adam's reach, twice the rate an
  update.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from tarl_tpu.config import RLConfig
from tarl_tpu.core.step import Policy, init_sim_state
from tarl_tpu.models.transformer import agent as r_agent
from tarl_tpu.models.transformer import embedding as r_emb
from tarl_tpu.models.transformer.gt_conv import GTConv
from tarl_tpu.models.transformer.mlp import MLP
from tarl_tpu.models.transformer.model import GraphTransformerNet
from tarl_tpu.models.transformer.slot_forward import (
    slot_edge_tables as r_slot_edge_tables,
)
from tarl_tpu.models.transformer.slot_forward import slot_twin as r_slot_twin
from tarl_tpu.rl.ppo import PPO
from tarl_tpu.routing.policies import random_choice

from tarl_tpu_torch import convert
from tarl_tpu_torch.config import RLConfig as PortRLConfig
from tarl_tpu_torch.core import rng as p_rng
from tarl_tpu_torch.core import step as p_step
from tarl_tpu_torch.models.transformer import agent as p_agent
from tarl_tpu_torch.models.transformer import embedding as p_emb
from tarl_tpu_torch.models.transformer import gt_conv as p_gt
from tarl_tpu_torch.models.transformer import mlp as p_mlp
from tarl_tpu_torch.models.transformer import model as p_model
from tarl_tpu_torch.models.transformer import slot_forward as p_slot
from tarl_tpu_torch.rl.ppo import PPO as PortPPO
from tarl_tpu_torch.rl.ppo import init_params
from tarl_tpu_torch.routing.policies import random_choice as p_random_choice

from test_torch_network import assert_tree_equal, load_both
from test_torch_train import _moments_ok

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "tarl_tpu_torch", "weights",
                       "braess_transformer_best.npz")
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def scenarios(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_gt_scen"))
    return {name: load_both(root, name) for name in ("Braess", "Grid4x4")}


@pytest.fixture(scope="module")
def grid(scenarios):
    """Grid4x4 with one encoding draw and a seeded context."""
    net, agents, pnet, pagents = scenarios["Grid4x4"]
    pe = r_agent.network_positional_encoding(net, 16)
    g = np.random.default_rng(0)
    x = (g.normal(size=(net.num_nodes, 16)) * 5).astype(np.float32)
    ef = np.asarray(net.full_attr).reshape(-1, 1)
    return net, pnet, pe, x, ef


def _port(tree) -> dict:
    """A Flax variable tree as a state dict."""
    return convert.mpnn_params_from_numpy(
        {"policy": jax.tree.map(np.asarray, tree), "value": {}},
        device="cpu")["policy"]


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("act", ["relu", "gelu", "tanh", "silu"])
def test_mlp_matches_flax(act):
    x = np.random.default_rng(1).normal(size=(40, 12)).astype(np.float32)
    ref = MLP(5, 24, 2, act=act)
    fp = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(ref.apply(fp, jnp.asarray(x)))
    model = p_mlp.MLP(12, 5, 24, 2, act=act)
    params = _port(fp)
    assert sorted(params) == sorted(model.state_dict())
    got = functional_call(model, params, (_t(x),))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


@pytest.mark.parametrize("aggs", [("sum",), ("sum", "mean"),
                                  ("sum", "mean", "max")])
@pytest.mark.parametrize("gate", [False, True])
def test_gt_conv_matches_flax(grid, gate, aggs):
    net, pnet, _, _, ef = grid
    n, e = net.num_nodes, net.num_full_edges
    g = np.random.default_rng(2)
    h = g.normal(size=(n, 16)).astype(np.float32)
    ea = g.normal(size=(e, 8)).astype(np.float32)
    ref = GTConv(node_dim=16, hidden_dim=16, edge_dim=8, num_heads=4,
                 gate=gate, aggregators=aggs)
    args = (jnp.asarray(h), net.full_src, net.full_dst, jnp.asarray(ea))
    fp = ref.init(jax.random.PRNGKey(3), *args)
    want_h, want_e = ref.apply(fp, *args)
    model = p_gt.GTConv(16, 16, edge_dim=8, num_heads=4, gate=gate,
                        aggregators=aggs)
    params = _port(fp)
    assert sorted(params) == sorted(model.state_dict())
    got_h, got_e = functional_call(
        model, params, (_t(h), pnet.full_src, pnet.full_dst, _t(ea)))
    # With "max", the virtual SRC nodes (no in-edges) aggregate -inf and
    # come out NaN in both packages.
    np.testing.assert_allclose(got_h.detach().numpy(), np.asarray(want_h),
                               **TOL)
    np.testing.assert_allclose(got_e.detach().numpy(), np.asarray(want_e),
                               **TOL)
    assert np.isfinite(got_e.detach().numpy()).all()
    assert np.isfinite(got_h.detach().numpy()[:net.num_roads]).all()


def test_graph_transformer_net_matches_flax(grid):
    net, pnet, pe, x, ef = grid
    ref = GraphTransformerNet(node_dim_in=16, edge_dim_in=1, pe_in_dim=16,
                              hidden_dim=16, num_gt_layers=2, num_heads=4,
                              gate=True, aggregators=("sum", "mean", "max"))
    args = (jnp.asarray(x), net.full_src, net.full_dst, jnp.asarray(ef),
            jnp.asarray(pe))
    fp = ref.init(jax.random.PRNGKey(4), *args)
    model = p_model.GraphTransformerNet(
        16, 1, 16, hidden_dim=16, num_gt_layers=2, num_heads=4, gate=True,
        aggregators=("sum", "mean", "max"))
    params = _port(fp)
    assert sorted(params) == sorted(model.state_dict())
    pargs = (_t(x), pnet.full_src, pnet.full_dst, _t(ef), _t(pe))
    for kw in ({}, {"raw": False, "zero_var": True}, {"raw": False}):
        want = ref.apply(fp, *args, **kw)
        got = functional_call(model, params, pargs, kw)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       err_msg=str(kw), **TOL)
        if kw.get("zero_var"):
            assert float(got[1].sum()) == 0.0
    drawn, std = functional_call(
        model, params, pargs, {"raw": False, "deterministic": False,
                               "generator": torch.Generator().manual_seed(0)})
    assert drawn.shape == (1,) and float(std[0]) > 0.0


def _policy_value(net, pe, x, ef, key=0):
    """Flax parameters of the reference's policy and value nets, and the
    port's state dicts of them."""
    t = jnp.asarray([21913.0], jnp.float32)
    pol, val = r_agent.TransformerRoutePolicy(pe=pe), \
        r_agent.TransformerValueNet(pe=pe)
    args = (jnp.asarray(x), jnp.asarray(ef), net.full_src, net.full_dst)
    fp = pol.init(jax.random.PRNGKey(key), *args)
    fv = val.init(jax.random.PRNGKey(key + 1), *args, t)
    tree = jax.tree.map(np.asarray, {"policy": fp, "value": fv})
    return (pol, val, fp, fv), convert.mpnn_params_from_numpy(
        tree, device="cpu")


def test_policy_and_value_match_flax_batched(grid):
    net, pnet, pe, x, ef = grid
    (pol, val, fp, fv), params = _policy_value(net, pe, x, ef)
    ppol, pval = p_agent.TransformerRoutePolicy(pe), \
        p_agent.TransformerValueNet(pe)
    assert sorted(params["policy"]) == sorted(ppol.state_dict())
    assert sorted(params["value"]) == sorted(pval.state_dict())
    assert not p_agent.TransformerRoutePolicy.edge_row_independent
    g = np.random.default_rng(5)
    xs = np.stack([x, x * 3.0, g.normal(size=x.shape).astype(np.float32)])
    ts = np.asarray([[21913.0], [23000.0], [25000.5]], np.float32)
    tail = (_t(ef), pnet.full_src, pnet.full_dst)
    logits = functional_call(ppol, params["policy"], (_t(xs),) + tail)
    values = functional_call(pval, params["value"],
                             (_t(xs),) + tail + (_t(ts),),
                             {"layout": None})
    assert logits.shape == (3, net.num_full_edges) and values.shape == (3,)
    for i in range(3):
        args = (jnp.asarray(xs[i]), jnp.asarray(ef), net.full_src,
                net.full_dst)
        np.testing.assert_allclose(logits[i].detach().numpy(),
                                   np.asarray(pol.apply(fp, *args)), **TOL)
        np.testing.assert_allclose(
            float(values[i]), float(val.apply(fv, *args, jnp.asarray(ts[i]))),
            **TOL)
        one = functional_call(ppol, params["policy"], (_t(xs[i]),) + tail)
        assert torch.equal(one, logits[i])
        v1 = functional_call(pval, params["value"],
                             (_t(xs[i]),) + tail + (_t(ts[i]),))
        # The pooled sum and the heads' products reduce in another order
        # under a batch axis.
        np.testing.assert_allclose(float(v1), float(values[i]), rtol=1e-6)


def test_slot_twin_matches_flax_and_the_flat_forward(grid):
    net, pnet, pe, x, ef = grid
    (pol, _, fp, _), params = _policy_value(net, pe, x, ef, key=6)
    ppol = p_agent.TransformerRoutePolicy(pe)
    twin = p_slot.slot_twin(ppol)
    assert sorted(twin.state_dict()) == sorted(ppol.state_dict())
    tables = p_slot.slot_edge_tables(pnet)
    n = net.num_nodes
    cols = torch.arange(n, dtype=torch.int32)
    got = functional_call(twin, params["policy"], (_t(x), tables, cols))
    want = r_slot_twin(pol).apply(fp, jnp.asarray(x), r_slot_edge_tables(net),
                                  jnp.arange(n, dtype=jnp.int32))
    ok = tables.out_ok.numpy()
    assert ok.sum() == net.num_full_edges
    np.testing.assert_allclose(np.where(ok, got.numpy(), 0.0),
                               np.where(ok, np.asarray(want), 0.0), **TOL)
    flat = functional_call(ppol, params["policy"],
                           (_t(x), _t(ef), pnet.full_src, pnet.full_dst))
    # Edge e sits at out-slot (its rank among its source's edges, source).
    src = pnet.full_src.numpy()
    rank = np.array([np.sum(src[:i] == s) for i, s in enumerate(src)])
    np.testing.assert_allclose(got.numpy()[rank, src], flat.numpy(), **TOL)
    with pytest.raises(ValueError, match="deterministic"):
        p_slot.slot_twin(p_agent.TransformerRoutePolicy(pe, dropout=0.1))


# ---------------------------------------------------------------------------
def _clusters(vals: np.ndarray, tol: float = 1e-6):
    """Index runs of (sorted) ``vals`` within ``tol`` of their neighbour."""
    runs, start = [], 0
    for i in range(1, len(vals) + 1):
        if i == len(vals) or vals[i] - vals[i - 1] > tol:
            runs.append(np.arange(start, i))
            start = i
    return runs


@pytest.mark.parametrize("scenario", ["Braess", "Grid4x4"])
def test_positional_encoding_matches_the_references_eigenspaces(
        scenarios, scenario):
    net, _, pnet, _ = scenarios[scenario]
    r, n = net.num_roads, net.num_nodes
    src, dst = np.asarray(net.edge_src), np.asarray(net.edge_dst)
    want = r_agent.network_positional_encoding(net, 16)
    got = p_agent.network_positional_encoding(pnet, 16)
    assert got.shape == want.shape == (n, 16) and got.dtype == np.float32
    assert not got[r:].any() and not want[r:].any()
    # The normalised Laplacian, as both build it.
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    a = sp.coo_matrix((np.ones(len(src)), (src, dst)), shape=(r, r)).tocsr()
    lap = csgraph.laplacian((a + a.T) / 2, normed=True).toarray()
    full = np.sort(np.linalg.eigvalsh(lap))
    live = [j for j in range(16) if np.linalg.norm(want[:r, j]) > 0.5]
    assert live == [j for j in range(16)
                    if np.linalg.norm(got[:r, j]) > 0.5]
    quotients = []
    for pe in (want, got):
        v = pe[:r, live].astype(np.float64)
        quotients.append(np.einsum("ij,ik,kj->j", v, lap, v))
    np.testing.assert_allclose(quotients[1], quotients[0], atol=1e-5)
    # Compare the projector of every eigenvalue cluster wholly inside the
    # kept columns (the last may be cut off at 16).
    q = quotients[0]
    compared = 0
    for run in _clusters(q):
        lam = q[run[-1]]
        whole = np.sum(np.abs(full - lam) < 1e-6) == len(run)
        if not whole:
            continue
        cols = [live[i] for i in run]
        pw = want[:r, cols].astype(np.float64)
        pg = got[:r, cols].astype(np.float64)
        np.testing.assert_allclose(pg @ pg.T, pw @ pw.T, atol=1e-5)
        compared += len(run)
    assert compared >= len(live) // 2


def test_structural_encoding_and_mixer(grid):
    net, pnet, pe, x, _ = grid
    src = np.asarray(net.edge_src)
    se = r_emb.degree_structural_encoding(src, net.num_roads, net.num_nodes)
    got = p_emb.degree_structural_encoding(pnet.edge_src.numpy(),
                                           net.num_roads, net.num_nodes)
    np.testing.assert_array_equal(got, se)
    ref = r_emb.EmbeddingMixer(out_dim=8)
    fp = ref.init(jax.random.PRNGKey(7), jnp.asarray(x), jnp.asarray(pe),
                  jnp.asarray(se))
    model = p_emb.EmbeddingMixer(16, 16, 8)
    params = _port(fp)
    assert sorted(params) == sorted(model.state_dict())
    np.testing.assert_allclose(
        functional_call(model, params, (_t(x), _t(pe), _t(se)))
        .detach().numpy(),
        np.asarray(ref.apply(fp, jnp.asarray(x), jnp.asarray(pe),
                             jnp.asarray(se))), **TOL)


# ---------------------------------------------------------------------------
def test_init_params_draws_flax_law(grid):
    net, pnet, pe, x, ef = grid
    pol = r_agent.TransformerRoutePolicy(pe=pe)
    args = (jnp.asarray(x), jnp.asarray(ef), net.full_src, net.full_dst)
    init = jax.jit(lambda k: pol.init(k, *args))
    ref = [_port(init(jax.random.PRNGKey(s))) for s in range(16)]
    module = p_agent.TransformerRoutePolicy(pe)
    port = [init_params(module, torch.Generator().manual_seed(s))
            for s in range(16)]
    assert sorted(ref[0]) == sorted(port[0]) == sorted(module.state_dict())
    for k in ref[0]:
        assert ref[0][k].shape == port[0][k].shape, k
        pooled = {"ref": np.stack([d[k].numpy() for d in ref]),
                  "port": np.stack([d[k].numpy() for d in port])}
        leaf_is_norm = ".norm" in k
        if k.endswith(".bias"):
            for side, a in pooled.items():
                assert not a.any(), f"{k}: {side} bias not zero"
        elif leaf_is_norm:
            for side, a in pooled.items():
                assert (a == 1.0).all(), f"{k}: {side} scale not one"
        else:
            var = 1.0 / pooled["port"].shape[-1]
            bound = 2.0 * np.sqrt(var) / 0.87962566103423978
            for a in pooled.values():
                _moments_ok(a, 0.0, var, k)
                assert np.abs(a).max() <= bound * (1 + 1e-6), k


def test_committed_weights_round_trip_and_equal_the_checkpoint():
    spec = importlib.util.spec_from_file_location(
        "export_mpnn_params",
        os.path.join(REPO, "scripts", "export_mpnn_params.py"))
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    restored = export.restore_params(os.path.join(
        REPO, "runs", "learning", "braess_transformer", "checkpoints",
        "best"))
    committed = convert.load_params_npz(WEIGHTS)
    for part in ("policy", "value"):
        assert_tree_equal(restored[part], committed[part], part)
        assert_tree_equal(committed[part], restored[part], part)
    params = convert.mpnn_params_from_numpy(committed, device="cpu")
    assert sum(t.numel() for sub in params.values()
               for t in sub.values()) == 15624
    pe = committed["pe"]
    assert pe.shape == (14, 16) and pe.dtype == np.float32
    assert sorted(params["policy"]) == sorted(
        p_agent.TransformerRoutePolicy(pe).state_dict())
    assert sorted(params["value"]) == sorted(
        p_agent.TransformerValueNet(pe).state_dict())
    back = convert.transformer_params_to_numpy(params)
    for part in ("policy", "value"):
        assert_tree_equal(committed[part], back[part], part)
        assert_tree_equal(back[part], committed[part], part)


# ---------------------------------------------------------------------------
def test_train_iteration_matches_the_reference(scenarios):
    net, agents, pnet, pagents = scenarios["Braess"]
    st = init_sim_state(net, agents, policy=Policy(choice=random_choice))
    pst = p_step.init_sim_state(pnet, pagents,
                                policy=p_step.Policy(choice=p_random_choice))
    lr = 1e-3
    kw = dict(reward_mode="progress", gamma=0.98, gae_lambda=0.9,
              episode_start=21600, rollout_steps=32, num_epochs=2,
              minibatch_size=16, entropy_coef=0.003, learning_rate=lr)
    pe = r_agent.network_positional_encoding(net, 16)
    ref = PPO(net, r_agent.TransformerRoutePolicy(pe=pe),
              r_agent.TransformerValueNet(pe=pe), rl=RLConfig(**kw),
              value_uses_graph=True)
    port = PortPPO(pnet, p_agent.TransformerRoutePolicy(pe),
                   p_agent.TransformerValueNet(pe), rl=PortRLConfig(**kw),
                   value_uses_graph=True)
    ts = ref.init(st, jax.random.PRNGKey(0))
    params = convert.mpnn_params_from_numpy(
        jax.tree.map(np.asarray, ts.params), device="cpu")
    pts = port.init(pst, p_rng.prng_key(0), torch.Generator())
    pts = pts._replace(params=params, opt_state=port.optimizer.init(params),
                       key=tuple(int(k) for k in np.asarray(ts.key)))
    ts1, metrics = ref.train_iteration(ts)
    pts1, pmetrics = port.train_iteration(pts)
    assert pts1.key == tuple(int(k) for k in np.asarray(ts1.key))
    assert float(pts1.env.sim.time) == float(ts1.env.sim.time)
    np.testing.assert_array_equal(pts1.env.sim.agents.done.numpy(),
                                  np.asarray(ts1.env.sim.agents.done))
    for f in metrics._fields:
        np.testing.assert_allclose(float(getattr(pmetrics, f)),
                                   float(getattr(metrics, f)), rtol=1e-5,
                                   atol=1e-7, err_msg=f)
    assert pts1.opt_state.count == 4
    want = convert.mpnn_params_from_numpy(
        jax.tree.map(np.asarray, ts1.params), device="cpu")
    diffs = torch.cat([(want[p][k] - pts1.params[p][k]).abs().reshape(-1)
                       for p in want for k in want[p]])
    close = float((diffs <= 1e-5).double().mean())
    print(f"train_iteration: worst parameter difference "
          f"{float(diffs.max()):.3g}, {close:.4%} of {diffs.numel()} "
          f"within 1e-5")
    assert close >= 0.99
    # Adam's reach: an element whose gradient is rounding noise steps by up
    # to the rate either way, in each of the four updates.
    assert float(diffs.max()) <= 2 * lr * 4
    moved = torch.cat([(params[p][k] - pts1.params[p][k]).abs().reshape(-1)
                       for p in params for k in params[p]])
    assert float((moved > 0.5 * lr).double().mean()) > 0.25
