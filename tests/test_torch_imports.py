"""The port's package boundary and its kernel wrapper, on the CPU.

* ``tarl_tpu_torch`` and every submodule (the training modules
  ``rl.gae``, ``rl.checkpoint`` and ``rl.trainer`` among them) import with
  ``jax``, ``flax``, ``optax``, ``orbax`` and ``tarl_tpu`` blocked.
* No public function of the port places tensors on the CPU by default:
  every ``device`` parameter defaults to ``None``, the card.
* The fused-winner (K1), road-block winner (K7), primal-relax and
  fused-core wrappers (both K12 entries) send CPU tensors to their plain
  versions (without counting a launch) and raise on inputs the kernels
  would not take; a segment layout or a K7 table the kernels would not
  take is refused where it is built or first used.
* The kernels' CUDA sources exist and the build targets ``sm_90a``.
* On a machine with an NVIDIA GPU, each kernel equals its plain version
  (marked ``cuda``; skipped here).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import tarl_tpu_torch
from tarl_tpu_torch import _build
from tarl_tpu_torch.config import DEFAULT_PHYSICS
from tarl_tpu_torch.core import fused_core, fused_winner, rng
from tarl_tpu_torch.core.step import init_sim_state
from tarl_tpu_torch.io.matsim import load_network, load_population
from tarl_tpu_torch.io.scenarios import ensure_scenario
from tarl_tpu_torch.ops import segment as seg
from tarl_tpu_torch.routing import bellman_ford as bf
from tarl_tpu_torch.state import RoadState

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_imports_without_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "flax", "optax", "orbax",
                     "orbax.checkpoint", "tarl_tpu"):
            sys.modules[name] = None
        import tarl_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            tarl_tpu_torch.__path__, "tarl_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        assert "tarl_tpu_torch.core.fused_winner" in names
        assert "tarl_tpu_torch.core.fused_core" in names
        assert "tarl_tpu_torch.routing.bellman_ford" in names
        assert "tarl_tpu_torch.simulator" in names
        assert "tarl_tpu_torch.ops.segment" in names
        assert "tarl_tpu_torch.rl.ppo" in names
        assert "tarl_tpu_torch.rl.gae" in names
        assert "tarl_tpu_torch.rl.checkpoint" in names
        assert "tarl_tpu_torch.rl.trainer" in names
        assert "tarl_tpu_torch.parallel.shard_map_episode" in names
        assert "tarl_tpu_torch.parallel.sharded_episode" in names
        assert sys.modules["jax"] is None
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25


def test_no_public_function_defaults_to_the_cpu():
    import importlib
    import inspect
    import pkgutil

    from tarl_tpu_torch import convert, network, schema
    from tarl_tpu_torch.device import resolve_device
    from tarl_tpu_torch.io import matsim
    from tarl_tpu_torch.parallel import shard_map_episode
    from tarl_tpu_torch.rl import checkpoint

    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    listed = [matsim.load_network, matsim.load_population,
              network.build_network, convert.network_from_numpy,
              convert.agents_from_numpy, convert.sim_state_from_numpy,
              convert.mpnn_params_from_numpy, schema.agents_from_matrix,
              shard_map_episode.make_road_mesh,
              convert.adam_state_from_numpy, rng.permutation,
              checkpoint.restore_checkpoint]
    for fn in listed:
        assert inspect.signature(fn).parameters["device"].default is None, \
            fn.__qualname__
    seen = []
    walked = []
    for info in pkgutil.walk_packages(tarl_tpu_torch.__path__,
                                      "tarl_tpu_torch."):
        walked.append(info.name)
        mod = importlib.import_module(info.name)
        for obj in vars(mod).values():
            if not (inspect.isfunction(obj) and obj.__module__ == info.name):
                continue
            param = inspect.signature(obj).parameters.get("device")
            if param is not None and param.default is not param.empty:
                seen.append(obj.__qualname__)
                assert param.default is None, f"{info.name}.{obj.__qualname__}"
    assert len(seen) >= len(listed) + 4
    assert "tarl_tpu_torch.core.fused_core" in walked
    # Called without a device, an entry point asks for the card.
    assert shard_map_episode.make_road_mesh(4).device == torch.device("cuda")
    mat = np.zeros((2, 9), np.float32)
    if torch.cuda.is_available():
        assert schema.agents_from_matrix(mat).origin.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            schema.agents_from_matrix(mat)


@pytest.fixture(scope="module")
def grid4(tmp_path_factory):
    """A Grid4x4 network with a random ring state and selections."""
    base = ensure_scenario(str(tmp_path_factory.mktemp("torch_imp")),
                           "Grid4x4")
    net = load_network(os.path.join(base, "network"), device="cpu")
    agents, _ = load_population(os.path.join(base, "population"),
                                os.path.join(base, "network"), device="cpu")
    state = init_sim_state(net, agents)
    r, nmax = net.num_roads, net.nmax
    g = np.random.default_rng(0)
    count = torch.as_tensor(g.integers(0, 20, r).astype(np.int32))
    road = RoadState(
        fifo_ids=torch.as_tensor(g.integers(1, 500, (r, nmax)).astype(
            np.int32)),
        fifo_arrival=torch.zeros((r, nmax)),
        fifo_departure=torch.full((r, nmax), 21590.0),
        fifo_dest=torch.as_tensor(g.integers(0, 50, (r, nmax)).astype(
            np.int32)),
        head=torch.as_tensor(g.integers(0, nmax, r).astype(np.int32)),
        count=count,
    )
    return net, road, state.selected_road, rng.prng_key(4)


def test_wrapper_takes_plain_version_on_cpu(grid4):
    net, road, sel, key = grid4
    before = fused_winner.LAUNCHES
    got = fused_winner.direction_confirm(road, sel, net, 21600.0, key)
    want = fused_winner.direction_confirm_plain(road, sel, net, 21600.0,
                                                key)
    assert fused_winner.LAUNCHES == before
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert [t.dtype for t in got] == [torch.bool, torch.int32, torch.int32,
                                      torch.int32, torch.bool]
    assert bool(got[0].any())


@pytest.mark.parametrize("bad", ["key_word_range", "key_arity",
                                 "count_dtype", "fifo_layout",
                                 "selection_shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(grid4, bad):
    net, road, sel, key = grid4
    if bad == "key_word_range":
        key = (key[0], 1 << 32)
    elif bad == "key_arity":
        key = (*key, 0)
    elif bad == "count_dtype":
        road = road._replace(count=road.count.long())
    elif bad == "fifo_layout":
        road = road._replace(
            fifo_ids=road.fifo_ids.t().contiguous().t())
    else:
        sel = sel[:-1]
    with pytest.raises((TypeError, ValueError)):
        fused_winner.direction_confirm(road, sel, net, 21600.0, key,
                                       DEFAULT_PHYSICS)


LAYOUT_FAULTS = ["offsets_dtype", "offsets_length", "order_dtype",
                 "order_length", "ids_rank", "segment_count"]


def _refuse_bad_layout(bad: str, dev) -> None:
    """A segment layout the kernels would not take raises where it is
    built, and a layout for another segment count where a wrapper first
    uses it."""
    g = np.random.default_rng(5)
    e, n = 700, 37
    data = torch.as_tensor(g.normal(size=e).astype(np.float32), device=dev)
    ids = torch.as_tensor(g.integers(0, n, e).astype(np.int32), device=dev)
    good = seg.segment_layout(ids, n)
    offsets, order = good.offsets, good.order
    with pytest.raises((TypeError, ValueError)):
        if bad == "offsets_dtype":
            seg.SegmentLayout(offsets.long(), order, n, ids)
        elif bad == "offsets_length":
            seg.SegmentLayout(offsets[:-1], order, n, ids)
        elif bad == "order_dtype":
            seg.SegmentLayout(offsets, order.long(), n, ids)
        elif bad == "order_length":
            seg.SegmentLayout(offsets, order[1:], n, ids)
        elif bad == "ids_rank":
            seg.SegmentLayout(offsets, order, n, ids[None, :])
        else:
            seg.segment_sum(data, ids, n + 1, good)


@pytest.mark.parametrize("bad", LAYOUT_FAULTS)
def test_bad_layout_is_refused_where_built_or_first_used(bad):
    _refuse_bad_layout(bad, torch.device("cpu"))


@pytest.mark.cuda
def test_bad_layout_is_refused_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CPU cases run the same checks")
    for bad in LAYOUT_FAULTS:
        _refuse_bad_layout(bad, torch.device("cuda", 0))


def test_kernel_source_and_build_target():
    source = os.path.join(os.path.dirname(tarl_tpu_torch.__file__), "csrc",
                          "fused_winner.cu")
    assert os.path.isfile(source)
    text = open(source).read()
    assert 'extern "C" int tarl_fused_winner(' in text
    assert "tarl_tpu/core/fused_winner.py::_kernel" in text
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "--use_fast_math" not in flags
    assert _build.BUILD_DIR.parts[-2:] == ("build", "tarl_tpu_torch")


def test_relax_kernel_source_and_build_command(tmp_path, monkeypatch):
    source = os.path.join(os.path.dirname(tarl_tpu_torch.__file__), "csrc",
                          "primal_relax.cu")
    text = open(source).read()
    for entry in ("tarl_primal_global", "tarl_primal_global_fit",
                  "tarl_primal_next_road"):
        assert f'extern "C" int {entry}(' in text
    assert "tarl_tpu/routing/bellman_ford.py::_multisweep_nr_kernel_body" \
        in text
    assert "_sweep_kernel_body" in text
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    cmd = _build.nvcc_command(_build.PACKAGE_DIR / "csrc" / "primal_relax.cu",
                              tmp_path / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "--fmad=false" in cmd
    assert cmd[-1].endswith("primal_relax.cu")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(grid4):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py checks the "
                    "kernel on the card")
    net, road, sel, key = grid4
    dev = torch.device("cuda", 0)
    net = net.to(dev)
    road = RoadState(*(t.to(dev) for t in road))
    sel = sel.to(dev)
    before = fused_winner.LAUNCHES
    want = fused_winner.direction_confirm_plain(road, sel, net, 21600.0, key)
    for clock in (21600.0, torch.tensor(21600.0, device=dev)):
        got = fused_winner.direction_confirm(road, sel, net, clock, key)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert fused_winner.LAUNCHES == before + 2


@pytest.fixture(scope="module")
def relax_inputs(grid4):
    """Grid4x4 relax inputs: seeded congested costs and the cold start."""
    net = grid4[0]
    g = np.random.default_rng(7)
    cost = net.free_flow * torch.as_tensor(
        g.uniform(1.0, 4.0, net.num_roads).astype(np.float32))
    i_n = net.num_intersections
    dist0 = torch.full((i_n, i_n), bf.BIG)
    dist0.fill_diagonal_(0.0)
    return net, cost, dist0


@pytest.mark.parametrize("max_iters,relax_only", [(8, False), (1, True),
                                                  (None, False)])
def test_relax_wrapper_takes_plain_version_on_cpu(relax_inputs, max_iters,
                                                  relax_only):
    net, cost, dist0 = relax_inputs
    tabs = (net.inter_out_road, net.inter_out_ok, net.road_to)
    before = (bf.LAUNCHES, bf.NEXT_ROAD_LAUNCHES)
    got = bf.primal_relax_next_roads(cost, *tabs, dist0, max_iters,
                                     relax_only)
    want = bf.primal_relax_next_roads_plain(cost, *tabs, dist0, max_iters,
                                            relax_only)
    assert (bf.LAUNCHES, bf.NEXT_ROAD_LAUNCHES) == before
    assert torch.equal(got[0], want[0]) and got[0].dtype == torch.float32
    assert not torch.equal(got[0], dist0)
    if relax_only:
        assert got[1] is None and want[1] is None
    else:
        assert torch.equal(got[1], want[1]) and got[1].dtype == torch.float32
    if max_iters is None:
        assert float(got[0].max()) < bf.BIG


@pytest.mark.parametrize("bad", ["cost_dtype", "cost_shape", "dist_dtype",
                                 "dist_rows", "dist_layout", "out_road_dtype",
                                 "out_ok_dtype"])
def test_relax_wrapper_rejects_what_the_kernel_does_not_take(relax_inputs,
                                                             bad):
    net, cost, dist0 = relax_inputs
    out_r, ok, road_to = net.inter_out_road, net.inter_out_ok, net.road_to
    if bad == "cost_dtype":
        cost = cost.double()
    elif bad == "cost_shape":
        cost = cost[:-1]
    elif bad == "dist_dtype":
        dist0 = dist0.double()
    elif bad == "dist_rows":
        dist0 = dist0[:-1]
    elif bad == "dist_layout":
        dist0 = dist0.t().contiguous().t()[:, :-1]
    elif bad == "out_road_dtype":
        out_r = out_r.long()
    else:
        ok = ok.to(torch.uint8)
    with pytest.raises((TypeError, ValueError)):
        bf.primal_relax_next_roads(cost, out_r, ok, road_to, dist0, 8)


@pytest.mark.cuda
def test_relax_kernel_matches_plain_on_card(relax_inputs):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py checks the "
                    "kernel on the card")
    net, cost, dist0 = relax_inputs
    dev = torch.device("cuda", 0)
    tabs = tuple(t.to(dev) for t in (net.inter_out_road, net.inter_out_ok,
                                     net.road_to))
    cost, dist0 = cost.to(dev), dist0.to(dev)
    for max_iters, relax_only in ((8, False), (1, True), (None, False)):
        before = bf.LAUNCHES
        got = bf.primal_relax_next_roads(cost, *tabs, dist0, max_iters,
                                         relax_only)
        want = bf.primal_relax_next_roads_plain(cost, *tabs, dist0,
                                                max_iters, relax_only)
        torch.cuda.synchronize()
        assert bf.LAUNCHES == before + 1
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b)


@pytest.fixture(scope="module")
def payload_inputs(grid4):
    """The fused core's sampler inputs on the Grid4x4 ring state: edge
    logits with a third of the edges ineligible (-inf), head agents and
    source roads as payloads."""
    net, road = grid4[0], grid4[1]
    e = net.edge_src.shape[0]
    g = np.random.default_rng(5)
    logits = torch.as_tensor(g.normal(size=e).astype(np.float32))
    logits[torch.as_tensor(g.random(e) < 1 / 3)] = float("-inf")
    agents = road.head_ids()[net.edge_src.long()]
    return net, logits, agents, net.edge_src


def test_payload_wrapper_takes_plain_version_on_cpu(payload_inputs):
    net, logits, agents, src = payload_inputs
    key = rng.prng_key(9)
    before = fused_core.PAYLOAD_LAUNCHES
    got = fused_core.gumbel_argmax_payload(
        logits, net.edge_dst, agents, src, key, net.num_roads,
        net.edge_layout)
    want = fused_core.gumbel_argmax_payload_plain(
        logits, net.edge_dst, agents, src, key, net.num_roads)
    assert fused_core.PAYLOAD_LAUNCHES == before
    for a, b in zip(got, want):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    assert bool((got[0] > 0).any()) and bool((got[1] == net.num_roads).any())
    assert net.edge_layout is net.edge_layout
    assert net.to("cpu").edge_layout is not net.edge_layout


@pytest.mark.parametrize("bad", ["logits_dtype", "logits_shape",
                                 "payload_dtype", "payload_shape",
                                 "foreign_layout"])
def test_payload_wrapper_rejects_what_the_kernel_does_not_take(
        payload_inputs, bad):
    net, logits, agents, src = payload_inputs
    ids, layout = net.edge_dst, None
    if bad == "logits_dtype":
        logits = logits.double()
    elif bad == "logits_shape":
        logits = logits[:-1]
    elif bad == "payload_dtype":
        agents = agents.long()
    elif bad == "payload_shape":
        src = src[1:]
    else:
        layout = net.edge_layout
        ids = ids.clone()
    with pytest.raises((TypeError, ValueError)):
        fused_core.gumbel_argmax_payload(logits, ids, agents, src,
                                         rng.prng_key(0), net.num_roads,
                                         layout)


def test_payload_kernel_source():
    csrc = os.path.join(os.path.dirname(tarl_tpu_torch.__file__), "csrc")
    text = open(os.path.join(csrc, "fused_core.cu")).read()
    assert 'extern "C" int tarl_gumbel_argmax_payload(' in text
    assert 'extern "C" int tarl_fused_core_sample(' in text
    assert "template <bool kFused>" in text
    assert "tarl_tpu/core/fused_core.py::_argmax_payload_kernel" in text
    assert '#include "threefry.cuh"' in text
    header = open(os.path.join(csrc, "threefry.cuh")).read()
    assert "0x1BD11BDA" in header
    assert "{13, 15, 26, 6}, {17, 29, 16, 24}" in header


@pytest.mark.cuda
def test_payload_kernel_matches_plain_on_card(payload_inputs):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py checks the "
                    "kernel on the card")
    net, logits, agents, src = payload_inputs
    dev = torch.device("cuda", 0)
    net = net.to(dev)
    logits, agents = logits.to(dev), agents.to(dev)
    key = rng.prng_key(9)
    before = fused_core.PAYLOAD_LAUNCHES
    got = fused_core.gumbel_argmax_payload(
        logits, net.edge_dst, agents, net.edge_src, key, net.num_roads,
        net.edge_layout)
    want = fused_core.gumbel_argmax_payload_plain(
        logits, net.edge_dst, agents, net.edge_src, key, net.num_roads)
    torch.cuda.synchronize()
    assert fused_core.PAYLOAD_LAUNCHES == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def shard_inputs(grid4):
    """K7's inputs on the Grid4x4 ring state over 5 road blocks of 10
    roads (two padded): the halo vectors, the packed words and the local
    counts, every block's in-slot columns and capacities (as
    ``ShardTables`` fields), and a key."""
    from tarl_tpu_torch.core.direction import pack_upstream, \
        upstream_pack_layout

    net, road, sel = grid4[:3]
    r, nmax = net.num_roads, net.nmax
    rp = 50

    def pad(x, fill):
        return torch.cat([x, torch.full((rp - r,) + tuple(x.shape[1:]), fill,
                                        dtype=x.dtype)])

    def cols(x, fill):
        return pad(x.t(), fill).t().contiguous()

    s = sel[:r]
    sel_enc = pad(torch.where((s >= 0) & (s < r), s, r), r)
    pack = pack_upstream(pad(road.head_departure(), 0.0), pad(road.count, 0),
                         pad(net.capacity, 0.0), sel_enc, 21600.0,
                         DEFAULT_PHYSICS, r, nmax)
    halo = [pack, pad(road.head_ids(), 0), pad(road.head_dests(), 0)]
    tables = dict(in_src=cols(net.in_src_tab, 0),
                  in_logit=cols(net.in_logit_tab, 0.0),
                  in_ok=cols(net.in_edge_ok, False),
                  capacity=pad(net.capacity, 0.0), road_order=net.road_order)
    return (halo, rng.prng_key(3), tables,
            pad(road.count, 0).to(torch.float32), rp,
            upstream_pack_layout(r, nmax))


def _shard_call(fn, inputs, col0=0, cut=slice(None)):
    """``fn`` (K7 or its plain version) on ``inputs``' columns ``cut``."""
    halo, key, tables, count_f, rp, layout = inputs
    local = {k: (v if k == "road_order" else
                 v[cut].contiguous() if v.dim() == 1 else
                 v[:, cut].contiguous()) for k, v in tables.items()}
    return fn(*halo, key, fused_winner.ShardTables(**local),
              count_f[cut].contiguous(), col0, rp, DEFAULT_PHYSICS, layout)


def test_shard_winner_wrapper_takes_plain_version_on_cpu(shard_inputs):
    rp = shard_inputs[4]
    before = fused_winner.SHARD_LAUNCHES
    got = _shard_call(fused_winner.fused_shard_winner, shard_inputs)
    want = _shard_call(fused_winner.fused_shard_winner_plain, shard_inputs)
    assert fused_winner.SHARD_LAUNCHES == before
    assert [t.dtype for t in got] == [torch.bool] + [torch.int32] * 3
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(got[0].any()) and bool((got[1] == rp).any())
    # The last block alone equals the whole device's columns of it.
    last = _shard_call(fused_winner.fused_shard_winner, shard_inputs, 40,
                       slice(40, 50))
    for a, b in zip(last, got):
        assert torch.equal(a, b[40:])


@pytest.mark.parametrize("bad", ["pack_dtype", "pack_shape", "key_word_range",
                                 "src_shape", "ok_dtype", "count_layout",
                                 "device", "columns", "key_arity",
                                 "road_order_shape", "road_order_dtype"])
def test_shard_winner_rejects_what_the_kernel_does_not_take(shard_inputs,
                                                            bad):
    halo, key, tables, count_f, rp, layout = shard_inputs
    halo, tables, col0 = list(halo), dict(tables), 0
    if bad == "pack_dtype":
        halo[0] = halo[0].long()
    elif bad == "pack_shape":
        halo[0] = halo[0][:-1]
    elif bad == "key_word_range":
        key = (key[0], 1 << 32)
    elif bad == "key_arity":
        key = (key[0], key[1], 0)
    elif bad == "src_shape":
        tables["in_src"] = tables["in_src"][:, :-1]
    elif bad == "ok_dtype":
        tables["in_ok"] = tables["in_ok"].to(torch.uint8)
    elif bad == "count_layout":
        count_f = torch.stack([count_f, count_f], 1)[:, 0]
    elif bad == "device":
        tables["capacity"] = tables["capacity"].to("meta")
    elif bad == "road_order_shape":
        tables["road_order"] = tables["road_order"][None, :]
    elif bad == "road_order_dtype":
        tables["road_order"] = tables["road_order"].long()
    else:
        col0 = 10
    with pytest.raises((TypeError, ValueError)):
        fused_winner.fused_shard_winner(
            *halo, key, fused_winner.ShardTables(**tables), count_f, col0,
            rp, DEFAULT_PHYSICS, layout)


def test_shard_winner_kernel_source():
    source = os.path.join(os.path.dirname(tarl_tpu_torch.__file__), "csrc",
                          "fused_winner.cu")
    text = open(source).read()
    assert 'extern "C" int tarl_fused_shard_winner(' in text
    assert "__global__ void fw_shard_winner_kernel(" in text
    assert "tarl_tpu/core/fused_winner.py::_shard_winner_kernel" in text
    # The noise is drawn inside, through K1's transform and address.
    body = text[text.index("__global__ void fw_shard_winner_kernel("):]
    assert "gumbel_from_bits(tarl::threefry_bits(k1, k2, q))" in body
    assert "road_order[col]" in body
    assert "__shfl_xor_sync" in body


@pytest.mark.cuda
def test_shard_winner_kernel_matches_plain_on_card(shard_inputs):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py checks the "
                    "kernel on the card")
    halo, key, tables, count_f, rp, layout = shard_inputs
    on_card = ([t.to("cuda") for t in halo], key,
               {k: v.to("cuda") for k, v in tables.items()},
               count_f.to("cuda"), rp, layout)
    before = fused_winner.SHARD_LAUNCHES
    for col0, cut in ((0, slice(None)), (20, slice(20, 30))):
        got = _shard_call(fused_winner.fused_shard_winner, on_card, col0,
                          cut)
        want = _shard_call(fused_winner.fused_shard_winner_plain, on_card,
                           col0, cut)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert fused_winner.SHARD_LAUNCHES == before + 2


def test_fused_sample_wrapper_takes_plain_version_on_cpu(grid4):
    net, road, sel = grid4[:3]
    key = rng.prng_key(11)
    before = fused_core.LAUNCHES
    got = fused_core.fused_core_sample(road, sel, net, 21600.0, key)
    want = fused_core.fused_core_sample_plain(road, sel, net, 21600.0, key)
    assert fused_core.LAUNCHES == before
    for a, b in zip(got, want):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    assert bool((got[0] > 0).any())
    assert bool((got[1] == net.num_roads).any())


@pytest.mark.parametrize("bad", ["key_word_range", "key_arity",
                                 "fifo_dtype", "head_shape", "sel_shape",
                                 "count_device"])
def test_fused_sample_rejects_what_the_kernel_does_not_take(grid4, bad):
    net, road, sel = grid4[:3]
    key = rng.prng_key(11)
    if bad == "key_word_range":
        key = (-1, key[1])
    elif bad == "key_arity":
        key = (key[0],)
    elif bad == "fifo_dtype":
        road = road._replace(fifo_departure=road.fifo_departure.double())
    elif bad == "head_shape":
        road = road._replace(head=road.head[:-1])
    elif bad == "sel_shape":
        sel = sel[:net.num_roads]
    else:
        road = road._replace(count=road.count.to("meta"))
    with pytest.raises((TypeError, ValueError)):
        fused_core.fused_core_sample(road, sel, net, 21600.0, key)
