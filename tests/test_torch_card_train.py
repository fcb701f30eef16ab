"""PPO training on a card, with no jax: on a card run

    python -m pytest --noconftest -m cuda tests/test_torch_card_train.py

Marked ``cuda``; skips where no card is.

* K9-K11's wrappers on CUDA tensors refuse float32 1-D data that requires
  grad while grad is enabled, as on the CPU (``tests/test_torch_grad.py``);
  under ``torch.no_grad()`` they launch; inside ``plain_segments()`` they
  launch nothing and their gradients equal ``PLAIN``'s (to rounding: the
  plain sums add with atomics on the card).
* One training iteration at Grid4x4 (32 steps, two epochs of two
  minibatches of 16), once with the kernels in the collection and once
  with ``PLAIN``: one K1, K11 and K10 launch a collection step with the
  kernels, none of K9-K11 with ``PLAIN`` and none in the update; actions,
  rewards, dones and values bitwise equal, log-probs within rtol 1e-5,
  atol 1e-5; parameters within twice the learning rate times the updates
  (Adam's reach: ``chip_smoke.py`` phase 21 states why).
* Three chained ``Adam`` updates of a seeded parameter tree on the card
  and on the CPU, bitwise, with and without the global-norm clip (its
  norm well clear of the limit, so the card's sum order cannot flip it):
  the bias corrections are divided by as optax divides, on both devices.
"""
import os

import numpy as np
import pytest
import torch

from tarl_tpu_torch.config import RLConfig
from tarl_tpu_torch.core import rng
from tarl_tpu_torch.core.step import Policy, init_sim_state
from tarl_tpu_torch.io.matsim import load_network, load_population
from tarl_tpu_torch.io.scenarios import ensure_scenario
from tarl_tpu_torch.models.mpnn import MPNNPolicyNet, MPNNValueNetSimple
from tarl_tpu_torch.ops import segment as seg
from tarl_tpu_torch.rl.ppo import PPO, Adam
from tarl_tpu_torch.routing.policies import random_choice


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; chip_smoke.py phase 21 "
                    "runs the same path")
    return torch.device("cuda", 0)


def _counts():
    return {"K9": seg.SUM_LAUNCHES, "K10": seg.MAX_LAUNCHES,
            "K11": seg.ARGMAX_LAUNCHES}


@pytest.mark.cuda
def test_wrappers_refuse_grad_on_the_card(card):
    g = np.random.default_rng(17)
    e, n = 300, 90
    ids = torch.as_tensor(g.permutation(np.sort(g.integers(0, n, size=e)))
                          .astype(np.int32), device=card)
    lay = seg.segment_layout(ids, n)
    x = torch.as_tensor((g.normal(size=e) * 2.0).astype(np.float32),
                        device=card).requires_grad_()
    calls = [lambda: seg.segment_sum(x, ids, n, lay),
             lambda: seg.segment_max(x, ids, n, lay),
             lambda: seg.segment_argmax(x, ids, n, lay),
             lambda: seg.segment_softmax(x, ids, n, lay),
             lambda: seg.segment_log_softmax(x, ids, n, lay)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
    seg.reset_launches()
    with torch.no_grad():
        for call in calls:
            call()
    assert _counts() == {"K9": 2, "K10": 3, "K11": 1}
    seg.reset_launches()
    with seg.plain_segments():
        lp = seg.segment_log_softmax(x, ids, n, lay)
    assert _counts() == {"K9": 0, "K10": 0, "K11": 0}
    lp.square().sum().backward()
    y = x.detach().clone().requires_grad_()
    seg.segment_log_softmax(y, ids, n, ops=seg.PLAIN).square().sum() \
        .backward()
    # The plain sums add with atomics on the card: equal to rounding.
    torch.testing.assert_close(x.grad, y.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_training_iteration_kernels_against_plain(card, tmp_path):
    assert not torch.backends.cuda.matmul.allow_tf32
    base = ensure_scenario(str(tmp_path), "Grid4x4")
    net = load_network(os.path.join(base, "network"), device=card)
    agents, _ = load_population(os.path.join(base, "population"),
                                os.path.join(base, "network"), device=card)
    st = init_sim_state(net, agents, policy=Policy(choice=random_choice))
    lr, steps = 1e-3, 32
    rl = RLConfig(rollout_steps=steps, minibatch_size=16, num_epochs=2,
                  entropy_coef=0.003, learning_rate=lr,
                  reward_mode="progress", gamma=0.98, gae_lambda=0.9,
                  episode_start=21600)
    ppo = PPO(net, MPNNPolicyNet(net.num_nodes, net.num_roads + 1,
                                 use_distance_prior=True, prior_scale=30.0),
              MPNNValueNetSimple(net.num_nodes), rl=rl)
    ts = ppo.init(st, rng.prng_key(0), torch.Generator().manual_seed(0))
    trajs, launches = {}, {}
    collect = ppo.collect_rollout

    def keep(*args, **kw):
        out = collect(*args, **kw)
        trajs[label] = out[3]
        return out

    ppo.collect_rollout = keep
    outs = {}
    for label, ops in (("kernels", seg.KERNELS), ("plain", seg.PLAIN)):
        seg.reset_launches()
        outs[label] = ppo.train_iteration(ts, ops)
        torch.cuda.synchronize()
        launches[label] = _counts()
    assert launches["kernels"] == {"K9": 0, "K10": steps, "K11": steps}
    assert launches["plain"] == {"K9": 0, "K10": 0, "K11": 0}
    k, p = trajs["kernels"], trajs["plain"]
    for f in ("action", "reward", "done", "value"):
        assert torch.equal(getattr(k, f), getattr(p, f)), f
    torch.testing.assert_close(k.log_prob, p.log_prob, rtol=1e-5, atol=1e-5)
    for m in outs["kernels"][1]:
        assert bool(torch.isfinite(m))
    updates = outs["kernels"][0].opt_state.count
    assert updates == 4
    a, b = outs["kernels"][0].params, outs["plain"][0].params
    d = torch.cat([(a[q][n] - b[q][n]).abs().reshape(-1) for q in a
                   for n in a[q]])
    assert float(d.max()) <= 2 * lr * updates


@pytest.mark.cuda
def test_adam_update_on_the_card_equals_the_cpu(card):
    g = np.random.default_rng(23)
    shapes = {"policy": {"fc.weight": (64, 19), "fc.bias": (64,)},
              "value": {"out.weight": (1, 64), "out.bias": (1,)}}

    def tree(scale):
        return {part: {k: torch.as_tensor(
            (g.normal(size=shape) * scale).astype(np.float32))
            for k, shape in sub.items()} for part, sub in shapes.items()}

    params, grads = tree(0.3), [tree(1e-2) for _ in range(3)]
    for clip in (None, 1e3):
        opt = Adam(RLConfig(learning_rate=1e-3, max_grad_norm=clip))
        out = {}
        for dev in ("cpu", card):
            def to(t, dev=dev):
                return {p: {k: v.to(dev) for k, v in sub.items()}
                        for p, sub in t.items()}

            p, state = to(params), opt.init(to(params))
            for gr in grads:
                p, state = opt.update(to(gr), state, p)
            out[str(dev)] = (p, state.mu, state.nu)
        for a, b in zip(out["cpu"], out[str(card)]):
            for part, sub in a.items():
                for k, v in sub.items():
                    assert torch.equal(v.view(torch.int32),
                                       b[part][k].cpu().view(torch.int32)), \
                        (clip, part, k)
