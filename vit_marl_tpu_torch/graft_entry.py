"""Entry points: one forward step of the flagship model, and a
data-parallel dry run.

Counterpart of ``__graft_entry__.py``.  ``entry`` is the ViT actor-critic
over the book-image observation (``tiny`` preset, continuous actions
bounded by ``[-1, 0, 0]`` .. ``[3, 1, 1]``, fc and hidden width 64) on a
batch of 32 actors and one time step.  ``dryrun_multichip(n)`` runs one
update of a small 2-player world (a market maker on ``gru``, a vision
execution agent on ``vit_gru`` at the micro preset) data parallel over an
``n``-rank gloo group of CPU processes, and checks that every rank ends
with the same finite metrics and the same weights.

    from vit_marl_tpu_torch.graft_entry import entry, dryrun_multichip
    fn, args = entry()             # on the card; entry("cpu") on request
    h2, action, value = fn(*args)
    dryrun_multichip(2)
"""

from __future__ import annotations

import math
import time

import torch

from vit_marl_tpu_torch.models.rnn import ScannedGRU
from vit_marl_tpu_torch.models.vit import VIT_PRESETS, ViTActorCriticRNN
from vit_marl_tpu_torch.parallel.distributed import run_group
from vit_marl_tpu_torch.utils.device import resolve_device

BATCH, OBS_DIM, LEVELS, HIDDEN = 32, 28, 10, 64
ACTION_LOW = (-1.0, 0.0, 0.0)
ACTION_HIGH = (3.0, 1.0, 1.0)


def flagship_model(device=None, vit=None) -> ViTActorCriticRNN:
    """The flagship network on ``device`` (its encoder ``vit``, default
    the ``tiny`` preset), weights from torch's generator."""
    dev = resolve_device(device)
    return ViTActorCriticRNN(
        obs_dim=OBS_DIM, levels=LEVELS, action_dim=3,
        vit=vit or VIT_PRESETS["tiny"], fc_dim=HIDDEN, hidden_size=HIDDEN,
        action_low=torch.tensor(ACTION_LOW),
        action_high=torch.tensor(ACTION_HIGH)).to(dev)


def entry(device=None, vit=None):
    """``(fn, example_args)``: ``fn(h, obs, dones)`` runs the flagship
    model's forward on one step and returns ``(h2, pi.mode(), value)``;
    ``fn.net`` is the model (``vit``: another encoder config, e.g. the
    tiny preset in float32).  The example inputs are those of the JAX
    entry: a zero carry, observations of ones, no resets."""
    net = flagship_model(device, vit)
    dev = next(net.parameters()).device
    h = ScannedGRU.initialize_carry(BATCH, HIDDEN, dev)
    obs = {"obs": torch.ones((1, BATCH, OBS_DIM), device=dev),
           "vision_obs": torch.ones((1, BATCH, LEVELS, 3, 2), device=dev)}
    dones = torch.zeros((1, BATCH), dtype=torch.bool, device=dev)

    @torch.no_grad()
    def forward(h, obs, dones):
        h2, pi, value = net(h, obs, dones)
        return h2, pi.mode(), value

    forward.net = net
    return forward, (h, obs, dones)


def _dryrun_rank(group, n: int):
    """One rank of :func:`dryrun_multichip`: its metrics and a checksum of
    every weight."""
    from vit_marl_tpu_torch import config as c
    from vit_marl_tpu_torch.rl.ppo import make_train

    ma = c.MultiAgentConfig(
        world=c.WorldConfig(n_data_msg_per_step=2, ep_type="fixed_steps",
                            episode_time=4, start_resolution=4,
                            n_messages_per_synthetic_day=300),
        agents=(c.MarketMakingConfig(),
                c.ExecutionConfig(action_space="policy_blending",
                                  observation_space="execution_policy",
                                  reward_space="dual_ppo",
                                  use_vision_obs=True)),
        n_agents_per_type=(1, 1))
    num_envs = 2 * n
    tc = c.TrainConfig(num_envs=num_envs, num_steps=2, num_minibatches=1,
                       update_epochs=1, total_timesteps=num_envs * 2,
                       network=("gru", "vit_gru"), vit_preset="micro",
                       hidden_size=32, fc_dim=32, log_backend="none",
                       mesh_shape=(n,), mesh_axes=("data",))
    out = make_train(ma, tc, device="cpu", group=group)(0)
    sums = [float(sum(t.double().sum() for t in net.state_dict().values()))
            for net in out["networks"]]
    metrics = {k: v for k, v in out["metrics"][0].items()
               if k not in ("rollout_s", "update_s")}
    return metrics, sums


def dryrun_multichip(n_devices: int, deadline_s: float = 300.0) -> None:
    """One data-parallel IPPO update over ``n_devices`` CPU processes in a
    gloo group on a free local port (``init_process_group`` with a
    timeout, the children joined within ``deadline_s``); raises if a rank
    fails or hangs, if a metric is not finite, or if the ranks' metrics or
    weights differ."""
    t0 = time.perf_counter()
    outs = run_group(_dryrun_rank, n_devices, (n_devices,),
                     deadline_s=deadline_s)
    metrics, sums = outs[0]
    bad = [k for k, v in metrics.items() if not math.isfinite(v)]
    if bad:
        raise RuntimeError(f"dryrun_multichip: non-finite metrics {bad}")
    for rank, (m, s) in enumerate(outs[1:], 1):
        if m != metrics or s != sums:
            raise RuntimeError(f"dryrun_multichip: rank {rank} differs "
                               "from rank 0 after the update")
    print(f"dryrun_multichip({n_devices}): one update over {n_devices} "
          f"gloo ranks in {time.perf_counter() - t0:.1f}s; "
          f"{len(metrics)} metrics finite and equal on every rank, "
          "weights equal", flush=True)
