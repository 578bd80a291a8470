"""Entry points: one forward step of the flagship model, and a
data-parallel dry run.

Counterpart of ``__graft_entry__.py``.  ``entry`` is the ViT actor-critic
over the book-image observation (``tiny`` preset, continuous actions
bounded by ``[-1, 0, 0]`` .. ``[3, 1, 1]``, fc and hidden width 64) on a
batch of 32 actors and one time step.  ``dryrun_multichip(n)`` runs one
update of a small 2-player world (a market maker on ``gru``, a vision
execution agent on ``vit_gru`` at the micro preset) over an ``n``-rank
gloo group of CPU processes on the JAX dry run's mesh (a ``(n/2, 2)``
data x model grid for even n >= 4, else ``n`` data ranks), checks that
every rank ends with the same finite metrics and the same weights, and
holds the update against its unsharded twin in one process, as
``__graft_entry__.py`` does.

    from vit_marl_tpu_torch.graft_entry import entry, dryrun_multichip
    fn, args = entry()             # on the card; entry("cpu") on request
    h2, action, value = fn(*args)
    dryrun_multichip(4)            # a (2, 2) data x model mesh
"""

from __future__ import annotations

import contextlib
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
SEED = 0


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


def dryrun_mesh(n: int):
    """The JAX dry run's mesh of ``n`` devices
    (``__graft_entry__.py:172-178``): ``(n/2, 2)`` over ``("data",
    "model")`` for even n >= 4, else ``(n,)`` over ``("data",)``."""
    if n % 2 == 0 and n >= 4:
        return (n // 2, 2), ("data", "model")
    return (n,), ("data",)


def _dryrun_configs(n: int, sharded: bool):
    """The dry run's world and trainer configs (the JAX dry run's), with
    its mesh where ``sharded``."""
    from vit_marl_tpu_torch import config as c

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
    shape, axes = dryrun_mesh(n)
    num_envs = 2 * shape[0]             # two envs a data rank
    if not sharded:
        shape, axes = (), ("data",)
    tc = c.TrainConfig(num_envs=num_envs, num_steps=2, num_minibatches=1,
                       update_epochs=1, total_timesteps=num_envs * 2,
                       network=("gru", "vit_gru"), vit_preset="micro",
                       hidden_size=32, fc_dim=32, log_backend="none",
                       mesh_shape=shape, mesh_axes=axes)
    return ma, tc


@contextlib.contextmanager
def global_draws(seed: int, rank: int, world: int, device="cpu"):
    """Within: the envs' reset and step draws and the policies' samples
    come from one generator seeded ``seed`` on every rank, each drawn for
    the global batch of ``world`` data ranks and sliced to data rank
    ``rank``'s envs and actors, as the JAX package splits one key over
    the global batch.  A sharded run then draws what one process draws
    (``world=1``), and the two updates can be compared.  Only for the
    processes of a dry run: it replaces ``WorldEnv.draw_reset`` /
    ``draw_step`` and the distributions' ``sample`` while it lasts."""
    from vit_marl_tpu_torch.env.world import WorldEnv
    from vit_marl_tpu_torch.models.distributions import (
        Categorical,
        SquashedNormal,
    )
    from vit_marl_tpu_torch.parallel.shard_step import (
        local_reset_draws,
        local_step_draws,
    )

    g = torch.Generator(device=device).manual_seed(seed)
    saved = (WorldEnv.draw_reset, WorldEnv.draw_step, Categorical.sample,
             SquashedNormal.sample)
    inner = [False]         # draw_step's own reset draws are global already

    def draw_reset(self, n, generator):
        if inner[0]:
            return saved[0](self, n, g)
        return local_reset_draws(saved[0](self, n * world, g), rank * n,
                                 (rank + 1) * n)

    def draw_step(self, n, generator):
        inner[0] = True
        try:
            d = saved[1](self, n * world, g)
        finally:
            inner[0] = False
        return local_step_draws(d, rank * n, (rank + 1) * n)

    def rows(shape, draw):
        a = shape[1]
        return draw((shape[0], a * world) + tuple(shape[2:]), generator=g,
                    device=device)[:, rank * a:(rank + 1) * a]

    def cat_sample(self, generator=None, uniforms=None):
        return saved[2](self, uniforms=rows(self.logits.shape, torch.rand))

    def box_sample(self, generator=None, noise=None):
        return saved[3](self, noise=rows(self.mean.shape, torch.randn))

    WorldEnv.draw_reset, WorldEnv.draw_step = draw_reset, draw_step
    Categorical.sample, SquashedNormal.sample = cat_sample, box_sample
    try:
        yield g
    finally:
        (WorldEnv.draw_reset, WorldEnv.draw_step, Categorical.sample,
         SquashedNormal.sample) = saved


def _run_update(n: int, sharded: bool, group):
    """One update of the dry run's configs under :func:`global_draws`:
    the metrics (no host times) and each network's weights."""
    from vit_marl_tpu_torch.parallel.mesh import mesh_coords
    from vit_marl_tpu_torch.rl.ppo import make_train

    ma, tc = _dryrun_configs(n, sharded)
    rank, world = 0, 1                  # the data rank and data ranks
    if sharded:
        shape, axes = dryrun_mesh(n)
        rank, world = mesh_coords(group.rank, shape, axes)[0], shape[0]
    with global_draws(SEED, rank, world):
        out = make_train(ma, tc, device="cpu",
                         group=group if sharded else None)(SEED)
    metrics = {k: v for k, v in out["metrics"][0].items()
               if k not in ("rollout_s", "update_s")}
    weights = [{k: v.detach().clone() for k, v in net.state_dict().items()}
               for net in out["networks"]]
    return metrics, weights, float(tc.lr)


def _dryrun_rank(group, n: int, setup=None):
    """One rank of :func:`dryrun_multichip`: ``setup()`` first (tests
    plant faults with it), then the sharded update."""
    if setup is not None:
        setup()
    return _run_update(n, True, group)


def _twin(group, n: int):
    """The unsharded twin: the same update in one process."""
    return _run_update(n, False, None)


def dryrun_multichip(n_devices: int, deadline_s: float = 300.0,
                     setup=None) -> None:
    """One IPPO update over ``n_devices`` CPU processes in a gloo group on
    a free local port (``init_process_group`` with a timeout, the
    children joined within ``deadline_s``), on the JAX dry run's mesh
    (:func:`dryrun_mesh`: ``(n/2, 2)`` data x model for even n >= 4),
    then its unsharded twin in one process, both on the same global
    draws (:func:`global_draws`), as ``__graft_entry__.py:191-217``
    checks.  Raises if a rank fails or hangs, if a metric is not finite,
    if the ranks' metrics or weights differ, if a metric of the sharded
    update differs from the twin's beyond rtol 1e-4 / atol 1e-5, or a
    weight by more than 3 x the learning rate.  ``setup``: a picklable
    function each sharded rank calls first."""
    import numpy as np

    t0 = time.perf_counter()
    shape, axes = dryrun_mesh(n_devices)
    outs = run_group(_dryrun_rank, n_devices, (n_devices, setup),
                     deadline_s=deadline_s)
    metrics, weights, lr = outs[0]
    bad = [k for k, v in metrics.items() if not math.isfinite(v)]
    if bad:
        raise RuntimeError(f"dryrun_multichip: non-finite metrics {bad}")
    for rank, (m, w, _) in enumerate(outs[1:], 1):
        if m != metrics or any(
                not np.array_equal(a[k], b[k])
                for a, b in zip(w, weights) for k in a):
            raise RuntimeError(f"dryrun_multichip: rank {rank} differs "
                               "from rank 0 after the update")
    (ref, ref_w, _), = run_group(_twin, 1, (n_devices,),
                                 deadline_s=deadline_s)
    if set(ref) != set(metrics):
        raise RuntimeError("dryrun_multichip: the sharded and unsharded "
                           "updates report different metrics")
    for k, v in metrics.items():
        if not np.isclose(v, ref[k], rtol=1e-4, atol=1e-5):
            raise RuntimeError(f"dryrun_multichip: sharded != unsharded "
                               f"for metric {k}: {v} vs {ref[k]}")
    worst = max(float(np.abs(a[k].astype(np.float64)
                             - b[k].astype(np.float64)).max())
                for a, b in zip(weights, ref_w) for k in a)
    if worst > 3 * lr + 1e-6:
        raise RuntimeError(f"dryrun_multichip: updated weights diverge "
                           f"beyond one-Adam-step noise: max |diff| "
                           f"{worst:.3e} > 3 x lr")
    print(f"dryrun_multichip({n_devices}): one update over a "
          f"{dict(zip(axes, shape))} mesh of gloo ranks in "
          f"{time.perf_counter() - t0:.1f}s; {len(metrics)} metrics finite "
          "and equal on every rank, weights equal; sharded == unsharded "
          f"(metrics within rtol 1e-4 / atol 1e-5, weights within "
          f"{worst:.2e} <= 3 x lr)", flush=True)
