"""IPPO with recurrent policies, single device.

Port of ``vit_marl_tpu/rl/ppo.py::make_train`` for GRU policies
(``gru``) and ViT-GRU policies over ``{"obs", "vision_obs"}`` dict
observations (``vit_gru``), with discrete or continuous (``Box``) actions:
one network, optimizer and hidden state per agent type; each update collects
``num_steps`` batched env steps (a Python loop where the reference scans),
computes per-type GAE (a reverse loop) and runs per-type clipped-PPO epochs
over shuffled minibatches of actors.  The optimizer is the reference's
``optax.chain(clip_by_global_norm, adam(eps=1e-5))``: a hand-written
global-norm clip (optax's, without the ``1e-6`` that
``torch.nn.utils.clip_grad_norm_`` adds), then Adam with the learning rate
read from the linear anneal at the optimizer's step count before the step.

Actors are env-major: actor ``k`` of a type is instance ``k % n`` of env
``k // n`` (``batchify``), so the per-env ``__all__`` done is repeated, not
tiled, onto the actor axis (``global_done_for_actors``).

Observations, transitions and minibatches are trees (a dict observation
is indexed leaf by leaf).

With ``log_env_info`` (on by default) each env step's info tree is
reduced on the device to per-field moments (:func:`_reduce_info`, one
stacked reduction per agent type and one for the world), stacked per
update and folded into ``{name}/info_{k}_mean|_std`` and
``world/{k}_mean`` (:func:`_fold_info_stats`), beside the action metrics
``{name}/action_pct_{a}`` or ``{name}/action_mean|_std``
(:func:`_action_metrics`); the host reads the metrics once an update.
Each update's metrics go to :class:`rl.logger.Logger`; with
``checkpoint_dir`` the learners are saved (``rl/checkpoint.py``) every
``checkpoint_every`` updates and at the last, and ``resume`` restores the
latest and continues after it (the env states and the generator restart
from the seed, as in the JAX package).

With ``eval_every`` the policies are evaluated greedily every
``eval_every`` updates on a held-out world (:func:`make_eval_env`) for
``eval_steps`` steps of ``eval_envs`` envs (:func:`eval_rollout`), which
adds ``{name}/eval_mean_reward`` and, with ``log_env_info``, the
``eval_``-prefixed action and info metrics to the update's metrics.

Not ported yet, and refused by :func:`check_ported` or ``make_network``:
the pipeline rollout, meshes, ``cnn_gru`` and continuous actions on
``gru``.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
from torch import nn

from vit_marl_tpu_torch.config import MultiAgentConfig, TrainConfig
from vit_marl_tpu_torch.env import spaces
from vit_marl_tpu_torch.env.structs import Info
from vit_marl_tpu_torch.env.world import WorldEnv
from vit_marl_tpu_torch.models.rnn import ActorCriticRNN, ScannedGRU
from vit_marl_tpu_torch.models.vit import VIT_PRESETS, ViTActorCriticRNN
from vit_marl_tpu_torch.rl.checkpoint import (
    CheckpointManager,
    adam_state,
    load_adam_state,
)
from vit_marl_tpu_torch.rl.logger import Logger
from vit_marl_tpu_torch.utils.tree import tree_map

Tensor = torch.Tensor


class Transition(NamedTuple):
    """(ref: ippo_rnn_JAXMARL.py:119-128); leaves are ``(T, actors, ...)``
    once stacked; ``obs`` may be a dict of such leaves."""

    global_done: Tensor
    done: Tensor
    action: Tensor
    value: Tensor
    reward: Tensor
    log_prob: Tensor
    obs: Tensor


def batchify(x, num_actors: int):
    """``(E, n, ...)`` -> ``(E * n, ...)``, env-major; leaf by leaf for a
    dict observation."""
    return tree_map(
        lambda v: v.reshape((num_actors,) + tuple(v.shape[2:])), x)


def global_done_for_actors(done_all: Tensor, n_per_type: int) -> Tensor:
    """Per-env ``__all__`` done on the env-major actor axis: actor k belongs
    to env k // n, hence ``repeat_interleave`` (ref: ppo.py:53-62)."""
    return done_all.repeat_interleave(n_per_type)


def _per_type(val, i: int):
    if isinstance(val, (tuple, list)):
        return val[i % len(val)]
    return val


def _moments(info: Info, squares: bool):
    """Per-field float32 means over all elements (and means of squares:
    ``(2,)`` ``[mean, mean of squares]`` a field).  The fields come in
    :class:`Info`'s buffers, one a (dtype, shape); the buffers of one
    element count are cast into one float32 block (a copy a buffer),
    squared in one pass and reduced in one."""
    groups: Dict[int, list] = {}
    for names, buf in info.buffers:
        groups.setdefault(buf[0].numel(), []).append((names, buf))
    out = {}
    for numel, bufs in groups.items():
        n_fields = sum(len(names) for names, _ in bufs)
        dev = bufs[0][1].device
        y = torch.empty((2 if squares else 1, n_fields, numel),
                        dtype=torch.float32, device=dev)
        off = 0
        for names, buf in bufs:
            y[0, off:off + len(names)].view(buf.shape).copy_(buf)
            off += len(names)
        if squares:
            torch.mul(y[0], y[0], out=y[1])
        m = y.mean(dim=2)
        keys = [k for names, _ in bufs for k in names]
        out.update((k, m[:, j] if squares else m[0, j])
                   for j, k in enumerate(keys))
    return {k: out[k] for k in info}


def _reduce_info(info):
    """One env step's info tree reduced on the device (ref: ppo.py:71-91):
    each agent type's fields to ``(2,)`` ``[mean, mean of squares]``, the
    world's to means.  A dict of fields is taken into an :class:`Info`
    first."""
    def as_info(d):
        return d if isinstance(d, Info) else Info(d)
    return {"agents": [_moments(as_info(inf), True)
                       for inf in info["agents"]],
            "world": _moments(as_info(info["world"]), False)}


def _action_metrics(action: Tensor, space, prefix: str, out) -> None:
    """Per-update action metrics (ref: ppo.py:93-110): the percentage of
    each action id of a Discrete space (``bincount(length=n)``), or the
    mean and population std of a Box space's sampled actions."""
    if isinstance(space, spaces.Discrete):
        ids = torch.arange(space.n, device=action.device)
        counts = (action.reshape(-1, 1).to(torch.int32) == ids).sum(0)
        pct = 100.0 * counts / action.numel()
        for a in range(space.n):
            out[f"{prefix}/action_pct_{a}"] = pct[a]
    else:
        af = action.to(torch.float32)
        out[f"{prefix}/action_mean"] = af.mean()
        out[f"{prefix}/action_std"] = af.std(correction=0)


def _fold_info_stats(info_stats, names, out, prefix: str = "") -> None:
    """Fold stacked per-step moments (agent leaves ``(steps, 2)``, world
    leaves ``(steps,)``) into per-update mean/std metrics (ref:
    ppo.py:113-130): every step reduces as many elements, so the mean of
    the per-step moments is the whole rollout's, and std =
    sqrt(max(E[x^2] - E[x]^2, 0))."""
    for i, name in enumerate(names):
        for k, ms in info_stats["agents"][i].items():
            mean = ms[:, 0].mean()
            var = torch.clamp(ms[:, 1].mean() - mean.square(), min=0.0)
            out[f"{prefix}{name}/info_{k}_mean"] = mean
            out[f"{prefix}{name}/info_{k}_std"] = torch.sqrt(var)
    for k, v in info_stats["world"].items():
        out[f"{prefix}world/{k}_mean"] = v.mean()


def compute_gae(traj: Transition, last_val: Tensor, gamma: float,
                lam: float):
    """Reverse-loop GAE (ref: ppo.py:410-420); returns (advantages,
    targets), both ``(T, actors)``."""
    gae = torch.zeros_like(last_val)
    next_value = last_val
    adv = []
    for t in range(traj.reward.shape[0] - 1, -1, -1):
        not_done = 1.0 - traj.global_done[t].to(last_val.dtype)
        delta = traj.reward[t] + gamma * next_value * not_done \
            - traj.value[t]
        gae = delta + gamma * lam * not_done * gae
        adv.append(gae)
        next_value = traj.value[t]
    advantages = torch.stack(adv[::-1])
    return advantages, advantages + traj.value


def linear_schedule(lr: float, count: int, n_mb: int,
                    num_updates: int) -> float:
    """(ref: ppo.py:314-317): constant within an update, read at the
    optimizer step count before the step."""
    return lr * (1.0 - (count // n_mb) / num_updates)


class PPOLearner:
    """One agent type's network and optimizer state."""

    def __init__(self, net: nn.Module, cfg: TrainConfig, i: int,
                 num_updates: int):
        self.net = net
        self.lr = float(_per_type(cfg.lr, i))
        self.max_grad_norm = float(_per_type(cfg.max_grad_norm, i))
        self.clip_eps = float(_per_type(cfg.clip_eps, i))
        self.vf_coef = float(_per_type(cfg.vf_coef, i))
        self.ent_coef = float(_per_type(cfg.ent_coef, i))
        self.anneal = cfg.anneal_lr
        self.n_mb = cfg.num_minibatches * cfg.update_epochs
        self.num_updates = num_updates
        self.opt = torch.optim.Adam(net.parameters(), lr=self.lr, eps=1e-5)
        self.count = 0     # optimizer steps taken (optax's schedule count)

    def loss(self, init_h: Tensor, traj: Transition, gae: Tensor,
             targets: Tensor):
        """Clipped PPO loss (ref: ppo.py:442-462)."""
        clip_eps = self.clip_eps
        _, pi, value = self.net(init_h, traj.obs, traj.done)
        log_prob = pi.log_prob(traj.action)
        v_clip = traj.value + (value - traj.value).clamp(-clip_eps, clip_eps)
        v_loss = 0.5 * torch.maximum((value - targets) ** 2,
                                     (v_clip - targets) ** 2).mean()
        logratio = log_prob - traj.log_prob
        ratio = torch.exp(logratio)
        gae = (gae - gae.mean()) / (gae.std(correction=0) + 1e-8)
        l1 = ratio * gae
        l2 = ratio.clamp(1 - clip_eps, 1 + clip_eps) * gae
        actor_loss = -torch.minimum(l1, l2).mean()
        entropy = pi.entropy().mean()
        approx_kl = ((ratio - 1) - logratio).mean()
        clip_frac = ((ratio - 1).abs() > clip_eps).float().mean()
        total = actor_loss + self.vf_coef * v_loss - self.ent_coef * entropy
        return total, torch.stack([v_loss, actor_loss, entropy, approx_kl,
                                   clip_frac])

    def apply_gradients(self) -> None:
        """optax ``clip_by_global_norm`` then Adam at the annealed rate."""
        params = [p for p in self.net.parameters() if p.grad is not None]
        g_norm = torch.sqrt(sum((p.grad.float() ** 2).sum() for p in params))
        keep = g_norm < self.max_grad_norm
        for p in params:
            p.grad = torch.where(keep, p.grad,
                                 p.grad / g_norm * self.max_grad_norm)
        lr = (linear_schedule(self.lr, self.count, self.n_mb,
                              self.num_updates) if self.anneal else self.lr)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1

    def update(self, init_h: Tensor, traj: Transition, advantages: Tensor,
               targets: Tensor, num_minibatches: int,
               perms: Sequence[Tensor]) -> Dict[str, Tensor]:
        """PPO epochs (ref: ppo.py:464-501): one permutation of the actors
        per epoch, ``num_minibatches`` contiguous slices of it."""
        n_actors = advantages.shape[1]
        mb = n_actors // num_minibatches
        losses = []
        for perm in perms:
            for j in range(num_minibatches):
                idx = perm[j * mb:(j + 1) * mb]
                batch = tree_map(lambda v: v[:, idx], traj)
                self.opt.zero_grad(set_to_none=True)
                total, aux = self.loss(init_h[idx], batch, advantages[:, idx],
                                       targets[:, idx])
                total.backward()
                self.apply_gradients()
                losses.append(torch.cat([total.detach()[None],
                                         aux.detach()]))
        ls = torch.stack(losses).mean(dim=0)
        names = ("total_loss", "value_loss", "actor_loss", "entropy",
                 "approx_kl", "clip_frac")
        return dict(zip(names, ls))


def make_network(cfg: TrainConfig, i: int, action_space, obs_space
                 ) -> nn.Module:
    """The policy network of agent type ``i`` (ref: ppo.py:131-172)."""
    kind = _per_type(cfg.network, i)
    continuous = isinstance(action_space, spaces.Box)
    if continuous:
        action_dim = int(action_space.shape[0])
        low, high = action_space.low, action_space.high
    else:
        action_dim = int(action_space.n)
        low = high = None
    if kind == "vit_gru":
        # the preset with the vit_* switches (ref: ppo.py:141-156);
        # models/vit.py raises for a mode the port does not have
        vit = dataclasses.replace(
            VIT_PRESETS[cfg.vit_preset],
            fused_block=cfg.vit_fused_block,
            fused_block_full=cfg.vit_fused_block_full,
            attn_kernel=cfg.vit_attn_kernel,
            attn_bwd_kernel=cfg.vit_attn_bwd_kernel,
            attn_env_block=cfg.vit_attn_env_block,
            attn_ln_fold=cfg.vit_attn_ln_fold)
        return ViTActorCriticRNN(
            obs_dim=int(obs_space.spaces["obs"].shape[0]),
            levels=int(obs_space.spaces["vision_obs"].shape[0]),
            action_dim=action_dim, vit=vit, fc_dim=cfg.fc_dim,
            hidden_size=cfg.hidden_size, action_low=low, action_high=high)
    if kind != "gru":
        raise NotImplementedError(f"network {kind!r} is not ported yet")
    if continuous:
        raise NotImplementedError(
            "continuous actions on the gru network are not ported yet")
    return ActorCriticRNN(obs_dim=int(obs_space.shape[0]),
                          action_dim=action_dim, fc_dim=cfg.fc_dim,
                          hidden_size=cfg.hidden_size)


def make_networks(env: WorldEnv, cfg: TrainConfig) -> List[nn.Module]:
    return [make_network(cfg, i, env.action_spaces[i],
                         env.observation_spaces[i]).to(env.device)
            for i in range(len(env.agent_types))]


def check_ported(cfg: TrainConfig) -> None:
    """Raise ``NotImplementedError`` for a trainer option the port would
    otherwise accept and drop without a word: a device mesh and the
    pipelined rollout."""
    refused = {
        "MESH_SHAPE": tuple(cfg.mesh_shape) != (),
        "ROLLOUT_MODE": cfg.rollout_mode == "pipeline",
    }
    bad = [k for k, v in refused.items() if v]
    if bad:
        raise NotImplementedError(
            f"{', '.join(bad)}: not ported yet (mesh_shape="
            f"{tuple(cfg.mesh_shape)}, rollout_mode={cfg.rollout_mode!r})")


def make_eval_env(ma_config: MultiAgentConfig, cfg: TrainConfig,
                  train_env: WorldEnv) -> WorldEnv:
    """The held-out evaluation world (ref: ppo.py:182-214), on the
    training world's device.

    LOBSTER data: ``cfg.eval_time_period`` selects the held-out period;
    without it the training data is used only with
    ``cfg.eval_allow_in_sample`` (a warning on stderr), else this raises.
    Synthetic data: ``cfg.eval_data_seed`` (auto: world seed + 1) makes a
    different day.
    """
    wcfg = ma_config.world
    dev = train_env.device
    if cfg.eval_time_period and wcfg.data_path:
        ew = dataclasses.replace(wcfg, time_period=cfg.eval_time_period)
        return WorldEnv(dataclasses.replace(ma_config, world=ew), device=dev)
    if not wcfg.data_path:
        seed = cfg.eval_data_seed if cfg.eval_data_seed >= 0 \
            else wcfg.seed + 1
        ew = dataclasses.replace(wcfg, seed=seed)
        return WorldEnv(dataclasses.replace(ma_config, world=ew), device=dev)
    if cfg.eval_allow_in_sample:
        print("WARNING: eval env shares the TRAINING data "
              "(EVAL_ALLOW_IN_SAMPLE=true) — eval curves are in-sample.",
              file=sys.stderr)
        return train_env
    raise ValueError(
        "LOBSTER data is configured but EVAL_TIME_PERIOD is unset: the "
        "eval env would silently share the TRAINING data and every eval "
        "curve would be in-sample. Set EVAL_TIME_PERIOD to a held-out "
        "period, or opt in explicitly with EVAL_ALLOW_IN_SAMPLE=true "
        "(smoke runs only).")


def eval_rollout(env: WorldEnv, nets: Sequence[nn.Module], n_envs: int,
                 n_steps: int, hidden_size: int, log_env_info: bool,
                 generator: Optional[torch.Generator] = None,
                 draws=None) -> Dict[str, Tensor]:
    """Greedy evaluation (ref: ppo.py:668-716): ``n_steps`` steps of
    ``n_envs`` envs from a reset, each type acting on its distribution's
    mode.  Returns ``{name}/eval_mean_reward`` (the mean over steps of
    each step's mean reward) and, with ``log_env_info``, the
    ``eval_{name}/action_*`` and ``eval_``-prefixed info metrics.
    ``draws``: (reset draws, a step's draws each step), which tests feed
    from the JAX package's keys; else the env draws from ``generator``."""
    n_types = len(env.agent_types)
    actors = [n * n_envs for n in env.n_per_type]
    dev = env.device
    params = env.default_params
    obs, state = env.reset(draws[0] if draws else
                           env.draw_reset(n_envs, generator), params)
    hs = [ScannedGRU.initialize_carry(actors[i], hidden_size, dev)
          for i in range(n_types)]
    dns = [torch.zeros(actors[i], dtype=torch.bool, device=dev)
           for i in range(n_types)]
    rews, stats, acts = [], [], [[] for _ in range(n_types)]
    with torch.no_grad():
        for t in range(n_steps):
            step_acts = []
            for i in range(n_types):
                obs_i = tree_map(lambda v: v[None],
                                 batchify(obs[i], actors[i]))
                hs[i], pi, _ = nets[i](hs[i], obs_i, dns[i][None])
                a = pi.mode()[0]
                a = a.reshape((n_envs, env.n_per_type[i])
                              + tuple(a.shape[1:]))
                acts[i].append(a)
                step_acts.append(a[:, 0] if env.n_per_type[i] == 1 else a)
            obs, state, rew, done, info = env.step_vec(
                state, step_acts, params,
                draws=draws[1][t] if draws else None, generator=generator)
            dns = [done["agents"][i].reshape(actors[i])
                   for i in range(n_types)]
            rews.append(torch.stack([r.float().mean() for r in rew]))
            if log_env_info:
                stats.append(_reduce_info(info))
    names = [a.cfg.short_name for a in env.agent_types]
    mean_rew = torch.stack(rews).mean(dim=0)
    out = {f"{names[i]}/eval_mean_reward": mean_rew[i]
           for i in range(n_types)}
    if log_env_info:
        for i in range(n_types):
            _action_metrics(torch.stack(acts[i]), env.action_spaces[i],
                            f"eval_{names[i]}", out)
        _fold_info_stats(tree_map(lambda *v: torch.stack(v), *stats),
                         names, out, prefix="eval_")
    return out


def _resume(ckpt: CheckpointManager, learners: Sequence[PPOLearner]) -> int:
    """Restore each learner's parameters, Adam state and step count from
    the latest checkpoint (ref: ppo.py:216-271); returns the next update.
    Raises ``ValueError`` where a saved shape or the optimizer's structure
    differs from the live one."""
    latest = ckpt.latest_step()
    restored = ckpt.restore(latest)
    if len(restored["params"]) != len(learners):
        raise ValueError(f"resume: {len(restored['params'])} agent types "
                         f"saved, {len(learners)} live")
    for i, lr in enumerate(learners):
        live = lr.net.state_dict()
        saved = restored["params"][i]
        if set(saved) != set(live):
            raise ValueError(f"resume: agent type {i}'s parameters changed "
                             "since the checkpoint was written")
        for k, v in live.items():
            if saved[k].shape != v.shape:
                raise ValueError(
                    f"resume: checkpoint leaf {k} has shape "
                    f"{tuple(saved[k].shape)}, the live network's "
                    f"{tuple(v.shape)}: the network architecture changed "
                    "since the checkpoint was written "
                    "(hidden_size/fc_dim/preset?). Start fresh or match "
                    "the original config.")
        lr.net.load_state_dict(saved)
        load_adam_state(lr.opt, restored["opt"][i], f" (agent type {i})")
        lr.count = int(restored["count"][i])
    print(f"resumed from checkpoint update {latest} "
          f"(next update: {latest + 1})", flush=True)
    return latest + 1


def make_train(ma_config: MultiAgentConfig, cfg: TrainConfig,
               env: Optional[WorldEnv] = None, device=None,
               logger: Optional[Logger] = None):
    """Build the training function (ref: ppo.py:274-833).

    The env (with its window table) is built here, on ``device`` (the card
    unless ``device="cpu"``); ``train(seed, n_updates=None)`` then seeds a
    ``torch.Generator`` and the networks from ``seed``, restores the latest
    checkpoint with ``cfg.resume``, and runs the updates from there to
    ``cfg.num_updates`` (at most ``n_updates`` of them).  ``logger``
    (default: ``cfg.log_backend`` to ``cfg.log_path``) receives each
    update's metrics dict.
    """
    check_ported(cfg)
    if cfg.resume and not cfg.checkpoint_dir:
        raise ValueError(
            "RESUME=true needs CHECKPOINT_DIR set: with no checkpoint "
            "directory there is nothing to resume from (refusing to "
            "silently restart at update 0)")
    env = env or WorldEnv(ma_config, device=device)
    eval_env = make_eval_env(ma_config, cfg, env) if cfg.eval_every \
        else None
    logger = logger or Logger(cfg.log_backend, cfg.log_path)
    dev = env.device
    n_types = len(env.agent_types)
    num_actors = [n * cfg.num_envs for n in env.n_per_type]
    num_updates = max(cfg.num_updates, 1)
    if any(a % cfg.num_minibatches for a in num_actors):
        raise ValueError("actors per type must divide into NUM_MINIBATCHES")
    for i, sp in enumerate(env.observation_spaces):
        if (isinstance(sp, spaces.Dict)
                and _per_type(cfg.network, i) != "vit_gru"):
            raise ValueError(f"agent type {i} emits dict observations; set "
                             f"network[{i}] to 'vit_gru'")

    def train(seed: int = 0, n_updates: Optional[int] = None):
        torch.manual_seed(seed)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        params = env.default_params
        nets = make_networks(env, cfg)
        learners = [PPOLearner(nets[i], cfg, i, num_updates)
                    for i in range(n_types)]
        hstates = [ScannedGRU.initialize_carry(num_actors[i], cfg.hidden_size,
                                               dev) for i in range(n_types)]
        obs, state = env.reset(env.draw_reset(cfg.num_envs, gen), params)
        dones = [torch.zeros(num_actors[i], dtype=torch.bool, device=dev)
                 for i in range(n_types)]
        ckpt = (CheckpointManager(cfg.checkpoint_dir,
                                  max_to_keep=cfg.checkpoint_max_to_keep)
                if cfg.checkpoint_dir else None)
        start = 0
        if cfg.resume and ckpt.latest_step() is not None:
            start = _resume(ckpt, learners)
        stop = (num_updates if n_updates is None
                else min(num_updates, start + n_updates))
        names = [a.cfg.short_name for a in env.agent_types]
        metrics_history = []
        for u in range(start, stop):
            t0 = time.perf_counter()
            initial_h = [h.clone() for h in hstates]
            steps: List[List[Transition]] = [[] for _ in range(n_types)]
            step_stats = []
            with torch.no_grad():
                for _ in range(cfg.num_steps):
                    actions, values, log_probs = [], [], []
                    for i in range(n_types):
                        obs_i = tree_map(lambda v: v[None],
                                         batchify(obs[i], num_actors[i]))
                        hstates[i], pi, value = nets[i](
                            hstates[i], obs_i, dones[i][None])
                        action = pi.sample(gen)
                        log_probs.append(pi.log_prob(action)[0])
                        values.append(value[0])
                        actions.append(action[0])
                    env_actions = [
                        a.reshape((cfg.num_envs, n) + a.shape[1:])
                        if n > 1 else a
                        for a, n in zip(actions, env.n_per_type)]
                    obs, state, reward, done, info = env.step_vec(
                        state, env_actions, params, generator=gen)
                    if cfg.log_env_info:
                        step_stats.append(_reduce_info(info))
                    for i in range(n_types):
                        steps[i].append(Transition(
                            global_done=global_done_for_actors(
                                done["__all__"], env.n_per_type[i]),
                            done=dones[i], action=actions[i],
                            value=values[i],
                            reward=batchify(reward[i], num_actors[i]),
                            log_prob=log_probs[i],
                            obs=batchify(obs[i], num_actors[i])))
                        dones[i] = batchify(done["agents"][i], num_actors[i])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            metrics: Dict[str, Tensor] = {}
            for i in range(n_types):
                traj = tree_map(lambda *v: torch.stack(v), *steps[i])
                with torch.no_grad():
                    _, _, last_val = nets[i](
                        hstates[i], tree_map(lambda v: v[None], batchify(
                            obs[i], num_actors[i])), dones[i][None])
                    adv, tgt = compute_gae(traj, last_val[0],
                                           _per_type(cfg.gamma, i),
                                           _per_type(cfg.gae_lambda, i))
                perms = [torch.randperm(num_actors[i], generator=gen,
                                        device=dev)
                         for _ in range(cfg.update_epochs)]
                loss_info = learners[i].update(initial_h[i], traj, adv, tgt,
                                               cfg.num_minibatches, perms)
                name = names[i]
                metrics[f"{name}/mean_reward"] = traj.reward.mean()
                for k, v in loss_info.items():
                    metrics[f"{name}/{k}"] = v
                if cfg.log_env_info:
                    _action_metrics(traj.action, env.action_spaces[i], name,
                                    metrics)
            if cfg.log_env_info:
                _fold_info_stats(tree_map(lambda *v: torch.stack(v),
                                          *step_stats), names, metrics)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t2 = time.perf_counter()
            if eval_env is not None and (u + 1) % cfg.eval_every == 0:
                metrics.update(eval_rollout(
                    eval_env, nets, cfg.eval_envs or cfg.num_envs,
                    cfg.eval_steps, cfg.hidden_size, cfg.log_env_info, gen))
            # one read of every metric
            values = torch.stack([v.to(torch.float64)
                                  for v in metrics.values()]).tolist()
            metrics = {"update_step": u, **dict(zip(metrics, values))}
            metrics["rollout_s"] = t1 - t0
            metrics["update_s"] = t2 - t1
            # keys in sorted order, as the JAX package's jitted update
            # returns them
            metrics = dict(sorted(metrics.items()))
            logger.log(metrics)
            metrics_history.append(metrics)
            if ckpt is not None and ((u + 1) % cfg.checkpoint_every == 0
                                     or u == num_updates - 1):
                ckpt.save(u, [lr.net.state_dict() for lr in learners],
                          [adam_state(lr.opt) for lr in learners],
                          [lr.count for lr in learners], metrics=metrics)
        return {"metrics": metrics_history, "networks": nets,
                "state": state, "learners": learners}

    train.env = env
    train.eval_env = eval_env
    return train
