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

Not ported yet, and refused by :func:`check_ported` or ``make_network``:
eval, checkpoints and resume, the pipeline rollout, meshes, log backends
other than ``print``/``none``, ``cnn_gru`` and continuous actions on
``gru``.  The info/action metrics (``LOG_ENV_INFO``, on by default) are
not emitted.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
from torch import nn

from vit_marl_tpu_torch.config import MultiAgentConfig, TrainConfig
from vit_marl_tpu_torch.env import spaces
from vit_marl_tpu_torch.env.world import WorldEnv
from vit_marl_tpu_torch.models.rnn import ActorCriticRNN, ScannedGRU
from vit_marl_tpu_torch.models.vit import VIT_PRESETS, ViTActorCriticRNN
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
    otherwise accept and drop without a word: a device mesh, periodic
    eval, checkpoints or resume, the pipelined rollout, and log backends
    other than ``print`` and ``none``."""
    refused = {
        "MESH_SHAPE": tuple(cfg.mesh_shape) != (),
        "EVAL_EVERY": cfg.eval_every > 0,
        "CHECKPOINT_DIR": bool(cfg.checkpoint_dir),
        "RESUME": cfg.resume,
        "ROLLOUT_MODE": cfg.rollout_mode == "pipeline",
        "LOG_BACKEND": cfg.log_backend not in ("print", "none"),
    }
    bad = [k for k, v in refused.items() if v]
    if bad:
        raise NotImplementedError(
            f"{', '.join(bad)}: not ported yet (mesh_shape="
            f"{tuple(cfg.mesh_shape)}, eval_every={cfg.eval_every}, "
            f"checkpoint_dir={cfg.checkpoint_dir!r}, resume={cfg.resume}, "
            f"rollout_mode={cfg.rollout_mode!r}, "
            f"log_backend={cfg.log_backend!r})")


def make_train(ma_config: MultiAgentConfig, cfg: TrainConfig,
               env: Optional[WorldEnv] = None, device=None,
               log=None):
    """Build the training function (ref: ppo.py:274-833).

    The env (with its window table) is built here, on ``device`` (the card
    unless ``device="cpu"``); ``train(seed)`` then seeds a
    ``torch.Generator`` and the networks from ``seed`` and runs
    ``cfg.num_updates`` updates.  ``log``, if given, receives each update's
    metrics dict.
    """
    check_ported(cfg)
    env = env or WorldEnv(ma_config, device=device)
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
        metrics_history = []
        for u in range(num_updates if n_updates is None else n_updates):
            t0 = time.perf_counter()
            initial_h = [h.clone() for h in hstates]
            steps: List[List[Transition]] = [[] for _ in range(n_types)]
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
                    obs, state, reward, done, _ = env.step_vec(
                        state, env_actions, params, generator=gen)
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
            metrics: Dict[str, float] = {"update_step": u}
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
                name = env.agent_types[i].cfg.short_name
                metrics[f"{name}/mean_reward"] = traj.reward.mean()
                for k, v in loss_info.items():
                    metrics[f"{name}/{k}"] = v
            metrics = {k: float(v) for k, v in metrics.items()}
            t2 = time.perf_counter()
            metrics["rollout_s"] = t1 - t0
            metrics["update_s"] = t2 - t1
            metrics_history.append(metrics)
            if log is not None:
                log(metrics)
        return {"metrics": metrics_history, "networks": nets,
                "state": state, "learners": learners}

    train.env = env
    return train
