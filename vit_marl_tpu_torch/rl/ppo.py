"""IPPO with recurrent policies, on one device or data parallel.

Port of ``vit_marl_tpu/rl/ppo.py::make_train`` for GRU policies
(``gru``), and ViT-GRU and CNN-GRU policies over ``{"obs",
"vision_obs"}`` dict observations (``vit_gru``, ``cnn_gru``), each with
discrete or continuous (``Box``) actions:
one network, optimizer and hidden state per agent type; each update collects
``num_steps`` batched env steps, computes per-type GAE (a reverse loop)
and runs per-type clipped-PPO epochs over shuffled minibatches of actors.
The optimizer is the reference's
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
Under ``scan`` (and ``auto``) the eval replays one CUDA graph of its step
on a card (:class:`EvalRollout`, captured at the first eval), its body
eagerly on the CPU; ``loop`` and ``pipeline`` issue it step by step
(:func:`eval_rollout_loop`).

The rollout mode resolves as in the JAX package (:func:`rollout_mode`):
``scan``, and ``auto`` (the JAX package's ``auto`` is the scan on every
backend but a TPU), collect with ``rl/scan.py`` (on a card one CUDA
graph of the step, replayed ``num_steps`` times; on the CPU the same body
run eagerly); ``loop`` with the host loop :func:`rollout_loop`;
``pipeline`` with the split-batch pipelined rollout
(:func:`rollout_pipeline`, ``rl/pipeline.py``).  ``MESH_SHAPE``
over data axes trains data parallel over ``torch.distributed``, one
process a device (``parallel/``, :class:`PPOLearner`); a ``model`` axis
adds tensor parallelism: each model rank stores its share of the split
weights and of their Adam moments (``parallel/mesh.py``).  Refused by
:func:`check_ported`: an axis wider than one that is neither a data axis
nor ``model``, a mesh of more ranks than the group, the pipeline under
a group of several ranks.
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
from vit_marl_tpu_torch.models.cnn import CNNActorCriticRNN
from vit_marl_tpu_torch.models.rnn import ActorCriticRNN, ScannedGRU
from vit_marl_tpu_torch.models.vit import VIT_PRESETS, ViTActorCriticRNN
from vit_marl_tpu_torch.parallel.distributed import DataGroup, mesh_groups
from vit_marl_tpu_torch.parallel.mesh import (
    join_shards,
    mesh_ranks,
    placement_plan,
    shard,
    wide_other_axes,
)
from vit_marl_tpu_torch.parallel.shard_step import make_sharded_step, rank_seed
from vit_marl_tpu_torch.rl.pipeline import (
    concat_halves,
    make_pipelined_runner,
    split_half,
)
from vit_marl_tpu_torch.rl.checkpoint import (
    CheckpointManager,
    adam_state,
    load_adam_state,
)
from vit_marl_tpu_torch.rl.logger import Logger
from vit_marl_tpu_torch.rl.scan import ScanRollout, StepGraph, assign
from vit_marl_tpu_torch.utils.tree import tree_leaves, tree_map

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


def _action_metrics(action: Tensor, space, prefix: str, out,
                    group: Optional[DataGroup] = None) -> None:
    """Per-update action metrics (ref: ppo.py:93-110): the percentage of
    each action id of a Discrete space (``bincount(length=n)``), or the
    mean and population std of a Box space's sampled actions; under a
    group, of every rank's actions (equal counts a rank)."""
    group = group or DataGroup()
    if isinstance(space, spaces.Discrete):
        ids = torch.arange(space.n, device=action.device)
        counts = (action.reshape(-1, 1).to(torch.int32) == ids).sum(0)
        (pct,) = group.mean_tensors([100.0 * counts / action.numel()])
        for a in range(space.n):
            out[f"{prefix}/action_pct_{a}"] = pct[a]
    elif not group.distributed:
        af = action.to(torch.float32)
        out[f"{prefix}/action_mean"] = af.mean()
        out[f"{prefix}/action_std"] = af.std(correction=0)
    else:
        af = action.to(torch.float32)
        (mean,) = group.mean_tensors([af.mean()])
        (var,) = group.mean_tensors([(af - mean).square().mean()])
        out[f"{prefix}/action_mean"] = mean
        out[f"{prefix}/action_std"] = torch.sqrt(var)


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


def global_actors(n_local: int, group: DataGroup) -> int:
    """A type's actors over the data ranks: the model ranks of one data
    index hold the same actors, so the loss's row count takes no model
    rank."""
    return n_local * group.world


class PPOLearner:
    """One agent type's network and optimizer state.

    Under a :class:`~vit_marl_tpu_torch.parallel.distributed.DataGroup`
    with a process group each rank holds its own share of the actors, and
    the update computes what the JAX package's GSPMD update computes over
    the global batch: every minibatch is a slice of one permutation of the
    *global* actors an epoch (``vit_marl_tpu/rl/ppo.py:474-481``), so its
    rows fall unevenly across ranks; each rank evaluates the loss terms on
    the rows it holds as sums over the global row count, the advantage
    normalisation's mean and centred second moment are all-reduced first,
    the gradients (with the loss terms, for the metrics) are all-reduced
    in one buffer, and every rank clips by the same global norm and takes
    the same Adam step.

    Under a ``model`` axis (``group.model``) the weights that
    ``parallel/mesh.py::placement_plan`` splits are stored, with their
    Adam moments, as shards: the optimizer's parameter for such a leaf
    is this model rank's block of it (a view of the network's weight),
    and the network's whole weights are the gathered copy the rollout
    and the PPO forward and backward read.  A step all-reduces over the
    data ranks this rank's block of each split leaf's gradient and the
    whole gradient of each replicated one, takes the global norm from
    the replicated part and the model ranks' all-reduced split part,
    takes the Adam step on the blocks, and all-gathers the updated
    blocks into the whole weights (in place: a captured graph reading
    them sees the new values).  Every collective is outside the
    rollout's graph, and the fused kernels take whole weights, as the
    JAX package's Pallas calls do under GSPMD."""

    def __init__(self, net: nn.Module, cfg: TrainConfig, i: int,
                 num_updates: int, group: Optional[DataGroup] = None):
        self.net = net
        self.group = group or DataGroup()
        self.lr = float(_per_type(cfg.lr, i))
        self.max_grad_norm = float(_per_type(cfg.max_grad_norm, i))
        self.clip_eps = float(_per_type(cfg.clip_eps, i))
        self.vf_coef = float(_per_type(cfg.vf_coef, i))
        self.ent_coef = float(_per_type(cfg.ent_coef, i))
        self.anneal = cfg.anneal_lr
        self.n_mb = cfg.num_minibatches * cfg.update_epochs
        self.num_updates = num_updates
        model = self.group.model
        self.splits = (list(placement_plan(net, model.world).values())
                       if model is not None else
                       [None] * len(list(net.parameters())))
        # the optimizer's parameters: this rank's block of a split leaf (a
        # view of the network's weight), a replicated leaf whole
        self.opt_params = [
            p if s is None else nn.Parameter(
                shard(p.detach(), s, model.rank, model.world))
            for p, s in zip(net.parameters(), self.splits)]
        self.opt = torch.optim.Adam(self.opt_params, lr=self.lr, eps=1e-5)
        self.count = 0     # optimizer steps taken (optax's schedule count)

    def loss(self, init_h: Tensor, traj: Transition, gae: Tensor,
             targets: Tensor, count: Optional[int] = None):
        """Clipped PPO loss (ref: ppo.py:442-462) over a minibatch of
        ``count`` (T x actors) elements, of which this rank holds
        ``traj``'s: each term is this rank's sum over ``count``, the
        advantages normalised by the all-reduced moments.  Returns (total,
        the five terms stacked), this rank's shares."""
        clip_eps = self.clip_eps
        g = self.group
        count = gae.numel() if count is None else count
        # the global minibatch's advantage moments (biased std, as jnp's)
        mean = g.all_reduce(gae.sum()[None])[0] / count
        var = g.all_reduce((gae - mean).square().sum()[None])[0] / count
        gae = (gae - mean) / (torch.sqrt(var) + 1e-8)
        if traj.value.numel() == 0:
            # no row of this minibatch on this rank: nothing to add, but
            # every parameter still joins the gradient all-reduce
            zero = sum(p.sum() for p in self.net.parameters()) * 0.0
            return zero, zero.new_zeros(5)
        _, pi, value = self.net(init_h, traj.obs, traj.done)
        log_prob = pi.log_prob(traj.action)
        v_clip = traj.value + (value - traj.value).clamp(-clip_eps, clip_eps)
        v_loss = 0.5 * torch.maximum((value - targets) ** 2,
                                     (v_clip - targets) ** 2).sum() / count
        logratio = log_prob - traj.log_prob
        ratio = torch.exp(logratio)
        l1 = ratio * gae
        l2 = ratio.clamp(1 - clip_eps, 1 + clip_eps) * gae
        actor_loss = -torch.minimum(l1, l2).sum() / count
        # a SquashedNormal's entropy is one value for every element
        entropy = torch.broadcast_to(pi.entropy(), log_prob.shape).sum() \
            / count
        approx_kl = ((ratio - 1) - logratio).sum() / count
        clip_frac = ((ratio - 1).abs() > clip_eps).float().sum() / count
        total = actor_loss + self.vf_coef * v_loss - self.ent_coef * entropy
        return total, torch.stack([v_loss, actor_loss, entropy, approx_kl,
                                   clip_frac])

    def apply_gradients(self, aux: Optional[Tensor] = None
                        ) -> Optional[Tensor]:
        """optax ``clip_by_global_norm`` then Adam at the annealed rate.
        Under a group the gradients, and ``aux`` with them, are summed
        over ranks first (one all-reduce); returns the summed ``aux``."""
        params = list(self.net.parameters())
        model = self.group.model
        if self.group.distributed:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            if model is not None:
                # this rank's block of each split leaf's gradient
                grads = [g if s is None else shard(g, s, model.rank,
                                                   model.world)
                         for g, s in zip(grads, self.splits)]
            extra = [] if aux is None else [aux]
            flat = self.group.all_reduce(torch.cat(
                [t.reshape(-1) for t in grads + extra]))
            off = 0
            for q, g in zip(self.opt_params, grads):
                q.grad = flat[off:off + g.numel()].view(g.shape)
                off += g.numel()
            if aux is not None:
                aux = flat[off:]
        params = [q for q in self.opt_params if q.grad is not None]
        if model is None:
            g_norm = torch.sqrt(sum((p.grad.float() ** 2).sum()
                                    for p in params))
        else:
            sq = [sum(((q.grad.float() ** 2).sum()
                       for q, s in zip(self.opt_params, self.splits)
                       if (s is None) is rep), torch.zeros(
                           (), device=params[0].device))
                  for rep in (True, False)]
            # the split leaves' blocks are disjoint: their squares add
            # over the model ranks
            g_norm = torch.sqrt(sq[0] + model.all_reduce(sq[1][None])[0])
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
        if model is not None:
            self.gather_weights()
        return aux

    def gather_weights(self) -> None:
        """Every model rank's blocks of the split leaves into the
        network's whole weights (one all-gather), and model rank 0's
        replicated leaves to the others (one broadcast: a card's
        backward need not repeat bit for bit, and the model ranks must
        hold one set of weights)."""
        model = self.group.model
        split = [(p, q, s) for p, q, s in zip(self.net.parameters(),
                                              self.opt_params, self.splits)
                 if s is not None]
        rep = [p for p, s in zip(self.net.parameters(), self.splits)
               if s is None]
        with torch.no_grad():
            if rep:
                flat = model.broadcast(torch.cat([p.reshape(-1)
                                                  for p in rep]))
                off = 0
                for p in rep:
                    p.copy_(flat[off:off + p.numel()].view_as(p))
                    off += p.numel()
            if not split:
                return
            blocks = model.all_gather(torch.cat(
                [q.detach().reshape(-1) for _, q, _ in split]))
            off = 0
            for p, q, s in split:
                join_shards(p.data, blocks[:, off:off + q.numel()].view(
                    (model.world,) + tuple(q.shape)), s)
                off += q.numel()

    def adam_state(self) -> Dict[str, List[Tensor]]:
        """The Adam moments and step counts in ``net.parameters()`` order,
        whole (``rl/checkpoint.py``'s format, the same as one process's);
        under a model axis the blocks are all-gathered, so every model
        rank must call this."""
        st = adam_state(self.opt)
        model = self.group.model
        if model is None:
            return st
        idx = [j for j, s in enumerate(self.splits) if s is not None]
        params = list(self.net.parameters())
        for key in ("exp_avg", "exp_avg_sq"):
            moments = st[key]
            blocks = model.all_gather(torch.cat(
                [moments[j].reshape(-1) for j in idx]))
            off = 0
            for j in idx:
                k = moments[j].numel()
                full = torch.empty_like(params[j])
                moments[j] = join_shards(full, blocks[:, off:off + k].view(
                    (model.world,) + tuple(moments[j].shape)),
                    self.splits[j])
                off += k
        return st

    def load_adam_state(self, saved, label: str = "") -> None:
        """Put whole saved moments and step counts (:meth:`adam_state`'s
        format) into the optimizer; under a model axis each split leaf's
        block of them."""
        model = self.group.model
        if model is not None:
            params = list(self.net.parameters())
            if len(saved["exp_avg"]) == len(params):
                saved = dict(saved)
                for key in ("exp_avg", "exp_avg_sq"):
                    saved[key] = [
                        m if s is None or m.shape != p.shape
                        else shard(m, s, model.rank, model.world)
                        for m, p, s in zip(saved[key], params, self.splits)]
        load_adam_state(self.opt, saved, label)

    def update(self, init_h: Tensor, traj: Transition, advantages: Tensor,
               targets: Tensor, num_minibatches: int,
               perms: Sequence[Tensor]) -> Dict[str, Tensor]:
        """PPO epochs (ref: ppo.py:464-501): one permutation of the
        actors per epoch, ``num_minibatches`` contiguous slices of it.
        Under a group the permutations are of the global actors, and this
        rank's actors are ``rank * n_local`` onwards; the loss metrics are
        the global minibatches'."""
        g = self.group
        n_local = advantages.shape[1]
        n_actors = global_actors(n_local, g)
        mb = n_actors // num_minibatches
        count = advantages.shape[0] * mb
        lo = g.rank * n_local
        losses = []
        for perm in perms:
            if g.distributed:
                # the rows of each global slice that this rank holds, in
                # their order within it (one read of the permutation)
                host = perm.cpu()
            for j in range(num_minibatches):
                if g.distributed:
                    sl = host[j * mb:(j + 1) * mb]
                    idx = (sl[(sl >= lo) & (sl < lo + n_local)] - lo).to(
                        advantages.device)
                else:
                    idx = perm[j * mb:(j + 1) * mb]
                batch = tree_map(lambda v: v[:, idx], traj)
                self.net.zero_grad(set_to_none=True)
                total, aux = self.loss(init_h[idx], batch, advantages[:, idx],
                                       targets[:, idx], count)
                total.backward()
                aux = torch.cat([total.detach()[None], aux.detach()])
                losses.append(self.apply_gradients(aux))
        ls = torch.stack(losses).mean(dim=0)
        names = ("total_loss", "value_loss", "actor_loss", "entropy",
                 "approx_kl", "clip_frac")
        return dict(zip(names, ls))


def make_network(cfg: TrainConfig, i: int, action_space, obs_space
                 ) -> nn.Module:
    """The policy network of agent type ``i`` (ref: ppo.py:131-172):
    ``gru``, ``vit_gru`` or ``cnn_gru``, with a ``Categorical`` head for a
    ``Discrete`` space or a ``SquashedNormal`` one for a ``Box``."""
    kind = _per_type(cfg.network, i)
    continuous = isinstance(action_space, spaces.Box)
    if continuous:
        action_dim = int(action_space.shape[0])
        low, high = action_space.low, action_space.high
    else:
        action_dim = int(action_space.n)
        low = high = None
    if kind in ("vit_gru", "cnn_gru"):
        obs_dim = int(obs_space.spaces["obs"].shape[0])
        levels = int(obs_space.spaces["vision_obs"].shape[0])
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
            obs_dim=obs_dim, levels=levels, action_dim=action_dim, vit=vit,
            fc_dim=cfg.fc_dim, hidden_size=cfg.hidden_size, action_low=low,
            action_high=high)
    if kind == "cnn_gru":
        return CNNActorCriticRNN(
            obs_dim=obs_dim, levels=levels, action_dim=action_dim,
            fc_dim=cfg.fc_dim, hidden_size=cfg.hidden_size, action_low=low,
            action_high=high)
    if kind != "gru":
        raise ValueError(f"unknown network {kind!r}")
    return ActorCriticRNN(obs_dim=int(obs_space.shape[0]),
                          action_dim=action_dim, fc_dim=cfg.fc_dim,
                          hidden_size=cfg.hidden_size, action_low=low,
                          action_high=high)


def make_networks(env: WorldEnv, cfg: TrainConfig) -> List[nn.Module]:
    return [make_network(cfg, i, env.action_spaces[i],
                         env.observation_spaces[i]).to(env.device)
            for i in range(len(env.agent_types))]


def check_ported(cfg: TrainConfig, group: Optional[DataGroup] = None
                 ) -> None:
    """Raise ``NotImplementedError`` for a trainer option the port would
    otherwise accept and drop without a word: a mesh axis wider than one
    device that is neither a data axis nor ``model``; a mesh of more
    ranks (data ranks times the ``model`` axis) than the group
    (``group``: default one process) has; the pipelined rollout under a
    group of more than one rank, which the JAX package refuses too."""
    group = group or DataGroup()
    shape, axes = tuple(cfg.mesh_shape), tuple(cfg.mesh_axes)
    if shape:
        other = wide_other_axes(shape, axes)
        if other:
            raise NotImplementedError(
                f"MESH_SHAPE={list(shape)} over MESH_AXES={list(axes)}: "
                f"the axes {other} are neither data axes nor 'model'; the "
                "port splits envs over 'data' and '*_data' axes and "
                "weights over 'model'")
        need = mesh_ranks(shape, axes)
        if need > group.world:
            raise NotImplementedError(
                f"MESH_SHAPE={list(shape)} needs {need} devices but only "
                f"{group.world} are visible: start one process a device "
                f"(torchrun --nproc-per-node {need} -m "
                "vit_marl_tpu_torch.train ...)")
    if cfg.rollout_mode == "pipeline" and group.world > 1:
        raise NotImplementedError(
            "ROLLOUT_MODE=pipeline does not compose with a multi-device "
            "mesh yet; use loop (the mesh path shards the whole step "
            "instead)")


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
    from the JAX package's keys; else the env draws from ``generator``.
    Runs :class:`EvalRollout` (on a card a graph of the step, captured
    for this call; with ``draws`` its body eagerly)."""
    return EvalRollout(env, nets, n_envs, n_steps, hidden_size,
                       log_env_info, generator).run(draws)


class EvalRollout(StepGraph):
    """The greedy evaluation of :func:`eval_rollout` over static buffers,
    the JAX package's ``jax.lax.scan`` over ``eval_steps``
    (``vit_marl_tpu/rl/ppo.py:703``): the carry (env state, each type's
    observations, done flags and GRU states), ``(n_steps, ...)`` buffers
    of each step's mean rewards and, with ``log_env_info``, of the
    actions and the info moments, and the step index on the device.  On
    a card one step is captured once (``rl/scan.py::StepGraph``: a
    warm-up on a side stream, ``generator`` registered with the graph,
    the carry and the generator put back after the capture) and replayed
    ``n_steps`` times a :meth:`run`; on the CPU the same body runs
    eagerly.  The reset before the steps is eager, as the JAX package's
    is outside its scan (``ppo.py:668-678``).

    The graph reads the networks' parameters from their storage: the
    trainer's optimizer updates them in place, so every :meth:`run`
    sees the current weights.  Replacing a parameter tensor (a resume
    with ``load_state_dict(assign=True)``, a new ``nn.Parameter``)
    would leave a stale graph; :meth:`StepGraph.replay` sees the moved
    tensor and captures again.  A capture that fails raises."""

    def __init__(self, env: WorldEnv, nets: Sequence[nn.Module],
                 n_envs: int, n_steps: int, hidden_size: int,
                 log_env_info: bool,
                 generator: Optional[torch.Generator] = None):
        super().__init__(n_steps, [generator], env.device)
        self.env, self.nets = env, list(nets)
        self.n_envs, self.hidden_size = n_envs, hidden_size
        self.log_env_info = log_env_info
        self.generator = generator
        self.params = env.default_params
        self.actors = [n * n_envs for n in env.n_per_type]
        self.rews = self.acts = self.stats = None

    def step(self, draws=None) -> None:
        """One greedy step from the carry into slot ``t``: the body the
        graph captures (``draws``: eager runs only)."""
        env, c = self.env, self.carry
        hs, acts, step_acts = list(c.hstates), [], []
        for i, net in enumerate(self.nets):
            obs_i = tree_map(lambda v: v[None],
                             batchify(c.obs[i], self.actors[i]))
            hs[i], pi, _ = net(c.hstates[i], obs_i, c.dones[i][None])
            a = pi.mode()[0]
            a = a.reshape((self.n_envs, env.n_per_type[i])
                          + tuple(a.shape[1:]))
            acts.append(a)
            step_acts.append(a[:, 0] if env.n_per_type[i] == 1 else a)
        obs, state, rew, done, info = env.step_vec(
            c.state, step_acts, self.params, draws=draws,
            generator=self.generator)
        dones = [done["agents"][i].reshape(self.actors[i])
                 for i in range(len(self.nets))]
        rew = torch.stack([r.float().mean() for r in rew])
        stats = _reduce_info(info) if self.log_env_info else None
        if self.rews is None:     # the first (eager) step sizes the slots
            self.rews = self._slots(rew)
            if self.log_env_info:
                self.acts, self.stats = self._slots(acts), self._slots(stats)
        self._put(self.rews, rew)
        if self.log_env_info:
            self._put(self.acts, acts)
            self._put(self.stats, stats)
        assign(c, Carry(state, obs, dones, hs))
        self.t.add_(1)

    def run(self, draws=None) -> Dict[str, Tensor]:
        """Reset (eagerly), ``n_steps`` steps, and the metrics of
        :func:`eval_rollout`.  ``draws`` (the reset's and each step's)
        run the body eagerly, on any device."""
        env, dev = self.env, self.device
        obs, state = env.reset(draws[0] if draws else env.draw_reset(
            self.n_envs, self.generator), self.params)
        carry = Carry(state, obs,
                      [torch.zeros(a, dtype=torch.bool, device=dev)
                       for a in self.actors],
                      [ScannedGRU.initialize_carry(a, self.hidden_size, dev)
                       for a in self.actors])
        self.set_carry(carry)
        with torch.no_grad():
            self.replay(draws[1] if draws else None)
        names = [a.cfg.short_name for a in env.agent_types]
        mean_rew = self.rews.mean(dim=0)
        out = {f"{names[i]}/eval_mean_reward": mean_rew[i]
               for i in range(len(names))}
        if self.log_env_info:
            for i in range(len(names)):
                _action_metrics(self.acts[i], env.action_spaces[i],
                                f"eval_{names[i]}", out)
            _fold_info_stats(self.stats, names, out, prefix="eval_")
        return out


def eval_rollout_loop(env: WorldEnv, nets: Sequence[nn.Module],
                      n_envs: int, n_steps: int, hidden_size: int,
                      log_env_info: bool,
                      generator: Optional[torch.Generator] = None,
                      draws=None) -> Dict[str, Tensor]:
    """Greedy evaluation issued step by step from the host (the trainer's
    ``ROLLOUT_MODE=loop``): what :func:`eval_rollout` returns, from the
    same draws."""
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
        lr.load_adam_state(restored["opt"][i], f" (agent type {i})")
        lr.count = int(restored["count"][i])
    print(f"resumed from checkpoint update {latest} "
          f"(next update: {latest + 1})", flush=True)
    return latest + 1


class Carry(NamedTuple):
    """The rollout's carry between steps and updates: the env states,
    each type's observations, done flags and GRU states (actor axis
    env-major)."""

    state: object
    obs: list
    dones: list
    hstates: list


def policy_step(nets: Sequence[nn.Module], obs, dones, hstates, n_envs: int,
                n_per_type: Sequence[int], generator):
    """Every type's policy on one step of ``n_envs`` envs: returns the new
    GRU states, the env's actions and, per type, (action, value,
    log_prob) on the actor axis."""
    hs, env_actions, outs = list(hstates), [], []
    for i, net in enumerate(nets):
        n = n_per_type[i]
        obs_i = tree_map(lambda v: v[None], batchify(obs[i], n_envs * n))
        hs[i], pi, value = net(hs[i], obs_i, dones[i][None])
        action = pi.sample(generator)
        outs.append((action[0], value[0], pi.log_prob(action)[0]))
        a = action[0]
        env_actions.append(a.reshape((n_envs, n) + a.shape[1:]) if n > 1
                           else a)
    return hs, env_actions, outs


def env_step(step_fn, state, env_actions, params, n_envs: int,
             n_per_type: Sequence[int], generator, log_env_info: bool):
    """One env step of ``n_envs`` envs: returns the new state, the
    observations, the new done flags on the actor axis, per type
    (reward, global done, batchified obs) and the step's reduced info."""
    obs, state, reward, done, info = step_fn(state, env_actions, params,
                                             generator=generator)
    outs, dones = [], []
    for i, n in enumerate(n_per_type):
        actors = n_envs * n
        outs.append((batchify(reward[i], actors),
                     global_done_for_actors(done["__all__"], n),
                     batchify(obs[i], actors)))
        dones.append(batchify(done["agents"][i], actors))
    return state, obs, dones, outs, (_reduce_info(info) if log_env_info
                                     else None)


def _transitions(dones_in, pol_out, env_out):
    """Each type's Transition of one step."""
    return [Transition(global_done=e[1], done=d, action=p[0], value=p[1],
                       reward=e[0], log_prob=p[2], obs=e[2])
            for d, p, e in zip(dones_in, pol_out, env_out)]


def _stack_steps(steps, n_types: int):
    """Per type, one step's Transitions stacked over the steps."""
    return [tree_map(lambda *v: torch.stack(v), *[s[i] for s in steps])
            for i in range(n_types)]


def rollout_loop(step_fn, nets, carry: Carry, params, n_steps: int,
                 n_envs: int, n_per_type, pol_gen, env_gen,
                 log_env_info: bool):
    """``n_steps`` steps, policy then env each step (ref: ppo.py:356-402).
    Returns (per type the stacked Transition, the per-step info
    moments or None, the new carry)."""
    steps, stats = [], []
    state, obs, dones, hs = carry
    for _ in range(n_steps):
        hs, acts, pol_out = policy_step(nets, obs, dones, hs, n_envs,
                                        n_per_type, pol_gen)
        dones_in = dones
        state, obs, dones, env_out, st = env_step(
            step_fn, state, acts, params, n_envs, n_per_type, env_gen,
            log_env_info)
        steps.append(_transitions(dones_in, pol_out, env_out))
        stats.append(st)
    info = (tree_map(lambda *v: torch.stack(v), *stats) if log_env_info
            else None)
    return _stack_steps(steps, len(nets)), info, Carry(state, obs, dones, hs)


def rollout_pipeline(step_fn, nets, carry: Carry, params, n_steps: int,
                     n_envs: int, n_per_type, gens, log_env_info: bool,
                     merged: bool = True):
    """The split-batch pipelined rollout (``rl/pipeline.py``; ref:
    ppo.py:533-653): half ``h`` runs its policy on ``gens[0][h]`` and
    its env on ``gens[1][h]``; ``merged`` puts each tick's halves on two
    CUDA streams.  Returns what :func:`rollout_loop` returns, the
    halves joined on the actor (and env) axis."""
    half = n_envs // 2

    def policy_half(_, pol_state, pol_in):
        gen, hs = pol_state
        obs_h, done_h = pol_in
        hs, acts, outs = policy_step(nets, obs_h, done_h, hs, half,
                                     n_per_type, gen)
        # the policy side of each Transition, with its done input
        return (gen, hs), acts, (outs, done_h)

    def env_half(_, env_carry, acts):
        gen, st = env_carry
        st, obs, dones, outs, stats = env_step(
            step_fn, st, acts, params, half, n_per_type, gen, log_env_info)
        return (gen, st), (obs, dones), (outs, stats)

    run = make_pipelined_runner(policy_half, env_half, merged=merged)
    actors = [n * half for n in n_per_type]
    pol_states = [(gens[0][h], [split_half(hv, h, a) for hv, a
                                in zip(carry.hstates, actors)])
                  for h in (0, 1)]
    env_states = [(gens[1][h], split_half(carry.state, h, half))
                  for h in (0, 1)]
    pol_ins = [([split_half(o, h, half) for o in carry.obs],
                [split_half(d, h, a) for d, a in zip(carry.dones, actors)])
               for h in (0, 1)]
    pol_f, env_f, in_f, pouts, eouts = run(None, pol_states, env_states,
                                           pol_ins, n_steps)
    trajs_h = [_stack_steps([_transitions(pouts[h][t][1], pouts[h][t][0],
                                          eouts[h][t][0])
                             for t in range(n_steps)], len(nets))
               for h in (0, 1)]
    # (T, actors, ...) leaves: the halves join on the actor axis
    trajs = [tree_map(lambda a, b: torch.cat([a, b], dim=1), a, b)
             for a, b in zip(*trajs_h)]
    info = None
    if log_env_info:
        # per-step moments over equal half sizes: the mean of the two
        # halves is the full batch's
        st = [tree_map(lambda *v: torch.stack(v),
                       *[eouts[h][t][1] for t in range(n_steps)])
              for h in (0, 1)]
        info = tree_map(lambda a, b: (a + b) / 2, st[0], st[1])
    new = Carry(concat_halves(env_f[0][1], env_f[1][1]),
                [concat_halves(a, b) for a, b in zip(in_f[0][0],
                                                     in_f[1][0])],
                [concat_halves(a, b) for a, b in zip(in_f[0][1],
                                                     in_f[1][1])],
                [concat_halves(a, b) for a, b in zip(pol_f[0][1],
                                                     pol_f[1][1])])
    return trajs, info, new


def pipeline_generators(seed: int, device) -> List[List[torch.Generator]]:
    """The pipelined rollout's generators, ``[policy, env][half]``, each
    seeded from (seed, role, half)."""
    out = []
    for role in range(2):
        row = []
        for h in range(2):
            g = torch.Generator(device=device)
            g.manual_seed(rank_seed(seed, 1 + 2 * role + h))
            row.append(g)
        out.append(row)
    return out


ROLLOUT_MODES = ("auto", "scan", "loop", "pipeline")


def rollout_mode(mode: str) -> str:
    """The collection ``ROLLOUT_MODE`` names (ref: ppo.py:744-745): ``auto``
    is the scan, as in the JAX package on every backend but a TPU;
    ``scan``, ``loop`` and ``pipeline`` name themselves."""
    if mode not in ROLLOUT_MODES:
        raise ValueError(f"ROLLOUT_MODE={mode!r}: one of {ROLLOUT_MODES}")
    return "scan" if mode == "auto" else mode


def resolve_group(cfg: TrainConfig, group: Optional[DataGroup] = None
                  ) -> DataGroup:
    """The data-parallel group of a run: with ``MESH_SHAPE``, ``group``
    or the initialized default process group (one process, no group,
    where there is none); without it, one process."""
    if not tuple(cfg.mesh_shape):
        return DataGroup()
    return group or DataGroup.current()


def make_train(ma_config: MultiAgentConfig, cfg: TrainConfig,
               env: Optional[WorldEnv] = None, device=None,
               logger: Optional[Logger] = None,
               group: Optional[DataGroup] = None):
    """Build the training function (ref: ppo.py:274-833).

    The env (with its window table) is built here, on ``device`` (the card
    unless ``device="cpu"``); ``train(seed, n_updates=None)`` then seeds a
    ``torch.Generator`` and the networks from ``seed``, restores the latest
    checkpoint with ``cfg.resume``, and runs the updates from there to
    ``cfg.num_updates`` (at most ``n_updates`` of them).  ``logger``
    (default: ``cfg.log_backend`` to ``cfg.log_path``) receives each
    update's metrics dict.

    :func:`rollout_mode` picks the collection: the scan
    (``rl/scan.py::ScanRollout``, built once a ``train`` call; on the card
    a CUDA graph of the step, captured before the first update), the loop
    or :func:`rollout_pipeline` (two CUDA streams on the card).

    With ``MESH_SHAPE`` the run is data parallel over ``group`` (default:
    the initialized process group; see :func:`resolve_group`): this rank
    steps ``NUM_ENVS / ranks`` envs with its generator seeded from (seed,
    rank), the networks start from rank 0's weights, the epochs'
    permutations are rank 0's, and the update is the global batch's
    (:class:`PPOLearner`).  Rank 0 logs, checkpoints and evaluates; every
    rank resumes from the same checkpoint.  With a ``model`` axis the
    group is cut into a ``data x model`` grid
    (``parallel/distributed.py::mesh_groups``): "rank" above is the data
    rank, so the model ranks of one data index step the same envs from
    the same seed, each stores its share of the split weights and Adam
    moments, and every model rank of data rank 0 evaluates (their
    generators stay in step) while one of them logs and writes.
    """
    group = resolve_group(cfg, group)
    check_ported(cfg, group)
    if tuple(cfg.mesh_shape) and mesh_ranks(cfg.mesh_shape,
                                            cfg.mesh_axes) != group.world:
        raise ValueError(
            f"MESH_SHAPE={list(cfg.mesh_shape)} has "
            f"{mesh_ranks(cfg.mesh_shape, cfg.mesh_axes)} ranks; the "
            f"group has {group.world}: start one process a rank")
    if tuple(cfg.mesh_shape):
        group = mesh_groups(group, cfg.mesh_shape, cfg.mesh_axes)
    if cfg.resume and not cfg.checkpoint_dir:
        raise ValueError(
            "RESUME=true needs CHECKPOINT_DIR set: with no checkpoint "
            "directory there is nothing to resume from (refusing to "
            "silently restart at update 0)")
    mode = rollout_mode(cfg.rollout_mode)
    pipeline = mode == "pipeline"
    n_envs = group.local_count(cfg.num_envs)
    if pipeline and n_envs % 2:
        raise ValueError("rollout_mode=pipeline needs an even NUM_ENVS")
    env = env or WorldEnv(ma_config, device=device)
    # data rank 0 evaluates and draws the epochs' permutations (under a
    # model axis each model rank of it, so that their generators stay
    # in step); one rank logs and writes checkpoints
    lead = group.rank == 0
    eval_env = make_eval_env(ma_config, cfg, env) \
        if cfg.eval_every and lead else None
    logger = logger or Logger(cfg.log_backend if group.writer else "none",
                              cfg.log_path)
    dev = env.device
    n_types = len(env.agent_types)
    num_actors = [n * n_envs for n in env.n_per_type]
    num_updates = max(cfg.num_updates, 1)
    if any(a * group.world % cfg.num_minibatches for a in num_actors):
        raise ValueError("actors per type must divide into NUM_MINIBATCHES")
    for i, sp in enumerate(env.observation_spaces):
        if (isinstance(sp, spaces.Dict)
                and _per_type(cfg.network, i) not in ("vit_gru", "cnn_gru")):
            raise ValueError(f"agent type {i} emits dict observations; set "
                             f"network[{i}] to 'vit_gru' or 'cnn_gru'")
    step_fn = make_sharded_step(env, group)

    def train(seed: int = 0, n_updates: Optional[int] = None):
        torch.manual_seed(seed)
        gen = torch.Generator(device=dev)
        gen.manual_seed(rank_seed(seed, group.rank))
        half_gens = (pipeline_generators(rank_seed(seed, group.rank), dev)
                     if pipeline else None)
        params = env.default_params
        nets = make_networks(env, cfg)
        for net in nets:
            for t in net.state_dict().values():
                group.broadcast(t)
        learners = [PPOLearner(nets[i], cfg, i, num_updates, group)
                    for i in range(n_types)]
        hstates = [ScannedGRU.initialize_carry(num_actors[i], cfg.hidden_size,
                                               dev) for i in range(n_types)]
        obs, state = env.reset(env.draw_reset(n_envs, gen), params)
        dones = [torch.zeros(num_actors[i], dtype=torch.bool, device=dev)
                 for i in range(n_types)]
        carry = Carry(state, obs, dones, hstates)
        scan = (ScanRollout(step_fn, nets, params, cfg.num_steps, n_envs,
                            env.n_per_type, gen, gen, cfg.log_env_info, dev)
                if mode == "scan" else None)
        evaluator = (EvalRollout(eval_env, nets, cfg.eval_envs
                                 or cfg.num_envs, cfg.eval_steps,
                                 cfg.hidden_size, cfg.log_env_info, gen)
                     if mode == "scan" and eval_env is not None else None)
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
            initial_h = [h.clone() for h in carry.hstates]
            with torch.no_grad():
                if pipeline:
                    trajs, step_stats, carry = rollout_pipeline(
                        step_fn, nets, carry, params, cfg.num_steps, n_envs,
                        env.n_per_type, half_gens, cfg.log_env_info)
                elif scan is not None:
                    trajs, step_stats, carry = scan.run(carry)
                else:
                    trajs, step_stats, carry = rollout_loop(
                        step_fn, nets, carry, params, cfg.num_steps, n_envs,
                        env.n_per_type, gen, gen, cfg.log_env_info)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            metrics: Dict[str, Tensor] = {}
            for i in range(n_types):
                traj = trajs[i]
                with torch.no_grad():
                    _, _, last_val = nets[i](
                        carry.hstates[i], tree_map(lambda v: v[None],
                                                   batchify(carry.obs[i],
                                                            num_actors[i])),
                        carry.dones[i][None])
                    adv, tgt = compute_gae(traj, last_val[0],
                                           _per_type(cfg.gamma, i),
                                           _per_type(cfg.gae_lambda, i))
                n_global = global_actors(num_actors[i], group)
                perms = []
                for _ in range(cfg.update_epochs):
                    perm = (torch.randperm(n_global, generator=gen,
                                           device=dev) if lead else
                            torch.empty(n_global, dtype=torch.int64,
                                        device=dev))
                    perms.append(group.broadcast(perm))
                loss_info = learners[i].update(initial_h[i], traj, adv, tgt,
                                               cfg.num_minibatches, perms)
                name = names[i]
                (metrics[f"{name}/mean_reward"],) = group.mean_tensors(
                    [traj.reward.mean()])
                for k, v in loss_info.items():
                    metrics[f"{name}/{k}"] = v
                if cfg.log_env_info:
                    _action_metrics(traj.action, env.action_spaces[i], name,
                                    metrics, group)
            if cfg.log_env_info:
                # equal counts a rank: the ranks' mean moments are the
                # global batch's
                means = iter(group.mean_tensors(tree_leaves(step_stats)))
                step_stats = tree_map(lambda _: next(means), step_stats)
                _fold_info_stats(step_stats, names, metrics)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t2 = time.perf_counter()
            if eval_env is not None and (u + 1) % cfg.eval_every == 0:
                metrics.update(evaluator.run() if evaluator is not None
                               else eval_rollout_loop(
                                   eval_env, nets,
                                   cfg.eval_envs or cfg.num_envs,
                                   cfg.eval_steps, cfg.hidden_size,
                                   cfg.log_env_info, gen))
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
            if ckpt is not None and (
                    (u + 1) % cfg.checkpoint_every == 0
                    or u == num_updates - 1):
                # whole moments: under a model axis every rank gathers
                opt_states = [lr.adam_state() for lr in learners]
                if group.writer:
                    ckpt.save(u, [lr.net.state_dict() for lr in learners],
                              opt_states, [lr.count for lr in learners],
                              metrics=metrics)
        if ckpt is not None:
            ckpt.close()
        return {"metrics": metrics_history, "networks": nets,
                "state": carry.state, "learners": learners}

    train.env = env
    train.eval_env = eval_env
    train.group = group
    return train
