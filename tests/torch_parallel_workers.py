"""Functions that ``tests/test_torch_parallel.py`` runs in each rank of a
gloo group (``parallel/distributed.py::run_group``).  They import no JAX:
each child process starts from a fresh interpreter, and imports this
module to find them."""

from vit_marl_tpu_torch.env.world import WorldEnv
from vit_marl_tpu_torch.parallel.shard_step import (
    local_reset_draws,
    make_sharded_step,
)
from vit_marl_tpu_torch.rl import ppo as tppo
from vit_marl_tpu_torch.utils.tree import tree_map


def sharded_steps(group, ma, reset_draws, actions, step_draws):
    """Reset this rank's envs from its slice of the whole batch's reset
    draws, then step them with the whole batch's actions and draws (the
    sharded step slices the draws); returns each step's (obs, state,
    rewards, dones) of this rank's envs."""
    env = WorldEnv(ma, device="cpu")
    params = env.default_params
    n = reset_draws.window.shape[0] // group.world
    lo = group.rank * n
    obs, state = env.reset(local_reset_draws(reset_draws, lo, lo + n),
                           params)
    step = make_sharded_step(env, group)
    out = [(obs, state)]
    for acts, draws in zip(actions, step_draws):
        obs, state, rew, done, _ = step(
            state, [a[lo:lo + n] for a in acts], params, draws=draws)
        out.append((obs, state, rew, done))
    return out


def ppo_updates(group, make_net, state_dict, cfg, n_updates, traj, init_h,
                adv, tgt, perms):
    """``len(perms)`` updates of one learner on this rank's share of the
    actors (``traj`` and the rest are the whole batch's); returns the
    weights and each update's loss metrics."""
    net = make_net()
    net.load_state_dict(state_dict, strict=True)
    learner = tppo.PPOLearner(net, cfg, 0, n_updates, group)
    n = adv.shape[1] // group.world
    sl = slice(group.rank * n, (group.rank + 1) * n)
    local = tree_map(lambda v: v[:, sl], traj)
    infos = []
    for ep_perms in perms:
        info = learner.update(init_h[sl], local, adv[:, sl], tgt[:, sl],
                              cfg.num_minibatches, ep_perms)
        infos.append({k: float(v) for k, v in info.items()})
    return ({k: v.numpy() for k, v in net.state_dict().items()}, infos,
            learner.count)


def train(group, ma, tc, seed):
    """``make_train`` over the group; returns the metrics (without the
    host times), each network's weights and each learner's step count."""
    out = tppo.make_train(ma, tc, device="cpu", group=group)(seed)
    metrics = [{k: v for k, v in m.items()
                if k not in ("rollout_s", "update_s")}
               for m in out["metrics"]]
    weights = [{k: v.numpy() for k, v in net.state_dict().items()}
               for net in out["networks"]]
    return metrics, weights, [lr.count for lr in out["learners"]]


def make_gru(obs_dim, action_dim, hidden):
    from vit_marl_tpu_torch.models.rnn import ActorCriticRNN
    return ActorCriticRNN(obs_dim, action_dim, fc_dim=hidden,
                          hidden_size=hidden)



def scan_against_loop(group, ma, tc, seed):
    """On this rank: ``rl/scan.py``'s body run eagerly and
    ``rollout_loop`` from the same carry and generator states, over the
    sharded step; returns the labels of the leaves that differ."""
    import torch

    from vit_marl_tpu_torch.parallel.shard_step import rank_seed
    from vit_marl_tpu_torch.rl.scan import ScanRollout
    from vit_marl_tpu_torch.utils.tree import tree_leaves

    env = WorldEnv(ma, device="cpu")
    n = group.local_count(tc.num_envs)
    torch.manual_seed(seed)
    nets = tppo.make_networks(env, tc)
    gen = torch.Generator().manual_seed(rank_seed(seed, group.rank))
    params = env.default_params
    obs, state = env.reset(env.draw_reset(n, gen), params)
    actors = [k * n for k in env.n_per_type]
    carry = tppo.Carry(state, obs,
                       [torch.zeros(a, dtype=torch.bool) for a in actors],
                       [torch.zeros(a, tc.hidden_size) for a in actors])
    step = make_sharded_step(env, group)
    twin = torch.Generator()
    twin.set_state(gen.get_state())
    scan = ScanRollout(step, nets, params, tc.num_steps, n, env.n_per_type,
                       gen, gen, True, "cpu")
    with torch.no_grad():
        got = scan.run(carry)
        want = tppo.rollout_loop(step, nets, carry, params, tc.num_steps, n,
                                 env.n_per_type, twin, twin, True)
    bad = [i for i, (a, b) in enumerate(zip(tree_leaves(got),
                                            tree_leaves(want)))
           if not torch.equal(a, b)]
    return bad, len(tree_leaves(want)), group.rank


def count_model_ranks():
    """A planted fault: the loss's global row count takes the model ranks
    too (``graft_entry.py::dryrun_multichip``'s twin check must see it)."""
    def rows(n_local, group):
        model = group.model.world if group.model is not None else 1
        return n_local * group.world * model
    tppo.global_actors = rows


def train_with_state(group, ma, tc, seed):
    """:func:`train`, plus each learner's parameters as stored: per
    parameter (name, whole shape, the optimizer's shape, the Adam
    moment's shape) and the whole Adam moments (every rank gathers)."""
    out = tppo.make_train(ma, tc, device="cpu", group=group)(seed)
    metrics = [{k: v for k, v in m.items()
                if k not in ("rollout_s", "update_s")}
               for m in out["metrics"]]
    weights = [{k: v.numpy() for k, v in net.state_dict().items()}
               for net in out["networks"]]
    stored, moments = [], []
    for lr in out["learners"]:
        stored.append([(name, tuple(p.shape), tuple(q.shape),
                        tuple(lr.opt.state[q]["exp_avg"].shape))
                       for (name, p), q in zip(lr.net.named_parameters(),
                                               lr.opt_params)])
        moments.append(lr.adam_state())
    return metrics, weights, [lr.count for lr in out["learners"]], \
        stored, moments
