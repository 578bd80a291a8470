"""Data parallelism over ``torch.distributed`` (``parallel/``) against the
JAX package's mesh training, in gloo groups of 2 CPU processes.

Every multi-process test goes through ``parallel/distributed.py::
run_group``: a free local port, ``init_process_group`` with a timeout,
and the children joined within a deadline of their own (then killed, and
the test fails), so no rendezvous can hang the run.

- The sharded step: 2 ranks, each stepping its 2 of 4 envs, bit-equal
  (floats within 1e-5) to the JAX ``make_sharded_step`` on a 2-device
  CPU mesh, on the JAX package's draws replayed
  (``tests/test_torch_env.py``'s helpers), the whole batch's draws
  sliced per rank by the port's sharded step;
- a 2-rank PPO update (two updates, two epochs of two minibatches)
  within 1e-4 of the JAX update of the whole batch on the same
  trajectory and permutations, where some minibatch puts unequal row
  counts on the two ranks;
- ``make_train`` over 2 ranks, checkpointed by rank 0 and resumed by
  both: the update index continues, every rank's metrics and weights
  are equal, the optimizer's step count continues;
- ``graft_entry.py::dryrun_multichip(2)``;
- the refusals: a ``model`` axis of more ranks than the group, an axis
  that is neither a data axis nor ``model``, an uneven split of the
  envs, the pipeline under a group of 2 (data or model ranks), a mesh
  of more ranks than the group.  The ``model`` axis itself:
  ``tests/test_torch_model_axis.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from test_torch_env import (
    E,
    _actions,
    _assert_close,
    _assert_state_equal,
    _env_pair,
    _reset_draws,
    _step_draws,
)
from test_torch_ppo import (
    A,
    EPOCHS,
    N_MB,
    N_UPDATES,
    OBS,
    ACT,
    H,
    _behaviour_log_prob,
    _jax_gae,
    _jax_update,
    _jtraj,
    _trajectory,
    _ttraj,
)
from vit_marl_tpu.models.rnn import ActorCriticRNN as JActorCriticRNN
from vit_marl_tpu.models.rnn import ScannedGRU as JScannedGRU
from vit_marl_tpu.parallel import make_mesh
from vit_marl_tpu.parallel.shard_step import make_sharded_step
from vit_marl_tpu_torch import config as tcfg
from vit_marl_tpu_torch.graft_entry import dryrun_multichip
from vit_marl_tpu_torch.models.bridge import flax_to_state_dict
from vit_marl_tpu_torch.parallel.distributed import DataGroup, run_group
from vit_marl_tpu_torch.rl import ppo as tppo
from vit_marl_tpu_torch.utils.tree import tree_map

RANKS = 2
DEADLINE_S = 120.0


def _cat(parts):
    return tree_map(lambda *v: torch.from_numpy(np.concatenate(v)), *parts)


def test_sharded_step_matches_jax_on_a_2_device_mesh():
    jenv, tenv = _env_pair()
    mesh = make_mesh((RANKS,), ("data",))
    jstep = make_sharded_step(jenv, mesh)
    jp = jenv.default_params
    keys = jax.random.split(jax.random.PRNGKey(21), E)
    jobs, jst = jax.vmap(jenv.reset, in_axes=(0, None))(keys, jp)
    rng = np.random.default_rng(22)
    key = jax.random.PRNGKey(23)
    acts, draws, want = [], [], []
    for _ in range(3):
        key, sk = jax.random.split(key)
        a = [_actions(rng, sp, n)
             for sp, n in zip(tenv.action_spaces, tenv.n_per_type)]
        jobs, jst, jrew, jdone, _ = jstep(sk, jst,
                                          [jnp.asarray(x) for x in a], jp)
        acts.append([torch.from_numpy(x) for x in a])
        draws.append(_step_draws(jenv, sk))
        want.append((jobs, jst, jrew, jdone))
    ma = tcfg.MultiAgentConfig(
        world=tcfg.WorldConfig(**dict(tenv.wcfg.__dict__)),
        agents=tuple(a.cfg for a in tenv.agent_types),
        n_agents_per_type=tenv.n_per_type)
    outs = run_group(workers.sharded_steps, RANKS,
                     (ma, _reset_draws(jenv, keys), acts, draws),
                     deadline_s=DEADLINE_S)
    n_types = len(tenv.agent_types)
    saw_reset = False
    for t, (jobs, jst, jrew, jdone) in enumerate(want):
        tobs, tst, trew, tdone = _cat([o[t + 1] for o in outs])
        _assert_state_equal(jst, tst)
        for i in range(n_types):
            _assert_close(jobs[i], tobs[i], f"step {t} obs {i}")
            _assert_close(jrew[i], trew[i], f"step {t} reward {i}")
            np.testing.assert_array_equal(np.asarray(jdone["agents"][i]),
                                          tdone["agents"][i].numpy())
        np.testing.assert_array_equal(np.asarray(jdone["__all__"]),
                                      tdone["__all__"].numpy())
        saw_reset |= bool(tdone["__all__"].any())
    assert saw_reset, "the episode boundary was not crossed"


def _uneven(perms, mb):
    """Whether some minibatch slice of the permutations holds unequal row
    counts of the two ranks' actors (rank 0 holds actors 0..A/2-1)."""
    return any(int((p[j * mb:(j + 1) * mb] < A // RANKS).sum()) != mb // 2
               for p in perms for j in range(N_MB))


def test_two_rank_ppo_update_matches_the_jax_update():
    from flax.training.train_state import TrainState
    import optax

    jnet = JActorCriticRNN(action_dim=ACT, fc_dim=H, hidden_size=H)
    params = jnet.init(jax.random.PRNGKey(31),
                       JScannedGRU.initialize_carry(A, H),
                       (jnp.zeros((1, A, OBS)), jnp.zeros((1, A), bool)))
    sd = flax_to_state_dict(jax.device_get(params))
    make_net = functools.partial(workers.make_gru, OBS, ACT, H)
    net = make_net()
    net.load_state_dict(sd)
    init_h = np.random.default_rng(32).normal(size=(A, H)).astype(
        np.float32)
    tr = _trajectory(33)
    tr = _trajectory(33, with_logp=_behaviour_log_prob(net, init_h, tr))
    cfg = tcfg.TrainConfig(num_minibatches=N_MB, update_epochs=EPOCHS,
                           lr=1e-3)
    last = np.zeros(A, np.float32)
    jadv, jtgt = _jax_gae(cfg.gamma, cfg.gae_lambda, _jtraj(tr),
                          jnp.asarray(last))
    tadv, ttgt = tppo.compute_gae(_ttraj(tr), torch.from_numpy(last),
                                  cfg.gamma, cfg.gae_lambda)
    rng = np.random.default_rng(34)
    perms = [[rng.permutation(A) for _ in range(EPOCHS)] for _ in range(2)]
    assert _uneven([p for ps in perms for p in ps], A // N_MB)
    n_mb = N_MB * EPOCHS
    lr_fn = functools.partial(
        lambda lr, count: lr * (1.0 - (count // n_mb) / N_UPDATES), cfg.lr)
    tx = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                     optax.adam(learning_rate=lr_fn, eps=1e-5))
    ts = TrainState.create(apply_fn=jnet.apply, params=params, tx=tx)
    jlosses = []
    for ps in perms:
        ts, jl = _jax_update(ts, jnp.asarray(init_h), _jtraj(tr), jadv,
                             jtgt, ps, cfg)
        jlosses.append(np.mean(jl))
    outs = run_group(workers.ppo_updates, RANKS,
                     (make_net, sd, cfg, N_UPDATES, _ttraj(tr),
                      torch.from_numpy(init_h), tadv, ttgt,
                      [[torch.from_numpy(p) for p in ps] for ps in perms]),
                     deadline_s=DEADLINE_S)
    want = flax_to_state_dict(jax.device_get(ts.params))
    for weights, infos, count in outs:
        assert count == 2 * n_mb
        for jl, info in zip(jlosses, infos):
            np.testing.assert_allclose(jl, info["total_loss"], rtol=1e-4)
        for k, w in want.items():
            np.testing.assert_allclose(w.numpy(), weights[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    # every rank took the same steps
    for k in want:
        np.testing.assert_array_equal(outs[0][0][k], outs[1][0][k])


SMALL = dict(n_orders=64, n_messages_per_synthetic_day=4000,
             episode_time=2, start_resolution=5)


def _mesh_config(**kw):
    return tcfg.TrainConfig(num_envs=4, num_steps=4, num_minibatches=2,
                            update_epochs=1, log_backend="none",
                            mesh_shape=(RANKS,), mesh_axes=("data",), **kw)


def test_resume_under_a_two_rank_group(tmp_path):
    ma = tcfg.MultiAgentConfig(world=tcfg.WorldConfig(**SMALL))
    ck = str(tmp_path / "ckpt")
    first = run_group(workers.train, RANKS,
                      (ma, _mesh_config(total_timesteps=16,
                                        checkpoint_dir=ck), 3),
                      deadline_s=DEADLINE_S)
    second = run_group(workers.train, RANKS,
                       (ma, _mesh_config(total_timesteps=32,
                                         checkpoint_dir=ck, resume=True), 3),
                       deadline_s=DEADLINE_S)
    for (m0, w0, c0), (m1, w1, c1) in zip(first, second):
        assert [m["update_step"] for m in m0] == [0]
        assert [m["update_step"] for m in m1] == [1]
        assert c0 == [2, 2] and c1 == [4, 4]      # epochs x minibatches
        assert all(np.isfinite(v) for v in m1[0].values())
    # the ranks agree: global metrics, identical weights
    for run in (first, second):
        assert run[0][0] == run[1][0]
        for a, b in zip(run[0][1], run[1][1]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the resumed run started from the saved weights, not from the seed
    assert any(not np.array_equal(first[0][1][0][k], second[0][1][0][k])
               for k in first[0][1][0])


def test_dryrun_multichip_two_ranks(capsys):
    dryrun_multichip(RANKS, deadline_s=DEADLINE_S)
    assert "weights equal" in capsys.readouterr().out


@pytest.mark.parametrize("kw,group,error,match", [
    (dict(mesh_shape=(2, 2), mesh_axes=("data", "model")), DataGroup(0, 2),
     NotImplementedError, "needs 4 devices"),
    (dict(mesh_shape=(4,)), DataGroup(0, 2), NotImplementedError,
     "needs 4 devices"),
    (dict(mesh_shape=(2,), rollout_mode="pipeline"), DataGroup(0, 2),
     NotImplementedError, "ROLLOUT_MODE=pipeline"),
    (dict(mesh_shape=(2,), num_envs=3), DataGroup(0, 2), ValueError,
     "not divisible"),
    (dict(mesh_shape=(1, 2), mesh_axes=("data", "model"),
          rollout_mode="pipeline"), DataGroup(0, 2), NotImplementedError,
     "ROLLOUT_MODE=pipeline"),
    (dict(mesh_shape=(1, 2), mesh_axes=("data", "seq")), DataGroup(0, 2),
     NotImplementedError, "neither data axes nor 'model'"),
], ids=["model_axis", "more_ranks_than_the_group", "pipeline_under_a_group",
        "uneven_split", "pipeline_under_a_model_axis", "other_axis"])
def test_refusals(kw, group, error, match):
    tc = tcfg.TrainConfig(**kw)
    with pytest.raises(error, match=match):
        tppo.make_train(tcfg.MultiAgentConfig(
            world=tcfg.WorldConfig(**SMALL)), tc, device="cpu", group=group)


def test_a_dcn_and_an_ici_data_axis_are_all_data_ranks():
    """The hybrid mesh's ``dcn_data`` and ``data`` axes both split the
    envs: (2, 1) over (dcn_data, data) trains over a group of 2 as (2,)
    over (data,) does; a size-1 ``model`` axis is no tensor
    parallelism."""
    from vit_marl_tpu_torch.parallel.mesh import mesh_ranks
    assert mesh_ranks((2, 1), ("dcn_data", "data")) == 2
    assert mesh_ranks((2, 1), ("data", "model")) == 2
    tppo.check_ported(tcfg.TrainConfig(mesh_shape=(2, 1),
                                       mesh_axes=("data", "model")),
                      DataGroup(0, 2))
