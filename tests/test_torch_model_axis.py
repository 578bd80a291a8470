"""The ``model`` mesh axis (tensor parallelism) against the JAX package's
``vit_marl_tpu/parallel/mesh.py::shard_params`` and its trainer.

- ``parallel/mesh.py::placement_plan`` places every parameter as
  ``shard_params`` places the flax leaf (or, for the GRU's packed gates,
  the leaves) that ``models/bridge.py`` maps it from, on ``(1, 2)`` and
  ``(1, 4)`` ``data x model`` meshes of the conftest's CPU devices: each
  flax leaf is replaced by the map of which model rank holds each of its
  elements (-1 where it is replicated), the maps go through the bridge,
  and rank ``r``'s block of each port parameter
  (``parallel/mesh.py::shard``) must hold exactly the elements the JAX
  rank ``r`` holds.  The ``gru`` network at width 30 (some 2-D leaves
  divide by neither side on 4 ranks), the micro ``vit_gru`` and
  ``cnn_gru``;
- ``graft_entry.py::dryrun_multichip(4)`` builds the JAX dry run's
  ``(2, 2)`` mesh and passes its unsharded-twin check; with the loss's
  row count counting the model ranks (a fault planted through
  ``rl/ppo.py::global_actors``) the twin check raises;
- a ``(1, 2)`` run of ``make_train`` (2 gloo ranks): split leaves and
  their Adam moments are stored as shards of half the elements, the
  update matches one process's (metrics rtol 5e-4 / atol 1e-5, weights
  within 3 x lr; the data rank's seed is the one process's), its
  checkpoint holds whole moments equal to one process's, and a resume
  under the mesh continues the step count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from vit_marl_tpu.models.cnn import CNNActorCriticRNN as JCNNActorCriticRNN
from vit_marl_tpu.models.rnn import ActorCriticRNN as JActorCriticRNN
from vit_marl_tpu.models.rnn import ScannedGRU as JScannedGRU
from vit_marl_tpu.models.vit import VIT_PRESETS as J_PRESETS
from vit_marl_tpu.models.vit import ViTActorCriticRNN as JViTActorCriticRNN
from vit_marl_tpu.parallel import make_mesh
from vit_marl_tpu.parallel.mesh import shard_params
from vit_marl_tpu_torch import config as tcfg
from vit_marl_tpu_torch.graft_entry import dryrun_mesh, dryrun_multichip
from vit_marl_tpu_torch.models import vit as tvit
from vit_marl_tpu_torch.models.bridge import flax_to_state_dict
from vit_marl_tpu_torch.models.cnn import CNNActorCriticRNN
from vit_marl_tpu_torch.models.rnn import ActorCriticRNN
from vit_marl_tpu_torch.parallel.distributed import run_group
from vit_marl_tpu_torch.parallel.mesh import placement_plan, shard
from vit_marl_tpu_torch.rl import ppo as tppo

B, OBS, LEVELS, ACT = 4, 28, 10, 8
DEADLINE_S = 120.0


def _nets(kind):
    """(flax module, its init inputs, the port's module) of one network."""
    h = 30 if kind == "gru" else 64
    obs = jnp.zeros((1, B, OBS))
    dones = jnp.zeros((1, B), bool)
    vis = {"obs": obs, "vision_obs": jnp.zeros((1, B, LEVELS, 3, 2))}
    if kind == "gru":
        return (JActorCriticRNN(action_dim=ACT, fc_dim=h, hidden_size=h),
                (obs, dones), ActorCriticRNN(OBS, ACT, fc_dim=h,
                                             hidden_size=h))
    if kind == "cnn_gru":
        return (JCNNActorCriticRNN(action_dim=ACT), (vis, dones),
                CNNActorCriticRNN(OBS, LEVELS, ACT))
    return (JViTActorCriticRNN(action_dim=ACT, vit=J_PRESETS["micro"]),
            (vis, dones),
            tvit.ViTActorCriticRNN(OBS, LEVELS, ACT,
                                   tvit.VIT_PRESETS["micro"]))


def _owner(leaf, placed, n):
    """Which model rank holds each element of ``leaf`` under ``placed``'s
    spec (-1: every rank)."""
    spec = tuple(placed.sharding.spec) + (None,) * leaf.ndim
    own = np.full(leaf.shape, -1.0, np.float32)
    for axis in range(leaf.ndim):
        if spec[axis] == "model":
            k = leaf.shape[axis] // n
            idx = np.arange(leaf.shape[axis]) // k
            own = np.broadcast_to(np.expand_dims(
                idx, tuple(a for a in range(leaf.ndim) if a != axis)),
                leaf.shape).astype(np.float32)
        else:
            assert spec[axis] is None, spec
    return own


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", ["gru", "vit_gru", "cnn_gru"])
def test_placement_plan_matches_shard_params(kind, n):
    jnet, inputs, net = _nets(kind)
    h = 30 if kind == "gru" else 64
    params = jax.device_get(jnet.init(jax.random.PRNGKey(0),
                                      JScannedGRU.initialize_carry(B, h),
                                      inputs))
    mesh = make_mesh((1, n), ("data", "model"))
    placed = shard_params(params, mesh)
    owners = flax_to_state_dict(jax.tree.map(
        lambda x, p: _owner(np.asarray(x), p, n), params, placed))
    plan = placement_plan(net, n)
    assert list(plan) == [k for k, _ in net.named_parameters()]
    assert set(owners) == set(plan)
    kinds = set()
    for name, split in plan.items():
        own = owners[name]
        if split is None:
            assert (own == -1).all(), name
            kinds.add("replicated" + ("_2d" if own.ndim == 2 else ""))
            continue
        kinds.add((split.dim, split.blocks))
        for r in range(n):
            block = shard(own, split, r, n)
            assert block.numel() * n == own.numel(), name
            assert (block == r).all(), f"{name}: rank {r}'s block"
    # the cases the rule has: output, input, the GRU's gates, replicated
    assert {(0, 1), (1, 1), "replicated"} <= kinds
    if kind != "gru" or n == 2:
        assert (0, 3) in kinds
    if kind == "gru" and n == 4:
        assert "replicated_2d" in kinds


def test_dryrun_multichip_2x2_twin_and_a_planted_fault(capsys):
    assert dryrun_mesh(4) == ((2, 2), ("data", "model"))
    assert dryrun_mesh(2) == ((2,), ("data",))
    assert dryrun_mesh(3) == ((3,), ("data",))
    dryrun_multichip(4, deadline_s=DEADLINE_S)
    out = capsys.readouterr().out
    assert "{'data': 2, 'model': 2} mesh" in out
    assert "sharded == unsharded" in out
    with pytest.raises(RuntimeError, match="sharded != unsharded"):
        dryrun_multichip(4, deadline_s=DEADLINE_S,
                         setup=workers.count_model_ranks)


SMALL = dict(n_orders=64, n_messages_per_synthetic_day=4000,
             episode_time=2, start_resolution=5)


def _cfg(mesh, **kw):
    shape, axes = ((1, 2), ("data", "model")) if mesh else ((), ("data",))
    return tcfg.TrainConfig(num_envs=4, num_steps=4, num_minibatches=2,
                            update_epochs=1, log_backend="none",
                            network=("gru", "vit_gru"), vit_preset="micro",
                            hidden_size=32, fc_dim=32, mesh_shape=shape,
                            mesh_axes=axes, **kw)


def _vision_world():
    return tcfg.MultiAgentConfig(
        world=tcfg.WorldConfig(**SMALL),
        agents=(tcfg.MarketMakingConfig(),
                tcfg.ExecutionConfig(action_space="policy_blending",
                                     observation_space="execution_policy",
                                     reward_space="dual_ppo",
                                     use_vision_obs=True, task_size=500)))


def test_model_axis_stores_shards_and_matches_one_process(tmp_path):
    ma = _vision_world()
    ck = str(tmp_path / "mesh")
    outs = run_group(workers.train_with_state, 2,
                     (ma, _cfg(True, total_timesteps=16,
                               checkpoint_dir=ck), 3),
                     deadline_s=DEADLINE_S)
    one = workers.train_with_state(None, ma, _cfg(
        False, total_timesteps=16, checkpoint_dir=str(tmp_path / "one")), 3)
    (m0, w0, c0, st0, mo0), (m1, w1, c1, st1, mo1) = outs
    assert m0 == m1 and c0 == c1 == one[2]
    for a, b in zip(w0, w1):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # split leaves and their moments stored as halves, the rest whole
    n_split = 0
    for types in (st0, st1):
        for name, full, opt, moment in (p for t in types for p in t):
            assert opt == moment, name
            if int(np.prod(opt)) != int(np.prod(full)):
                assert 2 * int(np.prod(opt)) == int(np.prod(full)), name
                n_split += 1
    assert n_split > 20
    # the one-process update
    lr = float(_cfg(False).lr)
    assert sorted(m0[0]) == sorted(one[0][0])
    for k, v in one[0][0].items():
        np.testing.assert_allclose(m0[0][k], v, rtol=5e-4, atol=1e-5,
                                   err_msg=k)
    for a, b in zip(w0, one[1]):
        for k in a:
            assert np.abs(a[k] - b[k]).max() <= 3 * lr + 1e-6, k
    # whole moments, on every rank and in the checkpoint
    saved = torch.load(tmp_path / "mesh" / "0" / "state.pt",
                       weights_only=True)
    for i, (a, b) in enumerate(zip(mo0, one[4])):
        for key in ("exp_avg", "exp_avg_sq"):
            for x, y, z, s in zip(a[key], b[key], mo1[i][key],
                                  saved["opt"][i][key]):
                assert x.shape == y.shape
                np.testing.assert_array_equal(x, z)
                np.testing.assert_array_equal(x, s.numpy())
                np.testing.assert_allclose(x, y, rtol=1e-3, atol=1e-6)
    resumed = run_group(workers.train, 2,
                        (ma, _cfg(True, total_timesteps=32,
                                  checkpoint_dir=ck, resume=True), 3),
                        deadline_s=DEADLINE_S)
    for metrics, _, counts in resumed:
        assert [m["update_step"] for m in metrics] == [1]
        assert counts == [4, 4]
        assert all(np.isfinite(v) for v in metrics[0].values())
