"""The port's PPO pieces against the JAX package's, on identical inputs.

GAE, actor batching and one PPO update (two epochs of two minibatches, run
twice so the learning-rate anneal moves) are compared from identical
weights (through the flax bridge), trajectories and minibatch
permutations: for the GRU policy with discrete actions, and for the
ViT-GRU policy (micro preset, float32) with dict observations and
continuous ``SquashedNormal`` actions.  The JAX side is ``vit_marl_tpu/rl/ppo.py``'s code: GAE, the
loss and the epoch loop live inside its ``make_train`` closure, so they are
restated here line for line (ppo.py:410-420, 442-485) around its optax
chain.  GAE agrees within 1e-6, the updated weights within 1e-4 relative.
CPU ``make_train`` runs, of the 2-player world and of the vision world
(``configs/ippo_vision_dual_ppo.yaml`` cut to the micro preset and a few
envs, with the default blocks and in each fused-block mode), give finite
losses.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax.training.train_state import TrainState

from vit_marl_tpu.models.rnn import ActorCriticRNN as JActorCriticRNN
from vit_marl_tpu.models.rnn import ScannedGRU as JScannedGRU
from vit_marl_tpu.models.vit import VIT_PRESETS as J_PRESETS
from vit_marl_tpu.models.vit import ViTActorCriticRNN as JViTActorCriticRNN
from vit_marl_tpu.rl import ppo as jppo
from vit_marl_tpu_torch import config as tcfg
from vit_marl_tpu_torch.models.bridge import flax_to_state_dict
from vit_marl_tpu_torch.models import vit as tvit
from vit_marl_tpu_torch.models.rnn import ActorCriticRNN
from vit_marl_tpu_torch.ops import attention_kernel as attn
from vit_marl_tpu_torch.ops import block_kernel as bk
from vit_marl_tpu_torch.ops import book_kernel as bkern
from vit_marl_tpu_torch.rl import ppo as tppo
from vit_marl_tpu_torch.utils.tree import tree_map

T, A, OBS, ACT, H = 8, 16, 10, 6, 64
N_MB, EPOCHS, N_UPDATES = 2, 2, 4


def _jax_gae(gamma, lam, traj, last_val):
    """vit_marl_tpu/rl/ppo.py:410-420."""
    def scan_fn(carry, tr):
        gae, next_value = carry
        delta = (tr.reward + gamma * next_value * (1 - tr.global_done)
                 - tr.value)
        gae = delta + gamma * lam * (1 - tr.global_done) * gae
        return (gae, tr.value), gae
    _, adv = jax.lax.scan(scan_fn, (jnp.zeros_like(last_val), last_val),
                          traj, reverse=True, unroll=16)
    return adv, adv + traj.value


def _trajectory(seed, with_logp=None):
    rng = np.random.default_rng(seed)
    tr = dict(
        global_done=rng.random((T, A)) < 0.2,
        done=rng.random((T, A)) < 0.2,
        action=rng.integers(0, ACT, (T, A)).astype(np.int32),
        value=rng.normal(size=(T, A)).astype(np.float32),
        reward=(rng.normal(size=(T, A)) * 5).astype(np.float32),
        log_prob=np.full((T, A), -np.log(ACT), np.float32),
        obs=rng.normal(size=(T, A, OBS)).astype(np.float32))
    if with_logp is not None:
        tr["log_prob"] = with_logp
    return tr


def _jtraj(tr):
    return jppo.Transition(**jax.tree.map(jnp.asarray, tr))


def _ttraj(tr):
    return tppo.Transition(**tree_map(lambda v: torch.from_numpy(
        np.array(v)), tr))


def test_gae_matches_jax():
    tr = _trajectory(0)
    last = np.random.default_rng(1).normal(size=A).astype(np.float32)
    ja, jt = _jax_gae(0.99, 0.95, _jtraj(tr), jnp.asarray(last))
    ta, tt = tppo.compute_gae(_ttraj(tr), torch.from_numpy(last), 0.99, 0.95)
    np.testing.assert_allclose(np.asarray(ja), ta.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(jt), tt.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_batchify_and_global_done_are_env_major():
    x = np.arange(3 * 2 * 4).reshape(3, 2, 4)
    np.testing.assert_array_equal(
        np.asarray(jppo.batchify(jnp.asarray(x), 6)),
        tppo.batchify(torch.from_numpy(x), 6).numpy())
    d = np.array([True, False, True])
    np.testing.assert_array_equal(
        np.asarray(jppo.global_done_for_actors(jnp.asarray(d), 2)),
        tppo.global_done_for_actors(torch.from_numpy(d), 2).numpy())


def _jax_update(ts, init_h, traj, gae_all, tgt_all, perms, cfg):
    """The epoch loop of vit_marl_tpu/rl/ppo.py:442-485 with the
    permutations given instead of drawn."""
    clip_eps, vf_coef, ent_coef = cfg.clip_eps, cfg.vf_coef, cfg.ent_coef

    def _loss_fn(params, init_h, traj, gae, tgts):
        _, pi, value = ts.apply_fn(params, init_h, (traj.obs, traj.done))
        log_prob = pi.log_prob(traj.action)
        v_clip = traj.value + (value - traj.value).clip(-clip_eps, clip_eps)
        v_loss = 0.5 * jnp.maximum(jnp.square(value - tgts),
                                   jnp.square(v_clip - tgts)).mean()
        logratio = log_prob - traj.log_prob
        ratio = jnp.exp(logratio)
        gae = (gae - gae.mean()) / (gae.std() + 1e-8)
        l1 = ratio * gae
        l2 = jnp.clip(ratio, 1 - clip_eps, 1 + clip_eps) * gae
        actor_loss = -jnp.minimum(l1, l2).mean()
        entropy = pi.entropy().mean()
        return actor_loss + vf_coef * v_loss - ent_coef * entropy

    grad_fn = jax.jit(jax.value_and_grad(_loss_fn))
    losses = []
    mb = A // N_MB
    for perm in perms:
        for j in range(N_MB):
            idx = jnp.asarray(perm[j * mb:(j + 1) * mb])
            batch = jax.tree.map(lambda v: jnp.take(v, idx, axis=1), traj)
            loss, grads = grad_fn(ts.params, init_h[idx], batch,
                                  gae_all[:, idx], tgt_all[:, idx])
            ts = ts.apply_gradients(grads=grads)
            losses.append(float(loss))
    return ts, losses


def _check_update(jnet, params, net, tr, init_h, atol=1e-6):
    """Two updates of the same trajectory through both; the updated
    weights agree within 1e-4 relative (``atol`` absolute)."""
    cfg = tcfg.TrainConfig(num_minibatches=N_MB, update_epochs=EPOCHS,
                           lr=1e-3)
    n_mb = N_MB * EPOCHS
    lr_fn = functools.partial(
        lambda lr, count: lr * (1.0 - (count // n_mb) / N_UPDATES), cfg.lr)
    tx = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                     optax.adam(learning_rate=lr_fn, eps=1e-5))
    ts = TrainState.create(apply_fn=jnet.apply, params=params, tx=tx)
    learner = tppo.PPOLearner(net, cfg, 0, N_UPDATES)
    last = np.zeros(A, np.float32)
    jadv, jtgt = _jax_gae(cfg.gamma, cfg.gae_lambda, _jtraj(tr),
                          jnp.asarray(last))
    tadv, ttgt = tppo.compute_gae(_ttraj(tr), torch.from_numpy(last),
                                  cfg.gamma, cfg.gae_lambda)
    rng = np.random.default_rng(5)
    for update in range(2):        # the second runs at an annealed rate
        perms = [rng.permutation(A) for _ in range(EPOCHS)]
        ts, jl = _jax_update(ts, jnp.asarray(init_h), _jtraj(tr), jadv,
                             jtgt, perms, cfg)
        info = learner.update(torch.from_numpy(init_h), _ttraj(tr), tadv,
                              ttgt, N_MB,
                              [torch.from_numpy(p) for p in perms])
        np.testing.assert_allclose(np.mean(jl), float(info["total_loss"]),
                                   rtol=1e-4)
    assert learner.count == 2 * n_mb
    want = flax_to_state_dict(jax.device_get(ts.params))
    got = net.state_dict()
    assert set(want) == set(got)
    for k, w in want.items():
        np.testing.assert_allclose(w.numpy(), got[k].numpy(), rtol=1e-4,
                                   atol=atol, err_msg=k)
    # the update moved the weights well beyond the tolerance
    before = flax_to_state_dict(jax.device_get(params))
    assert max(float((got[k] - before[k]).abs().max()) for k in got) > 1e-3


def _behaviour_log_prob(net, init_h, tr):
    """Log-probs of the trajectory's actions near the policy's own."""
    with torch.no_grad():
        _, pi, _ = net(torch.from_numpy(init_h), _ttraj(tr).obs,
                       torch.from_numpy(tr["done"]))
        return pi.log_prob(torch.from_numpy(tr["action"])).numpy() + 0.05


def test_ppo_update_matches_jax():
    jnet = JActorCriticRNN(action_dim=ACT, fc_dim=H, hidden_size=H)
    params = jnet.init(jax.random.PRNGKey(0),
                       JScannedGRU.initialize_carry(A, H),
                       (jnp.zeros((1, A, OBS)), jnp.zeros((1, A), bool)))
    net = ActorCriticRNN(OBS, ACT, fc_dim=H, hidden_size=H)
    net.load_state_dict(flax_to_state_dict(jax.device_get(params)))
    tr = _trajectory(3)
    init_h = np.random.default_rng(4).normal(size=(A, H)).astype(np.float32)
    tr = _trajectory(3, with_logp=_behaviour_log_prob(net, init_h, tr))
    _check_update(jnet, params, net, tr, init_h)


def test_vit_gru_ppo_update_matches_jax():
    """ViT-GRU at the micro preset in float32: dict observations (28 flat
    features and a (10, 3, 2) book image) and continuous Box(3,) actions."""
    low = np.array([-1.0, 0.0, 0.0], np.float32)
    high = np.array([3.0, 1.0, 1.0], np.float32)
    jvit = dataclasses.replace(J_PRESETS["micro"], compute_dtype="float32")
    tvit_cfg = dataclasses.replace(tvit.VIT_PRESETS["micro"],
                                   compute_dtype="float32")
    jnet = JViTActorCriticRNN(action_dim=3, vit=jvit, continuous=True,
                              action_low=jnp.asarray(low),
                              action_high=jnp.asarray(high))
    rng = np.random.default_rng(6)
    tr = _trajectory(6)
    tr["obs"] = {"obs": rng.normal(size=(T, A, 28)).astype(np.float32),
                 "vision_obs": rng.normal(size=(T, A, 10, 3, 2)).astype(
                     np.float32)}
    tr["action"] = (low + (high - low) * rng.random((T, A, 3))).astype(
        np.float32)
    params = jnet.init(jax.random.PRNGKey(1),
                       JScannedGRU.initialize_carry(A, H),
                       (jax.tree.map(lambda v: jnp.asarray(v[:1]),
                                     tr["obs"]), jnp.zeros((1, A), bool)))
    net = tvit.ViTActorCriticRNN(28, 10, 3, tvit_cfg,
                                 action_low=torch.from_numpy(low),
                                 action_high=torch.from_numpy(high))
    net.load_state_dict(flax_to_state_dict(jax.device_get(params)),
                        strict=True)
    init_h = rng.normal(size=(A, H)).astype(np.float32)
    tr["log_prob"] = _behaviour_log_prob(net, init_h, tr)
    _check_update(jnet, params, net, tr, init_h)


def test_linear_schedule_reads_the_count_before_the_step():
    assert tppo.linear_schedule(1.0, 3, 4, 4) == 1.0
    assert tppo.linear_schedule(1.0, 4, 4, 4) == 0.75


WORLD = dict(n_orders=64, n_messages_per_synthetic_day=4000,
             episode_time=2, start_resolution=5)


def test_make_train_cpu_smoke():
    ma = tcfg.MultiAgentConfig(world=tcfg.WorldConfig(**WORLD))
    tc = tcfg.TrainConfig(num_envs=4, num_steps=4, update_epochs=1,
                          num_minibatches=2, total_timesteps=32)
    before = bkern.process_step_aggs.launches
    out = tppo.make_train(ma, tc, device="cpu")(seed=0)
    assert bkern.process_step_aggs.launches == before   # plain path on CPU
    assert len(out["metrics"]) == tc.num_updates == 2
    for m in out["metrics"]:
        assert all(np.isfinite(v) for v in m.values()), m
        assert {"MM/total_loss", "EXE/total_loss"} <= set(m)


def test_make_train_cpu_smoke_vision():
    """The vision world at the micro preset: ViT-GRU policy for the
    execution agent (policy blending, dual PPO), GRU for the market maker.
    On the CPU the attention runs its plain versions (no launch counted)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "ippo_vision_dual_ppo.yaml")
    with open(path) as f:
        raw = yaml.safe_load(f)
    raw.update(NUM_ENVS=4, NUM_STEPS=4, UPDATE_EPOCHS=1, NUM_MINIBATCHES=2,
               TOTAL_TIMESTEPS=32, VIT_PRESET="micro")
    raw["WORLD"].update({k.upper(): v for k, v in WORLD.items()})
    ma, tc = tcfg.make_config(raw)
    before = (attn.short_attention.launches_fwd,
              attn.short_attention.launches_bwd)
    out = tppo.make_train(ma, tc, device="cpu")(seed=0)
    assert (attn.short_attention.launches_fwd,
            attn.short_attention.launches_bwd) == before
    assert isinstance(out["networks"][1], tvit.ViTActorCriticRNN)
    assert len(out["metrics"]) == 2
    for m in out["metrics"]:
        assert all(np.isfinite(v) for v in m.values()), m
        assert {"MM/total_loss", "EXE/total_loss"} <= set(m)


@pytest.mark.parametrize("mode", ["VIT_FUSED_BLOCK_FULL", "VIT_FUSED_BLOCK",
                                  "VIT_ATTN_LN_FOLD"])
def test_make_train_cpu_smoke_vision_fused(mode):
    """The vision world at the micro preset in a fused-block mode: the
    plain versions of the fused functions on the CPU (no launch counted),
    finite losses."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "ippo_vision_dual_ppo.yaml")
    with open(path) as f:
        raw = yaml.safe_load(f)
    raw.update(NUM_ENVS=4, NUM_STEPS=4, UPDATE_EPOCHS=1, NUM_MINIBATCHES=2,
               TOTAL_TIMESTEPS=16, VIT_PRESET="micro", **{mode: True})
    raw["WORLD"].update({k.upper(): v for k, v in WORLD.items()})
    ma, tc = tcfg.make_config(raw)
    fns = (bk.fused_ln_qkv, bk.fused_proj_mlp, bk.fused_block_full,
           bk.fused_ln_qkv_attn)
    before = [f.launches for f in fns]
    out = tppo.make_train(ma, tc, device="cpu")(seed=0)
    assert [f.launches for f in fns] == before
    vit = out["networks"][1].vit.cfg
    assert getattr(vit, mode[4:].lower())
    assert len(out["metrics"]) == 1
    for m in out["metrics"]:
        assert all(np.isfinite(v) for v in m.values()), m
        assert {"MM/total_loss", "EXE/total_loss"} <= set(m)


def test_dict_observations_need_the_vit_network():
    ma = tcfg.MultiAgentConfig(world=tcfg.WorldConfig(**WORLD), agents=(
        tcfg.MarketMakingConfig(), tcfg.ExecutionConfig(
            action_space="policy_blending",
            observation_space="execution_policy", reward_space="dual_ppo",
            use_vision_obs=True)))
    with pytest.raises(ValueError, match="vit_gru"):
        tppo.make_train(ma, tcfg.TrainConfig(num_envs=4), device="cpu")


def test_train_cli_needs_a_card_unless_cpu_is_asked(monkeypatch):
    from vit_marl_tpu_torch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--set", "NUM_ENVS=4"])


def test_train_cli_overrides_parse_like_yaml():
    from vit_marl_tpu_torch import train
    raw = train.apply_set_overrides({}, ["NUM_ENVS=8", "TOTAL_TIMESTEPS=1e6",
                                         "ANNEAL_LR=false"])
    _, tc = tcfg.make_config(raw)
    assert (tc.num_envs, tc.total_timesteps, tc.anneal_lr) == (8, 1e6, False)
    assert dataclasses.replace(tc, seed=1).seed == 1
