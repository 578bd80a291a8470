"""The port's training entry points: ``--set`` overrides against the JAX
package's ``utils/cli.py``, the trainer options the port does not
honour, which ``make_train`` refuses instead of dropping, and the JAX
CLI's ``--cpu`` and ``--timing`` flags."""

import copy
import json
import os

import numpy as np
import pytest
import yaml

from vit_marl_tpu.utils import cli as jcli
from vit_marl_tpu_torch import config as tcfg
from vit_marl_tpu_torch import train as ttrain
from vit_marl_tpu_torch.rl import ppo as tppo
from vit_marl_tpu_torch.utils import cli as tcli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_WORLD = ["WORLD.N_ORDERS=64", "WORLD.N_MESSAGES_PER_SYNTHETIC_DAY=4000",
               "WORLD.EPISODE_TIME=2", "WORLD.START_RESOLUTION=5"]


def _raw(name="ippo_2player.yaml"):
    with open(os.path.join(ROOT, "configs", name)) as f:
        return yaml.safe_load(f)


@pytest.mark.parametrize("sets", [
    ["NUM_ENVS=8", "TOTAL_TIMESTEPS=1e6", "LR=2.5e-4", "ANNEAL_LR=false"],
    ["WORLD.DEBUG_MODE=true", "world.cancel_mode=2", "World.N_Orders=64"],
    ["AGENT_CONFIGS.EXECUTION.TASK_SIZE=100",
     "agent_configs.marketmaking.fixed_quant_value=3"],
    ["NEW.SECTION.KEY=1.5", "NETWORK=[gru, vit_gru]", "VIT_PRESET=small",
     "SEED=-7", "GAMMA=0.5"],
], ids=["top_level", "nested_mixed_case", "agent_sections",
        "new_sections_lists_negatives"])
def test_set_overrides_match_jax(sets):
    raw = _raw()
    want = jcli.apply_set_overrides(copy.deepcopy(raw), sets)
    got = tcli.apply_set_overrides(copy.deepcopy(raw), sets)
    assert got == want
    assert ttrain.apply_set_overrides is tcli.apply_set_overrides


def test_set_reaches_the_world_section():
    raw = tcli.apply_set_overrides(_raw(), ["WORLD.DEBUG_MODE=true"])
    ma, _ = tcfg.make_config(raw)
    assert ma.world.debug_mode is True


@pytest.mark.parametrize("val", ["inf", "-inf", "nan", "1e999"])
def test_set_refuses_inf_and_nan(val):
    with pytest.raises(ValueError, match="inf and nan"):
        tcli.apply_set_overrides({}, [f"LR={val}"])


def test_set_needs_key_and_value():
    with pytest.raises(ValueError, match="KEY=VALUE"):
        tcli.apply_set_overrides({}, ["NUM_ENVS"])


@pytest.mark.parametrize("field,value", [("mesh_shape", (8,))])
def test_options_the_port_does_not_honour_raise(field, value):
    tc = tcfg.TrainConfig(**{field: value})
    with pytest.raises(NotImplementedError, match=field.upper()):
        tppo.make_train(tcfg.MultiAgentConfig(), tc, device="cpu")


def test_options_the_port_honours_pass():
    for tc in (tcfg.TrainConfig(), tcfg.TrainConfig(log_backend="none"),
               tcfg.TrainConfig(rollout_mode="loop", log_env_info=True),
               tcfg.TrainConfig(log_backend="jsonl"),
               tcfg.TrainConfig(log_backend="wandb"),
               tcfg.TrainConfig(checkpoint_dir="ckpt", resume=True),
               tcfg.TrainConfig(eval_every=5),
               tcfg.TrainConfig(rollout_mode="pipeline"),
               tcfg.TrainConfig(mesh_shape=(1,))):
        tppo.check_ported(tc)


def test_mesh_config_raises():
    ma, tc = tcfg.load_yaml_config(
        os.path.join(ROOT, "configs", "mesh_ippo_2player.yaml"))
    with pytest.raises(NotImplementedError, match="MESH_SHAPE"):
        tppo.make_train(ma, tc, device="cpu")


def test_train_cli_pipeline_on_the_cpu():
    """``--set ROLLOUT_MODE=pipeline`` trains (the split-batch pipelined
    rollout, one update of a small world); it was refused before the
    port's pipeline."""
    out = ttrain.main([
        "--config", os.path.join(ROOT, "configs", "ippo_2player.yaml"),
        "--device", "cpu", "--set", "ROLLOUT_MODE=pipeline",
        *[a for s in SMALL_WORLD for a in ("--set", s)],
        "--set", "NUM_ENVS=4", "--set", "NUM_STEPS=4", "--set",
        "NUM_MINIBATCHES=2", "--set", "UPDATE_EPOCHS=1", "--set",
        "TOTAL_TIMESTEPS=16", "--set", "LOG_BACKEND=none"])
    assert len(out["metrics"]) == 1
    assert all(np.isfinite(v) for v in out["metrics"][0].values())


def test_train_cli_refuses_resume():
    """``RESUME=true`` with no ``CHECKPOINT_DIR`` has nothing to resume
    from, and raises, as the JAX trainer does."""
    with pytest.raises(ValueError, match="RESUME"):
        ttrain.main(["--config",
                     os.path.join(ROOT, "configs", "ippo_2player.yaml"),
                     "--device", "cpu", "--set", "RESUME=true"])


def test_train_cli_debug_mode_on_the_cpu():
    """``--set WORLD.DEBUG_MODE=true`` trains the 2-player world with the
    trade log in the state (one update, a small world)."""
    out = ttrain.main([
        "--config", os.path.join(ROOT, "configs", "ippo_2player.yaml"),
        "--device", "cpu", "--set", "WORLD.DEBUG_MODE=true",
        *[a for s in SMALL_WORLD for a in ("--set", s)],
        "--set", "NUM_ENVS=4", "--set", "NUM_STEPS=4", "--set",
        "NUM_MINIBATCHES=2", "--set", "UPDATE_EPOCHS=1", "--set",
        "TOTAL_TIMESTEPS=16", "--set", "LOG_BACKEND=none"])
    assert out["state"].world.trades.shape == (4, 128, 8)
    assert len(out["metrics"]) == 1
    assert all(np.isfinite(v) for v in out["metrics"][0].values())


def test_train_cli_checkpoints_logs_and_resumes(tmp_path):
    """``CHECKPOINT_DIR``, ``LOG_BACKEND=jsonl`` and ``RESUME=true`` through
    the CLI: two updates saved and logged, then a resumed run trains the
    third and appends its line."""
    ckpt, log = str(tmp_path / "ckpt"), str(tmp_path / "m.jsonl")
    common = [
        "--config", os.path.join(ROOT, "configs", "ippo_2player.yaml"),
        "--device", "cpu", *[a for s in SMALL_WORLD for a in ("--set", s)],
        "--set", "NUM_ENVS=4", "--set", "NUM_STEPS=4", "--set",
        "NUM_MINIBATCHES=2", "--set", "UPDATE_EPOCHS=1", "--set",
        f"CHECKPOINT_DIR={ckpt}", "--set", "LOG_BACKEND=jsonl", "--set",
        f"LOG_PATH={log}"]
    out = ttrain.main(common + ["--set", "TOTAL_TIMESTEPS=32"])
    assert [m["update_step"] for m in out["metrics"]] == [0, 1]
    out = ttrain.main(common + ["--set", "TOTAL_TIMESTEPS=48", "--set",
                                "RESUME=true"])
    assert [m["update_step"] for m in out["metrics"]] == [2]
    with open(log) as f:
        steps = [json.loads(line)["update_step"] for line in f]
    assert steps == [0, 1, 2]
    assert sorted(os.listdir(ckpt)) == ["1", "2"]


def test_train_cli_takes_the_jax_clis_cpu_and_timing(capsys):
    """``--cpu`` is ``--device cpu`` and ``--timing`` prints the JAX CLI's
    ``throughput:`` line after the port's own rate line (both flags
    were an argparse error before); ``--cpu`` with another device is an
    error."""
    out = ttrain.main([
        "--config", os.path.join(ROOT, "configs", "ippo_2player.yaml"),
        "--cpu", "--timing",
        *[a for s in SMALL_WORLD for a in ("--set", s)],
        "--set", "NUM_ENVS=4", "--set", "NUM_STEPS=4", "--set",
        "NUM_MINIBATCHES=2", "--set", "UPDATE_EPOCHS=1", "--set",
        "TOTAL_TIMESTEPS=16", "--set", "LOG_BACKEND=none"])
    assert out["state"].world.step_counter.device.type == "cpu"
    lines = capsys.readouterr().out.splitlines()
    assert lines[-2].startswith("done: 1 updates, 16 env-steps in ")
    assert "env-steps/s over the run" in lines[-2]
    assert lines[-1].startswith("throughput: ")
    assert lines[-1].endswith("as the JAX CLI prints it)")
    with pytest.raises(SystemExit):
        ttrain.main(["--cpu", "--device", "cuda"])
    assert "--cpu and --device cuda disagree" in capsys.readouterr().err
    ttrain.main(["--cpu", "--device", "cpu", "--config",
                 os.path.join(ROOT, "configs", "ippo_2player.yaml"),
                 *[a for s in SMALL_WORLD for a in ("--set", s)],
                 "--set", "NUM_ENVS=4", "--set", "NUM_STEPS=4", "--set",
                 "NUM_MINIBATCHES=2", "--set", "UPDATE_EPOCHS=1", "--set",
                 "TOTAL_TIMESTEPS=16", "--set", "LOG_BACKEND=none"])
    assert "throughput" not in capsys.readouterr().out
