"""The port's tools: ``utils/tree.py``'s stack and unstack,
``utils/profiling.py``, ``rl/sweep.py`` and ``eval/speed_test.py``, at tiny
sizes on the CPU, against the JAX package's where the result is data
(the wandb sweep config, the speed grid's row keys and message budget)."""

import csv
import json
import os
import sys
import types

import pytest
import torch
import yaml

from vit_marl_tpu.config import (
    ExecutionConfig as JExecutionConfig,
    MarketMakingConfig as JMarketMakingConfig,
    MultiAgentConfig as JMultiAgentConfig,
    WorldConfig as JWorldConfig,
)
from vit_marl_tpu.rl import sweep as jsweep
from vit_marl_tpu_torch.env.structs import Stream
from vit_marl_tpu_torch.eval import speed_test
from vit_marl_tpu_torch.rl import sweep
from vit_marl_tpu_torch.utils import profiling
from vit_marl_tpu_torch.utils.tree import tree_stack, tree_unstack

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = {
    "NUM_ENVS": 4, "NUM_STEPS": 4, "TOTAL_TIMESTEPS": 16,
    "NUM_MINIBATCHES": 2, "UPDATE_EPOCHS": 1, "LOG_BACKEND": "none",
    "WORLD": {"N_DATA_MSG_PER_STEP": 10, "EPISODE_TIME": 6,
              "START_RESOLUTION": 5, "N_MESSAGES_PER_SYNTHETIC_DAY": 2_000},
    "AGENT_CONFIGS": {
        "MarketMaking": {},
        "Execution": {"ACTION_SPACE": "simplest_case",
                      "OBSERVATION_SPACE": "simplest_case",
                      "REWARD_SPACE": "simplest_case"},
    },
}


@pytest.mark.parametrize("edits", ["ABLATIONS", "VARIANTS",
                                   "MASK_VARIANTS"])
def test_book_copies_find_their_edits(edits):
    """Each copy of ``book_scan.cu`` that ``tools/torch_ab_book.py``
    builds (``--ablate``, ``--variants``, ``--masks``) finds every text it
    replaces once in the source: a source that drifted from its edits
    stops the tool on the card."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import torch_ab_book
    finally:
        sys.path.pop(0)
    from vit_marl_tpu_torch.ops import book_kernel

    with open(book_kernel.SOURCE) as f:
        source = f.read()
    for label, old, new, *_ in getattr(torch_ab_book, edits):
        olds, news = ((old, new) if isinstance(old, tuple)
                      else ((old,), (new,)))
        assert len(olds) == len(news), label
        for o in olds:
            assert source.count(o) == 1, (label, o[:60])


def test_tree_stack_unstack_round_trip():
    trees = [{"a": torch.full((2, 3), float(i)),
              "b": (torch.tensor([i]), None),
              "s": Stream(msgs=torch.arange(4) + i, old_mid=torch.ones(1) * i,
                          lob_before=torch.zeros(2, 2))}
             for i in range(3)]
    stacked = tree_stack(trees)
    assert stacked["a"].shape == (3, 2, 3)
    assert stacked["b"][1] is None
    assert isinstance(stacked["s"], Stream)
    assert torch.equal(stacked["s"].msgs[2], torch.arange(4) + 2)
    back = tree_unstack(stacked)
    assert len(back) == 3
    for want, got in zip(trees, back):
        assert torch.equal(want["a"], got["a"])
        assert torch.equal(want["b"][0], got["b"][0])
        assert got["b"][1] is None
        assert torch.equal(want["s"].old_mid, got["s"].old_mid)


def test_timed_and_trace(tmp_path, capsys):
    x = torch.randn(64, 64)
    with profiling.timed("matmul", sync={"y": x, "n": None}):
        y = x @ x
    assert capsys.readouterr().out.startswith("[matmul] ")
    with profiling.trace(str(tmp_path / "tr")) as prof:
        for _ in range(3):
            y = torch.relu(y @ x)
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert prof.trace_path.startswith(str(tmp_path / "tr"))
    assert any("mm" in e.get("name", "") for e in events)
    assert any(k.key == "aten::mm" for k in prof.key_averages())


def test_kernel_events_leave_the_drain_out(tmp_path):
    """``kernel_events`` reads a trace's device kernels and leaves the
    drain's spin kernels out; on the CPU ``trace(drain=True)`` launches no
    drain and its trace holds no kernel."""
    path = tmp_path / "t.json"
    events = [("kernel", "book_scan_kernel", 2.0),
              ("kernel", "void at::native::spin_kernel(long)", 1.0),
              ("kernel", "no_duration", None), ("cpu_op", "aten::mm", 3.0)]
    path.write_text(json.dumps({"traceEvents": [
        dict(cat=c, name=n, ts=1.0, **({} if d is None else {"dur": d}))
        for c, n, d in events]}))
    assert [e["name"] for e in profiling.kernel_events(str(path))] == [
        "book_scan_kernel"]
    with profiling.trace(str(tmp_path / "tr"), drain=True) as prof:
        torch.relu(torch.randn(8, 8))
    assert profiling.kernel_events(prof.trace_path) == []


def rows_of(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_run_sweep(tmp_path):
    """A two-point grid at 4 envs x 4 steps x 1 update: the rows, the JSONL
    and the overrides applied to the trained config."""
    seen = []
    real = sweep.make_train

    def spy(ma, tc, device=None):
        seen.append((tc.lr, ma.agents[0].reward_space, device))
        return real(ma, tc, device=device)

    out = tmp_path / "sweep.jsonl"
    sweep.make_train = spy
    try:
        results = sweep.run_sweep(BASE, {
            "LR": [1e-4, 2.5e-4],
            "AGENT_CONFIGS.MarketMaking.REWARD_SPACE": ["buy_sell_pnl"],
        }, out_path=str(out), device="cpu")
    finally:
        sweep.make_train = real
    assert seen == [(1e-4, "buy_sell_pnl", "cpu"),
                    (2.5e-4, "buy_sell_pnl", "cpu")]
    assert len(results) == 2
    assert [r["overrides"]["LR"] for r in results] == [1e-4, 2.5e-4]
    rows = rows_of(out)
    assert rows == json.loads(json.dumps(results))
    for r in rows:
        m = r["final_metrics"]
        assert m["update_step"] == 0.0
        assert all(isinstance(v, float) for v in m.values())


def sweep_yaml(tmp_path, grid):
    cfg = dict(BASE, **({"SWEEP": grid} if grid is not None else {}))
    path = tmp_path / "sweep.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_sweep_cli_file_driven(tmp_path, monkeypatch):
    """``--config`` with a ``SWEEP:`` section runs its grid (a scalar is a
    one-value list), on the device ``--device`` names."""
    calls = []
    monkeypatch.setattr(sweep, "make_train", lambda ma, tc, device=None: (
        calls.append((tc.lr, tc.gamma, device))
        or (lambda seed: {"metrics": [{"loss": seed + 0.5}]})))
    out = tmp_path / "results.jsonl"
    sweep.main(["--config", sweep_yaml(tmp_path, {"LR": [1e-4, 2.5e-4],
                                                  "GAMMA": 0.99}),
                "--out", str(out), "--device", "cpu", "--seed", "3"])
    assert calls == [(1e-4, 0.99, "cpu"), (2.5e-4, 0.99, "cpu")]
    rows = rows_of(out)
    assert [r["overrides"] for r in rows] == [
        {"LR": 1e-4, "GAMMA": 0.99}, {"LR": 2.5e-4, "GAMMA": 0.99}]
    assert rows[0]["final_metrics"] == {"loss": 3.5}


def test_sweep_cli_requires_sweep_section(tmp_path):
    with pytest.raises(SystemExit, match="SWEEP"):
        sweep.main(["--config", sweep_yaml(tmp_path, None)])


def test_sweep_cli_runs_on_the_card_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep.main(["--config", sweep_yaml(tmp_path, {"LR": [1e-4]}),
                    "--out", str(tmp_path / "r.jsonl")])


def test_split_sweep_of_the_shipped_config():
    """``configs/sweep_fine.yaml``: the JAX CLI's base and grid, and every
    first grid value survives the port's strict config merge."""
    from vit_marl_tpu_torch.config import make_config

    with open(os.path.join(os.path.dirname(__file__), "..", "configs",
                           "sweep_fine.yaml")) as f:
        raw = yaml.safe_load(f)
    base, grid = sweep.split_sweep(raw)
    assert "SWEEP" not in base and "SWEEP" in raw
    assert grid == raw["SWEEP"]
    for k, vals in grid.items():
        sweep._set_dotted(base, k, vals[0])
    make_config(base)


def test_grid_to_wandb_sweep_matches_jax():
    grid = {"LR": [1e-4, 2.5e-4],
            "AGENT_CONFIGS.MarketMaking.REWARD_SPACE": ["spooner"],
            "AGENT_CONFIGS.Execution.TASK_SIZE": [600],
            "AGENT_CONFIGS.Execution.ACTION_SPACE": ["twap", "fixed_quants"]}
    for method in ("grid", "random"):
        assert (sweep.grid_to_wandb_sweep(grid, method)
                == jsweep.grid_to_wandb_sweep(grid, method))
    nested = {"LR": 1e-3, "_wandb": {"x": 1},
              "AGENT_CONFIGS": {"Execution": {"TASK_SIZE": 7}}}
    assert (sweep._flatten_wandb_config(nested)
            == jsweep._flatten_wandb_config(nested))


def test_run_wandb_sweep_with_stubbed_service(monkeypatch):
    """Each agent trial applies the service's nested overrides before it
    trains (``wandb`` and the trainer stubbed, as JAX's
    ``tests/test_sweep.py`` does)."""
    calls = {}

    class FakeRun:
        config = {"LR": 1e-3,
                  "AGENT_CONFIGS": {"Execution": {"TASK_SIZE": 7}},
                  "_wandb": {"internal": True}}

        def finish(self):
            calls["finished"] = True

    fake = types.ModuleType("wandb")
    fake.init = lambda **kw: FakeRun()
    fake.log = lambda d: calls.setdefault("logged", d)

    def fake_sweep(sweep, project, entity):
        calls["sweep_cfg"] = sweep
        return "sweep123"

    def fake_agent(sweep_id, function, count):
        calls["sweep_id"] = sweep_id
        function()

    fake.sweep, fake.agent = fake_sweep, fake_agent
    monkeypatch.setitem(sys.modules, "wandb", fake)
    seen = {}

    def fake_make_train(ma, tc, device=None):
        seen.update(lr=tc.lr, task_size=ma.agents[0].task_size,
                    device=device)
        return lambda seed: {"metrics": [{"MM/mean_reward": 1.0}]}

    monkeypatch.setattr(sweep, "make_train", fake_make_train)
    sid = sweep.run_wandb_sweep(
        {"NUM_ENVS": 4, "NUM_STEPS": 4, "TOTAL_TIMESTEPS": 16},
        {"LR": [1e-3], "AGENT_CONFIGS.Execution.TASK_SIZE": [7]},
        device="cpu")
    assert sid == "sweep123" and calls["sweep_id"] == "sweep123"
    assert calls["sweep_cfg"]["parameters"]["LR"] == {"values": [1e-3]}
    assert seen == {"lr": 1e-3, "task_size": 7, "device": "cpu"}
    assert calls["logged"] == {"MM/mean_reward": 1.0}
    assert calls["finished"]


def test_run_wandb_sweep_without_wandb_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.raises(RuntimeError, match="run_sweep"):
        sweep.run_wandb_sweep({}, {"LR": [1e-4]})


def test_speed_grid(tmp_path):
    """One configuration at 4 envs x 2 steps: the JAX package's row keys,
    its message budget (the JAX ``WorldEnv`` takes ``num_msgs_per_step``
    from this config), and the CSV."""
    path = tmp_path / "speed.csv"
    rows = speed_test.run_speed_grid(((1, 1),), (1,), num_envs=4,
                                     num_steps=2, csv_path=str(path),
                                     device="cpu")
    assert list(rows[0]) == ["n_mm", "n_exec", "n_data_msg", "num_envs",
                             "num_steps", "msgs_per_step", "seconds",
                             "env_steps_per_sec"]
    jma = JMultiAgentConfig(
        world=JWorldConfig(n_data_msg_per_step=1, ep_type="fixed_steps",
                           episode_time=2, start_resolution=2,
                           n_orders=128, n_trades=128),
        agents=(JMarketMakingConfig(), JExecutionConfig()),
        n_agents_per_type=(1, 1))
    assert rows[0]["msgs_per_step"] == jma.num_msgs_per_step
    assert rows[0]["env_steps_per_sec"] > 0
    with open(path) as f:
        got = list(csv.DictReader(f))
    assert [{k: float(v) for k, v in r.items()} for r in got] == [
        {k: float(v) for k, v in r.items()} for r in rows]


def test_speed_grid_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        speed_test.run_speed_grid()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        speed_test.main(["--csv", "unused.csv"])


def _tool(name):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def test_kernel_bench_smoke(capsys):
    """``tools/torch_kernel_bench.py`` on the CPU at ViT-micro's width: a
    row for each of the five kernels, the ratio and a bound in each, and
    the device line; a width past the kernels' is a stated skip."""
    tool = _tool("torch_kernel_bench")
    assert tool.main(["--envs", "8", "--width", "64", "--heads", "2",
                      "--reps", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    for row in tool.ROWS:
        line = [x for x in out if x.startswith(row + " ")]
        assert len(line) == 1 and "x " in line[0] and "(bytes)" in line[0]
    assert out[-1].startswith("# device=cpu")
    assert tool.main(["--envs", "2", "--width", "768", "--heads", "12",
                      "--reps", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert all(f"skip {row}: W=768" in out for row in tool.FUSED)
    assert "\nattention " in out


def test_profile_vit_smoke(capsys):
    """``tools/torch_profile_vit.py --preset micro --envs 8 --reps 1
    --device cpu``: every stage's row, the roofline line at the card's
    989 TFLOP/s; ViT-Base's fused stages would be stated skips."""
    tool = _tool("torch_profile_vit")
    assert tool.main(["--preset", "micro", "--envs", "8", "--reps", "1",
                      "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    stages = ["full_policy_fwd", "vit_encoder", "vit_encoder_attnkernel",
              "vit_encoder_fusedblock", "vit_encoder_fusedblockfull",
              "vit_encoder_lnfold", "vit_encoder_rank3",
              "vit_encoder_fwdbwd_bwdkernel", "vit_encoder_fwdbwd_xlabwd",
              "vit_encoder_fwdbwd_lnfold", "attn_stack_x12",
              "mlp_stack_x12", "ln_stack_x24"]
    rows = [x.split()[0] for x in out.splitlines() if x.endswith("ms")
            or "roofline share" in x]
    assert rows == stages
    assert "(peak 989 TFLOP/s)" in out and "# micro B=8 N=11 W=64" in out
    assert out.rstrip().endswith("no card time)")
    from vit_marl_tpu_torch.models.vit import VIT_PRESETS

    base = VIT_PRESETS["base"]
    for kernel in ("fused_proj_mlp", "fused_block_full", "fused_ln_qkv_attn"):
        assert "width 768" in tool._why_skipped(kernel, base, 3072)
    assert tool._why_skipped("attention", base, 3072) is None


def test_tools_need_a_card_by_default(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("torch_kernel_bench", "torch_profile_vit"):
        assert _tool(name).main([]) == 2
        assert "--device cpu" in capsys.readouterr().err
