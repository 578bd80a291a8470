"""The port's bench and entry modules on the CPU.

- ``python -m vit_marl_tpu_torch.bench --smoke --device cpu --policy
  gru`` prints one JSON line ``{"metric", "value", "unit",
  "vs_baseline"}`` with the JAX bench's label (``bench.py:150-211``) and
  a positive value (in-process, the other policies and ``--vit-images``
  on a smaller synthetic day, made once); without a
  card and without ``--device cpu`` it prints the error line and exits
  non-zero; a mode other than ``loop`` and the selfcheck on the CPU
  refuse.  The labels of the fused modes name the composed route where
  the kernels do not take the preset's width.
- ``vit_marl_tpu_torch/graft_entry.py::entry`` on the weights of
  ``__graft_entry__._flagship_model()`` (carried across by
  ``models/bridge.py``) gives the JAX entry's ``(h2, mode, value)``: in
  float32 within 1e-5 (both models in float32), and within the bf16
  tolerance of ``tests/test_torch_vit.py`` (2e-2) at the flagship's bf16.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_marl_tpu_torch import bench
from vit_marl_tpu_torch import graft_entry as tentry
from vit_marl_tpu_torch.models.bridge import flax_to_state_dict
from vit_marl_tpu_torch.models.vit import VIT_PRESETS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _last_json(text):
    lines = [x for x in text.splitlines() if x.startswith("{")]
    assert len(lines) == 1, text
    return json.loads(lines[0])


@functools.lru_cache(maxsize=None)
def _small_day(wcfg):
    """The bench's synthetic days cut to 3,000 messages: windows enough
    for the smoke's 8 envs and 4 steps, made in about a second where the
    bench's 30,000 take about 14 s."""
    from vit_marl_tpu_torch.data.lobster import load_data
    return load_data(dataclasses.replace(
        wcfg, n_messages_per_synthetic_day=3_000))


def test_bench_smoke_cli_prints_one_line():
    r = subprocess.run([sys.executable, "-m", "vit_marl_tpu_torch.bench",
                        "--smoke", "--device", "cpu", "--policy", "gru"],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr
    out = _last_json(r.stdout)
    assert list(out) == ["metric", "value", "unit", "vs_baseline"]
    assert out["metric"] == "env_steps_per_sec_per_chip[gru,loop]"
    assert out["unit"] == "env-steps/s" and out["vs_baseline"] is None
    assert out["value"] > 0
    assert "# device=cpu" in r.stderr and "compile=" in r.stderr


@pytest.mark.parametrize("argv,metric,unit", [
    ([], "env_steps_per_sec_per_chip[vit-small,loop]", "env-steps/s"),
    (["--policy", "none"], "env_steps_per_sec_per_chip[none,loop]",
     "env-steps/s"),
    (["--vit-images", "--policy", "vit-tiny", "--no-attn-bwd-kernel"],
     "vit_fwd_bwd_images_per_sec[tiny,xla-bwd]", "images/s")])
def test_bench_smoke_in_process(argv, metric, unit, capsys, monkeypatch):
    """The loop and ``--vit-images`` on the CPU, on a smaller day; the ViT
    policies with the micro encoder in place of the preset's, to keep the
    CPU run short (the label is the preset's)."""
    micro = dataclasses.replace(VIT_PRESETS["micro"], attn_bwd_kernel=False)
    monkeypatch.setattr(bench, "_vit_config", lambda args, preset: micro)
    monkeypatch.setattr(bench, "_day_data", _small_day)
    out = bench.main(["--smoke", "--device", "cpu", *argv])
    assert out == _last_json(capsys.readouterr().out)
    assert (out["metric"], out["unit"]) == (metric, unit)
    assert out["value"] > 0


@pytest.mark.parametrize("argv,metric", [
    ([], "env_steps_per_sec_per_chip[vit-small,loop]"),
    (["--fused-block-full"],
     "env_steps_per_sec_per_chip[vit-small,fusedblockfull,loop]"),
    (["--fused-block", "--no-attn-kernel"],
     "env_steps_per_sec_per_chip[vit-small,fusedblock,xla-attn,loop]"),
    (["--attn-ln-fold", "--policy", "vit-tiny"],
     "env_steps_per_sec_per_chip[vit-tiny,lnfold,loop]"),
    (["--fused-block-full", "--policy", "gru"],
     "env_steps_per_sec_per_chip[gru,loop]"),
    (["--fused-block-full", "--policy", "vit-base"],
     "env_steps_per_sec_per_chip[vit-base,fusedblockfull:composed,loop]"),
    (["--fused-block", "--vit-images", "--policy", "vit-base"],
     "vit_fwd_bwd_images_per_sec[base,fusedblock:composed]"),
    (["--attn-ln-fold", "--vit-images", "--policy", "vit-base"],
     "vit_fwd_bwd_images_per_sec[base,lnfold:composed]"),
    (["--selfcheck"], "kernel_selfcheck_ok")])
def test_metric_labels(argv, metric):
    """The JAX bench's labels where the fused kernels take the shape (its
    ``full_block_ok`` / ``ln_qkv_attn_ok`` hold at 8,192 envs); at
    ViT-Base the label names the composed route."""
    assert bench.metric_label(bench.parse_args(argv))[0] == metric


def test_bench_without_a_card_prints_the_error_and_fails(monkeypatch,
                                                          capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench.main(["--smoke", "--policy", "gru"])
    assert e.value.code != 0
    out = _last_json(capsys.readouterr().out)
    assert out["value"] == 0.0 and "no_device" in out["error"]
    assert out["metric"] == "env_steps_per_sec_per_chip[gru,loop]"


def test_bench_refuses_other_modes_and_the_cpu_selfcheck(capsys):
    """``--mode scan`` and ``--selfcheck`` need a card: on the CPU each
    prints the error line and exits non-zero."""
    with pytest.raises(SystemExit) as e:
        bench.main(["--smoke", "--device", "cpu", "--mode", "scan"])
    assert e.value.code != 0
    out = _last_json(capsys.readouterr().out)
    assert out["metric"] == "env_steps_per_sec_per_chip[vit-small,scan]"
    assert out["value"] == 0.0 and "CUDA" in out["error"]
    with pytest.raises(SystemExit) as e:
        bench.main(["--smoke", "--device", "cpu", "--selfcheck"])
    assert e.value.code != 0
    out = _last_json(capsys.readouterr().out)
    assert out["metric"] == "kernel_selfcheck_ok" and "CUDA" in out["error"]


def _jax_flagship(dtype):
    """``__graft_entry__._flagship_model()`` (its own weights and example
    inputs), with the encoder's compute type replaced by ``dtype``."""
    sys.path.insert(0, ROOT)
    import __graft_entry__ as jentry
    from vit_marl_tpu.models import VIT_PRESETS as J_PRESETS
    from vit_marl_tpu.models import ViTActorCriticRNN as JNet

    _, params, h, obs, dones = jentry._flagship_model()
    net = JNet(action_dim=3, fc_dim=64, hidden_size=64, continuous=True,
               vit=dataclasses.replace(J_PRESETS["tiny"],
                                       compute_dtype=dtype),
               action_low=jnp.array([-1.0, 0.0, 0.0]),
               action_high=jnp.array([3.0, 1.0, 1.0]))
    h2, pi, value = net.apply(params, h, (obs, dones))
    return params, (h2, pi.mode(), value), jentry


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_entry_matches_the_jax_entry(dtype, tol):
    params, want, jentry = _jax_flagship(dtype)
    if dtype == "bfloat16":
        # the flagship as both entries build it
        jfn, jargs = jentry.entry()
        want = jfn(*jargs)
        fn, args = tentry.entry("cpu")
        assert fn.net.vit.cfg == VIT_PRESETS["tiny"]
    else:
        fn, args = tentry.entry(
            "cpu", vit=dataclasses.replace(VIT_PRESETS["tiny"],
                                           compute_dtype=dtype))
    fn.net.load_state_dict(flax_to_state_dict(params), strict=True)
    h, obs, dones = args
    assert h.shape == (32, 64) and obs["vision_obs"].shape == (1, 32, 10,
                                                                 3, 2)
    got = fn(*args)
    for name, g, w in zip(("h2", "mode", "value"), got, want):
        assert g.shape == np.asarray(w).shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=tol,
                                   atol=tol, err_msg=name)


def test_entry_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tentry.entry()
