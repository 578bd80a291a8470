"""The port's engine fuzzer, ``tools/torch_fuzz_engine.py``, on the CPU.

A few trials pass (the XLA-scan engine against the oracle and against the
plain records scan, bit for bit); a fault planted in the plain scan (one
ask quantity of every env's output book off by one) makes the run exit 1
with a repro line; the trials' configs cover every capacity of ``SHAPES``
and every cancel mode.
"""

import importlib.util
import os

import pytest

from vit_marl_tpu_torch.lob.book import BookState
from vit_marl_tpu_torch.ops import book_kernel as bkern

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fuzz():
    spec = importlib.util.spec_from_file_location(
        "torch_fuzz_engine", os.path.join(ROOT, "tools",
                                          "torch_fuzz_engine.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cpu_trials_pass(fuzz, capsys):
    assert fuzz.main(["--device", "cpu", "--trials", "6", "--seed0",
                      "40"]) == 0
    out = capsys.readouterr().out
    assert "fuzz done: 6 trials (40..45) on cpu" in out
    assert "0 failures" in out and "FAIL" not in out


def test_a_planted_fault_fails_with_a_repro_line(fuzz, capsys,
                                                 monkeypatch):
    real = bkern._scan_reference

    def broken(*args, **kw):
        book, bidask = real(*args, **kw)
        data = book.data.clone()
        data[:, 0, 1, 0] += 1
        return BookState(data), bidask

    monkeypatch.setattr(bkern, "_scan_reference", broken)
    assert fuzz.main(["--device", "cpu", "--trials", "2"]) == 1
    out = capsys.readouterr().out
    assert ("FAIL ENGINE vs RECORDS SCAN mismatch: seed=0 " in out
            and "| repro: python tools/torch_fuzz_engine.py --seed0 0 "
                "--trials 1 --device cpu" in out)
    assert "2 failures" in out


def test_trials_cover_the_capacities_and_modes(fuzz):
    seen = {fuzz.make_trial(seed, 1)[0] for seed in range(60)}
    assert {c.n_orders for c in seen} == {s[0] for s in fuzz.SHAPES}
    assert {2, 6, 24, 100, 128, 200} <= {s[0] for s in fuzz.SHAPES}
    assert {c.cancel_mode for c in seen} == {0, 1, 2, 3}


def test_kernel_checks_need_a_card(fuzz, capsys):
    assert fuzz.main(["--device", "cpu", "--kernel", "--trials", "1"]) == 2
    assert "--kernel needs a CUDA device" in capsys.readouterr().err
