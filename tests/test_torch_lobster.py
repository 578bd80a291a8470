"""The port's LOBSTER loader against the JAX package's, on CSVs the tests
write.

``vit_marl_tpu_torch/data/lobster.py::LobsterLoader`` and
``vit_marl_tpu/data/lobster.py::LobsterLoader`` read the same day files:
two synthetic days written in the LOBSTER naming convention
(``write_day_csvs``), a day of random rows with pre-open, post-close and
type 5-7 rows, and the hand-made fixture of ``tests/test_lobster_fixture.py``.
``messages``, ``starts``, ``ends``, ``init_books`` and
``max_msgs_per_window`` must be bit-equal, through the port's native
parser (``data/native.py``, ``native/lobster_parser.cpp`` built into
``vit_marl_tpu_torch/_build/``) and through its numpy path.  Also: the npz
cache (same file name and contents as the JAX package's), the skip of a
day left empty by the filtering, the raise when every day is, and a
world and one training update fed by the CSVs.
"""

import dataclasses
import os

import numpy as np
import pytest

from test_lobster_fixture import FIXTURE_ROWS, GOLDEN, _write_fixture_day
from test_native_loader import _write_day
from vit_marl_tpu.config import WorldConfig as JWorldConfig
from vit_marl_tpu.data import synthetic as jsyn
from vit_marl_tpu.data.lobster import LobsterLoader as JLoader
from vit_marl_tpu_torch import config as tcfg
from vit_marl_tpu_torch.data import lobster as tlob
from vit_marl_tpu_torch.data import native as tnative
from vit_marl_tpu_torch.data import synthetic as tsyn

STOCK, PERIOD = "SYNTH", "2024-01"
FIELDS = ("messages", "starts", "ends", "init_books", "max_msgs_per_window")
WINDOWS = dict(ep_type="fixed_steps", episode_time=5, start_resolution=3,
               n_data_msg_per_step=10)


def _write_days(root, n_days=2, n=3000):
    base = os.path.join(root, STOCK, PERIOD)
    for d in range(n_days):
        day = jsyn.generate_day(seed=d, n_messages=n, levels=10)
        jsyn.write_day_csvs(day, base, stock=STOCK, date=f"2024-01-0{d + 2}")
    _write_day(base, n=600, seed=5)       # named x_message_10.csv
    return base


def _configs(root, **kw):
    fields = dict(data_path=str(root), stock=STOCK, time_period=PERIOD,
                  cache_dir="", **WINDOWS)
    fields.update(kw)
    return JWorldConfig(**fields), tcfg.WorldConfig(**fields)


def _assert_equal(want, got):
    for f in FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.fixture
def no_native(monkeypatch):
    monkeypatch.setattr(tnative, "get_native_module", lambda: None)


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_loader_bit_equal_to_jax(tmp_path, route, request):
    if route == "numpy":
        request.getfixturevalue("no_native")
    else:
        assert tnative.get_native_module() is not None, \
            "the native parser did not build"
    _write_days(str(tmp_path))
    jc, tc = _configs(tmp_path)
    want = JLoader(jc).run_loading()
    got = tlob.load_data(tc)
    assert got.n_windows == want.n_windows > 10
    _assert_equal(want, got)
    assert len(tlob.LobsterLoader(tc).message_files) == 3


@pytest.mark.parametrize("seed", [0, 1])
def test_native_parser_equals_numpy_path(tmp_path, seed):
    """Per day: the built extension against ``np.loadtxt`` and
    ``_preprocess_day``, bit-equal, rows outside hours and types 5-7
    dropped."""
    mfile, bfile = _write_day(str(tmp_path), seed=seed)
    got_msgs, got_book = tnative.parse_day_native(mfile, bfile, 34_200,
                                                  57_600)
    want_msgs, want_book = tlob._preprocess_day(
        np.loadtxt(mfile, delimiter=",", ndmin=2),
        np.loadtxt(bfile, delimiter=",", ndmin=2), 34_200, 57_600)
    np.testing.assert_array_equal(got_msgs, want_msgs)
    np.testing.assert_array_equal(got_book, want_book.astype(np.int64))
    assert got_msgs.dtype == np.int32 and got_book.dtype == np.int64
    assert set(np.unique(got_msgs[:, 0])) <= {1, 2}


def test_native_builds_into_the_package(tmp_path):
    tnative.get_native_module()
    built = [f for f in os.listdir(tnative.BUILD_DIR)
             if f.startswith("_lobster_native")]
    assert built and tnative.BUILD_DIR.endswith(
        os.path.join("vit_marl_tpu_torch", "_build"))


def test_cache_round_trip_matches_jax(tmp_path):
    root = tmp_path / "data"
    _write_days(str(root))
    jc, tc = _configs(root, cache_dir=str(tmp_path / "tcache"))
    jc = dataclasses.replace(jc, cache_dir=str(tmp_path / "jcache"))
    want = JLoader(jc).run_loading()
    first = tlob.LobsterLoader(tc).run_loading()
    assert sorted(os.listdir(tmp_path / "tcache")) == \
        sorted(os.listdir(tmp_path / "jcache"))
    # the CSVs are gone: the second load reads the cache
    for f in os.listdir(root / STOCK / PERIOD):
        os.remove(root / STOCK / PERIOD / f)
    again = tlob.LobsterLoader(tc).run_loading()
    _assert_equal(want, first)
    _assert_equal(want, again)
    # and the JAX loader reads the port's cache
    _assert_equal(want, JLoader(dataclasses.replace(
        jc, cache_dir=str(tmp_path / "tcache"))).run_loading())


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_empty_day_skipped_as_in_jax(tmp_path, route, request):
    if route == "numpy":
        request.getfixturevalue("no_native")
    base = os.path.join(str(tmp_path), "FIX", "period")
    os.makedirs(base)
    _write_fixture_day(base, FIXTURE_ROWS, name="FIX_d1_message_10.csv")
    _write_fixture_day(base, [("34100.0", 1, 50, 5, 100_0000, 1),
                              ("36000.0", 7, 51, 0, 100_0000, 1)],
                       name="FIX_d2_message_10.csv")
    jc, tc = _configs(tmp_path, stock="FIX", time_period="period",
                      n_data_msg_per_step=1, episode_time=2,
                      start_resolution=1)
    got = tlob.LobsterLoader(tc).run_loading()
    _assert_equal(JLoader(jc).run_loading(), got)
    first = got.messages[got.starts[0]:got.ends[0]]
    np.testing.assert_array_equal(first, GOLDEN[:len(first)])


def test_all_days_empty_raises(tmp_path):
    base = os.path.join(str(tmp_path), "FIX", "period")
    os.makedirs(base)
    _write_fixture_day(base, [("34100.0", 1, 50, 5, 100_0000, 1)],
                       name="FIX_d1_message_10.csv")
    _, tc = _configs(tmp_path, stock="FIX", time_period="period")
    with pytest.raises(ValueError, match="empty after"):
        tlob.LobsterLoader(tc).run_loading()
    _, missing = _configs(tmp_path, stock="NONE")
    with pytest.raises(FileNotFoundError):
        tlob.load_data(missing)


def test_fixed_time_windows_still_raise(tmp_path):
    """``fixed_time`` windows of the written days (a synthetic day and a
    day of random rows): bit-equal to the JAX loader's."""
    _write_days(str(tmp_path), n_days=1)
    jc, tc = _configs(tmp_path, ep_type="fixed_time", episode_time=300,
                      start_resolution=300)
    want = JLoader(jc).run_loading()
    got = tlob.load_data(tc)
    assert got.n_windows == want.n_windows > 10
    _assert_equal(want, got)


def test_port_writes_the_same_csvs_as_jax(tmp_path):
    """``data/synthetic.py::write_day_csvs`` of the port: the same bytes
    as the JAX package's for the same day."""
    day = jsyn.generate_day(seed=3, n_messages=500, levels=10)
    j = jsyn.write_day_csvs(day, str(tmp_path / "j"))
    t = tsyn.write_day_csvs(day, str(tmp_path / "t"))
    for a, b in zip(j, t):
        assert os.path.basename(a) == os.path.basename(b)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


def test_lobster_fed_training_on_the_cpu(tmp_path):
    """``configs/ippo_2player.yaml`` with ``DATA_PATH`` at written CSVs:
    the world's window table is the JAX loader's, and one update trains
    with finite losses."""
    import yaml

    from vit_marl_tpu_torch.env.world import WorldEnv
    from vit_marl_tpu_torch.rl import ppo as tppo
    from vit_marl_tpu_torch.utils.cli import apply_set_overrides

    _write_days(str(tmp_path), n_days=1, n=4000)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "configs", "ippo_2player.yaml")) as f:
        raw = yaml.safe_load(f)
    raw = apply_set_overrides(raw, [
        f"WORLD.DATA_PATH={tmp_path}", f"WORLD.STOCK={STOCK}",
        f"WORLD.TIME_PERIOD={PERIOD}", "WORLD.N_ORDERS=64",
        "WORLD.EPISODE_TIME=4", "WORLD.START_RESOLUTION=5",
        "NUM_ENVS=4", "NUM_STEPS=4", "NUM_MINIBATCHES=2",
        "UPDATE_EPOCHS=1", "TOTAL_TIMESTEPS=16", "LOG_BACKEND=none"])
    ma, tc = tcfg.make_config(raw)
    env = WorldEnv(ma, device="cpu")
    jc = JWorldConfig(**{f.name: getattr(ma.world, f.name)
                         for f in dataclasses.fields(ma.world)})
    want = JLoader(jc).run_loading()
    assert env.n_windows == want.n_windows
    out = tppo.make_train(ma, tc, env=env)(seed=0)
    assert len(out["metrics"]) == 1
    assert all(np.isfinite(v) for v in out["metrics"][0].values())
