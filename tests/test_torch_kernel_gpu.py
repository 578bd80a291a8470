"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips without a CUDA device.  On a machine with
one, run ``python -m pytest tests/test_torch_kernel_gpu.py -q``.

- Book scan: every output bit-equal, including ragged batches (E not a
  multiple of the kernel's 4 envs per block) and book capacities of
  every route (the exact 32-256, the masked 1-1,024 and the block route
  past them, its book in shared memory to about 4,600 slots and in
  device memory past that, full bid books below -1 among them; the
  block route also at small capacities through
  ``torch_cases.launch_slot_map``; only S < 1 raises); in records mode at rec_k 16 and 128 with messages of more
  than 16 fills, and the trade log built from the kernel's records equal
  to the one built on the CPU from the plain version's.  On corner books
  and streams (``torch_cases.make_corner_case``) in both modes, at every
  capacity, with M that the kernel's 16-message staging chunks do not
  divide (7, 23, 40) and that they do (112), for 0-3 traders (1 and 2 are
  the aggregate kernel's templates, 0 and 3 its general path), and rec_k
  1, 16 and S; envs with and without the corners take the kernel's
  shortcuts and its full path, and a cancel of negative quantity that
  lifts a side's quantity sum past 2^31 takes it off the shortcut.
- Short attention, forward and backward, through the autograd wrapper:
  float32 (the CUDA-core route) within rtol 1e-5 / atol 1e-6 of the
  plain version; bfloat16 (the tensor-core route) within one bf16 ulp of
  it (rtol 8e-3, atol 1e-3), since the plain version is the same float32
  math rounded once.  Ragged B, B below the persistent grid, every
  padding of N (to 16 or 32) and D (to a multiple of 16), heads
  contiguous in the lanes at H > 1; each dtype launches its own route.
- Fused blocks (LN+QKV, proj+MLP, the whole block, LN+QKV+attention):
  float32 within rtol 2e-5 / atol 2e-5 of the plain versions, bfloat16
  within two bf16 ulps of the element or two (three for the blocks ending
  in ``x1 + mlp``) of the output's largest magnitude (``block_tol``);
  ragged B, every tile
  plan (N = 5, 11, 17, 32; W = 64 to 512); the edges of the bf16
  tensor-core route's plans (all four functions): more tiles than one
  persistent wave with a ragged last one (B=5,000), N = 1, 17, 18 and 32,
  W = 64 and 512, hidden 192 (chunks of 64) and 2,048, D = 8, 24 and 128
  (LN+QKV+attention's heads padded to 16 columns, its tiles of 64 rows
  where 128 do not fit), images fewer than one tile, LN+QKV's output
  widths K = 64, 320 and 2,048 (chunks of 128 or 64, a last chunk part
  past K); bf16 launches the tensor-core route and float32 the CUDA-core
  one, counted per route; the LN+QKV+attention backward through the
  attention backward kernel; shapes the kernels do not take raise
  ``NotImplementedError``, but for ViT-Base's width (W=768, hidden
  3,072), which takes the counted ``composed`` route and matches the
  plain versions at ``block_tol``.  Past 32 tokens (N = 33 to 257)
  the whole block and LN+QKV+attention take their route through a qkv
  buffer and the attention of ``csrc/long_attention.cuh`` in both dtypes,
  at the same tolerances, counted once a call on their dtype's route.
- The scan rollout (``rl/scan.py``): one CUDA graph of the 2-player step,
  replayed, bit-equal to the loop, its launches counted a replay.
- Kernels 1 and 2 on streams the port's worlds build: 126 messages a step
  (a ``fixed_prices`` market maker, ``fixed_prices`` and
  ``fixed_quants_1msg`` execution agents, three traders) and a
  ``fixed_time`` world's stream with data rows zeroed past the episode's
  end.
- The bench (``--selfcheck`` passes, the GRU loop reports a rate) and
  the entry module's forward step, on the card.
- The order-book engine (``lob/engine.py``) on the card bit-equal to the
  same calls on the CPU in every cancel mode, on ordinary and corner
  streams (books, logs, best quotes, saved states); on the corners both
  JAX engines share, the engine against kernel 2 at ``rec_k = S`` and the
  log built from its records (``torch_cases.engine_against_records``).
- The greedy eval's graph (``rl/ppo.py::EvalRollout``) bit-equal to the
  host-issued eval, twice, its warm-up the wrapper's one launch, and
  ``combinations.rollout``'s graph bit-equal to ``rollout_loop`` in both
  modes; an eval after an optimizer step, and after a parameter is
  replaced (captured again), sees the new weights.
"""

import itertools
import math
import os
import tempfile

import numpy as np
import pytest
import torch

from vit_marl_tpu_torch.config import EngineConfig
from vit_marl_tpu_torch.lob.book import BookState
from vit_marl_tpu_torch.ops import attention_kernel as attn
from vit_marl_tpu_torch.ops import block_kernel as blk
from vit_marl_tpu_torch.ops import book_kernel as bkern

from torch_cases import (TICK, TIDS, add_sweeps, dispatch_index,
                         engine_against_records, full_negative_bids,
                         launch_slot_map, make_case, make_corner_case,
                         plant_negative_cancel)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
@pytest.mark.parametrize("E,S", [(130, 32), (67, 64), (129, 128),
                                 (33, 256)])
def test_kernel_bit_equal_to_plain(cuda, mode, E, S):
    M = 40
    book, msgs, prev = make_case(E, M, S, seed=100 * mode + S)
    u = np.random.default_rng(mode).random((M, E), dtype=np.float32)
    args = (EngineConfig(n_orders=S, cancel_mode=mode),
            torch.from_numpy(msgs).to(cuda),
            BookState(torch.from_numpy(book).to(cuda)),
            torch.tensor(TIDS, dtype=torch.int32, device=cuda),
            torch.from_numpy(prev).to(cuda), TICK,
            torch.from_numpy(u).to(cuda))
    before = bkern.process_step_aggs.launches
    got = bkern.process_step_aggs(*args)
    assert bkern.process_step_aggs.launches == before + 1
    want = bkern.process_step_aggs_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0].data, want[0].data)
    for g, w in zip(got[1] + got[2], want[1] + want[2]):
        assert torch.equal(g, w)
    assert int(want[2][1][:, 0].sum()) > 0


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
@pytest.mark.parametrize("rec_k", [16, 128])
@pytest.mark.parametrize("E", [128, 1000, 4096])
def test_records_kernel_bit_equal_to_plain(cuda, mode, rec_k, E):
    M, S = 40, 128
    book, msgs, prev = make_case(E, M, S, seed=7 * mode + E, fill=0.7)
    msgs = add_sweeps(msgs, every=5, seed=mode)
    u = np.random.default_rng(mode).random((M, E), dtype=np.float32)
    args = (EngineConfig(n_orders=S, cancel_mode=mode),
            torch.from_numpy(msgs).to(cuda),
            BookState(torch.from_numpy(book).to(cuda)),
            torch.from_numpy(prev).to(cuda), rec_k,
            torch.from_numpy(u).to(cuda))
    before = bkern.process_step_records.launches
    got = bkern.process_step_records(*args)
    assert bkern.process_step_records.launches == before + 1
    want = bkern.process_step_records_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0].data, want[0].data)
    for g, w in zip(got[1] + got[2], want[1] + want[2]):
        assert torch.equal(g, w)
    counts = want[2][1]
    assert int(counts.max()) > 16
    log = bkern.finalize_trade_log_from_records(
        torch.full((E, 256, 8), -1, dtype=torch.int32, device=cuda),
        got[2][0], args[1], got[2][1])
    want_log = bkern.finalize_trade_log_from_records(
        torch.full((E, 256, 8), -1, dtype=torch.int32), want[2][0].cpu(),
        args[1].cpu(), counts.cpu())
    assert torch.equal(log.cpu(), want_log)


def _world_stream(cuda, name, E=512):
    """A step's message stream of a port world on the card: ``m126`` (a
    fixed_prices market maker, fixed_prices and fixed_quants_1msg
    execution agents, 126 messages a step) or ``fixed_time`` (data rows
    past the episode's end zeroed but for their times), after 3 steps."""
    from vit_marl_tpu_torch import config as c
    from vit_marl_tpu_torch.env import spaces
    from vit_marl_tpu_torch.env.world import WorldEnv

    if name == "m126":
        agents = (c.MarketMakingConfig(action_space="fixed_prices"),
                  c.ExecutionConfig(action_space="fixed_prices", n_actions=4,
                                    task_size=60),
                  c.ExecutionConfig(action_space="fixed_quants_1msg"))
        world = c.WorldConfig(n_messages_per_synthetic_day=6000)
    else:
        agents = (c.MarketMakingConfig(), c.ExecutionConfig())
        world = c.WorldConfig(n_messages_per_synthetic_day=6000,
                              ep_type="fixed_time", episode_time=600,
                              start_resolution=600)
    env = WorldEnv(c.MultiAgentConfig(world=world, agents=agents,
                                      n_agents_per_type=(1,) * len(agents)),
                   device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    params = env.default_params

    def acts():
        out = []
        for sp in env.action_spaces:
            if isinstance(sp, spaces.Discrete):
                out.append(torch.randint(0, sp.n, (E,), generator=gen,
                                         device=cuda))
            else:
                out.append(torch.randint(0, 101, (E,) + sp.shape,
                                         generator=gen, device=cuda,
                                         dtype=torch.int32))
        return out
    _, state = env.reset(env.draw_reset(E, gen), params)
    for _ in range(3):
        state = env.step_vec(state, acts(), params, generator=gen)[1]
    draws = env.draw_step(E, gen)
    msgs, _ = env._build_messages(state, env._actions(acts()), params,
                                  draws.shuffle, draws.agents)
    prev = torch.stack([state.world.best_asks[:, -1, 0],
                        state.world.best_bids[:, -1, 0]], 1)
    tids = torch.cat([p.trader_id for p in params.agents])
    return env.wcfg, msgs, state.world.books, tids, prev


@pytest.mark.parametrize("records", [False, True], ids=["aggs", "records"])
@pytest.mark.parametrize("name", ["m126", "fixed_time"])
def test_kernels_bit_equal_on_world_streams(cuda, name, records):
    """Kernels 1 and 2 on the streams of the newly ported spaces: 126
    messages a step with three traders, and fixed_time's zeroed rows."""
    cfg, msgs, books, tids, prev = _world_stream(cuda, name)
    if name == "m126":
        assert msgs.shape[1] == 126
    else:
        assert bool(((msgs[:, :, 0] == 0) & (msgs[:, :, 6] != 0)).any())
    if records:
        args = (cfg, msgs, books, prev, 16, None)
        fn, ref = bkern.process_step_records, \
            bkern.process_step_records_reference
    else:
        args = (cfg, msgs, books, tids, prev, TICK, None)
        fn, ref = bkern.process_step_aggs, bkern.process_step_aggs_reference
    before = fn.launches
    got = fn(*args)
    assert fn.launches == before + 1
    want = ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0].data, want[0].data)
    for g, w in zip(got[1] + got[2], want[1] + want[2]):
        assert torch.equal(g, w)


CORNER_SHAPES = [(130, 40, 32), (67, 7, 64), (129, 112, 128), (33, 23, 256)]
CORNER_TIDS = (-42, -43, -44)


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
@pytest.mark.parametrize("n_agg", [0, 1, 2, 3])
@pytest.mark.parametrize("E,M,S", CORNER_SHAPES)
def test_kernel_bit_equal_on_corners(cuda, mode, n_agg, E, M, S):
    book, msgs, prev = make_corner_case(E, M, S, seed=11 * mode + S + n_agg,
                                        tids=CORNER_TIDS)
    u = np.random.default_rng(mode).random((M, E), dtype=np.float32)
    args = (EngineConfig(n_orders=S, cancel_mode=mode),
            torch.from_numpy(msgs).to(cuda),
            BookState(torch.from_numpy(book).to(cuda)),
            torch.tensor(CORNER_TIDS[:n_agg], dtype=torch.int32,
                         device=cuda),
            torch.from_numpy(prev).to(cuda), TICK,
            torch.from_numpy(u).to(cuda))
    before = bkern.process_step_aggs.launches
    got = bkern.process_step_aggs(*args)
    assert bkern.process_step_aggs.launches == before + 1
    want = bkern.process_step_aggs_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0].data, want[0].data)
    for g, w in zip(got[1] + got[2], want[1] + want[2]):
        assert g.shape == w.shape and torch.equal(g, w)
    if n_agg:
        assert (want[2][1][:, 0] != 0).any()


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
@pytest.mark.parametrize("rec_k", [1, 16, None], ids=["1", "16", "S"])
@pytest.mark.parametrize("E,M,S", CORNER_SHAPES)
def test_records_kernel_bit_equal_on_corners(cuda, mode, rec_k, E, M, S):
    rec_k = rec_k or S
    book, msgs, prev = make_corner_case(E, M, S, seed=13 * mode + S + rec_k)
    msgs = add_sweeps(msgs, every=9, seed=mode)
    u = np.random.default_rng(mode).random((M, E), dtype=np.float32)
    args = (EngineConfig(n_orders=S, cancel_mode=mode),
            torch.from_numpy(msgs).to(cuda),
            BookState(torch.from_numpy(book).to(cuda)),
            torch.from_numpy(prev).to(cuda), rec_k,
            torch.from_numpy(u).to(cuda))
    got = bkern.process_step_records(*args)
    want = bkern.process_step_records_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0].data, want[0].data)
    for g, w in zip(got[1] + got[2], want[1] + want[2]):
        assert torch.equal(g, w)
    # the trap of a shortcut by message type: with wrapping prefix sums a
    # message that is no limit order fills
    counts = want[2][1].cpu().numpy()
    assert (counts[dispatch_index(msgs) >= 2] > 0).any()


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
@pytest.mark.parametrize("records", [False, True], ids=["aggs", "records"])
def test_kernel_bit_equal_after_a_negative_cancel(cuda, mode, records):
    """Positive live quantities whose sum is short of 2^31 until a cancel
    of negative quantity lifts it past; the next cancel, on the other side
    and crossing every slot, then fills (its prefix sums wrap), so the
    kernel may not skip its match (``torch_cases.plant_negative_cancel``,
    on either side, at the stream's start and at its end)."""
    E, M, S = 16, 23, 64
    book, msgs, prev = make_case(E, M, S, seed=5 + mode)
    ats = [0 if e % 4 < 2 else M - 2 for e in range(E)]
    for e in range(E):
        plant_negative_cancel(book, msgs, e, e % 2, ats[e])
    u = np.random.default_rng(mode).random((M, E), dtype=np.float32)
    cfg = EngineConfig(n_orders=S, cancel_mode=mode)
    msgs_t = torch.from_numpy(msgs).to(cuda)
    book_t = BookState(torch.from_numpy(book).to(cuda))
    prev_t = torch.from_numpy(prev).to(cuda)
    u_t = torch.from_numpy(u).to(cuda)
    if records:
        args = (cfg, msgs_t, book_t, prev_t, S, u_t)
        got = bkern.process_step_records(*args)
        want = bkern.process_step_records_reference(*args)
    else:
        args = (cfg, msgs_t, book_t,
                torch.tensor(TIDS, dtype=torch.int32, device=cuda), prev_t,
                TICK, u_t)
        got = bkern.process_step_aggs(*args)
        want = bkern.process_step_aggs_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0].data, want[0].data)
    for g, w in zip(got[1] + got[2], want[1] + want[2]):
        assert torch.equal(g, w)
    # the planted cancel fills where it opens the stream
    filled = bkern.process_step_records_reference(
        cfg, msgs_t.cpu(), BookState(book_t.data.cpu()), prev_t.cpu(), S,
        u_t.cpu())[2][1]
    assert all(int(filled[e, 1]) > 0 for e in range(E) if ats[e] == 0)


def test_kernel_takes_unaligned_inputs(cuda):
    """Messages and books at an address that is no multiple of 16 bytes
    (the kernel's 16-byte loads): the wrapper copies them first."""
    E, M, S = 9, 20, 64
    book, msgs, prev = make_case(E, M, S, seed=3)
    flat_m = torch.zeros(msgs.size + 1, dtype=torch.int32, device=cuda)
    flat_m[1:] = torch.from_numpy(msgs.ravel()).to(cuda)
    flat_b = torch.zeros(book.size + 1, dtype=torch.int32, device=cuda)
    flat_b[1:] = torch.from_numpy(book.ravel()).to(cuda)
    m_view = flat_m[1:].view(E, M, 8)
    b_view = BookState(flat_b[1:].view(E, 2, 6, S))
    assert m_view.data_ptr() % 16 and b_view.data.data_ptr() % 16
    args = (EngineConfig(n_orders=S), m_view, b_view,
            torch.tensor(TIDS, dtype=torch.int32, device=cuda),
            torch.from_numpy(prev).to(cuda), TICK)
    got = bkern.process_step_aggs(*args)
    want = bkern.process_step_aggs_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0].data, want[0].data)
    for g, w in zip(got[1] + got[2], want[1] + want[2]):
        assert torch.equal(g, w)


def test_launch_plan_fits_one_wave_at_the_main_shape(cuda):
    """At S=128 the aggregate kernels for 1 and 2 traders and the records
    kernel keep 8 blocks of 4 warps on an SM, so 4096 envs run in one wave
    on 132 SMs; the plan is worked out once per (S, mode, n_agg, device)."""
    for n_agg in (None, 1, 2):
        plan = bkern.launch_plan(128, n_agg, cuda)
        assert plan["blocks_per_sm"] == 8, plan
        assert plan["warps_per_sm"] == 32, plan
        assert bkern.launch_plan(128, n_agg, cuda) is plan


def test_records_kernel_for_wide_rows_keeps_its_state_in_registers(cuda):
    """Rows of more than 96 records take a records kernel of their own,
    held to fewer blocks an SM so that nothing spills; narrower rows keep
    the one-wave kernel (the records tests above at rec_k 128, and at
    rec_k = S for S >= 128, run the wide one)."""
    narrow = bkern.launch_plan(128, None, cuda, 96)
    wide = bkern.launch_plan(128, None, cuda, 97)
    assert narrow["blocks_per_sm"] == 8, narrow
    assert wide["blocks_per_sm"] < 8 and wide["spill_bytes"] == 0, wide
    assert bkern.launch_plan(128, None, cuda, 128) == wide


def test_records_kernel_rejects_bad_rec_k(cuda):
    book, msgs, prev = make_case(4, 8, 32, seed=1)
    for rec_k in (0, 33):
        with pytest.raises(ValueError, match="rec_k"):
            bkern.process_step_records(
                EngineConfig(n_orders=32), torch.from_numpy(msgs).to(cuda),
                BookState(torch.from_numpy(book).to(cuda)),
                torch.from_numpy(prev).to(cuda), rec_k)


@pytest.mark.parametrize("S", [bkern.WARP_CAPACITY + 1, 2048])
def test_kernel_rejects_unsupported_capacity(cuda, S):
    """Only a book of no slots is refused (both modes raise, with no route
    to the plain version); past 1,024 slots, once refused, both kernels
    take the block route, bit-equal to their plain versions."""
    book, msgs, prev = make_case(4, 8, 1, seed=1)
    t = lambda x: torch.from_numpy(x).to(cuda)  # noqa: E731
    empty = BookState(t(book)[..., :0].contiguous())
    args = (EngineConfig(n_orders=1), t(msgs), empty)
    with pytest.raises(ValueError, match="capacity"):
        bkern.process_step_aggs(
            *args, torch.tensor(TIDS, dtype=torch.int32, device=cuda),
            t(prev), TICK)
    with pytest.raises(ValueError, match="n_orders=0"):
        bkern.process_step_records(*args, t(prev), 1)
    book, msgs, prev = make_case(67, 40, S, seed=S, fill=0.8)
    msgs = add_sweeps(msgs, every=4, seed=S)
    want = _both_kernels(cuda, S, 1, book, msgs, prev, 16)
    assert int(want[2][1].sum()) > 0


def _both_kernels(cuda, S, mode, book, msgs, prev, rec_k, n_agg=2):
    """Kernels 1 and 2 against their plain versions on one case; every
    output bit-equal, one launch each."""
    E, M = msgs.shape[:2]
    u = torch.from_numpy(np.random.default_rng(S).random(
        (M, E), dtype=np.float32)).to(cuda)
    cfg = EngineConfig(n_orders=S, cancel_mode=mode)
    t = lambda x: torch.from_numpy(x).to(cuda)  # noqa: E731
    tids = torch.tensor(CORNER_TIDS[:n_agg], dtype=torch.int32, device=cuda)
    for fn, ref, args in (
            (bkern.process_step_aggs, bkern.process_step_aggs_reference,
             (cfg, t(msgs), BookState(t(book)), tids, t(prev), TICK, u)),
            (bkern.process_step_records,
             bkern.process_step_records_reference,
             (cfg, t(msgs), BookState(t(book)), t(prev), rec_k, u))):
        before = fn.launches
        got = fn(*args)
        assert fn.launches == before + 1
        want = ref(*args)
        torch.cuda.synchronize()
        assert torch.equal(got[0].data, want[0].data)
        for g, w in zip(got[1] + got[2], want[1] + want[2]):
            assert torch.equal(g, w)
    return want


MASKED = (1, 2, 24, 48, 100, 101, 200, 384, 1000, 1024)


@pytest.mark.parametrize("mode", [0, 3])
@pytest.mark.parametrize("S", MASKED)
def test_kernels_bit_equal_at_every_capacity(cuda, mode, S):
    """The masked route (``capacity_route``): S not a multiple of 32 or 4,
    S of 1 and 2, S past 256 (16 and 32 slots a lane); corner streams with
    sweeps at a ragged E and M, 1-3 traders, records at rec_k = min(S,
    256)."""
    E, M = 67, 23
    book, msgs, prev = make_corner_case(E, M, S, seed=S + mode,
                                        tids=CORNER_TIDS)
    msgs = add_sweeps(msgs, every=3, seed=S)
    want = _both_kernels(cuda, S, mode, book, msgs, prev, min(S, 256),
                         n_agg=S % 3 + 1)
    assert int(want[2][1].sum()) > 0


BLOCK_ROUTE = (1025, 1500, 2048, 4096)


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
@pytest.mark.parametrize("S", BLOCK_ROUTE)
def test_block_route_bit_equal_past_a_warp(cuda, mode, S):
    """The block route (``capacity_route`` past 1,024): corner streams
    with sweeps at a ragged E and M, 1-3 traders, records at rec_k =
    min(S, 256), and random streams at rec_k = S."""
    assert bkern.capacity_route(S) == (bkern.BLOCK_ROUTE, False)
    E, M = 67, 23
    book, msgs, prev = make_corner_case(E, M, S, seed=S + mode,
                                        tids=CORNER_TIDS)
    msgs = add_sweeps(msgs, every=3, seed=S)
    want = _both_kernels(cuda, S, mode, book, msgs, prev, min(S, 256),
                         n_agg=S % 3 + 1)
    assert int(want[2][1].sum()) > 0
    book, msgs, prev = make_case(130, 40, S, seed=S + 10 * mode, fill=0.8)
    _both_kernels(cuda, S, mode, book, msgs, prev, S)


@pytest.mark.parametrize("mode", [0, 3])
def test_block_route_keeps_a_deep_book_in_device_memory(cuda, mode):
    """Past what shared memory holds (16,384 slots: 786 KB a book) the
    block route works on the output book in device memory."""
    S = 16_384
    plan = bkern.launch_plan(S, 2, cuda)
    assert plan["book_in_device_memory"] and plan["threads_per_env"] == 256
    assert not bkern.launch_plan(2048, 2, cuda)["book_in_device_memory"]
    book, msgs, prev = make_corner_case(8, 40, S, seed=S + mode,
                                        tids=CORNER_TIDS)
    msgs = add_sweeps(msgs, every=3, seed=S)
    want = _both_kernels(cuda, S, mode, book, msgs, prev, 64)
    assert int(want[2][1].sum()) > 0


@pytest.mark.parametrize("S", [1, 2, 24, 100, 257, 300, 1024])
@pytest.mark.parametrize("mode", [0, 1, 3])
def test_block_route_at_small_capacities(cuda, mode, S):
    """The block route taken at capacities the wrappers send to a warp
    (``torch_cases.launch_slot_map``, slots a lane 0): threads with no
    slot, one slot a thread, an insert's shift across threads; both
    kernels bit-equal to the plain versions."""
    book, msgs, prev = make_corner_case(67, 23, S, seed=S + mode,
                                        tids=CORNER_TIDS)
    msgs = add_sweeps(msgs, every=3, seed=S)
    E, M = msgs.shape[:2]
    u = torch.from_numpy(np.random.default_rng(S).random(
        (M, E), dtype=np.float32)).to(cuda)
    t = lambda x: torch.from_numpy(x).to(cuda)  # noqa: E731
    cfg = EngineConfig(n_orders=S, cancel_mode=mode)
    m, b, p = t(msgs), BookState(t(book)), t(prev)
    tids = torch.tensor(CORNER_TIDS[:S % 3 + 1], dtype=torch.int32,
                        device=cuda)
    lib = bkern._library()
    for got, want in (
            (launch_slot_map(lib, cfg, m, b, p, bkern.BLOCK_ROUTE, False,
                             tids=tids, uniforms=u),
             bkern.process_step_aggs_reference(cfg, m, b, tids, p, TICK, u)),
            (launch_slot_map(lib, cfg, m, b, p, bkern.BLOCK_ROUTE, False,
                             rec_k=min(S, 64), uniforms=u),
             bkern.process_step_records_reference(cfg, m, b, p,
                                                  min(S, 64), u))):
        torch.cuda.synchronize()
        assert torch.equal(got[0].data, want[0].data)
        for g, w in zip(got[1] + got[2], want[1] + want[2]):
            assert torch.equal(g, w)


@pytest.mark.parametrize("S", [1024, 1025])
def test_plans_of_other_trader_counts_share_a_kernel(cuda, S):
    """A plan for 2 traders after one for 3 (the general kernel, its
    shared memory past 48 KB) leaves the 3-trader launch valid."""
    bkern.launch_plan(S, 3, cuda)
    bkern.launch_plan(S, 2, cuda)
    book, msgs, prev = make_corner_case(67, 23, S, seed=S, tids=CORNER_TIDS)
    _both_kernels(cuda, S, 1, book, msgs, prev, 16, n_agg=3)


def test_every_capacity_has_a_plan(cuda):
    """``launch_plan`` gives a route for every S from 1 to 1,100 and for
    S to 65,536 by a stride, in both modes; an SM holds a block of it."""
    for S in [*range(1, 1101), *range(1101, 65_537, 61), 65_536]:
        for n_agg, rec_k in ((2, 1), (None, min(S, 128))):
            plan = bkern.launch_plan(S, n_agg, cuda, rec_k)
            assert plan["blocks_per_sm"] >= 1, (S, plan)
            assert plan["slots_per_lane"] == bkern.capacity_route(S)[0]


@pytest.mark.parametrize("S", [24, 100, 200, 1500])
def test_kernels_bit_equal_on_full_negative_bid_books(cuda, S):
    """Full bid sides below -1: a slot past the capacity is no hole, so
    the best bid stays below -1 until a real hole opens."""
    book, msgs, prev = make_case(130, 40, S, seed=S)
    book, msgs = full_negative_bids(book, msgs, S)
    want = _both_kernels(cuda, S, 1, book, msgs, prev, 16)
    assert (want[1][1][..., 0] < -1).any()


def test_launch_plans_of_every_route(cuda):
    """Each capacity's plan names its slot map; past 256 slots the kernels
    keep fewer blocks an SM; the masked route at S=128 (what the masks
    cost) gives the exact route's results."""
    for S in (2, 32, 100, 128, 200, 256, 384, 1024):
        for n_agg, rec_k in ((2, 1), (None, min(S, 128))):
            plan = bkern.launch_plan(S, n_agg, cuda, rec_k)
            spl, masked = bkern.capacity_route(S)
            assert (plan["slots_per_lane"], plan["masked"]) == (spl, masked)
            assert plan["blocks_per_sm"] >= 1, plan
    assert bkern.launch_plan(1024, 2, cuda)["blocks_per_sm"] == 1
    book, msgs, prev = make_case(129, 40, 128, seed=5)
    t = lambda x: torch.from_numpy(x).to(cuda)  # noqa: E731
    cfg, msgs, book, prev = (EngineConfig(n_orders=128), t(msgs),
                             BookState(t(book)), t(prev))
    tids = torch.tensor(TIDS, dtype=torch.int32, device=cuda)
    for exact, kw in (
            (bkern._launch(cfg, msgs, book, tids, prev, TICK, None),
             dict(tids=tids)),
            (bkern._launch_records(cfg, msgs, book, prev, 16, None),
             dict(rec_k=16))):
        masked = launch_slot_map(bkern._library(), cfg, msgs, book, prev, 4,
                                 True, **kw)
        assert torch.equal(exact[0].data, masked[0].data)
        for g, w in zip(exact[1] + exact[2], masked[1] + masked[2]):
            assert torch.equal(g, w)


ATTN_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-6),
            torch.bfloat16: dict(rtol=8e-3, atol=1e-3)}


# Shapes the bf16 route pads: N to 16 or 32 tokens, D to a multiple of
# 16; ragged B (1000, 37, 130) and B below the persistent grid (3).
PAD_SHAPES = [((1000, 3, 37, 130)[i % 4], N, (1, 2, 3)[i % 3], D)
              for i, (N, D) in enumerate(itertools.product(
                  (1, 11, 16, 17, 32), (8, 24, 64, 128)))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,N,H,D", [(37, 11, 2, 32), (1000, 11, 6, 64),
                                     (3, 5, 6, 64), (65, 32, 2, 128),
                                     (9, 1, 3, 8)] + PAD_SHAPES)
def test_attention_kernels_match_plain(cuda, dtype, B, N, H, D):
    rng = np.random.default_rng(B + N + H)
    x = torch.from_numpy(rng.normal(size=(B * N, 3 * H * D)).astype(
        np.float32)).to(cuda, dtype).requires_grad_(True)
    g = torch.from_numpy(rng.normal(size=(B * N, H * D)).astype(
        np.float32)).to(cuda, dtype)
    f0, b0 = attn.short_attention.launches_fwd, attn.short_attention.launches_bwd
    out = attn.short_attention(x, N, H)
    (dx,) = torch.autograd.grad(out, x, g)
    assert attn.short_attention.launches_fwd == f0 + 1
    assert attn.short_attention.launches_bwd == b0 + 1
    assert out.dtype == dx.dtype == dtype
    want = attn.short_attention_reference(x.detach(), N, H)
    want_dx = attn.short_attention_bwd_reference(x.detach(), g, N, H)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, **ATTN_TOL[dtype])
    torch.testing.assert_close(dx, want_dx, **ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "mma"),
                                         (torch.float32, "simt")])
def test_attention_route_follows_the_dtype(cuda, dtype, route):
    """bf16 launches the tensor-core kernels, float32 the CUDA-core ones;
    each launch counts once on its route and once in the totals."""
    names = [f"launches_{d}_{r}" for d in ("fwd", "bwd")
             for r in ("mma", "simt")] + ["launches_fwd", "launches_bwd"]
    before = {n: getattr(attn.short_attention, n) for n in names}
    x = torch.randn(7 * 11, 3 * 128, device=cuda).to(dtype)
    x.requires_grad_(True)
    (dx,) = torch.autograd.grad(attn.short_attention(x, 11, 2), x,
                                torch.randn(7 * 11, 128, device=cuda)
                                .to(dtype))
    torch.cuda.synchronize()
    grew = {n for n in names if getattr(attn.short_attention, n) != before[n]}
    assert grew == {f"launches_fwd_{route}", f"launches_bwd_{route}",
                    "launches_fwd", "launches_bwd"}
    assert all(getattr(attn.short_attention, n) == before[n] + 1
               for n in grew)
    assert dx.dtype == dtype


def test_attention_backward_is_the_gradient_of_the_forward(cuda):
    """float32: the plain backward and the kernel both equal autograd of
    the plain forward."""
    x = torch.randn(13 * 11, 3 * 128, device=cuda, requires_grad=True)
    g = torch.randn(13 * 11, 128, device=cuda)
    (want,) = torch.autograd.grad(
        attn.short_attention_reference(x, 11, 2), x, g)
    torch.testing.assert_close(
        attn.short_attention_bwd_reference(x.detach(), g, 11, 2), want,
        rtol=1e-5, atol=1e-6)
    (got,) = torch.autograd.grad(attn.short_attention(x, 11, 2), x, g)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_attention_kernel_rejects_unsupported_shapes(cuda):
    with pytest.raises(ValueError, match="N <= 32"):
        attn.short_attention(torch.zeros(33 * 2, 3 * 64, device=cuda), 33, 1)
    with pytest.raises(ValueError, match="multiple of 8"):
        attn.short_attention(torch.zeros(4 * 2, 3 * 12, device=cuda), 4, 1)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        attn.short_attention(torch.zeros(4 * 2, 3 * 16, device=cuda,
                                         dtype=torch.float16), 4, 1)
    flat = torch.zeros(8 * 48 + 1, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        attn.short_attention(flat[1:].view(8, 48), 4, 1)


def block_tol(kind, want):
    """float32: rtol 2e-5, atol 2e-5.  bf16: two ulps of the element (rtol
    1.6e-2) or ulps of the output's largest magnitude (atol): a one-ulp
    flip of a rounded intermediate (qkv, attention, x1, the MLP's sum)
    reaches the output, and where the output cancels to near 0 the error
    is an ulp of the intermediate, at the scale of the rows; three ulps
    where the output ends in x1 + mlp, two otherwise."""
    if want.dtype == torch.float32:
        return dict(rtol=2e-5, atol=2e-5)
    ulps = 3 if kind in ("proj_mlp", "full_block") else 2
    m = float(want.float().abs().max())
    return dict(rtol=1.6e-2,
                atol=ulps * 2.0 ** (math.floor(math.log2(m)) - 7))


BLOCK_KINDS = ["ln_qkv", "proj_mlp", "full_block", "ln_qkv_attn"]


def block_case(kind, B, N, W, H, dtype, device, seed, ratio=4):
    """(kernel wrapper, plain version, args) of one fused-block function
    on seeded normal inputs; weights in torch's (out, in) layout."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def t(*shape, scale=1.0, loc=0.0, dt=torch.float32):
        return (loc + scale * torch.randn(shape, generator=gen,
                                          device=device)).to(dt)

    x = t(B * N, W, dt=dtype)
    ln = [t(W, scale=0.1, loc=1.0), t(W, scale=0.1)]
    qkv = [t(3 * W, W, scale=W ** -0.5, dt=dtype), t(3 * W, scale=0.1)]
    tail = [t(W, W, scale=W ** -0.5, dt=dtype), t(W, scale=0.1),
            t(W, scale=0.1, loc=1.0), t(W, scale=0.1),
            t(ratio * W, W, scale=W ** -0.5, dt=dtype), t(ratio * W, scale=0.1),
            t(W, ratio * W, scale=(ratio * W) ** -0.5, dt=dtype),
            t(W, scale=0.1)]
    if kind == "ln_qkv":
        return blk.fused_ln_qkv, blk.ln_qkv_reference, [x] + ln + qkv
    if kind == "proj_mlp":
        return (blk.fused_proj_mlp, blk.proj_mlp_reference,
                [t(B * N, W, dt=dtype), x] + tail)
    if kind == "full_block":
        return (lambda *a: blk.fused_block_full(*a, N, H),
                lambda *a: blk.full_block_reference(*a, N, H),
                [x] + ln + qkv + tail)
    return (lambda *a: blk.fused_ln_qkv_attn(*a, N, H),
            lambda *a: blk.ln_qkv_attn_reference(*a, N, H), [x] + ln + qkv)


def _counter(kind):
    return {"ln_qkv": blk.fused_ln_qkv, "proj_mlp": blk.fused_proj_mlp,
            "full_block": blk.fused_block_full,
            "ln_qkv_attn": blk.fused_ln_qkv_attn}[kind]


# Edges of the bf16 route's plan (block_kernel.py::wgmma_plan), hidden 4W:
# a ragged last tile and more tiles than one persistent wave (B=5,000 at
# N=11); N = 1, 17 and 32; W = 64 and 512 (hidden 2,048); D = 8 and 128.
TC_EDGES = [(5000, 11, 384, 6), (40, 1, 128, 2), (25, 17, 192, 3),
            (9, 32, 256, 2), (13, 11, 64, 8), (7, 5, 512, 4),
            (11, 3, 512, 64)]
# and of LN+QKV(+attention)'s: N=18 (the last image's padded rows past
# the tile), D=24 (heads padded to 32 columns), W=448 (tiles of 64 rows),
# 2 images (one partial tile)
QKV_EDGES = [(6, 18, 384, 3), (10, 13, 192, 8), (50, 7, 448, 7),
             (2, 11, 384, 6)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", BLOCK_KINDS)
@pytest.mark.parametrize("B,N,W,H", [(37, 11, 384, 6), (5, 32, 512, 4),
                                     (9, 5, 64, 2), (3, 17, 192, 3),
                                     (1000, 11, 384, 6)] + TC_EDGES
                         + QKV_EDGES)
def test_block_kernels_match_plain(cuda, kind, dtype, B, N, W, H):
    torch.backends.cuda.matmul.allow_tf32 = False
    kern, plain, args = block_case(kind, B, N, W, H, dtype, cuda, B + N + W)
    fn = _counter(kind)
    before = fn.launches
    got = kern(*args)
    assert fn.launches == before + 1
    want = plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got, want, **block_tol(kind, want))


@pytest.mark.parametrize("kind", ["proj_mlp", "full_block"])
def test_block_kernels_match_plain_hidden_192(cuda, kind):
    """An MLP hidden width that is no multiple of 128 (chunks of 64) on
    the bf16 route: W=64, hidden 192, 8 heads of 8."""
    kern, plain, args = block_case(kind, 21, 11, 64, 8, torch.bfloat16,
                                   cuda, 192, ratio=3)
    fn = _counter(kind)
    before = fn.launches_wgmma
    got = kern(*args)
    assert fn.launches_wgmma == before + 1
    want = plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **block_tol(kind, want))


@pytest.mark.parametrize("W,K", [(128, 64), (128, 320), (512, 2048)])
def test_ln_qkv_kernel_output_widths(cuda, W, K):
    """LN+QKV at output widths other than 3W on the bf16 route: one
    chunk, a last chunk part past K, and the widest (chunks of 64)."""
    kern, plain, args = block_case("ln_qkv", 23, 11, W, 2, torch.bfloat16,
                                   cuda, K)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(K)
    args[3] = (torch.randn(K, W, generator=gen, device=cuda)
               * W ** -0.5).to(torch.bfloat16)
    args[4] = torch.randn(K, generator=gen, device=cuda) * 0.1
    before = blk.fused_ln_qkv.launches_wgmma
    got = kern(*args)
    assert blk.fused_ln_qkv.launches_wgmma == before + 1
    want = plain(*args)
    torch.cuda.synchronize()
    assert got.shape == (23 * 11, K)
    torch.testing.assert_close(got, want, **block_tol("ln_qkv", want))


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "simt")])
@pytest.mark.parametrize("kind", BLOCK_KINDS)
def test_block_route_follows_the_dtype(cuda, kind, dtype, route):
    """bf16 launches the tensor-core kernel, float32 the CUDA-core one;
    each launch counts once on its route and once in the total."""
    fn = _counter(kind)
    names = ["launches", "launches_wgmma", "launches_simt"]
    before = {n: getattr(fn, n) for n in names}
    kern, _, args = block_case(kind, 7, 11, 128, 2, dtype, cuda, 5)
    kern(*args)
    torch.cuda.synchronize()
    grew = {n: getattr(fn, n) - before[n] for n in names}
    assert grew == {"launches": 1, f"launches_{route}": 1,
                    f"launches_{'simt' if route == 'wgmma' else 'wgmma'}": 0}


def test_ln_qkv_attn_backward_runs_the_attention_kernel(cuda):
    N, H, W = 11, 6, 384
    _, _, args = block_case("ln_qkv_attn", 13, N, W, H, torch.float32, cuda,
                            1)
    args = [a.requires_grad_(True) for a in args]
    g = torch.randn(13 * N, W, device=cuda)
    b0 = attn.short_attention.launches_bwd
    got = torch.autograd.grad(blk.fused_ln_qkv_attn(*args, N, H), args, g)
    assert attn.short_attention.launches_bwd == b0 + 1
    want = torch.autograd.grad(blk.ln_qkv_attn_reference(*args, N, H), args,
                               g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_block_kernels_reject_unsupported_shapes(cuda):
    _, _, args = block_case("full_block", 2, 11, 64, 2, torch.float32, cuda,
                            2)
    with pytest.raises(NotImplementedError, match="D=4 "):
        blk.fused_block_full(*args, 11, 16)
    x = torch.zeros(22, 96, device=cuda)
    v = torch.zeros(96, device=cuda)
    with pytest.raises(NotImplementedError, match="W=96"):
        blk.fused_ln_qkv(x, v, v, torch.zeros(288, 96, device=cuda),
                         torch.zeros(288, device=cuda))
    with pytest.raises(NotImplementedError, match="float16"):
        blk.fused_ln_qkv(*[a.half() if a.dim() == 2 else a
                           for a in args[:5]])


COMPOSED = {"ln_qkv": "fused_ln_qkv", "proj_mlp": "fused_proj_mlp",
            "full_block": "fused_block_full",
            "ln_qkv_attn": "fused_ln_qkv_attn"}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("kind", list(COMPOSED))
def test_vit_base_width_takes_the_composed_route(cuda, kind, dtype):
    """W=768, hidden 3,072, 12 heads: past the JAX package's width
    guards, each wrapper runs the composed route on the card (counted in
    ``launches_composed``, no kernel launched) and matches the plain
    version at ``block_tol``."""
    from vit_marl_tpu_torch.selfcheck import block_tol

    fn = getattr(blk, COMPOSED[kind])
    names = ["launches", "launches_wgmma", "launches_simt",
             "launches_composed"]
    before = {n: getattr(fn, n) for n in names}
    kern, plain, args = block_case(kind, 37, 11, 768, 12, dtype, cuda, 8)
    got, want = kern(*args), plain(*args)
    torch.cuda.synchronize()
    grew = {n: getattr(fn, n) - before[n] for n in names}
    assert grew == {"launches": 0, "launches_wgmma": 0, "launches_simt": 0,
                    "launches_composed": 1}
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, **block_tol(COMPOSED[kind], want))


# past 32 tokens kernels 5 and 7 take their route of three launches (the
# qkv staged through a global buffer, csrc/long_attention.cuh): tile edges
# of the attention's 32-key tiles and 64- (bf16) or 32-row (float32) query
# blocks, and images longer than one CTA tile of 64 or 128 rows
LONG_N = [33, 41, 51, 64, 65, 128, 129, 257]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["full_block", "ln_qkv_attn"])
@pytest.mark.parametrize("N", LONG_N)
def test_block_kernels_past_32_tokens_match_plain(cuda, kind, dtype, N):
    """ViT-Small's widths (W=384, 6 heads of 64); each call counts once,
    on its dtype's route, and not as an LN+QKV or proj+MLP call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    kern, plain, args = block_case(kind, 7, N, 384, 6, dtype, cuda, N)
    fn = _counter(kind)
    route = "wgmma" if dtype == torch.bfloat16 else "simt"
    inner = (blk.fused_ln_qkv, blk.fused_proj_mlp)
    before = (fn.launches, getattr(fn, f"launches_{route}"),
              [f.launches for f in inner])
    got = kern(*args)
    assert (fn.launches, getattr(fn, f"launches_{route}"),
            [f.launches for f in inner]) == (before[0] + 1, before[1] + 1,
                                             before[2])
    want = plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got, want, **block_tol(kind, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,N,W,H", [(5, 41, 192, 8), (3, 65, 256, 2),
                                     (2, 33, 64, 8), (300, 41, 512, 4)])
def test_long_attention_head_widths(cuda, dtype, B, N, W, H):
    """D = 24 (padded to 32 columns), 128, 8 and W=512 past 32 tokens."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for kind in ("full_block", "ln_qkv_attn"):
        kern, plain, args = block_case(kind, B, N, W, H, dtype, cuda, B + N)
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **block_tol(kind, want))


def _kernel_launches(fn, piece):
    """Launches of kernels whose name holds ``piece`` while ``fn()`` runs,
    from a ``torch.profiler`` Chrome trace ended by its drain."""
    from vit_marl_tpu_torch.utils.profiling import kernel_events, trace

    with tempfile.TemporaryDirectory() as d:
        with trace(d, drain=True) as prof:
            fn()
        events = kernel_events(prof.trace_path)
    return sum(1 for ev in events if piece in ev.get("name", ""))


def test_scan_graph_replays_the_loop(cuda):
    """``rl/scan.py`` on the card: the 2-player step captured as one CUDA
    graph (after its warm-up) and replayed 3 times gives trajectories,
    info moments and carry bit-equal to ``rollout_loop`` from the same
    carry and generator state.  The book scan's wrapper counts the
    warm-up's launch and none for the capture or the replays; the graph
    holds one book-scan kernel node (its DOT dump), and a profiler trace
    of a second run finds the kernel launched once a replay, as
    ``StepGraph.replays`` counts; a run of the first 2 steps replays the
    same graph twice."""
    from vit_marl_tpu_torch import config as tcfg
    from vit_marl_tpu_torch.env.world import WorldEnv
    from vit_marl_tpu_torch.rl import ppo as tppo
    from vit_marl_tpu_torch.rl.scan import ScanRollout
    from vit_marl_tpu_torch.utils.tree import tree_leaves

    E, T = 64, 3
    ma = tcfg.MultiAgentConfig(world=tcfg.WorldConfig(
        n_orders=64, n_messages_per_synthetic_day=4000, episode_time=2,
        start_resolution=5))
    env = WorldEnv(ma, device=cuda)
    tc = tcfg.TrainConfig(num_envs=E, num_steps=T)
    torch.manual_seed(0)
    nets = tppo.make_networks(env, tc)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(1)
    params = env.default_params
    obs, state = env.reset(env.draw_reset(E, gen), params)
    actors = [n * E for n in env.n_per_type]
    carry = tppo.Carry(state, obs,
                       [torch.zeros(a, dtype=torch.bool, device=cuda)
                        for a in actors],
                       [torch.zeros(a, tc.hidden_size, device=cuda)
                        for a in actors])
    twin = torch.Generator(device=cuda)
    twin.set_state(gen.get_state())
    scan = ScanRollout(env.step_vec, nets, params, T, E, env.n_per_type,
                       gen, gen, True, cuda)
    with torch.no_grad():
        want = tppo.rollout_loop(env.step_vec, nets, carry, params, T, E,
                                 env.n_per_type, twin, twin, True)
        before = bkern.process_step_aggs.launches
        got = scan.run(carry)
        torch.cuda.synchronize()
    assert scan.graph is not None and scan.replays == T
    assert bkern.process_step_aggs.launches == before + 1
    la, lb = tree_leaves(got), tree_leaves(want)
    assert len(la) == len(lb)
    bad = [i for i, (a, b) in enumerate(zip(la, lb)) if not torch.equal(a, b)]
    assert bad == []
    assert gen.get_state().equal(twin.get_state())
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "graph.dot")
        scan.graph.debug_dump(path)
        with open(path) as f:
            assert f.read().count("book_scan_kernel") == 1
    with torch.no_grad():
        replayed = _kernel_launches(lambda: scan.run(got[2]),
                                    "book_scan_kernel")
    assert replayed == T and scan.replays == 2 * T
    with torch.no_grad():
        first = _kernel_launches(lambda: scan.run(got[2], steps=2),
                                 "book_scan_kernel")
    assert first == 2 and scan.replays == 2 * T + 2
    assert bkern.process_step_aggs.launches == before + 1


def test_bench_selfcheck_and_loop_on_the_card(cuda, capsys):
    """``python -m vit_marl_tpu_torch.bench`` in-process on the card: the
    selfcheck passes and the GRU loop reports a positive rate."""
    from vit_marl_tpu_torch import bench

    out = bench.main(["--selfcheck", "--envs", "512"])
    assert out["value"] is True, out
    out = bench.main(["--policy", "gru", "--envs", "512", "--steps", "2",
                      "--reps", "1"])
    assert out["value"] > 0


def test_entry_on_the_card(cuda):
    from vit_marl_tpu_torch.graft_entry import entry

    fn, args = entry()
    h2, mode, value = fn(*args)
    assert h2.shape == (32, 64) and mode.shape == (1, 32, 3)
    assert value.shape == (1, 32)
    assert all(bool(torch.isfinite(t).all()) for t in (h2, mode, value))


def _eval_world(cuda, E):
    from vit_marl_tpu_torch import config as tcfg
    from vit_marl_tpu_torch.env.world import WorldEnv
    from vit_marl_tpu_torch.rl import ppo as tppo

    ma = tcfg.MultiAgentConfig(world=tcfg.WorldConfig(
        n_orders=64, n_messages_per_synthetic_day=4000, episode_time=2,
        start_resolution=5))
    env = WorldEnv(ma, device=cuda)
    tc = tcfg.TrainConfig(num_envs=E)
    torch.manual_seed(0)
    return env, tppo.make_networks(env, tc), tc.hidden_size


def _twin_generators(cuda, seed):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(seed)
    twin = torch.Generator(device=cuda)
    twin.set_state(gen.get_state())
    return gen, twin


def test_eval_graph_replays_the_eager_eval(cuda):
    """``rl/ppo.py::EvalRollout`` on the card: one captured step replayed
    T times gives every metric of the host-issued eval bit for bit, on
    the same generator state; the book scan's wrapper counts the
    warm-up's launch only, a second run captures nothing new, and
    ``combinations.rollout`` (a graph a label) equals ``rollout_loop``
    in both modes."""
    from vit_marl_tpu_torch.eval import baselines as tbase
    from vit_marl_tpu_torch.eval import combinations as tcomb
    from vit_marl_tpu_torch.rl import ppo as tppo
    from vit_marl_tpu_torch.utils.tree import tree_leaves

    E, T = 64, 3
    env, nets, hidden = _eval_world(cuda, E)
    gen, twin = _twin_generators(cuda, 1)
    body = tppo.EvalRollout(env, nets, E, T, hidden, True, gen)
    for rnd in range(2):
        before = bkern.process_step_aggs.launches
        got = body.run()
        want = tppo.eval_rollout_loop(env, nets, E, T, hidden, True, twin)
        torch.cuda.synchronize()
        assert list(got) == list(want)
        assert [k for k in want if not torch.equal(got[k], want[k])] == []
        assert gen.get_state().equal(twin.get_state())
        # the graph's warm-up (first run only), then the loop's T
        assert bkern.process_step_aggs.launches == \
            before + T + (1 if rnd == 0 else 0)
    assert body.use_graph and body.captures == 1
    n = [sp.n for sp in env.action_spaces]
    pols = [tbase.LearnedPolicy(nets[0]), tbase.FixedActionPolicy(1, n[1])]
    for mode in ("sample", "greedy"):
        gen, twin = _twin_generators(cuda, 2)
        got = tcomb.rollout(env, env.default_params, pols, E, T, gen,
                            hidden_size=hidden, mode=mode)
        want = tcomb.rollout_loop(env, env.default_params, pols, E, T, twin,
                                  hidden_size=hidden, mode=mode)
        la, lb = tree_leaves(got), tree_leaves(want)
        assert len(la) == len(lb) > 0
        assert [i for i, (a, b) in enumerate(zip(la, lb))
                if a.dtype != b.dtype or not torch.equal(a, b)] == []
        assert gen.get_state().equal(twin.get_state())


def test_eval_graph_sees_the_trained_weights(cuda):
    """The eval graph reads the networks' weights from their storage: an
    optimizer step between two runs (in place) and a parameter replaced
    by ``load_state_dict(assign=True)`` (a new tensor: the graph is
    captured again) both give the eager eval of the new weights, never
    the old ones."""
    from vit_marl_tpu_torch.rl import ppo as tppo

    E, T = 64, 3
    env, nets, hidden = _eval_world(cuda, E)
    gen, twin = _twin_generators(cuda, 3)
    body = tppo.EvalRollout(env, nets, E, T, hidden, True, gen)
    first = body.run()
    tppo.eval_rollout_loop(env, nets, E, T, hidden, True, twin)
    opt = torch.optim.Adam(nets[0].parameters(), lr=0.5)
    for p in nets[0].parameters():
        p.grad = torch.randn_like(p)
    opt.step()                              # the trainer's in-place step
    for label in ("in place", "assign"):
        if label == "assign":
            sd = {k: v.clone() + 0.25 for k, v in
                  nets[1].state_dict().items()}
            nets[1].load_state_dict(sd, assign=True)
        got = body.run()
        want = tppo.eval_rollout_loop(env, nets, E, T, hidden, True, twin)
        torch.cuda.synchronize()
        assert [k for k in want if not torch.equal(got[k], want[k])] == [], \
            label
        assert not all(torch.equal(got[k], first[k]) for k in first), label
    assert body.captures == 2


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
@pytest.mark.parametrize("shared", [False, True], ids=["corner", "shared"])
def test_engine_on_the_card_equals_the_cpu(cuda, mode, shared):
    from vit_marl_tpu_torch.lob import engine

    E, M, S = 96, 40, 128
    book, msgs, _ = make_corner_case(E, M, S, seed=5 + mode, fill=0.7,
                                     shared=shared)
    u = torch.rand((M, E), generator=torch.Generator().manual_seed(mode))
    cfg = EngineConfig(n_orders=S, n_trades=256, cancel_mode=mode)
    out = {}
    for dev in ("cpu", cuda):
        on = lambda x: torch.from_numpy(x).to(dev)          # noqa: E731
        log0 = torch.full((E, 256, 8), -1, dtype=torch.int32, device=dev)
        b, log, quotes = engine.process_messages_save_bidask(
            cfg, on(msgs), BookState(on(book)), log0, M, u.to(dev))
        asks, bids, log2 = engine.process_messages_save_states(
            cfg, on(msgs), BookState(on(book)), log0, 3, u.to(dev))
        out[str(dev)] = [b.data, log, *quotes, asks.price, bids.quant, log2]
    for g, w in zip(out["cuda"], out["cpu"]):
        assert torch.equal(g.cpu(), w)
    assert int((out["cpu"][1][..., 0] != -1).sum()) > 0


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_engine_against_records_kernel_on_shared_corners(cuda, mode):
    E, M, S = 256, 112, 128
    book, msgs, prev = make_corner_case(E, M, S, seed=11 + mode, fill=0.7,
                                        shared=True, fresh_ids=True)
    msgs = add_sweeps(msgs, every=4, seed=mode, fresh_ids=True)
    u = torch.rand((M, E), generator=torch.Generator().manual_seed(mode))
    before = bkern.process_step_records.launches
    n, most = engine_against_records(
        EngineConfig(n_orders=S, cancel_mode=mode),
        torch.from_numpy(msgs).to(cuda),
        BookState(torch.from_numpy(book).to(cuda)),
        torch.from_numpy(prev).to(cuda), u.to(cuda))
    assert bkern.process_step_records.launches == before + 1
    assert n > 0 and most > 16
