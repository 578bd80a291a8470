"""Data-replay core: the window reset table and per-step data messages.

Port of ``vit_marl_tpu/env/base.py``.  The initial book of every window is
replayed once, for all windows together, through the book scan; a reset is
then a gather from that table.  :func:`state_from_data` replays one
window through the XLA-scan engine (``lob/engine.py``), as the JAX
function does; on the init messages (limit orders only) the two agree.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vit_marl_tpu_torch.config import MsgCol, WorldConfig
from vit_marl_tpu_torch.data.lobster import LoadedData, load_data
from vit_marl_tpu_torch.env.structs import LoadedState, WorldParams
from vit_marl_tpu_torch.lob import book as bk
from vit_marl_tpu_torch.lob import engine
from vit_marl_tpu_torch.ops.book_kernel import process_step_aggs
from vit_marl_tpu_torch.utils.tree import index_tree

Tensor = torch.Tensor


def _window_start(cfg: WorldConfig, window_index: Tensor,
                  first_msg_time: Tensor) -> Tensor:
    """A window's ``(..., 2)`` start time: its first message's, or in
    ``fixed_time`` episodes the ``start_resolution`` grid of the trading
    day (ref: base.py:37-44)."""
    if cfg.ep_type != "fixed_time":
        return first_msg_time.to(torch.int32)
    start = ((window_index * cfg.start_resolution)
             % (cfg.day_end - cfg.day_start - cfg.episode_time
                + cfg.start_resolution) + cfg.day_start)
    return torch.stack([start, torch.zeros_like(start)], dim=-1).to(
        torch.int32)


def state_from_data(cfg: WorldConfig, first_msg_time, book_row, max_steps,
                    window_index, start_index, device=None
                    ) -> Tuple[LoadedState, Tensor]:
    """One window's reset state (ref: base.py:29-54): the L2 snapshot
    ``book_row`` ``(4 L,)`` replayed into an empty book through
    :func:`vit_marl_tpu_torch.lob.engine.process_messages`, at
    ``first_msg_time`` ``(2,)``.  Returns the state, its leaves without an
    env axis (the book ``(2, 6, S)``), and the replay's ``(n_trades, 8)``
    trade log, which the JAX ``LoadedState`` holds as ``trades``."""
    dev = torch.device(device) if device is not None else (
        book_row.device if isinstance(book_row, Tensor)
        else torch.device("cpu"))
    as_i32 = lambda v: torch.as_tensor(  # noqa: E731
        v, device=dev).to(torch.int32)
    first_msg_time, window_index = as_i32(first_msg_time), as_i32(
        window_index)
    init_msgs = bk.init_msgs_from_l2(cfg, as_i32(book_row)[None],
                                     first_msg_time[None])
    # limit orders only: the random-cancel draws are never consulted
    book, trades = engine.process_messages(
        cfg, init_msgs, bk.init_book(cfg, 1, dev),
        bk.init_trades(cfg, 1, dev),
        uniforms=torch.zeros((init_msgs.shape[1], 1), device=dev))
    state = LoadedState(
        book=book.data[0],
        init_time=_window_start(cfg, window_index, first_msg_time),
        window_index=window_index, max_steps_in_episode=as_i32(max_steps),
        start_index=as_i32(start_index),
        step_counter=torch.zeros_like(as_i32(start_index)))
    return state, trades[0]


def build_init_states(cfg: WorldConfig, data: LoadedData,
                      device: torch.device) -> LoadedState:
    """All windows' reset states (ref: base.py:29-70).

    Replays each window's L2 snapshot into an empty book.  The init
    messages are limit orders only, so the random-cancel draws are never
    consulted; zeros stand in for them.  In ``fixed_time`` episodes a
    window starts on the ``start_resolution`` grid of the trading day
    (ref: base.py:37-44).
    """
    n = data.n_windows
    msgs_np = data.messages[data.starts][:, [MsgCol.TIME_S, MsgCol.TIME_NS]]
    first_times = torch.as_tensor(msgs_np, dtype=torch.int32, device=device)
    books = torch.as_tensor(data.init_books, device=device)
    init_msgs = bk.init_msgs_from_l2(cfg, books, first_times)
    uniforms = torch.zeros((init_msgs.shape[1], n), dtype=torch.float32,
                           device=device)
    book, _, _ = process_step_aggs(
        cfg, init_msgs, bk.init_book(cfg, n, device),
        torch.zeros((0,), dtype=torch.int32, device=device),
        tick=cfg.tick_size, uniforms=uniforms)
    max_steps = torch.as_tensor(
        data.max_msgs_per_window // cfg.n_data_msg_per_step + 1,
        dtype=torch.int32, device=device)
    window_index = torch.arange(n, dtype=torch.int32, device=device)
    return LoadedState(
        book=book.data,
        init_time=_window_start(cfg, window_index, first_times),
        window_index=window_index,
        max_steps_in_episode=max_steps,
        start_index=torch.as_tensor(data.starts, dtype=torch.int32,
                                    device=device),
        step_counter=torch.zeros(n, dtype=torch.int32, device=device))


def make_world_params(cfg: WorldConfig, device: torch.device,
                      data: Optional[LoadedData] = None) -> WorldParams:
    """Load data and build the reset table."""
    if data is None:
        data = load_data(cfg)
    return WorldParams(
        message_data=torch.as_tensor(data.messages, dtype=torch.int32,
                                     device=device),
        init_states=build_init_states(cfg, data, device))


def pick_window(cfg: WorldConfig, n_windows: int, n_envs: int,
                generator: torch.Generator) -> Tensor:
    """Random or fixed window index per env at reset (ref: base.py:83-88);
    the random pick draws from ``generator``."""
    if cfg.window_selector == -1:
        return torch.randint(0, n_windows, (n_envs,), generator=generator,
                             device=generator.device)
    return torch.full((n_envs,), cfg.window_selector,
                      device=generator.device)


def gather_reset_state(params: WorldParams, idx: Tensor) -> LoadedState:
    """Pure gather from the window table (ref: base.py:91-93)."""
    return index_tree(params.init_states, idx.long())


def get_data_messages(cfg: WorldConfig, message_data: Tensor,
                      start_index: Tensor, step_counter: Tensor,
                      end_time_s: Optional[Tensor] = None) -> Tensor:
    """This step's ``(E, n, 8)`` data messages (ref: base.py:96-116); the
    clip reproduces ``dynamic_slice``'s clamp-to-fit.  In ``fixed_time``
    episodes the messages at or after the episode's end (``end_time_s``,
    ``(E,)``) are zeroed but for their two time fields."""
    n = cfg.n_data_msg_per_step
    offset = torch.clamp(start_index.long() + n * step_counter.long(), 0,
                         message_data.shape[0] - n)
    rows = offset[:, None] + torch.arange(n, device=offset.device)
    msgs = message_data[rows]
    if cfg.ep_type == "fixed_time":
        past_end = msgs[:, :, MsgCol.TIME_S] >= end_time_s[:, None]
        msgs[:, :, :6] = torch.where(past_end[..., None], 0, msgs[:, :, :6])
    return msgs
