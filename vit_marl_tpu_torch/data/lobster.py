"""Message data for the world: LOBSTER CSV days, or synthetic days in the
LOBSTER schema.

Port of ``vit_marl_tpu/data/lobster.py``: all days are concatenated into
one ``(N, 8)`` int32 message array plus per-window start/end indices and
initial L2 book rows.  Preprocessing and windowing are copies of the
reference's (ref: lobster_loader.py:444-452, 618-782):

- split float seconds into (time_s, time_ns);
- drop messages outside [day_start, day_end] and types 5/6/7;
- MATCH(4) -> LIMIT(1) with the direction flipped; DELETE(3) -> CANCEL(2);
- trader_id := order_id;
- ``fixed_steps`` windows start every ``start_resolution * n_msg_per_step``
  messages, ``fixed_time`` windows every ``start_resolution`` seconds of
  the day (the messages of ``episode_time`` seconds from there); the last
  episode is zero-padded to a step multiple.

With ``data_path`` set, :class:`LobsterLoader` reads every day pair
``{data_path}/{stock}/{time_period}/*message*.csv`` / ``*orderbook*.csv``
(sorted, parsed in parallel by the native parser of ``data/native.py``,
else by ``np.loadtxt``), skips days left empty by the filtering, and
caches the result in ``cache_dir`` as a compressed npz under the JAX
package's key.
"""

from __future__ import annotations

import functools
import glob
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from vit_marl_tpu_torch.config import WorldConfig


@dataclass
class LoadedData:
    """Host-side arrays produced by loading; become env params."""

    messages: np.ndarray      # (N, 8) int32, engine message layout
    starts: np.ndarray        # (n_windows,) int32 message index of window start
    ends: np.ndarray          # (n_windows,) int32 message index of window end
    init_books: np.ndarray    # (n_windows, 4*levels) int64 L2 row at start
    max_msgs_per_window: np.ndarray  # (n_windows,) int32

    @property
    def n_windows(self) -> int:
        return len(self.starts)


def _preprocess_day(raw_msgs: np.ndarray, raw_book: np.ndarray,
                    day_start: int, day_end: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """LOBSTER preprocessing for one day (see module docstring)."""
    time = raw_msgs[:, 0]
    time_s = time.astype(np.int64)
    time_ns = np.rint((time - time_s) * 1_000_000_000).astype(np.int64)

    keep = (time_s >= day_start) & (time_s <= day_end)
    keep &= np.isin(raw_msgs[:, 1].astype(np.int64), [1, 2, 3, 4])
    raw_msgs = raw_msgs[keep]
    raw_book = raw_book[keep]
    time_s, time_ns = time_s[keep], time_ns[keep]

    mtype = raw_msgs[:, 1].astype(np.int64)
    oid = raw_msgs[:, 2].astype(np.int64)
    qty = raw_msgs[:, 3].astype(np.int64)
    price = raw_msgs[:, 4].astype(np.int64)
    direction = raw_msgs[:, 5].astype(np.int64)

    is_match = mtype == 4
    direction = np.where(is_match, -direction, direction)
    mtype = np.where(is_match, 1, mtype)
    mtype = np.where(mtype == 3, 2, mtype)
    tid = oid.copy()  # trader_id := order_id

    msgs = np.stack([mtype, direction, qty, price, oid, tid, time_s, time_ns],
                    axis=1).astype(np.int32)
    return msgs, raw_book


def _day_windows(msgs: np.ndarray, book: np.ndarray, cfg: WorldConfig,
                 index_offset: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Window start/end indices + init books for one preprocessed day."""
    n = len(msgs)
    if cfg.ep_type == "fixed_steps":
        span = cfg.episode_time * cfg.n_data_msg_per_step
        step = cfg.n_data_msg_per_step * cfg.start_resolution
        last_start = n - span
        starts = np.arange(0, max(last_start, 0) + 1, step)
        ends = starts + span
    elif cfg.ep_type == "fixed_time":
        # a window a start_resolution of the day: its first and last
        # message within episode_time seconds (ref: lobster.py:104-114)
        time_s = msgs[:, 6]
        starts_l: List[int] = []
        ends_l: List[int] = []
        for w0 in range(cfg.day_start, cfg.day_end + 1,
                        cfg.start_resolution):
            in_win = np.nonzero((time_s >= w0)
                                & (time_s < w0 + cfg.episode_time))[0]
            if len(in_win):
                starts_l.append(int(in_win[0]))
                ends_l.append(int(in_win[-1]))
        starts = np.array(starts_l, dtype=np.int64)
        ends = np.array(ends_l, dtype=np.int64)
    else:
        raise ValueError(f"unknown ep_type {cfg.ep_type!r}")
    init_books = book[starts]
    return starts + index_offset, ends + index_offset, init_books


def _pad_last_episode(messages: np.ndarray, max_msgs: np.ndarray,
                      n_per_step: int) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad so the last window is a step multiple
    (ref: lobster_loader.py:444-452)."""
    last = int(max_msgs[-1])
    new_len = (last // n_per_step + 1) * n_per_step
    pad = np.zeros((new_len - last, messages.shape[1]), dtype=np.int32)
    pad[:, 6] = messages[-1, 6] + 1
    messages = np.concatenate([messages, pad])
    max_msgs = max_msgs.copy()
    max_msgs[-1] = new_len
    return messages, max_msgs


def _assemble(days: Sequence[Tuple[np.ndarray, np.ndarray]],
              cfg: WorldConfig) -> LoadedData:
    """Concatenate preprocessed days, with their windows, into one table."""
    all_msgs: List[np.ndarray] = []
    all_starts, all_ends, all_books = [], [], []
    offset = 0
    for msgs, book in days:
        s, e, ib = _day_windows(msgs, book, cfg, offset)
        all_msgs.append(msgs)
        all_starts.append(s)
        all_ends.append(e)
        all_books.append(ib)
        offset += len(msgs)
    messages = np.concatenate(all_msgs)
    starts = np.concatenate(all_starts).astype(np.int32)
    ends = np.concatenate(all_ends).astype(np.int32)
    max_msgs = (ends - starts).astype(np.int32)
    if cfg.n_data_msg_per_step != 0:
        messages, max_msgs = _pad_last_episode(messages, max_msgs,
                                               cfg.n_data_msg_per_step)
    return LoadedData(messages=messages.astype(np.int32), starts=starts,
                      ends=ends, init_books=np.concatenate(all_books),
                      max_msgs_per_window=max_msgs)


class LobsterLoader:
    """Loads all day CSVs under ``{data_path}/{stock}/{time_period}/``
    (ref: vit_marl_tpu/data/lobster.py:135-232)."""

    def __init__(self, cfg: WorldConfig):
        self.cfg = cfg
        base = os.path.join(cfg.data_path, cfg.stock, cfg.time_period)
        self.message_files = sorted(
            glob.glob(os.path.join(base, "*message*.csv")))
        self.book_files = sorted(
            glob.glob(os.path.join(base, "*orderbook*.csv")))

    def _cache_path(self) -> Optional[str]:
        if not self.cfg.cache_dir:
            return None
        c = self.cfg
        key = "_".join(map(str, [
            c.stock, c.time_period, c.book_depth, c.ep_type, c.episode_time,
            c.start_resolution, c.n_data_msg_per_step, c.day_start, c.day_end,
        ]))
        os.makedirs(c.cache_dir, exist_ok=True)
        return os.path.join(c.cache_dir, f"lobster_{key}.npz")

    def _load_one(self, pair) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """One day: the native parser, else (unavailable, an empty result
        or a file it rejects) ``np.loadtxt`` and ``_preprocess_day``; None
        for an unreadable or empty file."""
        mfile, bfile = pair
        try:
            from vit_marl_tpu_torch.data.native import parse_day_native
            parsed = parse_day_native(mfile, bfile, self.cfg.day_start,
                                      self.cfg.day_end)
            if parsed is not None and parsed[0].size:
                return parsed
        except Exception:
            pass
        try:
            raw_msgs = np.loadtxt(mfile, delimiter=",", ndmin=2)
            raw_book = np.loadtxt(bfile, delimiter=",", ndmin=2)
        except (ValueError, OSError):
            return None
        if raw_msgs.size == 0 or raw_book.size == 0:
            return None
        msgs, book = _preprocess_day(raw_msgs, raw_book, self.cfg.day_start,
                                     self.cfg.day_end)
        return msgs, book.astype(np.int64)

    def run_loading(self) -> LoadedData:
        cache = self._cache_path()
        if cache and os.path.exists(cache):
            z = np.load(cache)
            return LoadedData(messages=z["messages"], starts=z["starts"],
                              ends=z["ends"], init_books=z["init_books"],
                              max_msgs_per_window=z["max_msgs"])
        pairs = list(zip(self.message_files, self.book_files))
        if not pairs:
            raise FileNotFoundError(
                f"no LOBSTER csv pairs under {self.cfg.data_path}/"
                f"{self.cfg.stock}/{self.cfg.time_period}")
        with ThreadPoolExecutor(max_workers=min(8, len(pairs))) as ex:
            days = [d for d in ex.map(self._load_one, pairs) if d is not None]
        # a day can be empty after filtering (a halted day, every row
        # outside trading hours): it has no windows
        days = [(m, b) for m, b in days if len(m)]
        if not days:
            raise ValueError(
                f"all {len(pairs)} day file pair(s) under {self.cfg.data_path}"
                f"/{self.cfg.stock}/{self.cfg.time_period} were empty after "
                f"trading-hours/type filtering")
        data = _assemble(days, self.cfg)
        if cache:
            np.savez_compressed(cache, messages=data.messages,
                                starts=data.starts, ends=data.ends,
                                init_books=data.init_books,
                                max_msgs=data.max_msgs_per_window)
        return data


@functools.lru_cache(maxsize=16)
def _synthetic_day(seed: int, n_messages: int, levels: int, day_start: int,
                   day_end: int) -> Tuple[np.ndarray, np.ndarray]:
    """One preprocessed synthetic day, made once a process for its
    arguments (generating one takes seconds of host time); read only."""
    from vit_marl_tpu_torch.data.synthetic import generate_day

    day = generate_day(seed=seed, n_messages=n_messages, levels=levels,
                       day_start=day_start, day_end=day_end)
    return _preprocess_day(day.messages, day.orderbook, day_start, day_end)


def load_data(cfg: WorldConfig) -> LoadedData:
    """The LOBSTER days under ``cfg.data_path``, or, where it is empty,
    ``cfg.n_synthetic_days`` synthetic days generated in memory."""
    if cfg.data_path:
        return LobsterLoader(cfg).run_loading()
    days = [_synthetic_day(cfg.seed + d, cfg.n_messages_per_synthetic_day,
                           cfg.book_depth, cfg.day_start, cfg.day_end)
            for d in range(cfg.n_synthetic_days)]
    return _assemble(days, cfg)
