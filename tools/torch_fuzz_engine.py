"""Differential fuzzer of the port's order-book engines.

The port's counterpart of ``tools/fuzz_engine.py``: random books, random
message streams and random engine configs, trial after trial until a
wall-clock budget (or a trial count) is spent.  Each trial draws one
config and ``ENVS`` books and streams of it, and requires, bit for bit:

- ``lob/engine.py`` (the XLA-scan engine) against the sequential
  ``lob/oracle.py``, books and trade logs, in the deterministic cancel
  modes 0-1 (the oracle models no random cancel);
- in every mode, the engine against the book scan in records mode with
  every fill recorded (``rec_k = S``) and the log built from its records
  (``tests/torch_cases.py::engine_against_records``): books, forward-filled
  best quotes and logs.  The streams keep out the order-id corners on which
  the two semantics differ (no message carries order id -1, and a book's
  holes hold no stale ids), as ``make_corner_case(..., fresh_ids=True)``
  does;
- with ``--kernel`` (a CUDA device): kernels 1 and 2 against their plain
  versions on the same tensors, books, best quotes and per-trader sums /
  records and fill counts, for one to three traders of the stream.

Configs: ``n_orders`` from ``SHAPES`` (2 to 200, the upstream's 100
included), cancel modes 0-3, trade logs short enough to overflow.  Each
failure prints one line with its repro command, and the run exits 1.

Usage:
  python tools/torch_fuzz_engine.py --minutes 10 [--kernel] [--seed0 0]
      [--max-failures 5] [--device cuda|cpu] [--trials N]

The engine and the plain versions run on ``--device`` (the card by
default); ``--kernel`` needs a card.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402

# (n_orders, n_trades, n_msgs): tiny books that overflow, odd capacities
# that take the kernel's masked route, and the exact ones
SHAPES = [
    (2, 3, 48),
    (6, 5, 80),
    (24, 24, 120),
    (100, 64, 112),     # the upstream's 100 orders a side
    (128, 32, 112),
    (200, 96, 96),
]
ENVS = {"cpu": 4, "cuda": 32}
TICK = 100


def _stream(rng, cfg, asks, bids, n_msgs, qhi, n_levels):
    """One env's random stream (the mix weights drawn per env: cancel
    storms, cross-heavy and passive-only streams all appear)."""
    from vit_marl_tpu_torch.utils.fixtures import (
        random_aggressive_message,
        random_cancel_for_book,
        random_message,
    )

    w = np.cumsum(rng.dirichlet(np.ones(5) * 0.7))
    msgs, t, oid = [], 34_201, -300
    for _ in range(n_msgs):
        roll = rng.random()
        if roll < w[0]:
            m = random_message(rng, time_s=t, oid=oid, tid=oid, kind="limit",
                               n_levels=n_levels, quant_range=(1, qhi))
        elif roll < w[1]:
            m = random_aggressive_message(rng, asks, bids, time_s=t, oid=oid,
                                          quant_range=(1, max(2 * qhi, 2)))
        elif roll < w[2]:
            side = asks if rng.random() < 0.5 else bids
            m = random_cancel_for_book(rng, side, -1 if side is asks else 1,
                                       time_s=t,
                                       partial=bool(rng.random() < 0.7))
        elif roll < w[3]:
            m = random_message(rng, time_s=t, oid=oid, tid=oid, kind="match",
                               n_levels=n_levels, quant_range=(1, qhi))
        else:
            m = random_message(rng, time_s=t, oid=oid, tid=oid, kind="noop")
        msgs.append(m)
        t += int(rng.integers(0, 3))
        oid -= 1
    return np.stack(msgs)


def make_trial(seed: int, n_envs: int):
    """A trial's config and its ``n_envs`` books ``(E, 2, 6, S)``, sorted,
    streams ``(E, M, 8)`` and uniforms ``(M, E)``, as numpy."""
    import torch

    from vit_marl_tpu_torch.config import EngineConfig
    from vit_marl_tpu_torch.lob import book as bk
    from vit_marl_tpu_torch.utils.fixtures import random_book

    rng = np.random.default_rng(seed)
    n_orders, n_trades, n_msgs = SHAPES[int(rng.integers(len(SHAPES)))]
    cfg = EngineConfig(n_orders=n_orders, n_trades=n_trades,
                       cancel_mode=int(rng.integers(4)))
    books, streams = [], []
    for _ in range(n_envs):
        n_levels = int(rng.integers(3, 30))
        qhi = int(rng.choice([50, 300, 800, 3000]))
        asks, bids, _ = random_book(cfg, rng, n_levels=n_levels,
                                    percent_fill=float(rng.uniform(0.1, 0.9)),
                                    quant_range=(1, qhi))
        books.append(np.stack([asks.T, bids.T]))
        streams.append(_stream(rng, cfg, asks, bids, n_msgs, qhi, n_levels))
    msgs = np.stack(streams).astype(np.int32)
    # the corners of fresh_ids: no order id -1 on the books or the streams
    if (msgs[..., 4] == -1).any():
        raise AssertionError("a stream carries order id -1")
    uniforms = rng.random((n_msgs, n_envs), dtype=np.float32)
    # the engines' precondition: each side in the sorted-arena layout
    book = bk.canonicalize_book(bk.BookState(torch.from_numpy(
        np.stack(books).astype(np.int32)))).data.numpy()
    return cfg, book, msgs, uniforms


def _against_oracle(cfg, book, msgs, trades):
    """The engine's sorted sides and its log against the oracle's, env by
    env; raises ``AssertionError`` on the first difference."""
    from vit_marl_tpu_torch.lob import book as bk
    from vit_marl_tpu_torch.lob.oracle import OracleBook

    for e in range(msgs.shape[0]):
        oracle = OracleBook(cfg)
        oracle.load_dense(book[e, 0].T, book[e, 1].T,
                          np.full((cfg.n_trades, 8), -1, np.int64))
        oracle.process_all(list(msgs[e]))
        for i, name in ((0, "asks"), (1, "bids")):
            side = bk.side_from_dense(trades["book"][e:e + 1, i].transpose(
                1, 2).cpu())
            got = bk.side_to_dense(bk.sort_side(side, is_bid=i == 1))[0]
            want = oracle.dense(getattr(oracle, name))
            if not np.array_equal(got.numpy().astype(np.int64), want):
                raise AssertionError(f"env {e}: {name} differ from the "
                                     "oracle's")
        if not np.array_equal(trades["log"][e].cpu().numpy().astype(
                np.int64), oracle.trades):
            raise AssertionError(f"env {e}: trade log differs from the "
                                 "oracle's")


def _kernels_against_plain(torch, cfg, msgs, book, prev, u, rng):
    """Kernels 1 and 2 against their plain versions on the card's
    tensors."""
    from vit_marl_tpu_torch.ops import book_kernel as bkern

    tids = np.unique(msgs[..., 5].cpu().numpy())
    tids = tids[tids != 0]
    n_agg = int(rng.integers(1, 4))
    pick = torch.as_tensor(rng.choice(tids, n_agg, replace=False),
                           dtype=torch.int32, device=msgs.device)
    got = bkern.process_step_aggs(cfg, msgs, book, pick, prev, TICK, u)
    want = bkern.process_step_aggs_reference(cfg, msgs, book, pick, prev,
                                             TICK, u)
    rec_k = int(rng.integers(1, cfg.n_orders + 1))
    got2 = bkern.process_step_records(cfg, msgs, book, prev, rec_k, u)
    want2 = bkern.process_step_records_reference(cfg, msgs, book, prev,
                                                 rec_k, u)
    for label, g, w in (("kernel 1", got, want), ("kernel 2", got2, want2)):
        pairs = {"book": (g[0].data, w[0].data),
                 "best asks": (g[1][0], w[1][0]),
                 "best bids": (g[1][1], w[1][1]),
                 "sums" if label == "kernel 1" else "records": (g[2][0],
                                                                 w[2][0]),
                 "totals" if label == "kernel 1" else "fill counts": (
                     g[2][1], w[2][1])}
        for what, (a, b) in pairs.items():
            if not torch.equal(a, b):
                raise AssertionError(f"{label} differs from its plain "
                                     f"version: {what} (n_agg={n_agg}, "
                                     f"rec_k={rec_k})")


def one_trial(seed: int, use_kernel: bool, device: str) -> str | None:
    """None on success, else a one-line description with its repro."""
    import torch

    from torch_cases import engine_against_records
    from vit_marl_tpu_torch.lob import engine
    from vit_marl_tpu_torch.lob.book import BookState

    dev = torch.device(device)
    E = ENVS[dev.type]
    cfg, book_np, msgs_np, u_np = make_trial(seed, E)
    S, M = cfg.n_orders, msgs_np.shape[1]
    repro = (f"python tools/torch_fuzz_engine.py --seed0 {seed} --trials 1 "
             f"--device {device}" + (" --kernel" if use_kernel else ""))
    what = (f"seed={seed} cfg=(n_orders={S}, n_trades={cfg.n_trades}, "
            f"cancel={cfg.cancel_mode}) envs={E} msgs={M}")
    book = BookState(torch.from_numpy(book_np).to(dev))
    msgs = torch.from_numpy(msgs_np).to(dev)
    u = torch.from_numpy(u_np).to(dev)
    prev = torch.full((E, 2), 12_345, dtype=torch.int32, device=dev)
    try:
        if cfg.cancel_mode <= 1:
            empty = torch.full((E, cfg.n_trades, 8), -1, dtype=torch.int32,
                               device=dev)
            out, log = engine.process_messages(cfg, msgs, book, empty, u)
            _against_oracle(cfg, book_np, msgs_np,
                            {"book": out.data, "log": log})
    except AssertionError as e:
        return f"ENGINE vs ORACLE mismatch: {what}: {e} | repro: {repro}"
    try:
        engine_against_records(cfg, msgs, book, prev, u, n_trades=M * S + 1)
    except AssertionError as e:
        return f"ENGINE vs RECORDS SCAN mismatch: {what}: {e} | repro: {repro}"
    if use_kernel:
        try:
            _kernels_against_plain(torch, cfg, msgs, book, prev, u,
                                   np.random.default_rng(seed + 1))
        except AssertionError as e:
            return f"KERNEL vs PLAIN mismatch: {what}: {e} | repro: {repro}"
    return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--minutes", type=float, default=10.0)
    p.add_argument("--seed0", type=int, default=0)
    p.add_argument("--kernel", action="store_true",
                   help="also hold the CUDA kernels 1 and 2 against their "
                        "plain versions (needs a card)")
    p.add_argument("--max-failures", type=int, default=5)
    p.add_argument("--device", default="cuda",
                   help="where the engines run: cuda (default) or cpu")
    p.add_argument("--trials", type=int, default=None,
                   help="stop after this many trials (else at --minutes)")
    args = p.parse_args(argv)

    import torch

    from vit_marl_tpu_torch.utils.device import resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"torch_fuzz_engine: {e}", file=sys.stderr)
        return 2
    if args.kernel and dev.type != "cuda":
        print("torch_fuzz_engine: --kernel needs a CUDA device",
              file=sys.stderr)
        return 2
    t0 = time.time()
    deadline = t0 + args.minutes * 60
    trials, failures, seed = 0, [], args.seed0
    t_last = t0
    while len(failures) < args.max_failures and (
            trials < args.trials if args.trials is not None
            else time.time() < deadline):
        msg = one_trial(seed, args.kernel, str(dev))
        trials += 1
        if msg:
            failures.append(msg)
            print(f"FAIL {msg}", flush=True)
        if time.time() - t_last > 60:
            print(f"... {trials} trials, {len(failures)} failures",
                  flush=True)
            t_last = time.time()
        seed += 1
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(f"fuzz done: {trials} trials ({args.seed0}..{seed - 1}) on {dev} "
          f"in {time.time() - t0:.1f}s, {len(failures)} failures"
          + (" [kernels checked]" if args.kernel else ""), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
