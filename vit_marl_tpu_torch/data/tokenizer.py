"""Token-stream observation encoding, batched over envs.

Port of ``vit_marl_tpu/data/tokenizer.py`` with its vocabulary and layout:

- each int32 field splits into two 16-bit halves, each offset into its own
  token band (order id, price, size, time);
- one combined event/direction token a message;
- the L2 book snapshot (with its timestamp) as 16-bit halves with per-column
  band offsets;
- observation = [book tokens, message tokens]: 84 book tokens (42 fields x
  2 halves) and 13 tokens a message.

Tokens are below ``TOTAL_NUM_TOKENS`` (2^18 + 16), so the port returns them
as int32; the JAX package returns uint32 of the same values.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from vit_marl_tpu_torch.utils.device import const

Tensor = torch.Tensor

_BAND = 1 << 16  # each band holds one 16-bit half-word


@dataclass(frozen=True)
class TokenizerConfig:
    EVENT_START: int = 0
    ORDER_ID_B_START: int = 16
    PRICE_B_START: int = ORDER_ID_B_START + _BAND
    SIZE_B_START: int = PRICE_B_START + _BAND
    TIME_B_START: int = SIZE_B_START + _BAND

    @property
    def TOTAL_NUM_TOKENS(self) -> int:
        return self.TIME_B_START + _BAND


DEFAULT_TOKENIZER = TokenizerConfig()


def split_and_offset(x: Tensor, offset: int) -> Tensor:
    """int32 -> two 16-bit tokens with a band offset, ``(..., 2)``
    (ref: mm_env.py:2505-2509)."""
    x = x.to(torch.int32)
    low = (x & 0xFFFF) + offset
    high = ((x >> 16) & 0xFFFF) + offset
    return torch.stack([low, high], dim=-1)


def tokenize_messages(cfg: TokenizerConfig, total_msgs: Tensor,
                      best_bids: Tensor, best_asks: Tensor,
                      old_mid_price: Tensor) -> Tensor:
    """``(E, M, 8)`` messages -> ``(E, M * 13)`` tokens
    (ref: mm_env.py:2429-2533); ``best_*`` ``(E, M, 2)``, the mid price
    before the step ``(E,)``."""
    event = total_msgs[..., 0]
    direction = total_msgs[..., 1]
    order_id = total_msgs[..., 4]
    price = torch.div(total_msgs[..., 3], 100, rounding_mode="floor")
    size = total_msgs[..., 2]
    time_s = total_msgs[..., 6]
    time_ns = total_msgs[..., 7]

    ds = time_s[:, 1:] - time_s[:, :-1]
    dns = time_ns[:, 1:] - time_ns[:, :-1]
    ds = ds - (dns < 0).to(torch.int32)
    dns = torch.where(dns < 0, dns + 1_000_000_000, dns)
    zero = torch.zeros_like(time_s[:, :1])
    delta_time_s = torch.cat([zero, ds], dim=1)
    delta_time_ns = torch.cat([zero, dns], dim=1)

    bb = torch.div(best_bids[..., 0], 100, rounding_mode="floor")
    ba = torch.div(best_asks[..., 0], 100, rounding_mode="floor")
    old_mid = torch.div(old_mid_price, 100, rounding_mode="floor")
    mid = torch.div(bb + ba, 2, rounding_mode="floor")
    first = (2 * (mid[:, 0] - old_mid)).to(torch.int32)[:, None]
    rest = (ba[:, 1:] - ba[:, :-1]) + (bb[:, 1:] - bb[:, :-1])
    delta_price = torch.cat([first, rest.to(torch.int32)], dim=1)

    # uint8 arithmetic, as the reference: direction -1 wraps to 255
    event_dir = ((direction & 0xFF) * 4 + (event & 0xFF)) & 0xFF
    tokens = torch.cat([
        (event_dir + cfg.EVENT_START)[..., None],
        split_and_offset(order_id, cfg.ORDER_ID_B_START),
        split_and_offset(price, cfg.PRICE_B_START),
        split_and_offset(size, cfg.SIZE_B_START),
        split_and_offset(delta_time_s, cfg.TIME_B_START),
        split_and_offset(delta_time_ns, cfg.TIME_B_START),
        split_and_offset(delta_price, cfg.PRICE_B_START),
    ], dim=-1)
    return tokens.reshape(tokens.shape[0], -1)


def tokenize_book(cfg: TokenizerConfig, l2_state: Tensor, time: Tensor,
                  n_levels: int = 10) -> Tensor:
    """L2 snapshot ``(E, 4 n_levels)`` + timestamp ``(E, 2)`` -> ``(E,
    84)`` tokens (ref: mm_env.py:2536-2555): each int32 as its low then
    high 16 bits, as a little-endian bitcast to uint16 gives them."""
    with_time = torch.cat([time.to(torch.int32), l2_state.to(torch.int32)],
                          dim=1)
    halves = torch.stack([with_time & 0xFFFF, (with_time >> 16) & 0xFFFF],
                         dim=-1).reshape(with_time.shape[0], -1)
    shift = const(
        [cfg.TIME_B_START] * 4
        + [cfg.PRICE_B_START, cfg.PRICE_B_START,
           cfg.SIZE_B_START, cfg.SIZE_B_START] * 2 * n_levels,
        torch.int32, halves.device)
    return halves + shift


def tokenize_observation(cfg: TokenizerConfig, total_msgs: Tensor,
                         best_bids: Tensor, best_asks: Tensor,
                         old_mid_price: Tensor, l2_before: Tensor,
                         time: Tensor) -> Tensor:
    """[book tokens, message tokens], ``(E, 84 + 13 M)``
    (ref: mm_env.py:2557-2564)."""
    book = tokenize_book(cfg, l2_before, time)
    msgs = tokenize_messages(cfg, total_msgs, best_bids, best_asks,
                             old_mid_price)
    return torch.cat([book, msgs], dim=1)
