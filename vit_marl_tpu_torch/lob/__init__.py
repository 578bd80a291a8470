"""The limit-order book: state and queries, the engine, its oracle and
facade (port of ``vit_marl_tpu/lob``).

- :mod:`vit_marl_tpu_torch.lob.book`      -- batched book state + queries
- :mod:`vit_marl_tpu_torch.lob.engine`    -- message processing / matching
- :mod:`vit_marl_tpu_torch.lob.oracle`    -- slow sequential reference
- :mod:`vit_marl_tpu_torch.lob.orderbook` -- OO facade
"""

from vit_marl_tpu_torch.lob.book import (  # noqa: F401
    BookState,
    SideState,
    init_book,
    init_side,
    init_trades,
    side_to_dense,
    side_from_dense,
    sort_side,
    canonicalize_book,
    best_ask,
    best_bid,
    best_bid_and_ask,
    best_bid_and_ask_incl_quants,
    volume_at_price,
    init_volume_at_price,
    get_l2_state,
    get_vision_l2_state,
    get_order_by_id,
    get_order_by_id_and_price,
    get_order_by_time,
    get_order_ids,
    get_next_executable_order,
    get_agent_trades,
    init_msgs_from_l2,
    make_cancel_msgs,
)
from vit_marl_tpu_torch.lob.engine import (  # noqa: F401
    process_message,
    process_messages,
    process_messages_save_bidask,
    process_messages_save_states,
)
from vit_marl_tpu_torch.lob.orderbook import OrderBook  # noqa: F401
