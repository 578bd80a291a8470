#!/usr/bin/env python3
"""Compare checkouts of the PyTorch port on one GPU, in turns.

    python3 tools/torch_ab_vision.py PARENT_TREE . . PARENT_TREE

Each argument is the root of a checkout (a ``git archive`` of another
commit unpacked in a directory that ``.gitignore`` lists, or ``.``).  For
each, in the order given and in a process of its own, the script builds
that checkout's kernels, times its attention kernels through its own
wrapper at ViT-Small's shapes (bf16, N=11, W=384, H=6: the forward at
B=32,768 and 1,024, the backward at 32,768; CUDA events around batches
of back-to-back calls, and replays of a CUDA graph of the same calls for
the device time alone; the timers of this checkout's ``chip_smoke.py``
for every tree), then trains ``configs/ippo_vision_dual_ppo.yaml``
for 2 updates in the default mode and in ``VIT_ATTN_LN_FOLD`` through
that checkout's ``chip_smoke.vision_phase``, which checks losses and
launch counts and prints env-steps/s and the rollout/PPO split.  Running
parent, change, change, parent in one call puts both on the same card
and host, which calls to the chip do not.
"""

from __future__ import annotations

import importlib.util
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, W, H = 11, 384, 6


def timing():
    """This checkout's chip_smoke.py, for its timers (``time_launches``,
    ``graph_ms``), which every tree is timed with alike."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timers", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def one(tree: str) -> None:
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    sys.path.insert(1, os.path.join(root, "tests"))
    import torch

    import chip_smoke
    from vit_marl_tpu_torch.config import load_yaml_config
    from vit_marl_tpu_torch.ops import attention_kernel as attn
    from vit_marl_tpu_torch.ops import block_kernel as blk
    from vit_marl_tpu_torch.ops import book_kernel as bkern
    from vit_marl_tpu_torch.rl.ppo import make_train

    if not torch.cuda.is_available():
        raise SystemExit("torch_ab_vision: no CUDA device available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for m in (bkern, attn, blk):
        m.build_library()
        m._library()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    B = 32_768
    x = torch.randn((B * N, 3 * W), generator=gen,
                    device="cuda").to(torch.bfloat16)
    g = torch.randn((B * N, W), generator=gen,
                    device="cuda").to(torch.bfloat16)
    x_roll = x[:1024 * N]
    timers = timing()
    for label, fn in [
            ("forward B=32768", lambda: attn.short_attention(x, N, H)),
            ("forward B=1024", lambda: attn.short_attention(x_roll, N, H)),
            ("backward B=32768", lambda: attn._launch_bwd(x, g, N, H))]:
        print(f"[{tree}] {label}: {timers.time_launches(fn)[0]:.4f} ms "
              f"through the wrapper, device {timers.graph_ms(fn):.4f} ms "
              f"[{smi}]", flush=True)
    del x, g, x_roll
    for mode in (None, "attn_ln_fold"):
        chip_smoke.vision_phase(torch, attn, bkern, blk, make_train,
                                load_yaml_config, torch.device("cuda"), smi,
                                mode)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        one(sys.argv[2])
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in sys.argv[1:]:
        print(f"== {tree}", flush=True)
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one", tree]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
