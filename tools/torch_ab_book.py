#!/usr/bin/env python3
"""Compare checkouts' book scan (kernels 1 and 2) on one GPU, in turns.

    python3 tools/torch_ab_book.py PARENT_TREE . . PARENT_TREE
    python3 tools/torch_ab_book.py --kernels-only .
    python3 tools/torch_ab_book.py --ablate
    python3 tools/torch_ab_book.py --variants
    python3 tools/torch_ab_book.py --masks

Each argument is the root of a checkout (a ``git archive`` of another
commit unpacked in a directory that ``.gitignore`` lists, or ``.``).  For
each, in the order given and in a process of its own, the script

1. compiles that checkout's ``ops/csrc/book_scan.cu`` once more with
   ``-Xptxas -v`` into a temporary directory and prints, per kernel, the
   registers, spills and static shared memory ptxas reports, the resident
   warps per SM and the waves at E=4096, 1024 and 512 that follow (4 warps
   a block; the shared memory each block asks for at n_agg=2 is given by
   the checkout's own launch plan where it has one), and what
   ``cuobjdump -sass`` shows of the message loop: its instructions, global
   and shared loads and stores, warp collectives, and the fewest and most
   instructions on one pass through it (its control-flow graph, inner
   loops taken once), and the issue bound at the fewest (8 warps an env
   on the block route);
2. builds the checkout's library as its wrapper does and times, through
   that wrapper, kernel 1 at E=4096, 2048, 1024 and 512 (M=112, S=128, two
   traders, cancel mode 1, the 2-player path's; also on the card alone, as
   replays of a CUDA graph, and the host's issue time a call, which bounds
   the wrapper's time at small E), kernel 1 at E=4096 with a
   cold L2 (launches rotate over three input sets, 120 MB of inputs),
   kernel 1 at E=4096 on that stream cut to one kind of message (padding
   in place of the others: cancels, limit orders that cross the book's
   middle, limit orders that rest, or padding alone; replays of a CUDA
   graph of launches, so the host's issue time stays out), and kernel 2 at
   E=4096, rec_k 16 and 128 (streams with sweeps); the timers
   are this checkout's ``chip_smoke.py`` (``time_launches``: CUDA events
   around batches of back-to-back launches; ``graph_ms``) and the inputs
   this checkout's ``tests/torch_cases.py``, for every tree alike;
3. unless ``--kernels-only``, trains ``configs/ippo_2player.yaml`` for 2
   updates and prints env-steps/s, the rollout/PPO split and the book
   scan's launches.

Running parent, change, change, parent in one call puts both on the same
card and host, which calls to the chip do not.

``--ablate`` times this checkout's kernel 1 at E=4096 on the card alone
against copies of ``book_scan.cu`` built with one part cut out (an
insert's shift of the orders behind it, the whole insert, the per-trader
sums): what each part costs; the copies compute wrong results and exist
only to be timed.  It also times the kernel on streams of padding alone
(M=1 and M=112): its fixed cost and each message's own.

``--variants`` builds copies of this checkout's ``book_scan.cu`` with one
design choice made otherwise (one shift for both directions of an
insert; which rec_k take the records kernel for wide rows, and how many
blocks an SM that kernel keeps), checks each bit-equal to the plain
version (kernel 1 on a corner stream, kernel 2 at rec_k=128 on a corner
stream with sweeps, both at E=4096) and times each, the whole kernel
first and last: kernel 1 at E=4096 and kernel 2 at rec_k 16 to 128,
through the wrapper and on the card alone, with each copy's launch
plans.

``--masks`` asks what the masked slot map costs (any capacity but 32,
64, 128 and 256 runs it).  It launches kernel 1 and kernel 2 (rec_k 16)
through ``torch_cases.launch_slot_map`` at E=4096, M=112, cancel mode 1
on ``chip_smoke.py`` phase 22's inputs (books and streams that hold the
two traders' orders, and the same without them): S=128 on the exact
map, S=128's data on the masked map of 4 slots a lane, and S=100, timed
in two turns over back-to-back launches and on the card alone, with each
map's
registers and spill bytes.  It does so for this checkout's
``book_scan.cu`` and for copies with one thing about the masks made
otherwise: the masked book (the register planes and the shared ones)
moved with 16-byte accesses where the capacity is a multiple of 4 (the
exact maps' book traffic), or the capacity a constant of the build (100
or 128, so the compiler folds the masks; each copy runs at its own
capacity).  Each copy's outputs must equal the plain version's on the
timed inputs.
"""

from __future__ import annotations

import functools
import importlib.util
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E_SHAPES = (4096, 2048, 1024, 512)
M, S = 112, 128
TIDS = (-100, -101)
TICK = 100
REC_KS = (16, 32, 48, 64, 96, 128)   # --variants: rows of kernel 2
SMS, SCHEDULERS = 132, 4
BLOCK_WARPS = 8         # warps an env on book_scan.cu's block route
WARPS = 4                       # warps a block, in every tree so far
COLLECTIVES = ("SHFL", "REDUX", "VOTE", "MATCH")


def this_checkouts(name: str, path: str):
    """A module of this checkout by path, so every tree gets the same
    timers (``chip_smoke.py``) and the same inputs (``tests/
    torch_cases.py``)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def timing():
    return this_checkouts("chip_smoke_timers", "chip_smoke.py")


def cuda_tool(name: str) -> str:
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", name)
    return path if os.path.exists(path) else name


def ptxas_report(text: str):
    """{mangled kernel: dict(regs, spill_st, spill_ld, stack, smem)} from
    the output of ``-Xptxas -v``."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, dict(regs=0, spill_st=0, spill_ld=0,
                                      stack=0, smem=0))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out[name].update(stack=int(m.group(1)), spill_st=int(m.group(2)),
                             spill_ld=int(m.group(3)))
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out.setdefault(name, dict(regs=0, spill_st=0, spill_ld=0,
                                      stack=0, smem=0))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["regs"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            if s:
                out[name]["smem"] = int(s.group(1))
    return {k: v for k, v in out.items() if "book_scan_kernel" in k}


def warps_per_sm(regs: int, smem_block: int) -> int:
    """Resident warps per SM of a 4-warp block: 65,536 registers (allocated
    per warp in units of 256), 228 KB of shared memory (1 KB reserved per
    block), 2,048 threads, 32 blocks."""
    per_warp = -(-regs * 32 // 256) * 256
    by_regs = 65536 // (per_warp * WARPS) if per_warp else 32
    by_smem = (233472 // (smem_block + 1024)) if smem_block else 32
    return min(by_regs, by_smem, 2048 // (32 * WARPS), 32) * WARPS


def sass_functions(text: str):
    """{mangled name: [(pc, opcode, text)]} from ``cuobjdump -sass``."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            body = m.group(2)
            op = re.sub(r"^@!?U?P[T0-9]+\s+", "", body).split()[0]
            cur.append((int(m.group(1), 16), op, body))
    return funcs


def branch_target(body: str):
    m = re.search(r"\b(?:BRA|BRX)\b.*?(0x[0-9a-f]+)", body)
    return int(m.group(1), 16) if m else None


def is_branch(op: str) -> bool:
    """A branch the warp takes when converged (``BRA.DIV`` leads to the
    compiler's slow path for a diverged warp and is left out)."""
    return op.split(".")[0] in ("BRA", "BRX") and ".DIV" not in op


def loop_stats(instrs):
    """Counts over the message loop (the narrowest backward branch of the
    function's main body that spans at least half of the widest; the body
    ends at its last unconditional EXIT, and the compiler's out-of-line
    slow paths follow it), and the fewest / most
    instructions on one pass from the loop's head to its back branch over
    the forward edges of its control-flow graph."""
    ends = [pc for pc, op, b in instrs if op == "EXIT" and not
            b.startswith("@")]
    if not ends:
        return None
    main_end = max(ends)
    back = [(t, pc) for pc, op, body in instrs
            if pc <= main_end and is_branch(op)
            and (t := branch_target(body)) is not None and t <= pc]
    if not back:
        return None
    # the innermost loop that spans most of the widest: the message loop
    # (inside a loop over staged chunks, where the tree has one)
    widest = max(t - h for h, t in back)
    head, tail = min((b for b in back if b[1] - b[0] >= widest // 2),
                     key=lambda b: b[1] - b[0])
    body = [(pc, op, b) for pc, op, b in instrs if head <= pc <= tail]
    counts = {"instructions": len(body)}
    for key, ops in [("LDG", ("LDG",)), ("STG", ("STG",)),
                     ("LDS", ("LDS",)), ("STS", ("STS",)),
                     ("LDL/STL", ("LDL", "STL")),
                     ("LDGSTS", ("LDGSTS",))] + [(c, (c,))
                                                 for c in COLLECTIVES]:
        counts[key] = sum(op.startswith(ops) for _, op, _ in body)
    # blocks: leaders are the head, branch targets and fall-throughs
    leaders = {head}
    for i, (pc, op, b) in enumerate(body):
        t = branch_target(b) if is_branch(op) else None
        if t is not None and head <= t <= tail:
            leaders.add(t)
        if (is_branch(op) or op in ("EXIT", "RET")) and i + 1 < len(body):
            leaders.add(body[i + 1][0])
    index = {pc: i for i, (pc, _, _) in enumerate(body)}
    starts = sorted(x for x in leaders if x in index)
    blocks = []
    for k, s in enumerate(starts):
        e = starts[k + 1] if k + 1 < len(starts) else tail + 1
        blocks.append([x for x in body[index[s]:] if x[0] < e])
    block_of = {b[0][0]: k for k, b in enumerate(blocks)}
    inf = float("inf")
    lo = [inf] * len(blocks)
    hi = [-inf] * len(blocks)
    lo[0] = hi[0] = 0
    for k, blk in enumerate(blocks):
        if lo[k] == inf or blk[-1][0] == tail:
            continue
        n = len(blk)
        pc, op, b = blk[-1]
        falls = k + 1 < len(blocks) and (not (is_branch(op) or op in (
            "EXIT", "RET")) or b.startswith("@"))
        succ = [k + 1] if falls else []
        t = branch_target(b) if is_branch(op) else None
        if t is not None and t > pc and t in block_of:
            succ.append(block_of[t])
        for j in succ:
            lo[j] = min(lo[j], lo[k] + n)
            hi[j] = max(hi[j], hi[k] + n)
    last = len(blocks) - 1
    counts["path_min"] = lo[last] + len(blocks[last])
    counts["path_max"] = hi[last] + len(blocks[last])
    return counts


def demangle(names):
    try:
        out = subprocess.run([cuda_tool("cu++filt")], input="\n".join(names),
                             capture_output=True, text=True, check=True)
        return dict(zip(names, out.stdout.splitlines()))
    except (OSError, subprocess.CalledProcessError):
        return {n: n for n in names}


def sm_clock_mhz() -> int:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True)
    return int(out.stdout.split()[0])


def facts(root: str, smem_of) -> None:
    """Step 1: ptxas's report and the SASS of the message loop."""
    src = os.path.join(root, "vit_marl_tpu_torch", "ops", "csrc",
                       "book_scan.cu")
    tmp = tempfile.mkdtemp(prefix="book_facts_")
    try:
        lib = os.path.join(tmp, "libbook_scan_facts.so")
        cmd = [cuda_tool("nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", lib, src]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=True)
        rep = ptxas_report(proc.stdout + proc.stderr)
        sass = subprocess.run([cuda_tool("cuobjdump"), "-sass", lib],
                              capture_output=True, text=True, check=True)
        funcs = sass_functions(sass.stdout)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    names = demangle(sorted(rep))
    clock = sm_clock_mhz()
    for name in sorted(rep, key=lambda n: names[n]):
        r = rep[name]
        line = (f"  {names[name]}: {r['regs']} registers, spill stores "
                f"{r['spill_st']} B, spill loads {r['spill_ld']} B, stack "
                f"{r['stack']} B, static shared {r['smem']} B")
        dyn = smem_of(name)
        if dyn is not None:
            w = warps_per_sm(r["regs"], dyn + r["smem"])
            waves = {E: -(-E // (w * SMS)) for E in (4096, 1024, 512)}
            line += (f", dynamic shared {dyn} B a block -> {w} warps per SM,"
                     f" waves {waves}")
        st = loop_stats(funcs.get(name, []))
        if st:
            # the block route runs an env on BLOCK_WARPS warps, each
            # taking every message
            warps = BLOCK_WARPS if "book_scan_kernel_block" in name else 1
            issue = {E: st["path_min"] * M * E * warps / (SMS * SCHEDULERS)
                     / (clock * 1e3) for E in (4096, 1024)}
            line += (f"; message loop {st['instructions']} SASS ("
                     + ", ".join(f"{k} {v}" for k, v in st.items()
                                 if k not in ("instructions", "path_min",
                                              "path_max"))
                     + f"), one pass {st['path_min']}-{st['path_max']} "
                     f"instructions; issue bound at the fewest, {clock} MHz: "
                     + ", ".join(f"E={E} {t:.4f} ms"
                                 for E, t in issue.items()))
        print(line, flush=True)


def one(root: str, kernels_only: bool) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    sys.path.insert(1, os.path.join(root, "tests"))
    import numpy as np
    import torch

    from vit_marl_tpu_torch.config import EngineConfig, load_yaml_config
    from vit_marl_tpu_torch.lob.book import BookState
    from vit_marl_tpu_torch.ops import book_kernel as bkern
    from vit_marl_tpu_torch.rl.ppo import make_train

    if not torch.cuda.is_available():
        raise SystemExit("torch_ab_book: no CUDA device available")
    cases = this_checkouts("torch_cases_ab", "tests/torch_cases.py")
    add_sweeps, dispatch_index, make_case = (
        cases.add_sweeps, cases.dispatch_index, cases.make_case)
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    plan = getattr(bkern, "launch_plan", None)

    def smem_of(mangled: str):
        """Dynamic shared memory a 4-warp block of an earlier tree asks for
        at n_agg=2 (none in records mode); None where the tree reports its
        own launch plan."""
        if plan is not None:
            return None
        return 0 if re.search(r"ILi\d+ELb1E", mangled) else \
            WARPS * (8 * 2 + 2) * 32 * 4

    facts(root, smem_of)
    if plan is not None:
        for n_agg in (None, 1, 2, 3):
            p = plan(S, n_agg, dev)
            print(f"  launch plan S={S}, "
                  + ("records" if n_agg is None else f"n_agg={n_agg}")
                  + ": " + ", ".join(f"{k} {v}" for k, v in p.items())
                  + ", waves " + str({E: -(-E // (p["warps_per_sm"] * SMS))
                                      for E in (4096, 1024, 512)}),
                  flush=True)
    bkern.build_library()
    bkern._library()
    timers = timing()
    tids = torch.tensor(TIDS, dtype=torch.int32, device=dev)
    cfg = EngineConfig(n_orders=S, cancel_mode=1)

    def case(E, seed, sweeps=False):
        book, msgs, prev = make_case(E, M, S, seed, tids=TIDS)
        if sweeps:
            msgs = add_sweeps(msgs, every=7, seed=seed)
        u = np.random.default_rng(seed).random((M, E), dtype=np.float32)
        return (torch.from_numpy(msgs).to(dev),
                BookState(torch.from_numpy(book).to(dev)),
                torch.from_numpy(prev).to(dev), torch.from_numpy(u).to(dev))

    for E in E_SHAPES:
        msgs, book, prev, u = case(E, 30 + E)

        def launch():
            return bkern.process_step_aggs(cfg, msgs, book, tids, prev, TICK,
                                           u)

        ms, ms_min = timers.time_launches(launch)
        bound = timers.scan_bytes(E, M, S, 2) / timers.HBM_BYTES_PER_S * 1e3
        print(f"[{root}] kernel 1, E={E}: {ms:.4f} ms (min {ms_min:.4f}) "
              f"through the wrapper, {timers.graph_ms(launch):.4f} ms on the "
              f"card alone, host issue {timers.host_ms(launch):.4f} ms a "
              f"call; bound {bound:.4f} ms [{smi}]", flush=True)
    sets = [case(4096, 60 + i) for i in range(3)]
    turn = [0]

    def cold():
        msgs, book, prev, u = sets[turn[0] % 3]
        turn[0] += 1
        return bkern.process_step_aggs(cfg, msgs, book, tids, prev, TICK, u)

    ms, ms_min = timers.time_launches(cold)
    print(f"[{root}] kernel 1, E=4096, cold L2 (3 input sets): {ms:.4f} ms "
          f"(min {ms_min:.4f}) [{smi}]", flush=True)
    del sets
    book, msgs, prev = make_case(4096, M, S, 30 + 4096, tids=TIDS)
    index = dispatch_index(msgs)
    mid = 2_200_000        # make_case's mid price
    crossing = (index <= 1) & np.where(index == 1, msgs[..., 3] > mid,
                                       msgs[..., 3] < mid)
    for label, keep in [
            ("padding alone", np.zeros_like(crossing)),
            ("cancels", (index == 2) | (index == 3)),
            ("crossing limit orders", crossing),
            ("resting limit orders", (index <= 1) & ~crossing)]:
        m_ = torch.from_numpy(np.where(keep[..., None], msgs, 0)).to(dev)
        b_ = BookState(torch.from_numpy(book).to(dev))
        p_ = torch.from_numpy(prev).to(dev)
        ms = timers.graph_ms(lambda: bkern.process_step_aggs(
            cfg, m_, b_, tids, p_, TICK, None))
        print(f"[{root}] kernel 1, E=4096, {label} ({keep.mean():.2f} of "
              f"the messages, padding elsewhere): {ms:.4f} ms on the card "
              f"alone (CUDA graph of {timers.PER_BATCH} launches) [{smi}]",
              flush=True)
    msgs, book, prev, u = case(4096, 40, sweeps=True)
    for rec_k in (16, 128):
        ms, ms_min = timers.time_launches(lambda: bkern.process_step_records(
            cfg, msgs, book, prev, rec_k, u))
        bound = timers.records_bytes(4096, M, S, rec_k, 1) \
            / timers.HBM_BYTES_PER_S * 1e3
        print(f"[{root}] kernel 2, E=4096, rec_k={rec_k}: {ms:.4f} ms (min "
              f"{ms_min:.4f}), bound {bound:.4f} ms [{smi}]", flush=True)
    del msgs, book, prev, u
    if kernels_only:
        return
    ma, tc = load_yaml_config(os.path.join(root, "configs",
                                           "ippo_2player.yaml"))
    train = make_train(ma, tc, device=dev)
    bkern.process_step_aggs.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = train(tc.seed, n_updates=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    steps = tc.num_envs * tc.num_steps * 2
    print(f"[{root}] 2-player, 2 updates: {steps / wall:.0f} env-steps/s; "
          f"{timers.update_split(out['metrics'])}; book-scan launches "
          f"{bkern.process_step_aggs.launches} [{smi}]", flush=True)


# (label, text in book_scan.cu, what takes its place) for --ablate
ABLATIONS = [
    ("no insert shift", "  // shift (fw_b, ha] right by one slot",
     "  return changed;\n  // shift (fw_b, ha] right by one slot"),
    ("no insert", "  if (add_q <= 0) return changed;",
     "  if (add_q <= 0 || true) return changed;"),
    ("no per-trader sums", "          add_sums<SPL, KIND>(",
     "          if (false) add_sums<SPL, KIND>("),
]


# (label, text in book_scan.cu, what takes its place) for --variants:
# copies that compute the same function
VARIANTS = [
    ("one shift for both directions", """  if (right) {
    // slot i in (lo, hi] takes slot i - 1; lane 0's first slot never moves
    auto shift = [&](int (&v)[SPL], int val) {
      int prev = __shfl_up_sync(kFull, v[SPL - 1], 1);
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        const int i = base + j, old = v[j];
        v[j] = i == lo ? val : (i > lo) & (i <= hi) ? prev : old;
        prev = old;
      }
    };
    shift(YP, msg.price);
    shift(YQ, add_q);
  } else {
    // slot i in [lo, hi) takes slot i + 1; lane 31's last slot never moves
    auto shift = [&](int (&v)[SPL], int val) {
      int next = __shfl_down_sync(kFull, v[0], 1);
#pragma unroll
      for (int j = SPL - 1; j >= 0; --j) {
        const int i = base + j, old = v[j];
        v[j] = i == hi ? val : (i >= lo) & (i < hi) ? next : old;
        next = old;
      }
    };
    shift(YP, msg.price);
    shift(YQ, add_q);
  }
  // The shared planes: lane t moves the four planes of one slot of a
  // group of 32 slots of the range (most ranges are shorter), a group's
  // reads before its writes, groups from the far end.
  if (right) {   // slots (lo, hi] take their left neighbour
    for (int top = hi; top > lo; top -= 32) {
      const int i = top - lane;
      int v[NPL];
#pragma unroll
      for (int f = 0; f < NPL; ++f) v[f] = i > lo ? Ypl[f * S + i - 1] : 0;
      __syncwarp();
#pragma unroll
      for (int f = 0; f < NPL; ++f)
        if (i > lo) Ypl[f * S + i] = v[f];
    }
  } else {       // slots [lo, hi) take their right neighbour
    for (int bot = lo; bot < hi; bot += 32) {
      const int i = bot + lane;
      int v[NPL];
#pragma unroll
      for (int f = 0; f < NPL; ++f) v[f] = i < hi ? Ypl[f * S + i + 1] : 0;
      __syncwarp();
#pragma unroll
      for (int f = 0; f < NPL; ++f)
        if (i < hi) Ypl[f * S + i] = v[f];
    }
  }
""", """  {
    const int at = right ? lo : hi;
    auto shift = [&](int (&v)[SPL], int val) {
      int prev = __shfl_up_sync(kFull, v[SPL - 1], 1);
      const int next = __shfl_down_sync(kFull, v[0], 1);
#pragma unroll
      for (int j = 0; j < SPL; ++j) {
        const int i = base + j, old = v[j];
        const int nb = right ? prev : (j + 1 < SPL ? v[j + 1] : next);
        const bool mv = right ? (i > lo) & (i <= hi) : (i >= lo) & (i < hi);
        v[j] = i == at ? val : mv ? nb : old;
        prev = old;
      }
    };
    shift(YP, msg.price);
    shift(YQ, add_q);
  }
  {
    const int d = right ? -1 : 1;
    for (int g = 0; g < hi - lo; g += 32) {
      const int i = right ? hi - g - lane : lo + g + lane;
      const bool mv = right ? i > lo : i < hi;
      int v[NPL];
#pragma unroll
      for (int f = 0; f < NPL; ++f) v[f] = mv ? Ypl[f * S + i + d] : 0;
      __syncwarp();
#pragma unroll
      for (int f = 0; f < NPL; ++f)
        if (mv) Ypl[f * S + i] = v[f];
    }
  }
"""),
    ("narrow rows at every rec_k (8 blocks an SM)",
     "constexpr int kWideRows = 96;", "constexpr int kWideRows = 256;"),
    ("wide rows at every rec_k (4 blocks an SM)",
     "constexpr int kWideRows = 96;", "constexpr int kWideRows = 0;"),
    ("wide rows at 6 blocks an SM",
     "return spl <= 4 && kind != kRecordsWide ? 8\n",
     "return spl <= 4 ? (kind != kRecordsWide ? 8 : 6)\n"),
]


WHOLE = ("whole kernel", "", "")

# (label, old texts, new texts, capacity or None: every S) for --masks:
# copies that compute the same function
VEC_LOAD = """#pragma unroll
    for (int j = 0; j < SPL; ++j) v[j] = base + j < n ? p[base + j] : fill;"""
VEC_STORE = """#pragma unroll
    for (int j = 0; j < SPL; ++j)
      if (base + j < n) p[base + j] = v[j];"""
VEC_SHARED = """  } else {
    for (int i = lane; i < 2 * NPL * S; i += 32) {"""
CAPACITY = ("const int n = MASK ? env.n : S;", "const int n = MASK ? a.n : S;")
MASK_VARIANTS = [
    ("masked book traffic in 16-byte accesses",
     (VEC_LOAD, VEC_STORE, VEC_SHARED), (
        """    if constexpr (SPL % 4 == 0) {
      if (n % 4 == 0) {
#pragma unroll
        for (int j = 0; j < SPL; j += 4) {
          int4 t = make_int4(fill, fill, fill, fill);
          if (base + j < n) t = *reinterpret_cast<const int4*>(p + base + j);
          v[j] = t.x; v[j + 1] = t.y; v[j + 2] = t.z; v[j + 3] = t.w;
        }
        return;
      }
    }
""" + VEC_LOAD,
        """    if constexpr (SPL % 4 == 0) {
      if (n % 4 == 0) {
#pragma unroll
        for (int j = 0; j < SPL; j += 4)
          if (base + j < n)
            *reinterpret_cast<int4*>(p + base + j) =
                make_int4(v[j], v[j + 1], v[j + 2], v[j + 3]);
        return;
      }
    }
""" + VEC_STORE,
        """  } else if ((n & 3) == 0) {
    for (int i = lane; i < 2 * NPL * S / 4; i += 32) {
      const int flat = 4 * i, sf = flat / S, slot = flat % S;
      if (slot < n)
        cp_async16(w + flat, bk + ((sf / NPL) * 6 + 2 + sf % NPL) * n + slot);
      else
        w[flat] = w[flat + 1] = w[flat + 2] = w[flat + 3] = kEmpty;
    }
""" + VEC_SHARED), None),
    *[(f"capacity {c} a constant of the build", CAPACITY,
       tuple(o.replace("env.n", str(c)).replace("a.n", str(c))
             for o in CAPACITY), c) for c in (100, 128)],
]


def copy_kernels(source, edits, bkern, nvcc):
    """Yield (label, changed) after loading into ``bkern`` a copy of
    ``book_scan.cu`` with each (label, old, new) edit in turn (an empty
    ``old``: the source as it is; tuples of ``old`` and ``new``: one
    replacement a pair), built with the wrapper's flags."""
    tmp = tempfile.mkdtemp(prefix="book_copies_")
    try:
        for n, (label, old, new) in enumerate(edits):
            pairs = (list(zip(old, new)) if isinstance(old, tuple)
                     else [(old, new)] if old else [])
            text = source
            for o, w in pairs:
                if text.count(o) != 1:
                    raise SystemExit(f"{label}: {o[:60]!r} not once in the "
                                     "source")
                text = text.replace(o, w)
            path = os.path.join(tmp, "book_scan.cu")
            with open(path, "w") as f:
                f.write(text)
            lib = nvcc.build(path, f"libbook_copy_{n}.so", bkern.NVCC_FLAGS)
            bkern._lib = None
            bkern.build_library = lambda lib=lib: lib
            bkern.launch_plan.cache_clear()
            yield label, bool(old)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def setup():
    """This checkout's modules, the card's line and the timers."""
    sys.path.insert(0, HERE)
    sys.path.insert(1, os.path.join(HERE, "tests"))
    import torch

    from vit_marl_tpu_torch.ops import book_kernel as bkern
    from vit_marl_tpu_torch.ops import nvcc

    if not torch.cuda.is_available():
        raise SystemExit("torch_ab_book: no CUDA device available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    with open(bkern.SOURCE) as f:
        source = f.read()
    return torch, bkern, nvcc, smi, timing(), source


def variants() -> None:
    torch, bkern, nvcc, smi, timers, source = setup()
    import numpy as np

    from torch_cases import add_sweeps, make_case, make_corner_case
    from vit_marl_tpu_torch.config import EngineConfig
    from vit_marl_tpu_torch.lob.book import BookState

    dev = torch.device("cuda")
    E = 4096
    cfg = EngineConfig(n_orders=S, cancel_mode=1)
    tids = torch.tensor(TIDS, dtype=torch.int32, device=dev)

    def on_card(book, msgs, prev):
        return (torch.from_numpy(msgs).to(dev),
                BookState(torch.from_numpy(book).to(dev)),
                torch.from_numpy(prev).to(dev))

    main = on_card(*make_case(E, M, S, 30 + E, tids=TIDS))
    book, msgs, prev = make_case(E, M, S, 40, tids=TIDS)
    sweeps = on_card(book, add_sweeps(msgs, every=7, seed=40), prev)
    c_book, c_msgs, c_prev = make_corner_case(E, M, S, 50, tids=TIDS)
    corner = on_card(c_book, c_msgs, c_prev)
    corner_sw = on_card(c_book, add_sweeps(c_msgs, every=7, seed=50),
                        c_prev)
    want_1 = bkern.process_step_aggs_reference(
        cfg, *corner[:2], tids, corner[2], TICK)
    want_2 = bkern.process_step_records_reference(cfg, *corner_sw, 128)
    flat = lambda out: [out[0].data, *out[1], *out[2]]   # noqa: E731
    for label, _ in copy_kernels(source, [WHOLE, *VARIANTS, WHOLE],
                                 bkern, nvcc):
        got_1 = bkern.process_step_aggs(cfg, *corner[:2], tids, corner[2],
                                        TICK)
        got_2 = bkern.process_step_records(cfg, *corner_sw, 128)
        same = all(torch.equal(g, w) for g, w in zip(
            flat(got_1) + flat(got_2), flat(want_1) + flat(want_2)))
        plans = [(f"kernel 2 at rec_k={k}",
                  bkern.launch_plan(S, None, dev, k)) for k in REC_KS]
        print(f"{label}: bit-equal {same}; " + "; ".join(
            f"{name} {p['registers']} registers, {p['spill_bytes']} spill "
            f"bytes, {p['warps_per_sm']} warps an SM" for name, p in
            [("kernel 1", bkern.launch_plan(S, 2, dev)), *plans]),
            flush=True)
        if not same:
            raise SystemExit(f"{label}: not bit-equal to the plain version")
        runs = [("kernel 1, E=4096", lambda: bkern.process_step_aggs(
            cfg, *main[:2], tids, main[2], TICK))]
        for rec_k in REC_KS:
            runs.append((f"kernel 2, E=4096, rec_k={rec_k}",
                         lambda rec_k=rec_k: bkern.process_step_records(
                             cfg, *sweeps, rec_k)))
        for name, fn in runs:
            ms, _ = timers.time_launches(fn)
            print(f"  {label}, {name}: {ms:.4f} ms through the wrapper, "
                  f"{timers.graph_ms(fn):.4f} ms on the card alone [{smi}]",
                  flush=True)


def masks() -> None:
    torch, bkern, nvcc, smi, timers, source = setup()

    from torch_cases import TIDS as OTHER_TIDS
    from torch_cases import launch_slot_map, make_case
    from vit_marl_tpu_torch.config import EngineConfig
    from vit_marl_tpu_torch.lob.book import BookState

    dev = torch.device("cuda")
    E, rec_k = 4096, 16
    tids = torch.tensor(timers.AGENT_TIDS, dtype=torch.int32, device=dev)
    data, want = {}, {}
    for inputs, owners in (("the traders' orders", timers.AGENT_TIDS),
                           ("no trader orders", OTHER_TIDS)):
        for cap in (128, 100):
            book, msgs, prev = make_case(E, M, cap, timers.SEED + cap,
                                         tids=owners)
            key = (inputs, cap)
            data[key] = (EngineConfig(n_orders=cap, cancel_mode=1),
                         torch.from_numpy(msgs).to(dev),
                         BookState(torch.from_numpy(book).to(dev)),
                         torch.from_numpy(prev).to(dev))
            want[key] = (bkern.process_step_aggs_reference(
                *data[key][:3], tids, data[key][3], TICK),
                bkern.process_step_records_reference(*data[key], rec_k))
    flat = lambda out: [out[0].data, *out[1], *out[2]]   # noqa: E731
    edits = [(label, old, new) for label, old, new, _ in MASK_VARIANTS]
    only = {label: cap for label, _, _, cap in MASK_VARIANTS}
    maps = (("S=128, exact map", 128, False), ("S=128, masked map", 128, True),
            ("S=100, masked map", 100, True))
    for label, _ in copy_kernels(source, [WHOLE, *edits, WHOLE], bkern,
                                 nvcc):
        lib = bkern._library()
        runs = []
        for (inputs, cap), args in data.items():
            for name, c, masked in maps:
                if c != cap or only.get(label) not in (None, cap) or (
                        only.get(label) and not masked):
                    continue
                k1 = functools.partial(launch_slot_map, lib, *args, 4,
                                       masked, tids=tids)
                k2 = functools.partial(launch_slot_map, lib, *args, 4,
                                       masked, rec_k=rec_k)
                if not all(torch.equal(g, w) for g, w in zip(
                        flat(k1()) + flat(k2()),
                        flat(want[inputs, cap][0])
                        + flat(want[inputs, cap][1]))):
                    raise SystemExit(f"{label}, {name}, {inputs}: not "
                                     "bit-equal to the plain version")
                plan = [bkern._plan(lib, cap, 4, masked, n_agg, k)
                        for n_agg, k in ((2, 1), (None, rec_k))]
                runs.append((f"{name}, {inputs}", k1, k2, plan))
        for _turn in range(2):
            for name, k1, k2, plan in runs:
                t1, t2 = timers.time_launches(k1), timers.time_launches(k2)
                g1, g2 = timers.graph_ms(k1), timers.graph_ms(k2)
                print(f"{label}, {name}: kernel 1 {t1[0]:.4f} ms (min "
                      f"{t1[1]:.4f}; card alone {g1:.4f}; "
                      f"{plan[0]['registers']} registers, "
                      f"{plan[0]['spill_bytes']} spill bytes), kernel 2 at "
                      f"rec_k {rec_k} {t2[0]:.4f} ms (min {t2[1]:.4f}; card "
                      f"alone {g2:.4f}; {plan[1]['registers']} registers, "
                      f"{plan[1]['spill_bytes']} spill bytes) a launch at "
                      f"E={E}, bit-equal [{smi}]", flush=True)


def ablate() -> None:
    torch, bkern, nvcc, smi, timers, source = setup()

    from torch_cases import make_case
    from vit_marl_tpu_torch.config import EngineConfig
    from vit_marl_tpu_torch.lob.book import BookState

    dev = torch.device("cuda")
    book, msgs, prev = make_case(4096, M, S, 30 + 4096, tids=TIDS)
    args = (EngineConfig(n_orders=S, cancel_mode=1),
            torch.from_numpy(msgs).to(dev),
            BookState(torch.from_numpy(book).to(dev)),
            torch.tensor(TIDS, dtype=torch.int32, device=dev),
            torch.from_numpy(prev).to(dev), TICK, None)
    for label, changed in copy_kernels(source, [WHOLE, *ABLATIONS],
                                       bkern, nvcc):
        ms = timers.graph_ms(lambda: bkern.process_step_aggs(*args))
        print(f"kernel 1, E=4096, {label}: {ms:.4f} ms on the card alone "
              f"[{smi}]", flush=True)
        if changed:
            continue
        for pad_m in (1, M):
            pad = (args[0], torch.zeros((4096, pad_m, 8), dtype=torch.int32,
                                        device=dev), *args[2:])
            ms = timers.graph_ms(lambda: bkern.process_step_aggs(*pad))
            print(f"kernel 1, E=4096, padding alone, M={pad_m}: "
                  f"{ms:.4f} ms on the card alone [{smi}]", flush=True)


def main() -> int:
    args = sys.argv[1:]
    if args == ["--ablate"]:
        ablate()
        return 0
    if args == ["--variants"]:
        variants()
        return 0
    if args == ["--masks"]:
        masks()
        return 0
    if len(args) >= 2 and args[0] == "--one":
        one(args[-1], "--kernels-only" in args)
        return 0
    kernels_only = "--kernels-only" in args
    trees = [a for a in args if a != "--kernels-only"]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in trees:
        print(f"== {tree}", flush=True)
        cmd = [sys.executable, os.path.abspath(__file__), "--one"]
        if kernels_only:
            cmd.append("--kernels-only")
        rc = subprocess.run(cmd + [tree]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
