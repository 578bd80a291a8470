#!/usr/bin/env python3
"""Compare checkouts' fused-block kernels (kernels 5, 6a, 6b, 7) on one GPU.

    python3 tools/torch_ab_block.py PARENT_TREE . . PARENT_TREE
    python3 tools/torch_ab_block.py --kernels-only PARENT_TREE . . PARENT_TREE
    python3 tools/torch_ab_block.py --ablate TREE
    python3 tools/torch_ab_block.py --profile

Each argument is the root of a checkout (a ``git archive`` of another
commit unpacked in a directory that ``.gitignore`` lists, or ``.``).  For
each, in the order given and in a process of its own, the script builds
that checkout's ``fused_block.cu`` and times its four fused-block kernels
through its own wrappers at ViT-Small's shapes (bf16, N=11, W=384, H=6,
hidden 1,536) at B=32,768 and 1,024: through the wrapper (CUDA events
around batches of back-to-back calls) and on the card alone (replays of a
CUDA graph of the calls), with this checkout's ``chip_smoke.py`` timers
for every tree alike.  Unless ``--kernels-only``, it then trains
``configs/ippo_vision_dual_ppo.yaml`` for 2 updates in each fused mode
(``VIT_ATTN_LN_FOLD``, ``VIT_FUSED_BLOCK``, ``VIT_FUSED_BLOCK_FULL``)
through that checkout's ``chip_smoke.vision_phase`` (losses, launch
counts, env-steps/s, the rollout/PPO split).  Running parent, change,
change, parent in one call puts both on the same card and host, which
calls to the chip do not.

``--ablate TREE`` times the four kernels of TREE at B=32,768 on the card
alone against copies of its ``fused_block.cu`` with one part cut out
(the copies compute wrong results and exist only to be timed): for the
first design's bf16 kernels (mma.sync with weight fragments from global
memory; only where TREE's bf16 still runs them), the weight loads
replaced by shared-memory loads, the output columns split so every warp
has work, the MLP's float32 shared-memory accumulation, kernel 6a's
output stores and kernel 5's attention taken out; for the tensor-core
kernels, the TMA copies, the wgmmas, the GELU, the epilogue's overlap
with the next chunk's products (5, 6a), 6a's output stores, LN1 of 5
and 6a (or done two rows a warp at a time, or from global memory
without the TMA loads), the attention of 5 and of 7; then plan
variants: one CTA a cluster, kernel
7's head group (1, 2, 3), 6a's chunks of 64 columns, 5 and 6a on tiles
of 64 rows, 5's head group 2 or 3 on them.  The edits that match the
tree's source are the ones run; a copy or variant that names kernels is
timed for those alone.

``--profile`` builds this checkout's ``fused_block.cu`` with
``-DFUSED_BLOCK_PROFILE`` and prints, for the four tensor-core kernels at
B=32,768, the cycles CTA 0's producer and each consumer warpgroup spent
by phase (loads and LN1, waits for weight slots, wgmmas, epilogues,
barriers, LN2, attention, the producer's waits for free slots); the
counters cost about a third of the kernels' time, so they are read as
shares.
"""

from __future__ import annotations

import ctypes
import glob
import importlib.util
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, W, H, HIDDEN = 11, 384, 6, 1536
B_MAIN, B_ROLLOUT = 32_768, 1_024
NAMES = ("fused_ln_qkv", "fused_proj_mlp", "fused_block_full",
         "fused_ln_qkv_attn")
# the fused modes each tree trains (2 updates each), after its kernels
TRAINED_MODES = ("attn_ln_fold", "fused_block", "fused_block_full")
PHASES = ("load", "wait_full", "mma", "epilogue", "sync", "ln2",
          "attention", "wait_empty", "issue", "wait_x")

# (label, text in fused_block.cu, what takes its place) for --ablate; the
# edits of one copy share its label
ABLATIONS = [
    # the first design's bf16 kernels
    ("first design: weight fragments from shared memory",
     "        b[j][0] = ldg32(wrow[j] + k0);\n"
     "        b[j][1] = ldg32(wrow[j] + k0 + 8);",
     "        b[j][0] = lds32(A + g * lda + k0 + 2 * t);\n"
     "        b[j][1] = lds32(A + g * lda + k0 + 8 + 2 * t);"),
    ("first design: every warp busy (one column group a warp)",
     "  if (ncols % 32 == 0)\n"
     "    mma_gemm<MT, 4>(A, lda, Wg, ldw, kin, ncols, epi);\n"
     "  else\n"
     "    mma_gemm<MT, 1>(A, lda, Wg, ldw, kin, ncols, epi);",
     "  switch (ncols % 64 ? 0 : ncols / 64) {\n"
     "    case 2: mma_gemm<MT, 2>(A, lda, Wg, ldw, kin, ncols, epi); break;\n"
     "    case 3: mma_gemm<MT, 3>(A, lda, Wg, ldw, kin, ncols, epi); break;\n"
     "    case 4: mma_gemm<MT, 4>(A, lda, Wg, ldw, kin, ncols, epi); break;\n"
     "    case 5: mma_gemm<MT, 5>(A, lda, Wg, ldw, kin, ncols, epi); break;\n"
     "    case 6: mma_gemm<MT, 6>(A, lda, Wg, ldw, kin, ncols, epi); break;\n"
     "    default: mma_gemm<MT, 1>(A, lda, Wg, ldw, kin, ncols, epi);\n"
     "  }"),
    ("first design: no float32 shared-memory MLP accumulation",
     "[&](int r, int c, float v) { acc[r * lda + c] += v; });",
     "[&](int r, int c, float v) {\n"
     "               if (v == -1.2345e30f) acc[r * lda + c] = v;\n"
     "             });"),
    ("first design: no output stores (kernel 6a)",
     "if (r < n_valid) st(out + size_t(r) * K + c, v + a.bqkv[c]);",
     "if (v == -1.2345e30f) st(out + size_t(r) * K + c, v + a.bqkv[c]);"),
    ("first design: no attention (kernel 5)",
     "      attn_body::head_softmax(qe, qe + gd, ldq, ldq, N, D, a.scale, Pw,\n"
     "                              lane);\n"
     "      attn_body::head_pv(Pw, qe + 2 * gd, ldq, N, D,\n"
     "                         att + size_t(e) * N * ldatt + (g0 + hh) * D, "
     "ldatt,\n                         lane);",
     ""),
    # the tensor-core kernels
    ("tc: no TMA copies (stale weights)",
     "      if (turn == rank)\n        tma_load(",
     "      if (false)\n        tma_load("),
    ("tc: no TMA copies (stale weights)",
     "mbar_expect_tx(full, uint32_t(rows * 128));",
     "mbar_expect_tx(full, 0u);"),
    ("tc: no wgmma",
     "  for (int j = 0; j < NC / 64; ++j) mma_n64(&acc[32 * j], da, "
     "desc(sb[j] + koff));",
     "  for (int j = 0; j < NC / 64; ++j) {}"),
    ("tc: no wgmma",
     "  if constexpr (NC == 128) mma_n128(acc, da, db);\n"
     "  else mma_n64(acc, da, db);",
     ""),
    ("tc: no GELU",
     "pack(gelu_fast(rnd16(acc2[i] + b.x)),\n"
     "                               gelu_fast(rnd16(acc2[i + 1] + b.y)));",
     "pack(rnd16(acc2[i] + b.x), rnd16(acc2[i + 1] + b.y));"),
    ("tc: no epilogue overlap (kernel 5, kernel 6a)",
     "        if (kb == min(1, n_kb - 1) && have_prev) finish(prev, cr);\n",
     ""),
    ("tc: no epilogue overlap (kernel 5, kernel 6a)",
     "      fence_acc(nxt);\n#pragma unroll\n",
     "      if (have_prev) finish(prev, cr);\n      fence_acc(nxt);\n"
     "#pragma unroll\n"),
    ("tc: no output stores (kernel 6a)",
     "              tma_store(&a.tm_out, c.c0 + 64 * h, int(cr.row0),\n"
     "                        st_addr + h * kKbBytes);",
     "              (void)st_addr;"),
    ("tc: no attention (kernel 5)",
     "          float s[MT][2 * MT][4];\n"
     "          mma_attn::product_nt<MT>(s, q, q + sl, ht, lane);\n"
     "          mma_attn::softmax_rows<MT>(s, N, a.scale, lane);\n"
     "          uint32_t hi[MT][MT][4], lo[MT][MT][4];\n"
     "          mma_attn::a_fragments<MT>(s, hi, lo);\n"
     "          __syncwarp();\n"
     "          mma_attn::product_pv<MT>(hi, lo, q + 2 * sl, q, ht, N, D, "
     "1.f,\n"
     "                                   lane);",
     "          (void)q;"),
    ("tc: no LN1 (kernel 5, kernel 6a)",
     "    ln_swizzled<1>(At, W, cr.nv, g1, b1, wi, 4, [&](int r, int c) {",
     "    if (false) ln_swizzled<1>(At, W, cr.nv, g1, b1, wi, 4, "
     "[&](int r, int c) {"),
    ("tc: LN1 two rows a warp at a time (kernel 5, kernel 6a)",
     "    ln_swizzled<1>(At, W, cr.nv, g1, b1, wi, 4, [&](int r, int c) {",
     "    ln_swizzled<2>(At, W, cr.nv, g1, b1, wi, 4, [&](int r, int c) {"),
    ("tc: LN1 from global memory, no TMA (kernel 5, kernel 6a)",
     "    if (cr.nv > 0) mbar_wait(xbar, xph++ & 1);", "    (void)xph;"),
    ("tc: LN1 from global memory, no TMA (kernel 5, kernel 6a)",
     "      const bool refill = after.done() && more && nr.nv > 0;",
     "      const bool refill = false;"),
    ("tc: LN1 from global memory, no TMA (kernel 5, kernel 6a)",
     "    if (lead && nr.nv > 0) {\n      mbar_expect_tx",
     "    if (false) {\n      mbar_expect_tx"),
    ("tc: LN1 from global memory, no TMA (kernel 5, kernel 6a)",
     "      return unpack(*reinterpret_cast<const uint32_t*>(At + swz(r, c)));",
     "      return unpack(*reinterpret_cast<const uint32_t*>(\n"
     "          a.x + (cr.row0 + r) * W + c));"),
    ("tc: no attention (kernel 7)",
     "          attn_body::head_softmax(qe, qe + SW, ldq, ldq, N, D, a.scale, "
     "Pw,\n                                  lane);\n"
     "          attn_body::head_pv(Pw, qe + 2 * SW, ldq, N, D, qe, ldq, "
     "lane);",
     ""),
]
WHOLE = ("whole kernel", "", "")


def this_checkouts(name: str, path: str):
    """A module of this checkout by path, so every tree gets the same
    timers (``chip_smoke.py``)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def setup(tree: str):
    """The tree's modules, the card's line and this checkout's timers."""
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    sys.path.insert(1, os.path.join(root, "tests"))
    import torch

    from vit_marl_tpu_torch.ops import block_kernel as blk
    from vit_marl_tpu_torch.ops import nvcc

    if not torch.cuda.is_available():
        raise SystemExit("torch_ab_block: no CUDA device available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return torch, blk, nvcc, smi, this_checkouts("chip_smoke_timers",
                                                 "chip_smoke.py")


def inputs(torch, B: int):
    """Seeded ViT-Small block parameters and rows (bf16; LayerNorms and
    biases float32) and the four kernels' calls on them."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)

    def rand(*shape, scale=1.0, loc=0.0, dt=torch.float32):
        return (loc + scale * torch.randn(shape, generator=gen,
                                          device=dev)).to(dt)

    bf = torch.bfloat16
    x, a = rand(B * N, W, dt=bf), rand(B * N, W, dt=bf)
    head = (rand(W, scale=0.1, loc=1.0), rand(W, scale=0.1),
            rand(3 * W, W, scale=W ** -0.5, dt=bf), rand(3 * W, scale=0.1))
    rest = (rand(W, W, scale=W ** -0.5, dt=bf), rand(W, scale=0.1),
            rand(W, scale=0.1, loc=1.0), rand(W, scale=0.1),
            rand(HIDDEN, W, scale=W ** -0.5, dt=bf), rand(HIDDEN, scale=0.1),
            rand(W, HIDDEN, scale=HIDDEN ** -0.5, dt=bf), rand(W, scale=0.1))
    return x, a, head, rest


def calls(blk, x, a, head, rest):
    return {"fused_ln_qkv": lambda: blk.fused_ln_qkv(x, *head),
            "fused_proj_mlp": lambda: blk.fused_proj_mlp(a, x, *rest),
            "fused_block_full": lambda: blk.fused_block_full(x, *head, *rest,
                                                             N, H),
            "fused_ln_qkv_attn": lambda: blk.fused_ln_qkv_attn(x, *head, N,
                                                               H)}


def one(tree: str, kernels_only: bool) -> None:
    torch, blk, _, smi, timers = setup(tree)
    blk.build_library()
    blk._library()
    x, a, head, rest = inputs(torch, B_MAIN)
    for B in (B_MAIN, B_ROLLOUT):
        fns = calls(blk, x[:B * N], a[:B * N], head, rest)
        for name in NAMES:
            ms = timers.time_launches(fns[name])[0]
            print(f"[{tree}] {name} B={B}: {ms:.4f} ms through the wrapper, "
                  f"{timers.graph_ms(fns[name]):.4f} ms on the card alone "
                  f"[{smi}]", flush=True)
    del x, a
    if kernels_only:
        return
    import chip_smoke
    from vit_marl_tpu_torch.config import load_yaml_config
    from vit_marl_tpu_torch.ops import attention_kernel as attn
    from vit_marl_tpu_torch.ops import book_kernel as bkern
    from vit_marl_tpu_torch.rl.ppo import make_train
    for m in (bkern, attn):
        m.build_library()
        m._library()
    for mode in TRAINED_MODES:
        chip_smoke.vision_phase(torch, attn, bkern, blk, make_train,
                                load_yaml_config, torch.device("cuda"), smi,
                                mode)


def copies(source: str, edits, blk, nvcc):
    """Yield (label, changed) after loading into ``blk`` a copy of
    ``fused_block.cu`` with each (label, old, new) edit in turn (an empty
    ``old``: the source as it is); edits whose text the source lacks, or
    that belong to the other design, are skipped.  The copies are built
    together, one nvcc each."""
    from concurrent.futures import ThreadPoolExecutor

    tmp = tempfile.mkdtemp(prefix="block_copies_")
    # the first design's copies only where bf16 still runs it
    first = "ldg32(" in source
    todo = []   # (label, [(old, new), ...]): an edit's lines share a label
    for label, old, new in edits:
        if todo and old and todo[-1][0] == label:
            todo[-1][1].append((old, new))
        else:
            todo.append((label, [(old, new)] if old else []))
    todo = [(n, label, pairs) for n, (label, pairs) in enumerate(todo)
            if not pairs or first or not label.startswith("first design")]
    for n, label, pairs in list(todo):
        if any(source.count(old) != 1 for old, _ in pairs):
            print(f"{label}: its text is not once in this source; skipped",
                  flush=True)
            todo.remove((n, label, pairs))

    def build(item):
        n, _, pairs = item
        d = os.path.join(tmp, str(n))
        os.makedirs(d)
        for header in glob.glob(os.path.join(nvcc.CSRC, "*.cuh")):
            shutil.copy(header, d)
        text = source
        for old, new in pairs:
            text = text.replace(old, new)
        path = os.path.join(d, "fused_block.cu")
        with open(path, "w") as f:
            f.write(text)
        return nvcc.build(path, f"libblock_copy_{n}.so")

    try:
        with ThreadPoolExecutor(min(8, len(todo))) as pool:
            libs = list(pool.map(build, todo))
        for (_, label, pairs), lib in zip(todo, libs):
            blk._lib = None
            blk.build_library = lambda lib=lib: lib
            yield label, bool(pairs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


KERNEL_OF = {"kernel 5": "fused_ln_qkv_attn", "kernel 6a": "fused_ln_qkv",
             "kernel 6b": "fused_proj_mlp", "kernel 7": "fused_block_full"}


def concerns(label: str, name: str) -> bool:
    """Whether a copy or plan variant labelled ``label`` is timed for
    kernel ``name``: those naming kernels (``(kernel 5)``) for those
    alone, the others for all four."""
    named = [k for k in KERNEL_OF if k + ")" in label or k + "," in label]
    return not named or any(KERNEL_OF[k] == name for k in named)


def ablate(tree: str) -> None:
    torch, blk, nvcc, smi, timers = setup(tree)
    with open(blk.SOURCE) as f:
        source = f.read()
    x, a, head, rest = inputs(torch, B_MAIN)
    fns = calls(blk, x, a, head, rest)
    for label, changed in copies(source, [WHOLE, *ABLATIONS, WHOLE], blk,
                                 nvcc):
        for name in NAMES:
            if not concerns(label, name):
                continue
            print(f"[{tree}] {name} B={B_MAIN}, {label}: "
                  f"{timers.graph_ms(fns[name]):.4f} ms on the card alone "
                  f"[{smi}]", flush=True)
        if changed or not hasattr(blk, "wgmma_plan"):
            continue
        # plan variants of the whole kernel: one CTA a cluster; kernel 7's
        # head groups
        base = blk.wgmma_plan
        variants = [("cluster of 1", lambda *s: dict(base(*s), cluster=1))]
        variants += [(f"kernel 7, head group {g}",
                      lambda *s, g=g: base(*s, head_group=g)
                      if s[0] == "fused_block_full" else base(*s))
                     for g in (1, 2, 3)]
        qkv = ("fused_ln_qkv", "fused_ln_qkv_attn")
        variants += [
            ("kernel 6a, chunks of 64 columns",
             lambda *s: base(*s, nc=64) if s[0] == qkv[0] else base(*s)),
            ("kernel 5, kernel 6a, tiles of 64 rows",
             lambda *s: base(*s, rows=64) if s[0] in qkv else base(*s))]
        variants += [(f"kernel 5, tiles of 64 rows, head group {g}",
                      lambda *s, g=g: base(*s, rows=64, head_group=g)
                      if s[0] == qkv[1] else base(*s)) for g in (2, 3)]
        for vlabel, plan in variants:
            blk.wgmma_plan = plan
            blk._plan_array.cache_clear()
            for name in NAMES:
                if not concerns(vlabel, name):
                    continue
                try:
                    ms = f"{timers.graph_ms(fns[name]):.4f} ms"
                except ValueError as e:   # no plan of this variant
                    ms = f"not run ({e})"
                print(f"[{tree}] {name} B={B_MAIN}, {vlabel}: {ms} on the "
                      f"card alone [{smi}]", flush=True)
        blk.wgmma_plan = base
        blk._plan_array.cache_clear()


def profile() -> None:
    torch, blk, nvcc, smi, timers = setup(HERE)
    lib = nvcc.build(blk.SOURCE, "libfused_block_profile.so",
                     flags=["-DFUSED_BLOCK_PROFILE"])
    blk._lib = None
    blk.build_library = lambda: lib
    x, a, head, rest = inputs(torch, B_MAIN)
    fns = calls(blk, x, a, head, rest)
    read = blk._library().fused_block_profile
    read.argtypes = [ctypes.c_void_p]
    for name in NAMES:
        k = blk.KINDS[name]
        ms = timers.graph_ms(fns[name])
        fns[name]()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * (4 * 3 * len(PHASES)))()
        if read(ctypes.addressof(buf)):
            raise SystemExit("fused_block_profile failed")
        print(f"{name} B={B_MAIN}, counters on: {ms:.4f} ms on the card "
              f"alone [{smi}]", flush=True)
        for w, who in enumerate(("producer", "warpgroup 0", "warpgroup 1")):
            v = list(buf)[(k * 3 + w) * len(PHASES):
                          (k * 3 + w + 1) * len(PHASES)]
            total = sum(v)
            print(f"  CTA 0 {who}: {total} cycles; " + ", ".join(
                f"{p} {c / total:.1%}" for p, c in zip(PHASES, v) if c),
                flush=True)


def main() -> int:
    args = sys.argv[1:]
    if args == ["--profile"]:
        profile()
        return 0
    if len(args) == 2 and args[0] == "--ablate":
        ablate(args[1])
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
