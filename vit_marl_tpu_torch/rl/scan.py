"""The rollout over static buffers, replayed as a CUDA graph of the step.

Counterpart of the JAX package's ``jax.lax.scan(_env_step, ...,
num_steps)`` inside its jitted update (``vit_marl_tpu/rl/ppo.py:356-402``,
``:521-527``), which ``rollout_mode="auto"`` takes on every backend but a
TPU.  :class:`ScanRollout` holds the rollout's state in buffers that live
as long as the trainer:

- the carry (env state, each type's observations, done flags and GRU
  states);
- per agent type the trajectory, one ``(T, ...)`` Transition;
- the per-step info moments (with ``log_env_info``), ``(T, ...)`` leaves;
- the step index ``t``, a one-element int64 tensor on the device.

Its body, :meth:`ScanRollout.step`, is one step of ``rl/ppo.py``'s loop
(the policies and their samples, the env step, the info reduction) that
writes the step's Transitions and moments into slot ``t`` of the buffers
(``index_copy_`` with the device index), the new carry over the old, and
adds one to ``t``.  No host value of the step is baked into it.

On a card the body is captured once as a ``torch.cuda.CUDAGraph``, after
a warm-up run on a side stream, and replayed ``T`` times an update: the
host launches one graph a step and nothing else (the capture is of one
step, not of all ``T``, so capturing costs one step's issue and the
graph one step's nodes; the slot index on the device lets the same graph
serve every step).  The generators the body draws from are registered
with the graph (``register_generator_state``), so each replay draws
afresh, at the offsets eager calls would take.  The warm-up and the
capture draw and move the carry, so the generator states and the carry
are saved before the warm-up and restored after the capture: update 0
starts from the state the loop starts from.  A capture that fails
raises; nothing falls back to the loop.

The kernel wrappers count the launches they make: the warm-up's, and
not the capture's, which only records them (``ops.tally``).  A replay
launches the graph's kernels without the wrappers; ``StepGraph.replays``
counts the replays where they are made, and a profiler trace of the
replays counts those launches.

On the CPU (which must be asked for) the same body runs eagerly ``T``
times: the CPU tests hold the captured function against the loop.

:class:`StepGraph` holds what any such rollout needs (the buffers' slot
index, the capture with its generators and carry put back, the replays,
the eager body); the greedy eval (``rl/ppo.py::EvalRollout``) and
``evaluate.py``'s rollouts (``eval/combinations.py::
CombinationRollout``) are its other bodies.
"""

from __future__ import annotations

import time
from typing import List, Sequence

import torch

from vit_marl_tpu_torch.utils.tree import tree_leaves, tree_map

Tensor = torch.Tensor


def _tensors(tree) -> List[Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, Tensor)]


def assign(dst, src) -> None:
    """Copy every tensor of ``src`` into the same leaf of ``dst`` (the
    same structure).  A leaf of ``src`` that shares storage with a buffer
    of ``dst`` other than its own (an unchanged field handed on, or a
    view of one) is cloned first, so no copy reads a buffer another copy
    has already overwritten; a leaf that is its own buffer is left."""
    dl, sl = _tensors(dst), _tensors(src)
    if len(dl) != len(sl):
        raise ValueError(f"assign: {len(sl)} tensors into {len(dl)}")
    held = {d.untyped_storage().data_ptr() for d in dl}
    sl = [s.clone() if s is not d and s.untyped_storage().data_ptr() in held
          else s for s, d in zip(sl, dl)]
    for d, s in zip(dl, sl):
        if s is not d:
            d.copy_(s)


class StepGraph:
    """``n_steps`` steps of one body over static buffers: on a card one
    CUDA graph of :meth:`step`, captured at the first :meth:`replay` and
    replayed ``n_steps`` times a call; on the CPU the body eagerly.

    A subclass writes :meth:`step` (reading ``self.carry``, writing its
    outputs into slot ``self.t`` of its buffers with :meth:`_put`, the
    new carry over the old with :func:`assign`, and adding one to
    ``self.t``), hands the carry to :meth:`set_carry` before each
    :meth:`replay` and names its modules in ``self.nets``.  ``gens``: the generators the body
    draws from, registered with the graph.

    The graph reads the modules' parameters and buffers from their
    storage: an in-place update (the optimizer's step, ``copy_``,
    ``load_state_dict``) is seen by the next replay.  Replacing a
    tensor (``load_state_dict(assign=True)``, a new ``nn.Parameter``)
    would leave the graph reading the old one; :meth:`replay` compares
    the tensors' addresses with the captured ones and captures again
    where they moved, so it never replays stale weights."""

    def __init__(self, n_steps: int, gens: Sequence[torch.Generator],
                 device):
        self.n_steps = n_steps
        self.gens = []
        for g in gens:
            if g is not None and all(g is not h for h in self.gens):
                self.gens.append(g)
        self.device = torch.device(device)
        self.use_graph = self.device.type == "cuda"
        self.nets: List[torch.nn.Module] = []
        self.t = None           # the step index, made at the first replay
        self.carry = None       # the carry buffers
        self.graph = None
        self.captures = 0
        self.replays = 0        # graph replays made, of any graph captured
        self._weights = None
        self.warmup_s = self.capture_s = self.instantiate_s = 0.0

    def _slots(self, tree):
        """``(T,) + leaf.shape`` buffers for one step's tree."""
        return tree_map(lambda v: torch.empty(
            (self.n_steps,) + tuple(v.shape), dtype=v.dtype,
            device=v.device), tree)

    def _put(self, bufs, tree) -> None:
        for b, v in zip(_tensors(bufs), _tensors(tree)):
            b.index_copy_(0, self.t, v.unsqueeze(0))

    def step(self) -> None:
        raise NotImplementedError

    def _weight_addresses(self):
        return tuple(t.data_ptr() for net in self.nets
                     for t in list(net.parameters()) + list(net.buffers()))

    def _capture(self) -> None:
        """Warm up on a side stream, capture one step, then put back the
        carry, the generators and the step index as they were."""
        carry0 = tree_map(lambda v: v.clone() if isinstance(v, Tensor)
                          else v, self.carry)
        gen_states = [g.get_state() for g in self.gens]
        t0 = self.t.clone()
        tw = time.perf_counter()
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.step()
        main.wait_stream(side)
        torch.cuda.synchronize(self.device)
        self.warmup_s = time.perf_counter() - tw
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for g in self.gens:
            graph.register_generator_state(g)
        tc = time.perf_counter()
        with torch.cuda.graph(graph):
            self.step()
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - tc
        ti = time.perf_counter()
        graph.instantiate()
        torch.cuda.synchronize(self.device)
        self.instantiate_s = time.perf_counter() - ti
        assign(self.carry, carry0)
        for g, s in zip(self.gens, gen_states):
            g.set_state(s)
        self.t.copy_(t0)
        self.graph = graph
        self.captures += 1
        self._weights = self._weight_addresses()

    def set_carry(self, carry) -> None:
        """Start the next :meth:`replay` from ``carry``: copied into the
        carry buffers (made from it on the first call)."""
        if self.carry is None:
            self.carry = tree_map(lambda v: v.clone() if isinstance(
                v, Tensor) else v, carry)
        elif carry is not self.carry:
            assign(self.carry, carry)

    def replay(self, step_draws=None, steps=None) -> None:
        """``n_steps`` steps from slot 0 and the carry buffers, or the first
        ``steps`` of them.  ``step_draws`` (each step's draws, as tests
        feed them) run the body eagerly, ``step(step_draws[k])``, on any
        device."""
        n = self.n_steps if steps is None else steps
        if not 0 <= n <= self.n_steps:
            raise ValueError(f"steps={steps}: the buffers hold "
                             f"{self.n_steps}")
        if self.t is None:
            self.t = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.t.zero_()
        if step_draws is not None or not self.use_graph:
            for k in range(n):
                self.step(*(() if step_draws is None else
                            (step_draws[k],)))
            return
        if self.graph is not None and \
                self._weights != self._weight_addresses():
            self.graph = None           # a weight was replaced: capture anew
        if self.graph is None:
            self._capture()
        for _ in range(n):
            self.graph.replay()
            self.replays += 1


class ScanRollout(StepGraph):
    """``n_steps`` steps of policy then env over static buffers (see the
    module docstring).  ``step_fn``, ``nets``, ``params``, ``n_envs``,
    ``n_per_type``, the generators and ``log_env_info`` are
    :func:`vit_marl_tpu_torch.rl.ppo.rollout_loop`'s; ``device`` decides
    between the graph (``cuda``) and the eager body (``cpu``).

    :meth:`run` returns what ``rollout_loop`` returns; the trajectories,
    moments and carry it returns are the buffers themselves, valid until
    the next :meth:`run`.  ``warmup_s``, ``capture_s`` and
    ``instantiate_s`` hold the set-up's seconds once captured."""

    def __init__(self, step_fn, nets: Sequence[torch.nn.Module], params,
                 n_steps: int, n_envs: int, n_per_type: Sequence[int],
                 pol_gen: torch.Generator, env_gen: torch.Generator,
                 log_env_info: bool, device):
        super().__init__(n_steps, [pol_gen, env_gen], device)
        self.step_fn, self.nets, self.params = step_fn, list(nets), params
        self.n_envs = n_envs
        self.n_per_type = tuple(n_per_type)
        self.pol_gen, self.env_gen = pol_gen, env_gen
        self.log_env_info = log_env_info
        self.traj = None        # per type a (T, ...) Transition
        self.info = None        # (T, ...) moments, or None

    def step(self) -> None:
        """One step from the carry buffers into slot ``t`` and the carry:
        the body the graph captures."""
        from vit_marl_tpu_torch.rl.ppo import (
            Carry,
            _transitions,
            env_step,
            policy_step,
        )

        c = self.carry
        hs, acts, pol_out = policy_step(self.nets, c.obs, c.dones, c.hstates,
                                        self.n_envs, self.n_per_type,
                                        self.pol_gen)
        state, obs, dones, env_out, stats = env_step(
            self.step_fn, c.state, acts, self.params, self.n_envs,
            self.n_per_type, self.env_gen, self.log_env_info)
        trans = _transitions(c.dones, pol_out, env_out)
        if self.traj is None:     # the first (eager) run sizes the slots
            self.traj = self._slots(trans)
            self.info = self._slots(stats) if self.log_env_info else None
        self._put(self.traj, trans)
        if self.log_env_info:
            self._put(self.info, stats)
        assign(c, Carry(state, obs, dones, hs))
        self.t.add_(1)

    def run(self, carry, steps=None):
        """``n_steps`` steps from ``carry`` (or the first ``steps``: the
        later slots keep what they held); returns (per type the
        trajectory, the per-step info moments or None, the new carry)."""
        self.set_carry(carry)
        self.replay(steps=steps)
        return self.traj, self.info, self.carry
