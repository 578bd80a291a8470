"""Entry point: one forward step of the flagship model.

Counterpart of ``__graft_entry__.py::entry``: the ViT actor-critic over
the book-image observation (``tiny`` preset, continuous actions bounded
by ``[-1, 0, 0]`` .. ``[3, 1, 1]``, fc and hidden width 64) on a batch of
32 actors and one time step.  ``dryrun_multichip`` waits for the port's
multi-GPU slice.

    from vit_marl_tpu_torch.graft_entry import entry
    fn, args = entry()             # on the card; entry("cpu") on request
    h2, action, value = fn(*args)
"""

from __future__ import annotations

import torch

from vit_marl_tpu_torch.models.rnn import ScannedGRU
from vit_marl_tpu_torch.models.vit import VIT_PRESETS, ViTActorCriticRNN
from vit_marl_tpu_torch.utils.device import resolve_device

BATCH, OBS_DIM, LEVELS, HIDDEN = 32, 28, 10, 64
ACTION_LOW = (-1.0, 0.0, 0.0)
ACTION_HIGH = (3.0, 1.0, 1.0)


def flagship_model(device=None, vit=None) -> ViTActorCriticRNN:
    """The flagship network on ``device`` (its encoder ``vit``, default
    the ``tiny`` preset), weights from torch's generator."""
    dev = resolve_device(device)
    return ViTActorCriticRNN(
        obs_dim=OBS_DIM, levels=LEVELS, action_dim=3,
        vit=vit or VIT_PRESETS["tiny"], fc_dim=HIDDEN, hidden_size=HIDDEN,
        action_low=torch.tensor(ACTION_LOW),
        action_high=torch.tensor(ACTION_HIGH)).to(dev)


def entry(device=None, vit=None):
    """``(fn, example_args)``: ``fn(h, obs, dones)`` runs the flagship
    model's forward on one step and returns ``(h2, pi.mode(), value)``;
    ``fn.net`` is the model (``vit``: another encoder config, e.g. the
    tiny preset in float32).  The example inputs are those of the JAX
    entry: a zero carry, observations of ones, no resets."""
    net = flagship_model(device, vit)
    dev = next(net.parameters()).device
    h = ScannedGRU.initialize_carry(BATCH, HIDDEN, dev)
    obs = {"obs": torch.ones((1, BATCH, OBS_DIM), device=dev),
           "vision_obs": torch.ones((1, BATCH, LEVELS, 3, 2), device=dev)}
    dones = torch.zeros((1, BATCH), dtype=torch.bool, device=dev)

    @torch.no_grad()
    def forward(h, obs, dones):
        h2, pi, value = net(h, obs, dones)
        return h2, pi.mode(), value

    forward.net = net
    return forward, (h, obs, dones)
