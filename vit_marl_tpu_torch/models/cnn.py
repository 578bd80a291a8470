"""CNN vision encoder and its recurrent actor-critic (``network:
cnn_gru``).

Port of ``vit_marl_tpu/models/cnn.py``: ``VisionAgentCNN`` is three
``(3, 2)`` convolutions with SAME padding (16, 32 and 32 channels), each
followed by ReLU, then ``Dense(128)``, ReLU and ``Dense(features)`` over
the book image ``(levels, 3, 2)`` in float32; ``CNNActorCriticRNN`` is the
ViT actor-critic with this encoder in place of the ViT (gated fusion,
GRU, the same heads).

Layouts: flax convolves NHWC images (H = levels, W = 3, C = 2) with a
``(kh, kw, in, out)`` kernel; ``torch.nn.Conv2d`` takes NCHW and
``(out, in, kh, kw)``, so the bridge transposes the kernels.  SAME
padding of the ``(3, 2)`` kernel pads the height by one row each side and
the width by one column on the right (``lax.padtype_to_pads``: the odd
pad goes after); :data:`SAME_PAD` gives that to ``F.pad`` explicitly.
The flatten before ``Dense(128)`` is where the layouts part: flax flattens
``(h, w, c)``, an NCHW tensor ``(c, h, w)``.  The encoder permutes its
activations back to NHWC before the flatten, so ``Dense(128)``'s weight is
the flax kernel transposed, with no permutation of its rows.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vit_marl_tpu_torch.models.rnn import _lecun_normal_
from vit_marl_tpu_torch.models.vit import Dense, VisionActorCritic

CHANNELS = (16, 32, 32)
KERNEL = (3, 2)
# F.pad's (left, right, top, bottom) for SAME with the (3, 2) kernel
SAME_PAD = (0, 1, 1, 1)


class VisionAgentCNN(nn.Module):
    """Book image ``(..., levels, 3, 2)`` -> ``(..., features)``
    float32."""

    def __init__(self, levels: int, features: int = 64, feats: int = 3,
                 channels: int = 2):
        super().__init__()
        # float32 convolutions and products in full float32, as in the JAX
        # package: no TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.convs = nn.ModuleList()
        c_in = channels
        for c_out in CHANNELS:
            conv = nn.Conv2d(c_in, c_out, KERNEL)
            with torch.no_grad():
                # flax's default conv init: lecun normal over the fan-in
                # of in x kh x kw, zero bias
                _lecun_normal_(conv.weight.view(c_out, -1))
                conv.bias.zero_()
            self.convs.append(conv)
            c_in = c_out
        self.fc1 = Dense(levels * feats * c_in, 128)
        self.fc2 = Dense(128, features)
        self.features = features

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        lead = image.shape[:-3]
        x = image.reshape((-1,) + tuple(image.shape[-3:])).float()
        x = x.permute(0, 3, 1, 2)                       # NHWC -> NCHW
        for conv in self.convs:
            x = torch.relu(conv(F.pad(x, SAME_PAD)))
        # flatten in flax's (h, w, c) order
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = self.fc2(torch.relu(self.fc1(x)))
        return x.reshape(lead + (self.features,))


class CNNActorCriticRNN(VisionActorCritic):
    """The vision actor-critic on :class:`VisionAgentCNN` (``network:
    cnn_gru``); parameters under ``cnn.``."""

    def __init__(self, obs_dim: int, levels: int, action_dim: int,
                 features: int = 64, fc_dim: int = 64,
                 hidden_size: int = 64,
                 action_low: Optional[torch.Tensor] = None,
                 action_high: Optional[torch.Tensor] = None):
        super().__init__("cnn", VisionAgentCNN(levels, features), features,
                         obs_dim, action_dim, fc_dim, hidden_size,
                         action_low, action_high)
