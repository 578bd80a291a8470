"""Flax -> PyTorch weight bridge for :class:`ActorCriticRNN`,
:class:`ViTActorCriticRNN` and :class:`CNNActorCriticRNN`.

Turns the parameter tree of the JAX package's ``ActorCriticRNN``,
``ViTActorCriticRNN`` or ``CNNActorCriticRNN`` (nested dicts of numpy
arrays, as ``jax.device_get(params)`` gives them) into the port's
``state_dict``; a continuous head's ``log_std`` comes along on every
tree.  Layout traps:

- a flax ``Dense`` kernel is ``(in, out)``; ``torch.nn.Linear.weight`` is
  ``(out, in)``;
- flax ``GRUCell`` has no hidden-side bias on the reset and update gates:
  its ``hr``/``hz`` kernels carry none, only ``hn`` does (the port's cell
  has the same parameters, so there is nothing to zero);
- a flax ``LayerNorm`` names its weight ``scale``;
- the ViT model names its flat embedding, so its unnamed head layers are
  ``Dense_0``..``Dense_3`` where ``ActorCriticRNN`` has ``Dense_1``..
  ``Dense_4``;
- the JAX ViT's fused modes (``fused_block``, ``fused_block_full``,
  ``attn_ln_fold``) keep each block's parameters as flat leaves
  (``ln1_scale``, ``qkv_kernel``, ...) instead of submodules.  The port has
  one parameter layout for every mode, so both trees load into the same
  ``state_dict``; a checkpoint needs no conversion between modes;
- a flax ``Conv`` kernel is ``(kh, kw, in, out)``; ``torch.nn.Conv2d``'s
  weight is ``(out, in, kh, kw)``.  The CNN's ``Dense(128)`` after the
  flatten needs no permutation: the port's encoder flattens in flax's
  ``(h, w, c)`` order (``models/cnn.py``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_DENSE = {"Dense_0": "embed", "Dense_1": "actor_fc", "Dense_2": "actor_out",
          "Dense_3": "critic_fc", "Dense_4": "critic_out"}
_VIT_DENSE = {"flat_embed": "flat_embed", "Dense_0": "actor_fc",
              "Dense_1": "actor_out", "Dense_2": "critic_fc",
              "Dense_3": "critic_out", "fusion/v_proj": "fusion.v_proj",
              "fusion/f_proj": "fusion.f_proj", "fusion/gate": "fusion.gate"}
_BLOCK_DENSE = ("attn/qkv", "attn/proj", "mlp1", "mlp2")
# A fused-family block's flat leaf -> its path in the unfused tree (a copy
# of the table in vit_marl_tpu/models/convert.py).
_FUSED_FROM_UNFUSED = {
    "ln1_scale": ("ln1", "scale"),
    "ln1_bias": ("ln1", "bias"),
    "qkv_kernel": ("attn", "qkv", "kernel"),
    "qkv_bias": ("attn", "qkv", "bias"),
    "proj_kernel": ("attn", "proj", "kernel"),
    "proj_bias": ("attn", "proj", "bias"),
    "ln2_scale": ("ln2", "scale"),
    "ln2_bias": ("ln2", "bias"),
    "mlp1_kernel": ("mlp1", "kernel"),
    "mlp1_bias": ("mlp1", "bias"),
    "mlp2_kernel": ("mlp2", "kernel"),
    "mlp2_bias": ("mlp2", "bias"),
}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _get(tree: Mapping, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _unfused_block(block: Mapping) -> Mapping:
    """A block's tree in the unfused layout, whichever layout it has."""
    if "qkv_kernel" not in block:
        return block
    out: Dict = {}
    for leaf, path in _FUSED_FROM_UNFUSED.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = block[leaf]
    return out


def _dense_into(sd: Dict[str, torch.Tensor], name: str, node: Mapping):
    sd[f"{name}.weight"] = _t(node["kernel"]).T.contiguous()
    sd[f"{name}.bias"] = _t(node["bias"])


def _gru_into(sd: Dict[str, torch.Tensor], gru: Mapping):
    (cell,) = gru.values()    # the one GRUCell_* child
    sd["gru.cell.w_i.weight"] = torch.cat(
        [_t(cell[g]["kernel"]).T for g in ("ir", "iz", "in")]).contiguous()
    sd["gru.cell.w_i.bias"] = torch.cat(
        [_t(cell[g]["bias"]) for g in ("ir", "iz", "in")])
    sd["gru.cell.w_h.weight"] = torch.cat(
        [_t(cell[g]["kernel"]).T for g in ("hr", "hz", "hn")]).contiguous()
    sd["gru.cell.b_hn"] = _t(cell["hn"]["bias"])


def flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params": {...}}`` (or the inner dict) of any of the three
    models -> ``state_dict`` of its port."""
    p = params.get("params", params)
    vision = "vit" in p or "cnn" in p
    sd: Dict[str, torch.Tensor] = {}
    for flax_name, name in (_VIT_DENSE if vision else _DENSE).items():
        _dense_into(sd, name, _get(p, flax_name))
    _gru_into(sd, p["ScannedGRU_0"])
    if "log_std" in p:
        sd["log_std"] = _t(p["log_std"])
    if "vit" in p:
        sd.update(vit_encoder_state_dict(p["vit"], prefix="vit."))
    if "cnn" in p:
        sd.update(cnn_encoder_state_dict(p["cnn"], prefix="cnn."))
    return sd


def cnn_encoder_state_dict(cnn: Mapping, prefix: str = ""
                           ) -> Dict[str, torch.Tensor]:
    """The ``VisionAgentCNN`` subtree (``Conv_0``..``Conv_2``,
    ``Dense_0``, ``Dense_1``) -> the port's ``VisionAgentCNN``
    ``state_dict``, keys under ``prefix``: each conv kernel ``(kh, kw,
    in, out)`` transposed to ``(out, in, kh, kw)``."""
    sd: Dict[str, torch.Tensor] = {}
    i = 0
    while f"Conv_{i}" in cnn:
        conv = cnn[f"Conv_{i}"]
        sd[f"{prefix}convs.{i}.weight"] = _t(conv["kernel"]).permute(
            3, 2, 0, 1).contiguous()
        sd[f"{prefix}convs.{i}.bias"] = _t(conv["bias"])
        i += 1
    _dense_into(sd, f"{prefix}fc1", cnn["Dense_0"])
    _dense_into(sd, f"{prefix}fc2", cnn["Dense_1"])
    return sd


def vit_encoder_state_dict(vit: Mapping, prefix: str = ""
                           ) -> Dict[str, torch.Tensor]:
    """The ``ViTEncoder`` subtree (``patch_embed``, ``pos_embed``,
    ``cls``, ``block{i}`` in either layout, ``ln_f``) -> the port's
    ``ViTEncoder`` ``state_dict``, keys under ``prefix``."""
    sd: Dict[str, torch.Tensor] = {}
    _dense_into(sd, f"{prefix}patch_embed", vit["patch_embed"])
    sd[f"{prefix}pos_embed"] = _t(vit["pos_embed"])
    sd[f"{prefix}cls"] = _t(vit["cls"])
    lns = [(f"{prefix}ln_f", vit["ln_f"])]
    i = 0
    while f"block{i}" in vit:
        blk = _unfused_block(vit[f"block{i}"])
        for flax_name in _BLOCK_DENSE:
            _dense_into(sd, f"{prefix}blocks.{i}."
                        + flax_name.replace("/", "."), _get(blk, flax_name))
        lns += [(f"{prefix}blocks.{i}.ln1", blk["ln1"]),
                (f"{prefix}blocks.{i}.ln2", blk["ln2"])]
        i += 1
    for name, node in lns:
        sd[f"{name}.weight"] = _t(node["scale"])
        sd[f"{name}.bias"] = _t(node["bias"])
    return sd
