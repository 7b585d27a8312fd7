"""Parameters for the port's :class:`..models.droid_net.DroidNet`: from the
JAX package's parameter trees and files, from the reference's
``droid.pth``, and from the port's own training checkpoints.

The JAX package keeps DroidNet parameters as ``{'params': {'fnet', 'cnet',
'update'}}`` with flax conv kernels in HWIO, and saves them as flax msgpack
(``weights/*.msgpack``). The port's module names are the flax names
(``fnet.layer2_0.conv1``, ``fnet.layer2_0.downsample``,
``update.corr_enc1``, ``update.gru.convz_glo``, ``update.agg.eta``, ...), so
the mapping is by path: ``kernel`` → ``weight`` transposed to OIHW,
``bias`` → ``bias``. The delta and weight heads are natively 2-channel in
both packages.

A reference ``droid.pth`` names its modules as PyTorch sequentials
(``update.corr_encoder.0``, ``fnet.layer2.0.conv1``) under a DDP
``module.`` prefix, with 4-channel delta and weight heads of which the
reference keeps the first 2 (droid.py:46-60). Its convolutions are OIHW
already, as the port's are.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .droid_net import DroidNet
from .msgpack_io import unpackb


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (nested dicts of numpy arrays) → a state dict for
    :class:`..models.droid_net.DroidNet`."""
    state: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str):
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{key}.")
                continue
            arr = np.asarray(value, dtype=np.float32)
            if key == "kernel":
                if arr.ndim != 4:
                    raise ValueError(f"{prefix}kernel: expected a 4-d conv kernel, got {arr.shape}")
                state[prefix + "weight"] = torch.from_numpy(arr.transpose(3, 2, 0, 1).copy())
            elif key == "bias":
                state[prefix + "bias"] = torch.from_numpy(arr.copy())
            else:
                raise KeyError(f"unexpected parameter leaf {prefix}{key}")

    walk(tree["params"], "")
    return state


def load_params(path: str) -> Dict:
    """A flax msgpack parameter file → its nested tree of numpy arrays, as
    ``flax.serialization.msgpack_restore`` gives it."""
    with open(path, "rb") as f:
        return unpackb(f.read())


# reference sequential index → port (= flax) module name, under ``update.``
# (the JAX package's models/weights.py::_SEQ_MAP)
_SEQ_MAP = {
    "corr_encoder.0": "corr_enc1",
    "corr_encoder.2": "corr_enc2",
    "flow_encoder.0": "flow_enc1",
    "flow_encoder.2": "flow_enc2",
    "weight.0": "weight1",
    "weight.2": "weight2",
    "delta.0": "delta1",
    "delta.2": "delta2",
    "agg.conv1": "agg.conv1",
    "agg.conv2": "agg.conv2",
    "agg.eta.0": "agg.eta",
    "agg.upmask.0": "agg.upmask",
    "gru.convz": "gru.convz",
    "gru.convr": "gru.convr",
    "gru.convq": "gru.convq",
    "gru.w": "gru.w",
    "gru.convz_glo": "gru.convz_glo",
    "gru.convr_glo": "gru.convr_glo",
    "gru.convq_glo": "gru.convq_glo",
}

# heads whose first 2 of 4 output channels are kept (droid.py:54-57)
_TRUNCATED = {"update.weight.2", "update.delta.2"}


def _encoder_key(rest: str) -> str:
    """fnet/cnet module path → port name: ``convN`` stays, ``layerK.B.convN``
    → ``layerK_B.convN``, ``layerK.B.downsample.0`` → ``layerK_B.downsample``."""
    parts = rest.split(".")
    if parts[0].startswith("conv"):
        return parts[0]
    return f"{parts[0]}_{parts[1]}.{parts[2]}"


def state_dict_from_reference(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference ``droid.pth`` state dict → a state dict for
    :class:`..models.droid_net.DroidNet` (float32, contiguous)."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state.items():
        key = key.removeprefix("module.")
        base, leaf = key.rsplit(".", 1)
        if leaf not in ("weight", "bias"):
            raise KeyError(f"unexpected leaf: {key}")
        value = torch.as_tensor(value).detach()
        if base in _TRUNCATED:
            value = value[:2]
        top, rest = base.split(".", 1)
        if top in ("fnet", "cnet"):
            name = f"{top}.{_encoder_key(rest)}"
        elif top == "update":
            if rest not in _SEQ_MAP:
                raise KeyError(f"unmapped update parameter: {key}")
            name = f"update.{_SEQ_MAP[rest]}"
        else:
            raise KeyError(f"unmapped parameter: {key}")
        out[f"{name}.{leaf}"] = value.to(torch.float32).contiguous()
    return out


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``droid.pth`` → a state dict for :class:`DroidNet`."""
    return state_dict_from_reference(torch.load(path, map_location="cpu", weights_only=True))


def load_weights(path: str) -> Dict[str, torch.Tensor]:
    """A weights file → a state dict for :class:`DroidNet`: a ``.pth`` or
    ``.pt`` file holding the port's own state dict (the parameter
    checkpoints of ``train/checkpoints.py``) or a reference checkpoint, else
    a flax msgpack file of the JAX package."""
    if path.endswith((".pth", ".pt")):
        state = torch.load(path, map_location="cpu", weights_only=True)
        if set(state) == set(DroidNet().state_dict()):
            return {k: torch.as_tensor(v).to(torch.float32).contiguous() for k, v in state.items()}
        return state_dict_from_reference(state)
    return params_from_jax(load_params(path))
