"""Carry JAX/flax parameter trees over to the port's modules.

The JAX package keeps DroidNet parameters as ``{'params': {'fnet', 'cnet',
'update'}}`` with flax conv kernels in HWIO. The port's module names are the
flax names (``fnet.layer2_0.conv1``, ``fnet.layer2_0.downsample``,
``update.corr_enc1``, ``update.gru.convz_glo``, ``update.agg.eta``, ...), so
the mapping is by path: ``kernel`` → ``weight`` transposed to OIHW,
``bias`` → ``bias``. The delta and weight heads are natively 2-channel in
both packages.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


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
