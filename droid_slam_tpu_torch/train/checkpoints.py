"""Checkpoints of training, on ``torch.save``.

Counterpart of the JAX package's ``train/checkpoints.py``: parameter-only
files (a state dict of :class:`..models.droid_net.DroidNet`, which
:func:`..models.weights.load_weights` reads, so a model trained here tracks
through ``apps/evaluate.py``) and the full train state (parameters,
optimizer state, step) that ``apps/train.py --resume`` restores, a
capability the reference lacks (it restores parameters only,
train.py:57-58).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch

from ..models.weights import load_weights


def _cpu_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def save_params(path: str, model: torch.nn.Module) -> None:
    """Parameter-only checkpoint: the model's state dict."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(_cpu_state(model), path)


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """A state dict for DroidNet from a checkpoint of this module, the JAX
    package's ``.msgpack`` or a reference ``.pth`` (:func:`load_weights`)."""
    return load_weights(path)


def save_train_state(path: str, state: Dict[str, Any]) -> None:
    """The full train state of :func:`..train.trainer.init_state`: the
    model's parameters, the optimizer's state and the step."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"params": _cpu_state(state["model"]), "opt_state": state["optimizer"].state_dict(),
                "step": int(state["step"])}, path)


def restore_train_state(path: str, state: Dict[str, Any]) -> Dict[str, Any]:
    """Load a saved train state into ``state`` (its model and optimizer, on
    their device) and return it."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    state["model"].load_state_dict(saved["params"])
    state["optimizer"].load_state_dict(saved["opt_state"])
    state["step"] = int(saved["step"])
    return state
