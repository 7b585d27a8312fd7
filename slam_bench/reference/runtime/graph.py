"""The fused step's branches: :func:`cond`, the port's ``lax.cond``, as
the reference runs it.

The fused tracking step (:mod:`.fused`) takes each of its branches
through :func:`cond`, and each branch writes its results into the state's
own storage. The reference runs it eagerly only: it reads the predicate
once on the host and runs one branch (at most 3 reads per frame). The
port's capture of the step into one CUDA graph, with the branches as
conditional nodes, is not copied: the reference captures nothing.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

Tensor = torch.Tensor


def cond(pred: Tensor, true_fn: Callable, false_fn: Optional[Callable], operand) -> None:
    """``true_fn(operand)`` where the 0-dim bool ``pred`` holds, else
    ``false_fn(operand)`` (nothing if it is None). Both write their results
    into ``operand`` in place; neither returns anything."""
    if bool(pred):
        true_fn(operand)
    elif false_fn is not None:
        false_fn(operand)
