"""Process groups as the port's mesh: the device check that every
collective of the port makes first, and the gather of rows.

A collective of the port runs on the device of the tensors it is given,
through the group's backend for that device type: NCCL for CUDA tensors,
gloo for CPU tensors. Gloo can take CUDA tensors for some collectives by
staging them through the host; the port never lets it, so a group that has
no NCCL backend refuses CUDA tensors and one without gloo refuses CPU
tensors (:func:`check_device`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# the backend that carries each device type's tensors
_BACKEND_FOR = {"cuda": "nccl", "cpu": "gloo"}


def _backends(group) -> dict:
    """{device type: backend name} of a group. ``dist.get_backend`` gives
    one name ("gloo", "nccl") or a list of pairs ("cpu:gloo,cuda:nccl")."""
    name = str(dist.get_backend(group)).lower()
    if ":" not in name:
        return {dev: name for dev, want in _BACKEND_FOR.items() if want == name}
    return dict(pair.split(":", 1) for pair in name.split(","))


def carries(group, device) -> bool:
    """Whether ``group`` carries tensors of ``device``'s type with the
    backend the port uses for it (NCCL for CUDA, gloo for the CPU)."""
    dev = torch.device(device).type
    return dev in _BACKEND_FOR and _backends(group).get(dev) == _BACKEND_FOR[dev]


def check_device(group, device) -> None:
    """Raise unless ``group`` :func:`carries` ``device``'s tensors."""
    dev = torch.device(device).type
    want = _BACKEND_FOR.get(dev)
    if not carries(group, device):
        raise RuntimeError(
            f"process group with backend {dist.get_backend(group)!r} cannot carry {dev} tensors: "
            f"the port's collectives on {dev} tensors need a {want or 'supported'} group "
            "(make one with dist.new_group(backend=...) on this device's backend)"
        )


def all_gather_rows(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """Gather every rank's ``inp`` [n, ...] into ``out`` [D·n, ...] in rank
    order (the concatenated layout, which gloo requires too)."""
    dist.all_gather_into_tensor(out, inp.contiguous(), group=group)
