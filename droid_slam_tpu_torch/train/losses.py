"""Training losses (PyTorch): geodesic pose loss, BA-residual loss, flow loss.

Counterpart of the JAX package's ``train/losses.py`` (reference
geom/losses.py). Each takes the per-step stacked outputs of
:meth:`..models.droid_net.DroidNet.forward` ([S, B, ...]) and returns
(scalar loss, metrics dict of 0-dim tensors); step s of S is weighted by
gamma^(S−1−s) (losses.py:42,83,106).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..ops import lie
from ..ops import projective as pops

Tensor = torch.Tensor


def _step_weights(n: int, gamma: float, device=None) -> Tensor:
    return gamma ** torch.arange(n - 1, -1, -1, dtype=torch.float32, device=device)


def _safe_norm(x: Tensor, dim: int = -1) -> Tensor:
    """L2 norm with a finite gradient at 0: d‖x‖/dx = x/‖x‖ is NaN at
    exactly 0, and masking the value does not mask the gradient, so one
    pixel whose estimate equals the ground truth bit for bit would poison
    the whole gradient. The 1e-12 floor moves the loss by ≤ 1e-6."""
    return torch.sqrt((x * x).sum(dim) + 1e-12)


def _relative(poses: Tensor, ii: Tensor, jj: Tensor) -> Tensor:
    """dP = P[jj] ∘ P[ii]⁻¹ along the frame axis (dim -2)."""
    return lie.rel(poses[..., ii, :], poses[..., jj, :])


def fit_scale(dP: Tensor, dG: Tensor) -> Tensor:
    """Least-squares translation scale between relative-pose sets
    (losses.py:21-27). dP, dG [..., B, N, 7] → [..., B]."""
    t1 = dP[..., :3].flatten(-2)
    t2 = dG[..., :3].flatten(-2)
    return (t1 * t2).sum(-1) / ((t2 * t2).sum(-1) + 1e-8)


def geodesic_loss(
    Ps: Tensor,  # [B, F, 7] ground-truth poses
    Gs_steps: Tensor,  # [S, B, F, 7] per-step estimates
    ii: Tensor,
    jj: Tensor,
    gamma: float = 0.9,
    do_scale: bool = True,
    edge_valid: Optional[Tensor] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """γ-weighted relative-pose geodesic distance (losses.py:30-74), with an
    optional per-sample scale fit (detached) for the monocular gauge.
    ``edge_valid`` masks padded edges of randomised graphs."""
    S = Gs_steps.shape[0]
    dP = _relative(Ps, ii, jj)  # [B, N, 7]
    w = _step_weights(S, gamma, Ps.device)
    if edge_valid is None:
        edge_valid = torch.ones(ii.shape, dtype=torch.bool, device=Ps.device)
    ev = edge_valid.float()  # [N]
    count = (ev * torch.ones(dP.shape[0], 1, device=Ps.device)).sum().clamp(min=1.0)

    def masked_mean(x):  # over the trailing [B, N]
        return (x * ev).sum((-1, -2)) / count

    dG = _relative(Gs_steps, ii, jj)  # [S, B, N, 7]
    if do_scale:
        s = fit_scale(dP, dG).detach()
        dG = torch.cat([dG[..., :3] * s[..., None, None], dG[..., 3:]], dim=-1)
    dE = lie.mul(dG, lie.inv(dP))  # [S, B, N, 7] error transforms
    d = lie.log(dE)
    tau = _safe_norm(d[..., :3])
    phi = _safe_norm(d[..., 3:])
    # the metric translation error is the group element's translation norm
    # (reference pose_metrics, geom/losses.py:9-18), not the tangent's
    t_grp = _safe_norm(dE[..., :3])
    total = (w * (masked_mean(tau) + masked_mean(phi))).sum()

    r_err = (180.0 / math.pi) * phi[-1]
    t_err = t_grp[-1]
    metrics = {
        "rot_error": masked_mean(r_err),
        "tr_error": masked_mean(t_err),
        "bad_rot": masked_mean((r_err < 0.1).float()),
        "bad_tr": masked_mean((t_err < 0.01).float()),
    }
    return total, metrics


def residual_loss(residuals: Tensor, gamma: float = 0.9,
                  edge_valid: Optional[Tensor] = None) -> Tuple[Tensor, Dict[str, Tensor]]:
    """γ-weighted mean |BA flow residual| (losses.py:77-86). residuals
    [S, E, h, w, 2] with E = B·N edge slots; ``edge_valid`` [E] averages
    over the valid slots only (padded slots' residuals are zero already,
    and counting them would weight the loss by n_valid/n_pad)."""
    S = residuals.shape[0]
    w = _step_weights(S, gamma, residuals.device)
    flat = residuals.reshape(S, residuals.shape[1], -1).abs()
    if edge_valid is None:
        per_step = flat.mean(dim=(1, 2))
    else:
        ev = edge_valid.to(flat.dtype)
        denom = ev.sum().clamp(min=1.0) * flat.shape[-1]
        per_step = (flat * ev[None, :, None]).sum(dim=(1, 2)) / denom
    total = (w * per_step).sum()
    return total, {"residual": total}


def flow_loss(
    Ps: Tensor,  # [B, F, 7] ground-truth poses
    disps: Tensor,  # [B, F, H, W] ground-truth inverse depth (full resolution)
    poses_steps: Tensor,  # [S, B, F, 7]
    disps_steps: Tensor,  # [S, B, F, H, W] estimated, upsampled (full resolution)
    intrinsics: Tensor,  # [B, F, 4] full resolution
    gamma: float = 0.9,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """End-point error of the induced flow against the ground truth's on
    the adjacent-frame graph, at full image resolution as the reference
    computes it (losses.py:89-118, train.py:112). Each step's transform is
    recomputed in the backward pass (checkpointed), so no per-pixel tensor
    is kept across steps; the metrics read the last step only."""
    S = poses_steps.shape[0]
    F = Ps.shape[1]
    dev = Ps.device
    pairs = [(a, b) for a in range(F) for b in range(F) if abs(a - b) == 1]
    ii = torch.tensor([a for a, _ in pairs], dtype=torch.long, device=dev)
    jj = torch.tensor([b for _, b in pairs], dtype=torch.long, device=dev)

    def transform(G, d):
        return pops.projective_transform_batched(G, d, intrinsics, ii, jj)

    coords0, val0 = transform(Ps, disps)
    val0 = val0 * (disps[:, ii] > 0).to(val0.dtype)[..., None]
    w = _step_weights(S, gamma, dev)

    def one_step(G, d):
        coords1, val1 = transform(G, d)
        v = (val0 * val1)[..., 0]
        return (v * _safe_norm(coords1 - coords0)).mean()

    run = (lambda *a: checkpoint(one_step, *a, use_reentrant=False)) if torch.is_grad_enabled() else one_step
    losses = torch.stack([run(poses_steps[s], disps_steps[s]) for s in range(S)])
    total = (w * losses).sum()

    with torch.no_grad():
        coords1, val1 = transform(poses_steps[-1], disps_steps[-1])
        last_v = ((val0 * val1)[..., 0] > 0.5).reshape(-1)
        last_epe = _safe_norm(coords1 - coords0).reshape(-1)
        denom = last_v.sum().clamp(min=1).float()
        zero = torch.zeros((), device=dev)
        metrics = {
            "f_error": torch.where(last_v, last_epe, zero).sum() / denom,
            "1px": torch.where(last_v & (last_epe < 1.0), 1.0, zero).sum() / denom,
        }
    return total, metrics
