"""SE(3) Lie-group operations on quaternion-parameterised poses (PyTorch).

Poses are tensors of shape ``(..., 7)`` laid out as ``[tx, ty, tz, qx, qy,
qz, qw]`` (translation, then xyzw unit quaternion), the layout of the JAX
package's ``ops/lie.py``. All functions broadcast over leading axes.

The Taylor switch points are those of the reference float32 code:
``theta_sq < 1e-8`` for the SO(3) exponential and ``theta <= 1e-4`` for the
SE(3) V-matrix terms (src/lie_groups.h:57-122), so Gauss-Newton trajectories
agree between the two packages.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _cos(x: Tensor) -> Tensor:
    """cos rounded from float64. PyTorch's vectorised float32 cos is not
    correctly rounded near 0 (it gives cos(2.66e-4) = 1.0, one ulp off), and
    the (1 − cos θ)/θ² terms below turn that ulp into an O(1) error; the
    float64 value rounds as the reference's float32 math does."""
    return torch.cos(x.double()).to(x.dtype)


def _sin(x: Tensor) -> Tensor:
    return torch.sin(x.double()).to(x.dtype)


def constant(values, like: Tensor) -> Tensor:
    """``torch.tensor(values)`` with ``like``'s dtype and device, written on
    the device by fill kernels: a copy from the host would wait for the
    device, and is refused while a CUDA graph is being captured."""
    out = like.new_zeros(len(values))
    for i, v in enumerate(values):
        if v != 0:
            out[i].fill_(v)
    return out


def _cross(a: Tensor, b: Tensor) -> Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


# -----------------------------------------------------------------------------
# quaternion primitives (xyzw layout, Hamilton product)
# -----------------------------------------------------------------------------


def quat_mul(q1: Tensor, q2: Tensor) -> Tensor:
    """Hamilton product q1 ⊗ q2 for xyzw quaternions."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
            w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_conj(q: Tensor) -> Tensor:
    """Conjugate (= inverse for unit quaternions)."""
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_rotate(q: Tensor, x: Tensor) -> Tensor:
    """Rotate 3-vectors ``x`` by unit quaternions ``q`` (two-cross-product
    form of ``actSO3``, src/lie_groups.h:5-15)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    uv = 2.0 * _cross(qv, x)
    return x + qw * uv + _cross(qv, uv)


# -----------------------------------------------------------------------------
# SE(3) group operations on (..., 7) pose tensors
# -----------------------------------------------------------------------------


def identity(shape=(), dtype=torch.float32, device=None) -> Tensor:
    """Identity pose(s) of shape ``shape + (7,)``."""
    pose = torch.zeros(tuple(shape) + (7,), dtype=dtype, device=device)
    pose[..., 6].fill_(1.0)
    return pose


def translation(pose: Tensor) -> Tensor:
    return pose[..., :3]


def quaternion(pose: Tensor) -> Tensor:
    return pose[..., 3:7]


def inv(pose: Tensor) -> Tensor:
    """Group inverse: (t, q) → (−R(q)⁻¹ t, q⁻¹)."""
    q_inv = quat_conj(quaternion(pose))
    t_inv = -quat_rotate(q_inv, translation(pose))
    return torch.cat([t_inv, q_inv], dim=-1)


def mul(a: Tensor, b: Tensor) -> Tensor:
    """Group composition a ∘ b."""
    q = quat_mul(quaternion(a), quaternion(b))
    t = translation(a) + quat_rotate(quaternion(a), translation(b))
    return torch.cat([t, q], dim=-1)


def rel(pose_i: Tensor, pose_j: Tensor) -> Tensor:
    """Relative pose G_ij = G_j ∘ G_i⁻¹ (``relSE3``, src/lie_groups.h:43-54)."""
    qij = quat_mul(quaternion(pose_j), quat_conj(quaternion(pose_i)))
    tij = translation(pose_j) - quat_rotate(qij, translation(pose_i))
    return torch.cat([tij, qij], dim=-1)


def act(pose: Tensor, X: Tensor) -> Tensor:
    """Act on homogeneous points ``X = (x, y, z, h)``: Y = (R x + h t, h)
    (``actSE3``, src/lie_groups.h:17-24)."""
    Y3 = quat_rotate(quaternion(pose), X[..., :3]) + X[..., 3:4] * translation(pose)
    return torch.cat([Y3, X[..., 3:4]], dim=-1)


def adjT(pose: Tensor, X: Tensor) -> Tensor:
    """Transpose-adjoint transport of a 6-vector (``adjSE3``,
    lie_groups.h:26-41): Ji = −adjT(G_ij, Jj)."""
    q_inv = quat_conj(quaternion(pose))
    a = quat_rotate(q_inv, X[..., :3])
    b = quat_rotate(q_inv, X[..., 3:6])
    u = _cross(X[..., :3], translation(pose))
    b = b + quat_rotate(q_inv, u)
    return torch.cat([a, b], dim=-1)


# -----------------------------------------------------------------------------
# exponential / logarithm / retraction
# -----------------------------------------------------------------------------


def exp_so3(phi: Tensor) -> Tensor:
    """SO(3) exponential: axis-angle 3-vector → xyzw quaternion, with the
    Taylor branch below theta² < 1e-8 (src/lie_groups.h:57-79)."""
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    theta_p4 = theta_sq * theta_sq
    small = theta_sq < 1e-8
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
    imag_small = 0.5 - (1.0 / 48.0) * theta_sq + (1.0 / 3840.0) * theta_p4
    real_small = 1.0 - (1.0 / 8.0) * theta_sq + (1.0 / 384.0) * theta_p4
    imag = torch.where(small, imag_small, _sin(0.5 * theta) / theta)
    real = torch.where(small, real_small, _cos(0.5 * theta))
    return torch.cat([imag * phi, real], dim=-1)


def exp(xi: Tensor) -> Tensor:
    """SE(3) exponential of twists ``xi = (tau, phi)`` → pose (..., 7); the
    translation falls back to t = tau exactly when θ ≤ 1e-4
    (src/lie_groups.h:94-122)."""
    tau = xi[..., :3]
    phi = xi[..., 3:6]
    q = exp_so3(phi)

    theta_sq = (phi * phi).sum(-1, keepdim=True)
    small = theta_sq <= (1e-4) ** 2
    theta_sq_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(theta_sq_safe)

    a = (1.0 - _cos(theta)) / theta_sq_safe
    b = (theta - _sin(theta)) / (theta * theta_sq_safe)

    c1 = _cross(phi, tau)
    c2 = _cross(phi, c1)
    t = tau + torch.where(small, torch.zeros_like(c1), a * c1 + b * c2)
    return torch.cat([t, q], dim=-1)


def log_so3(q: Tensor) -> Tensor:
    """SO(3) logarithm: xyzw quaternion → principal axis-angle vector. The
    double cover is canonicalised to qw ≥ 0 first."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    flip = torch.where(qw < 0.0, -1.0, 1.0)
    qv = qv * flip
    qw = qw * flip
    nv_sq = (qv * qv).sum(-1, keepdim=True)
    small = nv_sq < 1e-14
    nv = torch.sqrt(torch.where(small, torch.ones_like(nv_sq), nv_sq))
    theta = 2.0 * torch.atan2(nv, qw)
    scale_big = theta / nv
    # series of 2/qw * (1 - nv²/(3 qw²)) around nv → 0, guarded at qw ≈ 0
    qw_safe = torch.where(qw.abs() < 1e-8, torch.ones_like(qw), qw)
    scale_small = 2.0 / qw_safe * (1.0 - nv_sq / (3.0 * qw_safe * qw_safe))
    return torch.where(small, scale_small, scale_big) * qv


def log(pose: Tensor) -> Tensor:
    """SE(3) logarithm: pose → twist (tau, phi) with exp(log(G)) = G."""
    t = translation(pose)
    phi = log_so3(quaternion(pose))

    theta_sq = (phi * phi).sum(-1, keepdim=True)
    small = theta_sq <= (1e-4) ** 2
    theta_sq_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(theta_sq_safe)

    # V⁻¹ = I − ½[phi]× + c [phi]×² with c = (1 − θ cot(θ/2) / 2) / θ²
    half = 0.5 * theta
    cot_half = _cos(half) / _sin(half)
    c_big = (1.0 - half * cot_half) / theta_sq_safe
    c = torch.where(small, torch.full_like(c_big, 1.0 / 12.0), c_big)

    c1 = _cross(phi, t)
    c2 = _cross(phi, c1)
    tau = t - 0.5 * c1 + c * c2
    return torch.cat([tau, phi], dim=-1)


def retr(pose: Tensor, xi: Tensor) -> Tensor:
    """Left-multiplicative retraction: G ← exp(xi) ∘ G (lie_groups.h:124-142)."""
    return mul(exp(xi), pose)


def normalize(pose: Tensor) -> Tensor:
    """Renormalise the quaternion part (guards against f32 drift)."""
    q = quaternion(pose)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return torch.cat([translation(pose), q], dim=-1)


def to_matrix(pose: Tensor) -> Tensor:
    """Pose → 4×4 homogeneous matrix."""
    x, y, z, w = quaternion(pose).unbind(-1)
    R = torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )
    top = torch.cat([R, translation(pose)[..., :, None]], dim=-1)
    bottom = constant((0.0, 0.0, 0.0, 1.0), pose).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


# -----------------------------------------------------------------------------
# Sim(3): similarity transforms (t[3], q[4], s[1]) as (..., 8) tensors
# -----------------------------------------------------------------------------
# The layout of lietorch and of the JAX package: translation, xyzw
# quaternion, scale.


def sim3_identity(shape=(), dtype=torch.float32, device=None) -> Tensor:
    g = torch.zeros(tuple(shape) + (8,), dtype=dtype, device=device)
    g[..., 6:8] = 1.0
    return g


def sim3_scale(g: Tensor) -> Tensor:
    return g[..., 7:8]


def sim3_act(g: Tensor, x: Tensor) -> Tensor:
    """Apply s·R·x + t to 3-points."""
    return sim3_scale(g) * quat_rotate(g[..., 3:7], x) + g[..., :3]


def sim3_mul(a: Tensor, b: Tensor) -> Tensor:
    """(a ∘ b): scale s_a s_b, rotation q_a q_b, translation t_a + s_a R_a t_b."""
    t = a[..., :3] + sim3_scale(a) * quat_rotate(a[..., 3:7], b[..., :3])
    q = quat_mul(a[..., 3:7], b[..., 3:7])
    s = sim3_scale(a) * sim3_scale(b)
    return torch.cat([t, q, s], dim=-1)


def sim3_inv(g: Tensor) -> Tensor:
    q_inv = quat_conj(g[..., 3:7])
    s_inv = 1.0 / sim3_scale(g)
    t_inv = -s_inv * quat_rotate(q_inv, g[..., :3])
    return torch.cat([t_inv, q_inv, s_inv], dim=-1)


def sim3_exp(xi: Tensor) -> Tensor:
    """Sim(3) exponential of twists (tau, phi, sigma) → (..., 8).

    t = W·tau with W = C·I + A·[phi]× + B·[phi]×², s = e^sigma, theta =
    |phi|, a = s·sinθ, b = s·cosθ:

        C = (s − 1)/sigma
        A = (a·σ + (1 − b)·θ) / (θ·(θ² + σ²))
        B = (C − ((b − 1)σ + a·θ)/(θ² + σ²)) / θ²

    with the θ→0 and σ→0 limits where these are indeterminate (the branch
    structure of Sophus's calcW, as in the JAX package).
    """
    tau = xi[..., :3]
    phi = xi[..., 3:6]
    sigma = xi[..., 6:7]
    q = exp_so3(phi)
    s = torch.exp(sigma)

    theta_sq = (phi * phi).sum(-1, keepdim=True)
    small_t = theta_sq < 1e-10
    theta_sq_safe = torch.where(small_t, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(theta_sq_safe)
    small_s = sigma.abs() < 1e-5
    sigma_safe = torch.where(small_s, torch.ones_like(sigma), sigma)

    C = torch.where(small_s, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, (s - 1.0) / sigma_safe)

    # sigma small: the SE(3) coefficients
    A_s0 = torch.where(small_t, 0.5 - theta_sq / 24.0, (1.0 - _cos(theta)) / theta_sq_safe)
    B_s0 = torch.where(small_t, 1.0 / 6.0 - theta_sq / 120.0,
                       (theta - _sin(theta)) / (theta * theta_sq_safe))
    # sigma not small, theta small
    A_t0 = ((sigma_safe - 1.0) * s + 1.0) / (sigma_safe * sigma_safe)
    B_t0 = (C - s * (1.0 - sigma_safe / 2.0)) / (sigma_safe * sigma_safe)
    # general case
    a = s * _sin(theta)
    b = s * _cos(theta)
    c = theta_sq_safe + sigma * sigma
    A_g = (a * sigma + (1.0 - b) * theta) / (theta * c)
    B_g = (C - ((b - 1.0) * sigma + a * theta) / c) / theta_sq_safe

    A = torch.where(small_s, A_s0, torch.where(small_t, A_t0, A_g))
    B = torch.where(small_s, B_s0, torch.where(small_t, B_t0, B_g))

    c1 = _cross(phi, tau)
    c2 = _cross(phi, c1)
    t = C * tau + A * c1 + B * c2
    return torch.cat([t, q, s], dim=-1)


def sim3_retr(g: Tensor, xi: Tensor) -> Tensor:
    """Left-multiplicative Sim(3) retraction: g ← exp(xi) ∘ g."""
    return sim3_mul(sim3_exp(xi), g)
