"""Hand-written backward of the preprocess stage, on torch tensors.

Port of ``gstpu/ops/preprocess_bwd.py``: vectorized adjoints that follow the
reference's hand-written backward kernels stage for stage.  They are not the
exact adjoint of the forward in two places, and parity with the reference
needs its math, not the ideal one:

Q12 (EWA transform mismatch): the forward builds ``T_f = J @ V3`` with
    ``V3 = view[:3,:3]`` as stored, while the backward builds
    ``T_b = V3 @ J^T`` and differentiates ``cov2d = T_b^T Vrk T_b``; the
    stored matrix is the transposed world-to-camera, so ``T_b != T_f^T``
    for camera rotations that are not symmetric.

Q13 (cov3d decomposition mismatch): the forward computes
    ``Sigma = (R S)(R S)^T``, while the backward differentiates
    ``Sigma = (S R)^T (S R)``; the two differ by a quaternion conjugation.

Both are kept when ``parity=True`` (the default); ``parity=False`` takes the
consistent adjoint of the port's own forward through autograd.  Q15 (a
constant camera-translation bias in position gradients) is opt-in through
``translation_bias``.  Every small matrix product is written out term by
term, as in ``math3d``, so no matmul (and no TF32 path) is involved.
"""

from __future__ import annotations

import torch

from gstpu_torch.ops import math3d
from gstpu_torch.ops.math3d import SH_C0, SH_C1, SH_C2, SH_C3


def dnormvdv(v: torch.Tensor, dv: torch.Tensor) -> torch.Tensor:
    """Adjoint of vector normalization, batched (N,3)."""
    sum2 = torch.sum(v * v, dim=-1)
    ok = sum2 >= 1e-10
    sum2s = torch.where(ok, sum2, 1.0)
    invsum32 = 1.0 / torch.sqrt(sum2s * sum2s * sum2s)
    vdv = torch.sum(v * dv, dim=-1, keepdim=True)
    out = (sum2s[..., None] * dv - v * vdv) * invsum32[..., None]
    return torch.where(ok[..., None], out, 0.0)


def _visible(radii: torch.Tensor) -> torch.Tensor:
    """(N, 1) True for the Gaussians the forward kept.  Culled Gaussians'
    terms are dropped with ``torch.where``, not multiplied by nought: at
    view-space depth 0 they overflow, and nought times inf is NaN."""
    return (radii > 0)[:, None]


def cov2d_backward(means: torch.Tensor, cov3d: torch.Tensor,
                   radii: torch.Tensor, focal_x: float, focal_y: float,
                   tan_fovx: float, tan_fovy: float, view: torch.Tensor,
                   dL_dconic: torch.Tensor, parity: bool = True,
                   translation_bias: bool = False):
    """Adjoint of the EWA projection and the conic inversion.

    ``dL_dconic``: (N,3) gradients w.r.t. the conic (a, b, c), b in the
    reference's half convention.  Returns (dL_dmeans contribution (N,3),
    dL_dcov3d (N,6)).

    Q15: the reference transforms the view-space gradient as
    ``vec4(dt, 1) * view^T``, which adds the camera translation column of
    the stored view matrix to every visible Gaussian's position gradient.
    ``translation_bias=True`` keeps that; the default transforms the
    direction only.
    """
    dtype = means.dtype
    if not parity:
        # the true adjoint of the port's conic (EWA + blur + inversion); the
        # incoming b gradient is half the true one, so double it
        with torch.enable_grad():
            m = means.detach().requires_grad_(True)
            c6 = cov3d.detach().requires_grad_(True)
            cov2d = math3d.compute_cov2d(m, c6, view, tan_fovx, tan_fovy,
                                         2.0 * focal_x * tan_fovx,
                                         2.0 * focal_y * tan_fovy)
            a = cov2d[:, 0] + 0.3
            b = cov2d[:, 1]
            c = cov2d[:, 2] + 0.3
            det = a * c - b * b
            det_inv = 1.0 / torch.where(det == 0.0, 1.0, det)
            conic = torch.stack([c * det_inv, -b * det_inv, a * det_inv], -1)
            ct = dL_dconic * torch.tensor([1.0, 2.0, 1.0], dtype=dtype,
                                          device=means.device)
            dmean, dcov3d = torch.autograd.grad(conic, (m, c6), ct)
        vis = _visible(radii)
        return torch.where(vis, dmean, 0.0), torch.where(vis, dcov3d, 0.0)

    t = math3d.transform_points(means, view)
    tz = t[:, 2]
    inv_tz = 1.0 / tz
    txtz = t[:, 0] * inv_tz
    tytz = t[:, 1] * inv_tz
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    x_grad_mul = 1.0 - ((txtz < -limx) | (txtz > limx)).to(dtype)
    y_grad_mul = 1.0 - ((tytz < -limy) | (tytz > limy)).to(dtype)
    tx = torch.clamp(txtz, -limx, limx) * tz
    ty = torch.clamp(tytz, -limy, limy) * tz
    inv_tz2 = inv_tz * inv_tz
    inv_tz3 = inv_tz2 * inv_tz

    J00 = focal_x * inv_tz
    J11 = focal_y * inv_tz
    J02 = -focal_x * tx * inv_tz2
    J12 = -focal_y * ty * inv_tz2

    W3 = view[:3, :3]
    # T_b = W3 @ J^T (Q12: not the transpose of the forward's T_f = J @ W3)
    T00 = W3[0, 0] * J00 + W3[0, 2] * J02
    T10 = W3[1, 0] * J00 + W3[1, 2] * J02
    T20 = W3[2, 0] * J00 + W3[2, 2] * J02
    T01 = W3[0, 1] * J11 + W3[0, 2] * J12
    T11 = W3[1, 1] * J11 + W3[1, 2] * J12
    T21 = W3[2, 1] * J11 + W3[2, 2] * J12

    # cov2d = A Vrk A^T with A = T_b^T: cov_ab = Tcol_a . (Vrk @ Tcol_b)
    c00, c01, c02 = cov3d[:, 0], cov3d[:, 1], cov3d[:, 2]
    c11, c12, c22 = cov3d[:, 3], cov3d[:, 4], cov3d[:, 5]

    def vdot(t0, t1, t2):
        return (c00 * t0 + c01 * t1 + c02 * t2,
                c01 * t0 + c11 * t1 + c12 * t2,
                c02 * t0 + c12 * t1 + c22 * t2)

    u0 = vdot(T00, T10, T20)
    u1 = vdot(T01, T11, T21)
    a = T00 * u0[0] + T10 * u0[1] + T20 * u0[2] + 0.3
    b = T00 * u1[0] + T10 * u1[1] + T20 * u1[2]
    c = T01 * u1[0] + T11 * u1[1] + T21 * u1[2] + 0.3

    denom = a * c - b * b
    denom_ok = denom != 0.0
    denom2inv = torch.where(denom_ok, 1.0 / (denom * denom + 1e-7), 0.0)
    dc_a, dc_b, dc_c = dL_dconic[:, 0], dL_dconic[:, 1], dL_dconic[:, 2]
    # adjoint of the 2x2 inverse
    dL_da = denom2inv * (-c * c * dc_a + 2.0 * b * c * dc_b
                         + (denom - a * c) * dc_c)
    dL_dc = denom2inv * (-a * a * dc_c + 2.0 * a * b * dc_b
                         + (denom - a * c) * dc_a)
    dL_db = denom2inv * 2.0 * (b * c * dc_a - (denom + 2.0 * b * b) * dc_b
                               + a * b * dc_c)

    # dL/dSigma3D through cov2d = T^T Vrk T, packed upper triangle
    dcov3d = torch.stack([
        T00 * T00 * dL_da + T00 * T01 * dL_db + T01 * T01 * dL_dc,
        2.0 * T00 * T10 * dL_da + (T00 * T11 + T10 * T01) * dL_db
        + 2.0 * T01 * T11 * dL_dc,
        2.0 * T00 * T20 * dL_da + (T00 * T21 + T20 * T01) * dL_db
        + 2.0 * T01 * T21 * dL_dc,
        T10 * T10 * dL_da + T10 * T11 * dL_db + T11 * T11 * dL_dc,
        2.0 * T20 * T10 * dL_da + (T10 * T21 + T20 * T11) * dL_db
        + 2.0 * T11 * T21 * dL_dc,
        T20 * T20 * dL_da + T20 * T21 * dL_db + T21 * T21 * dL_dc,
    ], dim=-1)

    # dL/dT by the product rule; (Vrk @ Tcol_a)[k] are the u_a[k] above
    (tv0_0, tv0_1, tv0_2) = u0
    (tv1_0, tv1_1, tv1_2) = u1
    dT00 = 2.0 * tv0_0 * dL_da + tv1_0 * dL_db
    dT01 = 2.0 * tv0_1 * dL_da + tv1_1 * dL_db
    dT02 = 2.0 * tv0_2 * dL_da + tv1_2 * dL_db
    dT10 = 2.0 * tv1_0 * dL_dc + tv0_0 * dL_db
    dT11 = 2.0 * tv1_1 * dL_dc + tv0_1 * dL_db
    dT12 = 2.0 * tv1_2 * dL_dc + tv0_2 * dL_db

    # dL/dJ = W^T dL/dT
    dJ00 = W3[0, 0] * dT00 + W3[1, 0] * dT01 + W3[2, 0] * dT02
    dJ02 = W3[0, 2] * dT00 + W3[1, 2] * dT01 + W3[2, 2] * dT02
    dJ11 = W3[0, 1] * dT10 + W3[1, 1] * dT11 + W3[2, 1] * dT12
    dJ12 = W3[0, 2] * dT10 + W3[1, 2] * dT11 + W3[2, 2] * dT12

    # dL/d(view-space position)
    dtx = -focal_x * inv_tz2 * dJ02
    dty = -focal_y * inv_tz2 * dJ12
    dtz = (-focal_x * inv_tz2 * dJ00 - focal_y * inv_tz2 * dJ11
           + 2.0 * focal_x * tx * inv_tz3 * dJ02
           + 2.0 * focal_y * ty * inv_tz3 * dJ12)
    dt = (dtx * x_grad_mul, dty * y_grad_mul, dtz)
    # world-space gradient: dt @ view.T, with the w = 1 of Q15 adding the
    # translation row view[j, 3]
    dmean = torch.stack(
        [dt[0] * view[j, 0] + dt[1] * view[j, 1] + dt[2] * view[j, 2]
         + (view[j, 3] if translation_bias else 0.0) for j in range(3)],
        dim=-1)
    vis = _visible(radii)
    return torch.where(vis, dmean, 0.0), torch.where(vis, dcov3d, 0.0)


def projection_backward(means: torch.Tensor, radii: torch.Tensor,
                        proj: torch.Tensor,
                        dL_dmean2d: torch.Tensor) -> torch.Tensor:
    """Adjoint of the perspective projection of the mean.

    ``dL_dmean2d``: (N,2) NDC-space gradients.
    """
    m_hom = math3d.transform_points(means, proj)
    m_w = 1.0 / (m_hom[:, 3] + 1e-7)
    mul1 = m_hom[:, 0] * m_w * m_w
    mul2 = m_hom[:, 1] * m_w * m_w
    gx, gy = dL_dmean2d[:, 0], dL_dmean2d[:, 1]
    dmean = torch.stack([
        (proj[i, 0] * m_w - proj[i, 3] * mul1) * gx
        + (proj[i, 1] * m_w - proj[i, 3] * mul2) * gy for i in range(3)],
        dim=-1)
    return torch.where(_visible(radii), dmean, 0.0)


def sh_backward(means: torch.Tensor, shs: torch.Tensor, radii: torch.Tensor,
                campos: torch.Tensor, clamped: torch.Tensor,
                dL_dcolor: torch.Tensor, degree: int):
    """Adjoint of the SH color evaluation.

    Returns (dL_dshs (N,16,3), dL_dmeans contribution (N,3)).
    """
    n = means.shape[0]
    dtype = means.dtype
    dir_orig = means - campos[None, :]
    dir_len = torch.linalg.vector_norm(dir_orig, dim=-1)
    ok = (radii > 0) & (dir_len >= 1e-8)
    dirs = dir_orig / torch.clamp(dir_len, min=1e-12)[:, None]
    x = dirs[:, 0:1]
    y = dirs[:, 1:2]
    z = dirs[:, 2:3]

    # clamped channels get no gradient
    dL_dRGB = dL_dcolor * (1.0 - clamped)

    zero = torch.zeros((n, 3), dtype=dtype, device=means.device)
    dsh = [SH_C0 * dL_dRGB] + [zero] * 15
    dRGBdx = dRGBdy = dRGBdz = zero
    if degree > 0:
        sh1, sh2, sh3 = shs[:, 1], shs[:, 2], shs[:, 3]
        dsh[1] = -SH_C1 * y * dL_dRGB
        dsh[2] = SH_C1 * z * dL_dRGB
        dsh[3] = -SH_C1 * x * dL_dRGB
        dRGBdx = -SH_C1 * sh3
        dRGBdy = -SH_C1 * sh1
        dRGBdz = SH_C1 * sh2
        if degree > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            sh4, sh5, sh6, sh7, sh8 = (shs[:, i] for i in range(4, 9))
            dsh[4] = SH_C2[0] * xy * dL_dRGB
            dsh[5] = SH_C2[1] * yz * dL_dRGB
            dsh[6] = SH_C2[2] * (2.0 * zz - xx - yy) * dL_dRGB
            dsh[7] = SH_C2[3] * xz * dL_dRGB
            dsh[8] = SH_C2[4] * (xx - yy) * dL_dRGB
            dRGBdx = dRGBdx + (SH_C2[0] * y * sh4 + SH_C2[2] * 2.0 * -x * sh6
                               + SH_C2[3] * z * sh7 + SH_C2[4] * 2.0 * x * sh8)
            dRGBdy = dRGBdy + (SH_C2[0] * x * sh4 + SH_C2[1] * z * sh5
                               + SH_C2[2] * 2.0 * -y * sh6
                               + SH_C2[4] * 2.0 * -y * sh8)
            dRGBdz = dRGBdz + (SH_C2[1] * y * sh5 + SH_C2[2] * 4.0 * z * sh6
                               + SH_C2[3] * x * sh7)
            if degree > 2:
                sh9, sh10, sh11, sh12, sh13, sh14, sh15 = (
                    shs[:, i] for i in range(9, 16))
                dsh[9] = SH_C3[0] * y * (3.0 * xx - yy) * dL_dRGB
                dsh[10] = SH_C3[1] * xy * z * dL_dRGB
                dsh[11] = SH_C3[2] * y * (4.0 * zz - xx - yy) * dL_dRGB
                dsh[12] = (SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy)
                           * dL_dRGB)
                dsh[13] = SH_C3[4] * x * (4.0 * zz - xx - yy) * dL_dRGB
                dsh[14] = SH_C3[5] * z * (xx - yy) * dL_dRGB
                dsh[15] = SH_C3[6] * x * (xx - 3.0 * yy) * dL_dRGB
                dRGBdx = dRGBdx + (
                    SH_C3[0] * sh9 * 3.0 * 2.0 * xy
                    + SH_C3[1] * sh10 * yz
                    + SH_C3[2] * sh11 * -2.0 * xy
                    + SH_C3[3] * sh12 * -3.0 * 2.0 * xz
                    + SH_C3[4] * sh13 * (-3.0 * xx + 4.0 * zz - yy)
                    + SH_C3[5] * sh14 * 2.0 * xz
                    + SH_C3[6] * sh15 * 3.0 * (xx - yy))
                dRGBdy = dRGBdy + (
                    SH_C3[0] * sh9 * 3.0 * (xx - yy)
                    + SH_C3[1] * sh10 * xz
                    + SH_C3[2] * sh11 * (-3.0 * yy + 4.0 * zz - xx)
                    + SH_C3[3] * sh12 * -3.0 * 2.0 * yz
                    + SH_C3[4] * sh13 * -2.0 * xy
                    + SH_C3[5] * sh14 * -2.0 * yz
                    + SH_C3[6] * sh15 * -3.0 * 2.0 * xy)
                dRGBdz = dRGBdz + (
                    SH_C3[1] * sh10 * xy
                    + SH_C3[2] * sh11 * 4.0 * 2.0 * yz
                    + SH_C3[3] * sh12 * 3.0 * (2.0 * zz - xx - yy)
                    + SH_C3[4] * sh13 * 4.0 * 2.0 * xz
                    + SH_C3[5] * sh14 * (xx - yy))

    dL_ddir = torch.stack([torch.sum(dRGBdx * dL_dRGB, dim=-1),
                           torch.sum(dRGBdy * dL_dRGB, dim=-1),
                           torch.sum(dRGBdz * dL_dRGB, dim=-1)], dim=-1)
    dmean = dnormvdv(dir_orig, dL_ddir)
    okf = ok.to(dtype)
    return torch.stack(dsh, dim=1) * okf[:, None, None], dmean * okf[:, None]


def cov3d_backward(scales: torch.Tensor, rotations: torch.Tensor,
                   radii: torch.Tensor, scale_modifier: float,
                   dL_dcov3d: torch.Tensor, parity: bool = True):
    """Adjoint of the scale/rotation -> 3D covariance decomposition.

    With ``parity=True`` this is the reference's backward (Q13: not the
    adjoint of the forward ``Sigma = (R S)(R S)^T``); with ``parity=False``
    it is the true adjoint of ``math3d.compute_cov3d`` through autograd.
    Returns (dL_dscales (N,3), dL_drots (N,4) in (x,y,z,w) order).
    """
    vis = _visible(radii)
    if not parity:
        with torch.enable_grad():
            s_ = scales.detach().requires_grad_(True)
            q_ = rotations.detach().requires_grad_(True)
            cov = math3d.compute_cov3d(s_, scale_modifier, q_)
            dscale, drot = torch.autograd.grad(cov, (s_, q_), dL_dcov3d)
        return torch.where(vis, dscale, 0.0), torch.where(vis, drot, 0.0)

    q = rotations
    r = q[:, 3]
    x, y, z = q[:, 0], q[:, 1], q[:, 2]
    R = math3d.quat_to_rotmat(q)
    s = scale_modifier * scales

    # M = S @ R, dM = 2 M dSigma with the packed symmetric dSigma
    # (off-diagonals halved)
    d = dL_dcov3d
    dS = [[d[:, 0], 0.5 * d[:, 1], 0.5 * d[:, 2]],
          [0.5 * d[:, 1], d[:, 3], 0.5 * d[:, 4]],
          [0.5 * d[:, 2], 0.5 * d[:, 4], d[:, 5]]]
    Rm = [[R[:, i, j] for j in range(3)] for i in range(3)]
    sv = [s[:, 0], s[:, 1], s[:, 2]]
    dM = [[2.0 * sv[i] * (Rm[i][0] * dS[0][j] + Rm[i][1] * dS[1][j]
                          + Rm[i][2] * dS[2][j])
           for j in range(3)] for i in range(3)]

    # dscale_k = sum_j R[j][k] dM[j][k]
    dscale = torch.stack(
        [dM[0][k] * Rm[0][k] + dM[1][k] * Rm[1][k] + dM[2][k] * Rm[2][k]
         for k in range(3)], dim=-1) * scale_modifier

    def m_e(i, j):
        # m[i][j] = dM^T[i][j] * s_i = dM[j][i] * s_i
        return dM[j][i] * sv[i]

    dr = 2.0 * (z * (m_e(0, 1) - m_e(1, 0))
                + y * (m_e(2, 0) - m_e(0, 2))
                + x * (m_e(1, 2) - m_e(2, 1)))
    dx = (2.0 * (y * (m_e(1, 0) + m_e(0, 1))
                 + z * (m_e(2, 0) + m_e(0, 2))
                 + r * (m_e(1, 2) - m_e(2, 1)))
          - 4.0 * x * (m_e(2, 2) + m_e(1, 1)))
    dy = (2.0 * (x * (m_e(1, 0) + m_e(0, 1))
                 + r * (m_e(2, 0) - m_e(0, 2))
                 + z * (m_e(1, 2) + m_e(2, 1)))
          - 4.0 * y * (m_e(2, 2) + m_e(0, 0)))
    dz = (2.0 * (r * (m_e(0, 1) - m_e(1, 0))
                 + x * (m_e(2, 0) + m_e(0, 2))
                 + y * (m_e(1, 2) + m_e(2, 1)))
          - 4.0 * z * (m_e(1, 1) + m_e(0, 0)))
    drot = torch.stack([dx, dy, dz, dr], dim=-1)
    return torch.where(vis, dscale, 0.0), torch.where(vis, drot, 0.0)
