"""Quadrotor differential flatness map, forward only
(svsdf_tpu/ops/flatness.py): autograd replaces the reference's
hand-written adjoint, as ``jax.grad`` does there.

Transcribes flatness::FlatnessMap::forward
(`src/utils/include/utils/flatness.hpp:54-135`): (vel, acc, jerk, psi,
dpsi) -> (thrust, attitude quaternion, body rates) with the drag model.
Elementwise, so any leading shape works.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class FlatnessParams:
    mass: float = 0.61
    grav: float = 9.8
    dh: float = 0.10      # horizontal drag
    dv: float = 0.10      # vertical drag
    cp: float = 0.01      # parasitic drag
    veps: float = 0.0001  # speed smoothing


def forward(vel, acc, jer, psi, dpsi, p: FlatnessParams):
    """vel/acc/jer: (..., 3); psi/dpsi: (...,) tensors. Returns
    (thr (...,), quat (..., 4) wxyz, omg (..., 3))."""
    v0, v1, v2 = vel[..., 0], vel[..., 1], vel[..., 2]
    a0, a1, a2 = acc[..., 0], acc[..., 1], acc[..., 2]
    cp_term = torch.sqrt(v0 * v0 + v1 * v1 + v2 * v2 + p.veps)
    w_term = 1.0 + p.cp * cp_term
    w0, w1, w2 = w_term * v0, w_term * v1, w_term * v2
    dh_over_m = p.dh / p.mass
    zu0 = a0 + dh_over_m * w0
    zu1 = a1 + dh_over_m * w1
    zu2 = a2 + dh_over_m * w2 + p.grav
    zu_sqr0, zu_sqr1, zu_sqr2 = zu0 * zu0, zu1 * zu1, zu2 * zu2
    zu01, zu12, zu02 = zu0 * zu1, zu1 * zu2, zu0 * zu2
    zu_sqr_norm = zu_sqr0 + zu_sqr1 + zu_sqr2
    zu_norm = torch.sqrt(zu_sqr_norm)
    z0, z1, z2 = zu0 / zu_norm, zu1 / zu_norm, zu2 / zu_norm
    ng_den = zu_sqr_norm * zu_norm
    ng00 = (zu_sqr1 + zu_sqr2) / ng_den
    ng01 = -zu01 / ng_den
    ng02 = -zu02 / ng_den
    ng11 = (zu_sqr0 + zu_sqr2) / ng_den
    ng12 = -zu12 / ng_den
    ng22 = (zu_sqr0 + zu_sqr1) / ng_den
    v_dot_a = v0 * a0 + v1 * a1 + v2 * a2
    dw_term = p.cp * v_dot_a / cp_term
    dw0 = w_term * a0 + dw_term * v0
    dw1 = w_term * a1 + dw_term * v1
    dw2 = w_term * a2 + dw_term * v2
    dz_term0 = jer[..., 0] + dh_over_m * dw0
    dz_term1 = jer[..., 1] + dh_over_m * dw1
    dz_term2 = jer[..., 2] + dh_over_m * dw2
    dz0 = ng00 * dz_term0 + ng01 * dz_term1 + ng02 * dz_term2
    dz1 = ng01 * dz_term0 + ng11 * dz_term1 + ng12 * dz_term2
    dz2 = ng02 * dz_term0 + ng12 * dz_term1 + ng22 * dz_term2
    f_term0 = p.mass * a0 + p.dv * w0
    f_term1 = p.mass * a1 + p.dv * w1
    f_term2 = p.mass * (a2 + p.grav) + p.dv * w2
    thr = z0 * f_term0 + z1 * f_term1 + z2 * f_term2
    tilt_den = torch.sqrt(2.0 * (1.0 + z2))
    tilt0 = 0.5 * tilt_den
    tilt1 = -z1 / tilt_den
    tilt2 = z0 / tilt_den
    c_half_psi = torch.cos(0.5 * psi)
    s_half_psi = torch.sin(0.5 * psi)
    quat = torch.stack([
        tilt0 * c_half_psi,
        tilt1 * c_half_psi + tilt2 * s_half_psi,
        tilt2 * c_half_psi - tilt1 * s_half_psi,
        tilt0 * s_half_psi], dim=-1)
    c_psi = torch.cos(psi)
    s_psi = torch.sin(psi)
    omg_den = z2 + 1.0
    omg_term = dz2 / omg_den
    omg = torch.stack([
        dz0 * s_psi - dz1 * c_psi - (z0 * s_psi - z1 * c_psi) * omg_term,
        dz0 * c_psi + dz1 * s_psi - (z0 * c_psi + z1 * s_psi) * omg_term,
        (z1 * dz0 - z0 * dz1) / omg_den + dpsi], dim=-1)
    return thr, quat, omg
