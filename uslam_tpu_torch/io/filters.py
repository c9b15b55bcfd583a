"""Sensor prefilters (port of :mod:`uslam_tpu.io.filters`).

The reference's isam-only IMU low-pass (order-3 Butterworth, fs = 30 Hz,
cutoff 0.5 Hz, zero-phase ``filtfilt``; reference isam.py:271-287): the
coefficients come from the bilinear transform on the host (numpy, no scipy),
and the direct-form-II-transposed recursion runs forward and backward on the
tensor's device, in float32 and in the JAX package's order of operations,
each multiply-add rounded once as XLA compiles it (its ``lax.scan`` becomes
a loop over samples; on the CPU the result equals the JAX package's bit for
bit).

The isam-only explicit gravity compensation (reference isam.py:162-171)
rotates world gravity into the body frame and adds it to the measured
specific force. The batch path does not use it: gravity is handled inside
the IMU preintegration.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from uslam_tpu_torch.device import resolve_device
from uslam_tpu_torch.geometry.so3 import quat_conjugate, quat_rotate


def butter_lowpass_coeffs(order: int, cutoff_hz: float, fs_hz: float):
    """Butterworth low-pass (b, a), float32 CPU tensors, by the bilinear
    transform of the analog prototype; matches
    ``scipy.signal.butter(order, cutoff / (fs / 2))``."""
    # Analog prototype poles on the unit circle (left half plane).
    poles = np.array(
        [np.exp(1j * np.pi * (2 * k + order + 1) / (2 * order)) for k in range(order)]
    )
    # Pre-warped analog cutoff.
    warped = 2 * fs_hz * math.tan(math.pi * cutoff_hz / fs_hz)
    poles = poles * warped
    gain = warped**order
    # Bilinear transform: s = 2 fs (z-1)/(z+1).
    fs2 = 2 * fs_hz
    z_poles = (fs2 + poles) / (fs2 - poles)
    gain = gain.real / np.prod(fs2 - poles).real
    # All zeros of the low-pass at z = -1.
    b = gain * np.poly(-np.ones(order)).real
    a = np.poly(z_poles).real
    return torch.tensor(b, dtype=torch.float32), torch.tensor(a, dtype=torch.float32)


def _lfilter_zi(b: np.ndarray, a: np.ndarray) -> np.ndarray:
    """Steady-state DF2T initial state per unit input (scipy lfilter_zi)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    n = len(a)
    companion = np.zeros((n - 1, n - 1))
    companion[0, :] = -a[1:] / a[0]
    companion[1:, :-1] = np.eye(n - 2)
    IminusA = np.eye(n - 1) - companion.T
    B = b[1:] - a[1:] * b[0]
    return np.linalg.solve(IminusA, B)


def _iir_forward(b: torch.Tensor, a: torch.Tensor, x: torch.Tensor, zi: torch.Tensor):
    """Direct-form II transposed IIR along axis 0 of (T, C) ``x``; ``zi``
    (order,) is the unit-input steady state, scaled by x[0] as scipy's
    filtfilt does, so a heavy low-pass does not ring at the edges."""
    b = b / a[0]
    a = a / a[0]
    # b_0 x + s_0 and b_k x - a_k y with one rounding each, as XLA fuses
    # them (multiply-adds): a float32 product is exact in float64.
    b64 = b.double()
    state = zi[:, None] * x[0][None, :]
    zero = x.new_zeros((1, x.shape[1]))
    ys = []
    for xt in x:
        x64 = xt.double()
        yt = (b64[0] * x64 + state[0].double()).to(x.dtype)
        upd = (b64[1:, None] * x64 - (a[1:, None] * yt).double()).to(x.dtype)
        state = torch.cat([state[1:], zero]) + upd
        ys.append(yt)
    return torch.stack(ys)


def filtfilt(b: torch.Tensor, a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Zero-phase forward-backward filtering of (T, C) ``x`` along axis 0,
    on ``x``'s device (edges extended by odd reflection)."""
    order = a.shape[0] - 1
    pad = min(3 * (order + 1), x.shape[0] - 1)
    x_ext = torch.cat(
        [2 * x[0] - x[1 : pad + 1].flip(0), x, 2 * x[-1] - x[-pad - 1 : -1].flip(0)]
    )
    zi = torch.tensor(_lfilter_zi(b.cpu().numpy(), a.cpu().numpy()), dtype=x.dtype,
                      device=x.device)
    b, a = b.to(x.device), a.to(x.device)
    y = _iir_forward(b, a, x_ext, zi)
    y = _iir_forward(b, a, y.flip(0), zi).flip(0)
    return y[pad : pad + x.shape[0]]


def smooth_imu(data, fs: float = 30.0, cutoff: float = 0.5, order: int = 3, *,
               device="cuda") -> torch.Tensor:
    """Low-pass the (T, C) IMU stream with the reference ``smooth_imu``
    parameters (isam.py:271-287), in float32 on ``device``."""
    b, a = butter_lowpass_coeffs(order, cutoff, fs)
    return filtfilt(b, a, torch.as_tensor(data, dtype=torch.float32, device=resolve_device(device)))


def gravity_compensate(acc_body: torch.Tensor, quat_wxyz: torch.Tensor,
                       gravity: float = 9.81) -> torch.Tensor:
    """Reference isam.py:162-171: rotate world gravity (0, 0, -g) into the
    body frame with the IMU orientation and add it to the measured specific
    force, giving linear acceleration (on the inputs' device)."""
    g_world = acc_body.new_tensor([0.0, 0.0, -gravity])
    return acc_body + quat_rotate(quat_conjugate(quat_wxyz), g_world)
