"""Unscented Kalman Filter for ego-state estimation (self-contained).

Copy of `simlingo_tpu/agent/ukf.py`.

Counterpart of the reference's filterpy UKF with MerweScaledSigmaPoints and a
kinematic-bicycle transition (team_code/agent_simlingo.py:237-257, 1024-1170).
State: [x, y, yaw, speed]; measurements: GPS position + IMU yaw + speedometer.
The yaw dimension uses circular means/residuals.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np

# bicycle parameters tuned from World on Rails (reference :1046-1052)
FRONT_WB = -0.090769015
REAR_WB = 1.4178275
STEER_GAIN = 0.36848336
BRAKE_ACCEL = -4.952399
THROT_ACCEL = 0.5633837


def normalize_angle(a: float) -> float:
    return (a + math.pi) % (2 * math.pi) - math.pi


def bicycle_model_forward(x: np.ndarray, dt: float, steer: float,
                          throttle: float, brake: bool) -> np.ndarray:
    accel = BRAKE_ACCEL if brake else THROT_ACCEL * throttle
    wheel = STEER_GAIN * steer
    beta = math.atan(REAR_WB / (FRONT_WB + REAR_WB) * math.tan(wheel))
    nx = x[0] + x[3] * math.cos(x[2] + beta) * dt
    ny = x[1] + x[3] * math.sin(x[2] + beta) * dt
    nyaw = x[2] + x[3] / REAR_WB * math.sin(beta) * dt
    nspeed = max(x[3] + accel * dt, 0.0)
    return np.array([nx, ny, nyaw, nspeed])


class MerweSigmaPoints:
    def __init__(self, n: int, alpha: float = 1e-4, beta: float = 2.0,
                 kappa: Optional[float] = None):
        self.n = n
        kappa = 3 - n if kappa is None else kappa
        self.lmbda = alpha ** 2 * (n + kappa) - n
        c = n + self.lmbda
        self.Wm = np.full(2 * n + 1, 1.0 / (2 * c))
        self.Wc = self.Wm.copy()
        self.Wm[0] = self.lmbda / c
        self.Wc[0] = self.lmbda / c + (1 - alpha ** 2 + beta)

    def points(self, x: np.ndarray, P: np.ndarray) -> np.ndarray:
        n = self.n
        U = np.linalg.cholesky((n + self.lmbda) * P).T
        pts = np.zeros((2 * n + 1, n))
        pts[0] = x
        for k in range(n):
            pts[k + 1] = x + U[k]
            pts[n + k + 1] = x - U[k]
        return pts


def _state_mean(sigmas: np.ndarray, wm: np.ndarray) -> np.ndarray:
    x = np.zeros(4)
    x[0] = np.dot(sigmas[:, 0], wm)
    x[1] = np.dot(sigmas[:, 1], wm)
    x[2] = math.atan2(np.dot(np.sin(sigmas[:, 2]), wm),
                      np.dot(np.cos(sigmas[:, 2]), wm))
    x[3] = np.dot(sigmas[:, 3], wm)
    return x


def _residual(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    y = a - b
    y[2] = normalize_angle(y[2])
    return y


class EgoUKF:
    """4-state UKF with bicycle transition; measurement = identity."""

    def __init__(self, dt: float = 1.0 / 20.0):
        self.dt = dt
        self.points = MerweSigmaPoints(4)
        self.x = np.zeros(4)
        self.P = np.eye(4)
        # noise settings mirroring the reference agent (:246-255)
        self.Q = np.diag([0.0001, 0.0001, 0.001, 0.001])
        self.R = np.diag([0.5, 0.5, 0.000001, 0.000001])
        self.initialized = False

    def init_state(self, x: np.ndarray) -> None:
        self.x = np.asarray(x, float).copy()
        self.P = np.eye(4)
        self.initialized = True

    def predict(self, steer: float, throttle: float, brake: bool) -> None:
        sigmas = self.points.points(self.x, self.P)
        sig_f = np.array([bicycle_model_forward(s, self.dt, steer, throttle,
                                                brake) for s in sigmas])
        self.x_prior = _state_mean(sig_f, self.points.Wm)
        P = self.Q.copy()
        for i, s in enumerate(sig_f):
            y = _residual(s, self.x_prior)
            P += self.points.Wc[i] * np.outer(y, y)
        self.P_prior = P
        self._sig_f = sig_f

    def update(self, z: np.ndarray) -> None:
        sig_h = self._sig_f  # identity measurement
        z_pred = _state_mean(sig_h, self.points.Wm)
        S = self.R.copy()
        Pxz = np.zeros((4, 4))
        for i, s in enumerate(sig_h):
            dz = _residual(s, z_pred)
            dx = _residual(self._sig_f[i], self.x_prior)
            S += self.points.Wc[i] * np.outer(dz, dz)
            Pxz += self.points.Wc[i] * np.outer(dx, dz)
        K = Pxz @ np.linalg.inv(S)
        innov = _residual(np.asarray(z, float), z_pred)
        self.x = self.x_prior + K @ innov
        self.x[2] = normalize_angle(self.x[2])
        self.P = self.P_prior - K @ S @ K.T
