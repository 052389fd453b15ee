"""SE(3) pose helpers (parity with lib/utils/se3.py:10-91).

A copy of ``unseenobjectclustering_tpu/utils/se3.py`` (numpy): rigid-
transform math the reference carries from PoseCNN, unused in the
segmentation flow but part of the public utils surface (the reference
imports it from test_dataset.py:17).  Poses are [R | t] as 3x4 or 4x4
matrices; quaternions are (w, x, y, z).
"""

from __future__ import annotations

import numpy as np


def quat2mat(q: np.ndarray) -> np.ndarray:
    """Quaternion (w, x, y, z) -> 3x3 rotation matrix."""
    w, x, y, z = np.asarray(q, dtype=np.float64)
    n = w * w + x * x + y * y + z * z
    if n < 1e-12:
        return np.eye(3)
    s = 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1 - (xx + yy)],
    ])


def mat2quat(m: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix -> quaternion (w, x, y, z)."""
    m = np.asarray(m, dtype=np.float64)
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                         (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(m[i, i] - m[j, j] - m[k, k] + 1.0) * 2
    q = np.empty(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


def se3_inverse(rt: np.ndarray) -> np.ndarray:
    """Invert a 3x4 [R | t] transform (se3.py:30-38)."""
    r = rt[:3, :3]
    t = rt[:3, 3]
    out = np.zeros((3, 4), dtype=rt.dtype)
    out[:3, :3] = r.T
    out[:3, 3] = -r.T @ t
    return out


def se3_mul(rt1: np.ndarray, rt2: np.ndarray) -> np.ndarray:
    """Compose two 3x4 transforms: rt1 * rt2 (se3.py:41-52)."""
    out = np.zeros((3, 4), dtype=rt1.dtype)
    out[:3, :3] = rt1[:3, :3] @ rt2[:3, :3]
    out[:3, 3] = rt1[:3, :3] @ rt2[:3, 3] + rt1[:3, 3]
    return out


def se3_transform_points(rt: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply [R | t] to [N, 3] points."""
    return pts @ rt[:3, :3].T + rt[:3, 3]


def egocentric2allocentric(qt: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Rotate an egocentric pose quaternion to allocentric given translation
    (se3.py:55-72 capability)."""
    d = np.asarray(t, dtype=np.float64)
    d = d / max(np.linalg.norm(d), 1e-12)
    axis = np.cross(d, [0, 0, 1.0])
    angle = np.arccos(np.clip(d @ np.array([0, 0, 1.0]), -1, 1))
    if np.linalg.norm(axis) < 1e-12:
        return np.asarray(qt, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    s = np.sin(angle / 2)
    q_corr = np.array([np.cos(angle / 2), axis[0] * s, axis[1] * s,
                       axis[2] * s])
    return quat_mul(q_corr, qt)


def quat_mul(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    """Hamilton product of (w, x, y, z) quaternions."""
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])
