"""Camera vectors.

Counterpart of the first part of ``vrv_tpu/camera.py``: ``_normalize`` and
``dir_vecs`` (front, right, up from pitch and yaw; world-up is (0, -1, 0),
the reference's Y-down convention), in numpy only. The camera protocol, the
spherical orbit camera and the quaternion helpers come with the game loop
(ROADMAP Queue 1 item 9: game loop + app + native).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

Vec3 = np.ndarray


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def dir_vecs(worldup: Vec3, pitch: float, yaw: float) -> Tuple[Vec3, Vec3, Vec3]:
    """(front, right, up) from pitch/yaw, in float64."""
    front = _normalize(
        np.array(
            [
                math.cos(yaw) * math.cos(pitch),
                math.sin(pitch),
                math.sin(yaw) * math.cos(pitch),
            ],
            dtype=np.float64,
        )
    )
    right = _normalize(np.cross(front, worldup))
    up = _normalize(np.cross(right, front))
    return front, right, up
