"""PathTracer: world + materials + light structure + camera in one object.

Counterpart of ``vrv_tpu/models/pathtracer.py`` (``CameraPose``,
``PathTracer``): one frame (``render``), radiance accumulated across frames
(``render_progressive`` / ``reset_accumulation``) and a converged frame as a
host loop over sample passes (``render_converged``), which
``Scene.render_converged`` equals bit for bit (same pass ids, the same
per-pass sum over samples, the same accumulation order and divisor).
Entry points run on CUDA unless the caller passes ``device='cpu'``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from vrv_tpu_torch.config import RenderConfig, WorldConfig
from vrv_tpu_torch.render.megakernel import pack_bgra
from vrv_tpu_torch.render.scene import Scene


@dataclasses.dataclass
class CameraPose:
    eye: np.ndarray
    front: np.ndarray
    right: np.ndarray
    up: np.ndarray

    @staticmethod
    def looking(eye, yaw: float = 0.0, pitch: float = 0.0) -> "CameraPose":
        from vrv_tpu_torch.camera import dir_vecs

        front, right, up = dir_vecs(np.array([0.0, -1.0, 0.0]), pitch, yaw)
        return CameraPose(np.asarray(eye, np.float32), front, right, up)

    def arrays(self, device) -> Tuple[torch.Tensor, ...]:
        """(eye, front, right, up) as float32 tensors on ``device`` (the
        scene's), so a render call moves nothing from the host."""
        return tuple(
            torch.tensor(np.asarray(v, np.float32), device=device)
            for v in (self.eye, self.front, self.right, self.up)
        )


class PathTracer:
    def __init__(
        self,
        world_cfg: Optional[WorldConfig] = None,
        render_cfg: Optional[RenderConfig] = None,
        grid: Optional[np.ndarray] = None,
        device=None,
    ):
        self.world_cfg = world_cfg or WorldConfig()
        self.render_cfg = render_cfg or RenderConfig()
        self.scene = Scene(self.world_cfg, grid=grid, device=device)
        self._accum: Optional[torch.Tensor] = None
        self._accum_frames = 0

    @classmethod
    def on_scene(cls, scene: Scene, render_cfg: RenderConfig) -> "PathTracer":
        """A PathTracer over an existing scene (e.g. ``entry.graded_scene``'s,
        which carries an edit, a lamp and an entity)."""
        pt = cls.__new__(cls)
        pt.world_cfg, pt.render_cfg, pt.scene = scene.world_cfg, render_cfg, scene
        pt.reset_accumulation()
        return pt

    def render(self, pose: CameraPose, frame: int = 0) -> torch.Tensor:
        """One frame (H, W, 4) u8 BGRA."""
        return self.scene.render(pose.eye, pose.front, pose.right, pose.up,
                                 frame, self.render_cfg)

    def render_progressive(self, pose: CameraPose, frame: int) -> torch.Tensor:
        """Accumulate each frame's per-pixel sample mean across frames and
        pack the running mean."""
        samples = self.scene.render_samples(
            pose.eye, pose.front, pose.right, pose.up, frame, self.render_cfg
        ).mean(dim=0)
        if self._accum is None:
            self._accum = samples
            self._accum_frames = 1
        else:
            self._accum = self._accum + samples
            self._accum_frames += 1
        return pack_bgra(self._accum / self._accum_frames)

    def reset_accumulation(self) -> None:
        self._accum = None
        self._accum_frames = 0

    def render_converged(
        self, pose: CameraPose, total_spp: int = 128, frame0: int = 0
    ) -> torch.Tensor:
        """Converged frame by accumulating ``samples_per_pixel``-sized passes
        with pass ids ``frame0 + i``: one ``render_samples`` call per pass
        from the host."""
        chunk = self.render_cfg.samples_per_pixel
        n_chunks = max(1, total_spp // chunk)
        acc = None
        for i in range(n_chunks):
            s = self.scene.render_samples(
                pose.eye, pose.front, pose.right, pose.up,
                (frame0 + i) & 0xFFFFFFFF, self.render_cfg,
            ).sum(dim=0)
            acc = s if acc is None else acc + s
        return pack_bgra(acc / (n_chunks * chunk))
