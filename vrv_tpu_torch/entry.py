"""The graded scene and a headless render of it.

Counterpart of ``__graft_entry__.py::_scene_args`` / ``entry``:
``graded_scene(world_size, cfg, device)`` builds the world the benchmark
renders — worldgen, one lamp placed on the terrain surface by a real
``set_block`` edit (lights + a non-empty edit list) and the ego cube entity
hovering at the spawn — and returns it with the world-space camera.
``render_graded`` renders frames of it with the main path's usual
configuration, the default ``RenderConfig`` (the fused path kernel, in-kernel
NEE and radiance, 32x32 patches); ``STAGED_CONFIG`` is the staged
configuration of the same path. As a program,

    python -m vrv_tpu_torch.entry --out frame.png [--device cpu] [--width ...]

writes one frame as a PNG (the game-loop CLI waits for the game loop).
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Tuple

import numpy as np
import torch

from vrv_tpu_torch.config import RenderConfig, WorldConfig
from vrv_tpu_torch.device import resolve_device
from vrv_tpu_torch.ops.instances import Isometry, transform_mesh
from vrv_tpu_torch.render.scene import Scene
from vrv_tpu_torch.utils.geometry import unitcube
from vrv_tpu_torch.utils.image import save_png

# the main path's usual configuration: the default RenderConfig at the graded
# size (one path-kernel launch per frame)
MAIN_CONFIG = RenderConfig(width=800, height=600, samples_per_pixel=8, max_bounces=4)
# the staged configuration of the same path: every bounce + one batched
# shadow trace through the march kernel
STAGED_CONFIG = RenderConfig(
    width=800, height=600, samples_per_pixel=8, max_bounces=4,
    tracer="proc", proc_backend="pallas", pallas_fused=False, nee_mode="split",
)


def graded_scene(world_size: int, render_cfg: Optional[RenderConfig] = None,
                 device=None) -> Tuple[Scene, tuple]:
    """Returns (scene, (eye, front, right, up)) — world-space camera."""
    dev = resolve_device(device)
    g = world_size
    wc = WorldConfig(size=(g, g, g), origin=(-g // 2, -g // 2, -g // 2), seed=0)
    scene = Scene(wc, device=dev)
    # ensure the NEE path is exercised: drop a lamp on the terrain surface
    lamp = scene.table.block_idx("lamp")
    solid = scene.table.solid[scene.grid_host]
    col = solid[g // 2, :, g // 2]
    ys = np.nonzero(col)[0]
    y = int(ys.max()) + 1 if len(ys) and ys.max() + 1 < g else g // 2
    scene.set_block(np.array([0, y + wc.origin[1], 0]), lamp)

    # the ego cube entity (unit cube with raw texture ids 0-5 = glass faces)
    cube = transform_mesh(
        unitcube(),
        Isometry(np.array([2.0, y + wc.origin[1] + 3.0, 2.0])
                 - np.asarray(wc.origin, np.float64)),
    )
    scene.set_instances([cube])

    eye = np.array([0.0, y + wc.origin[1] + 6.0, -10.0], np.float32)
    front = np.array([0.0, -0.35, 0.94], np.float32)
    right = np.array([-1.0, 0.0, 0.0], np.float32)
    up = np.array([0.0, -0.94, -0.35], np.float32)
    return scene, (eye, front, right, up)


def render_graded(world_size: int = 128, cfg: RenderConfig = MAIN_CONFIG,
                  frames: int = 1, device=None) -> torch.Tensor:
    """Render ``frames`` frames of the graded scene; returns the last one,
    (H, W, 4) uint8 BGRA on the device."""
    scene, cam = graded_scene(world_size, cfg, device)
    out = None
    for f in range(frames):
        out = scene.render(*cam, f, cfg)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="vrv_tpu_torch.entry", description=__doc__)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--spp", type=int, default=8)
    p.add_argument("--bounces", type=int, default=4)
    p.add_argument("--grid", type=int, default=128, help="cubic grid side")
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--device", default=None, help="default: cuda (raises without one)")
    p.add_argument("--backend", choices=["pallas", "xla", "auto"], default="pallas",
                   help="'pallas': the CUDA kernels (their plain versions for CPU "
                        "tensors); 'xla': the staged path's plain versions; 'auto': the "
                        "kernels exactly on CUDA")
    p.add_argument("--out", type=str, default=None, help="PNG output path")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = MAIN_CONFIG.replace(
        width=args.width, height=args.height, samples_per_pixel=args.spp,
        max_bounces=args.bounces, proc_backend=args.backend,
    )
    kernels = args.backend == "pallas" or (args.backend == "auto" and dev.type == "cuda")
    if not kernels:
        # the staged plain path: 'auto' NEE would resolve to mixture NEE there,
        # which waits for the BVH descent (split is what it resolves to on the
        # fused path), and the plain versions' beam pre-pass waits for the
        # grid tracers
        cfg = cfg.replace(nee_mode="split", beam_prepass=False)
    path = "fused" if (kernels and cfg.pallas_fused) else "staged"
    scene, cam = graded_scene(args.grid, cfg, dev)
    g = args.grid
    print(f"world ({g}, {g}, {g})/render {cfg.width}x{cfg.height} spp={cfg.samples_per_pixel} "
          f"bounces={cfg.max_bounces} tracer={cfg.tracer}/{cfg.proc_backend} "
          f"path={path} beam_prepass={cfg.beam_prepass} device={dev}")
    frame = None
    for f in range(args.frames):
        t0 = time.perf_counter()
        frame = scene.render(*cam, f, cfg)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        rays = cfg.width * cfg.height * cfg.samples_per_pixel
        print(f"fps: {1.0 / dt:.2f} rays/s: {rays / dt:.3e}")
    if args.out:
        save_png(args.out, frame)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
