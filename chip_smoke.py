#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (vrv_tpu_torch).

    python3 chip_smoke.py            # needs one CUDA card and nvcc

What it does, each phase failing the run (non-zero exit) on any failure:

1. device: requires ``torch.cuda.is_available()``; prints the card's name and
   power limit as ``nvidia-smi`` gives them;
2. builds the CUDA kernels from ``vrv_tpu_torch/csrc`` (one ``nvcc`` each,
   started together), loads them and prints K1's and K2's registers, stack
   frame and spill bytes (ptxas -v) and K1's persistent grid;
3. holds every kernel against its plain PyTorch version on the card, at
   >= 1M rays per case: the march kernel K1 (packed words exactly equal,
   ``t`` bit-equal) and the path kernel K2 in both record modes (integer
   records exact, float records bit-equal with NaNs in the same places),
   with the refill edges of both kernels' persistent grids (1, 33 and 129
   rays, rays that leave the world at once interleaved with rays that graze
   the terrain; for K1 in the pristine and the graded world, and random rays
   with ``tcap``) and rays aimed at the entity instances (K2's bounding-box
   test);
4. drives the main path at full width: ``entry.graded_scene(128)`` and three
   frames of ``Scene.render`` at 800x600, 8 spp, 4 bounces with the default
   ``RenderConfig`` (the fused path: exactly one K2 launch and no K1 launch
   per frame), checks the frames, that a 160x120 fused frame is
   byte-identical between the kernel and its plain version and within +-1 u8
   at >= 99 % of pixels of the staged frame; then drives the staged
   configuration (``entry.STAGED_CONFIG``: 5 K1 launches per frame) and
   checks its 160x120 frame kernel vs plain version;
4b. converged rendering and the trace-record replays at full width: a
   128-spp converged frame through ``Scene.render_converged`` (16 passes:
   exactly 16 K2 launches and no K1 launch, the pass loop run under
   ``torch.cuda.set_sync_debug_mode("error")`` with the camera as device
   tensors, the frame equal bit for bit to ``PathTracer.render_converged``'s
   host loop; ms per frame and per pass); then frames with
   ``pallas_inkernel_radiance=False`` (1 K2 launch in trace-record mode and
   no K1 launch per frame) and with ``pallas_inkernel_nee=False`` (1 K2 and
   1 K1 launch per frame: the shadow rays of every bounce), with ms/frame and
   peak memory; at 160x120 each is byte-identical between the kernels and
   their plain versions and within +-1 u8 at >= 99 % of pixels of the
   in-kernel-radiance frame;
5. times each kernel at the shapes the main path gave it, beside its plain
   version and its bound (for K1 per staged launch: rays, steps per ray, ms
   and the launch's grid); prints K2's persistent grid (the runtime's
   occupancy) and the shadow rays and steps its radiance-mode skip removed;
6. drives the kernel-pricing tool chain, the path that runs the op-price
   probe K3 (``vrv_tpu_torch.tools.vpu_probe``): K3 is held against its
   plain version bit for bit in phase 3 (all ten op classes, >= 1M
   elements) and its timed chains are shown intact in the built library's
   SASS; here the price table (``ops``), the SASS histograms of K1 and K2
   (``audit``) and the roofline of K1 and K2 at the measured class rates
   (``tools.roofline``: bound at the measured rates, each kernel's share of
   it — for K1 also per staged launch —, the warp-serial floor of the static
   ray-to-thread assignment both kernels replaced, divergence factor); then
   prints one JSON line ``{"kernels": [...]}``.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

from vrv_tpu_torch import entry
from vrv_tpu_torch.config import RenderConfig
from vrv_tpu_torch.device import event_ms
from vrv_tpu_torch.models.pathtracer import CameraPose, PathTracer
from vrv_tpu_torch.ops import dda_proc
from vrv_tpu_torch.ops.camera_rays import raygen
from vrv_tpu_torch.ops.pallas import build
from vrv_tpu_torch.ops.pallas import path_proc as k2
from vrv_tpu_torch.ops.pallas import trace_proc as k1
from vrv_tpu_torch.tools import k2_ab, roofline
from vrv_tpu_torch.tools import vpu_probe as k3

# Published peaks of one H100 SXM (NVIDIA data sheet): float32 outside the
# tensor cores, and HBM bandwidth. The bound uses them as they are.
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12

# The kernels' fp32 + int32 operations, counted on their CUDA source by ALU
# class, are the tables of vrv_tpu_torch/tools/roofline.py.
FRAMES = 3                     # frames of the main path
STAGED_FRAMES = 2              # frames of the staged configuration
# (P, K, iters) at which K3 is held against its plain version: the two
# timed sizes and the two small ones
PROBE_CHECKS = ((8, 32, 2), (8, 1, 4), (2, 4, 3), (2, 3, 3))
T8_INT_BAR = 0.999             # the fallback bar (ROADMAP Queue 3, T8)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def random_rays(n: int, size: int, seed: int, dev):
    """Origins inside/around the grid, unit directions (numpy, seeded)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.1 * size, 1.1 * size, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


def edge_rays(n: int, size: int, seed: int, dev):
    """Random rays plus the edge classes: degenerate and axis-aligned
    directions, origins outside the grid entering through a face, rays
    along cell planes."""
    o, d = random_rays(n, size, seed, dev)
    o, d = o.cpu().numpy(), d.cpu().numpy()
    rng = np.random.default_rng(seed + 1)
    k = n // 8
    d[:k] = 0.0                                               # degenerate
    ax = rng.integers(0, 6, k)
    d[k:2 * k] = 0.0
    d[np.arange(k, 2 * k), ax // 2] = np.where(ax % 2 == 0, 1.0, -1.0)  # axis-aligned
    o[2 * k:3 * k, 0] = -5.0                                  # enter through -x
    d[2 * k:3 * k] = np.abs(d[2 * k:3 * k]) * [1.0, 0.2, 0.2]
    d[2 * k:3 * k] /= np.linalg.norm(d[2 * k:3 * k], axis=1, keepdims=True)
    o[3 * k:4 * k] = np.floor(o[3 * k:4 * k])                 # on cell corners
    seeds = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32).view(np.int32)
    return (torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
            torch.from_numpy(seeds.copy()).to(dev))


def leave_and_graze_rays(ps, n: int, seed: int, dev):
    """K2's refill edges: rays that leave the world at once (origins outside
    the grid pointing away: no step) interleaved with rays that graze the
    terrain (a little above the surface of the grid's centre column, nearly
    level: long marches), with seeds."""
    X, Y, Z = ps.shape
    xs = torch.full((Y,), X // 2, dtype=torch.int32, device=dev)
    ys = torch.arange(Y, dtype=torch.int32, device=dev)
    col = dda_proc.worldgen_blocks(ps, xs, ys, torch.full_like(xs, Z // 2)).cpu().numpy()
    solid_y = np.nonzero(col != ps.air)[0]
    top = int(solid_y.max()) + 1 if len(solid_y) else Y // 2
    rng = np.random.default_rng(seed)
    o = np.empty((n, 3), np.float32)
    d = np.empty((n, 3), np.float32)
    leave = np.arange(n) % 2 == 0
    k = int(leave.sum())
    o[leave] = rng.uniform(0, X, (k, 3)) + [-X - 4.0, 0.0, 0.0]      # beyond -x
    d[leave] = np.stack([-np.ones(k), rng.uniform(-0.3, 0.3, k), rng.uniform(-0.3, 0.3, k)], -1)
    m = n - k
    o[~leave] = np.stack([rng.uniform(0.5, 2.0, m), top + rng.uniform(0.2, 1.5, m),
                          rng.uniform(0, Z, m)], -1)
    d[~leave] = np.stack([np.ones(m), -rng.uniform(0.0, 0.03, m), rng.uniform(-0.2, 0.2, m)], -1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    seeds = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32).view(np.int32)
    return (torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
            torch.from_numpy(seeds.copy()).to(dev))


def instance_rays(scene, n: int, seed: int, dev):
    """Rays from around the scene's entity instances aimed at their centre
    (instance hits, grazes and near misses), with seeds."""
    inst = scene.instances_device
    ctr = inst["tri"][inst["valid"]].reshape(-1, 3).mean(0).cpu().numpy()
    rng = np.random.default_rng(seed)
    o = ctr + rng.uniform(-4.0, 4.0, (n, 3)) + [0.0, 3.0, 0.0]
    d = ctr + rng.uniform(-0.8, 0.8, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    seeds = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32).view(np.int32)
    return (torch.from_numpy(o.astype(np.float32)).to(dev),
            torch.from_numpy(d.astype(np.float32)).to(dev), torch.from_numpy(seeds.copy()).to(dev))


def hand_edited_world(ps0, dev):
    """ps/pd with an air hole, a lamp and a glass block near the terrain
    surface under the grid centre (covers solid, air and translucent rows)."""
    X, Y, Z = ps0.shape
    xs = torch.full((Y,), X // 2, dtype=torch.int32, device=dev)
    ys = torch.arange(Y, dtype=torch.int32, device=dev)
    col = dda_proc.worldgen_blocks(ps0, xs, ys, xs).cpu().numpy()
    solid_y = np.nonzero(col != ps0.air)[0]
    top = int(solid_y.max()) if len(solid_y) else Y // 2
    cells = np.full((4, 3), -(1 << 20), np.int32)
    cells[0] = (X // 2, top, Z // 2)          # air hole in the surface
    cells[1] = (X // 2 + 2, top + 1, Z // 2)  # lamp (opaque)
    cells[2] = (X // 2 - 2, top + 1, Z // 2)  # glass (solid + translucent)
    blocks = np.array([ps0.air, 2, 0, ps0.air], np.uint8)
    solid = np.array([False, True, True, False])
    transl = np.array([True, False, True, True])
    pd = {
        "edit_cells": torch.from_numpy(cells).to(dev),
        "edit_blocks": torch.from_numpy(blocks).to(dev),
        "edit_solid": torch.from_numpy(solid).to(dev),
        "edit_translucent": torch.from_numpy(transl).to(dev),
    }
    return ps0._replace(n_edits=4), pd


def place_mirror_and_glass(scene) -> None:
    """A mirror-class and a glass-class block on the terrain next to the lamp
    (real set_block edits; the fused path keeps both in-kernel)."""
    bt = scene.table
    g = scene.grid_host.shape[0]
    org = np.asarray(scene.world_cfg.origin)
    solid = bt.solid[scene.grid_host]
    for name, dx, dz in (("mirror", 1, 1), ("glass", -2, 0)):
        ys = np.nonzero(solid[g // 2 + dx, :, g // 2 + dz])[0]
        if not scene.set_block(np.array([g // 2 + dx, int(ys.max()) + 1, g // 2 + dz]) + org,
                               int(bt.block_idx(name))):
            fail(f"could not place {name}")
    ps = scene.proc_static
    if ps is None or not ps.edit_mats or not ps.edit_glass or not ps.edits_fused:
        fail("mirror/glass edits did not stay on the fused path")


def compare_case(name, ps, pd, o, d, tcap, results):
    """K1 vs its plain version on one ray batch: exact or fail."""
    stats = {}
    t_p, w_p = dda_proc.trace_proc_packed(ps, o, d, 0.001, 1000.0, pd, tcap, stats)
    t_k, w_k = k1.trace_proc_cuda_packed(ps, o, d, 0.001, 1000.0, pd, tcap)
    torch.cuda.synchronize()
    bad_w = int((w_p != w_k).sum())
    bad_t = int((t_p.view(torch.int32) != t_k.view(torch.int32)).sum())
    err = float((t_p - t_k).abs().max())
    hits = float((w_k & 1).float().mean())
    print(f"  {name}: rays={o.shape[0]} hit_rate={hits:.3f} "
          f"steps/ray={stats['steps'] / o.shape[0]:.1f} "
          f"packed_mismatch={bad_w} t_mismatch={bad_t} max_abs_err={err}",
          flush=True)
    results["mismatches"] += bad_w + bad_t
    results["max_abs_err"] = max(results["max_abs_err"], err)
    results["rays"] += o.shape[0]
    if bad_w or bad_t:
        fail(f"kernel disagrees with its plain version in case {name!r}")


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance in units in the last place between float32 tensors (as
    ordered integers; NaN vs NaN counts 0)."""
    def key(x):
        i = x.view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    u = (key(a) - key(b)).abs()
    both_nan = torch.isnan(a) & torch.isnan(b)
    return torch.where(both_nan, torch.zeros_like(u), u)


def compare_path(name, ps, pd, o, d, seeds, B, results, kw, per_case):
    """K2 vs trace_path_plain on one ray batch in one record mode: integer
    records exact and float records bit-equal (NaN-aware), or else the T8
    bar: integer records exact on >= 99.9 % of rays and every ray that
    differs first differs in a float record by <= 2 ulp."""
    stats = {}
    spec, ip, fp = k2.trace_path_plain(ps, o, d, seeds, B, pd=pd, raw=True,
                                       stats=stats, **kw)
    _, ik, fk = k2.trace_path_cuda(ps, o, d, seeds, B, pd=pd, raw=True, **kw)
    torch.cuda.synchronize()
    irows, frows = k2.record_layout(spec)
    n = o.shape[0]
    bad_i = (ik != ip)                                      # (ni, n)
    bad_f = (fk.view(torch.int32) != fp.view(torch.int32)) & ~(
        torch.isnan(fk) & torch.isnan(fp))
    ray_bad = bad_i.any(0) | bad_f.any(0)
    n_bad = int(ray_bad.sum())
    n_bad_int = int(bad_i.any(0).sum())
    fin = torch.isfinite(fk) & torch.isfinite(fp)
    err = float(torch.where(fin, (fk - fp).abs(), torch.zeros_like(fk)).max()) if fk.numel() else 0.0
    mode = "radiance" if spec.rad else "trace"
    covered = ""
    if spec.rad:
        c0 = ik[0]
        covered = (f"hit={float((c0 & 1).float().mean()):.3f} "
                   f"mirror={int((((ik >> 1) & 3) == 1).sum())} "
                   f"transmit={int((((ik >> 1) & 3) == 2).sum())} "
                   f"nan_sr={int(torch.isnan(fk[1::2][:B]).sum())}")
    elif spec.n_inst:
        covered = "instance_wins=" + str(sum(int((ik[irows.index(("prim", b))] >= 0).sum())
                                             for b in range(B)))
    steps = stats["path"].get("steps", 0) + stats.get("shadow", {}).get("steps", 0)
    print(f"  {name} [{mode}]: rays={n} steps/ray={steps / n:.1f} "
          f"shadow_rays={stats.get('shadow', {}).get('rays', 0)} {covered} "
          f"rays_differing={n_bad} (in integer records: {n_bad_int}) "
          f"max_abs_err={err}", flush=True)
    results["mismatches"] += n_bad
    results["max_abs_err"] = max(results["max_abs_err"], err)
    results["rays"] += n
    per_case.append({"case": name, "mode": mode, "rays": n, "differing": n_bad,
                     "differing_int": n_bad_int})
    if n_bad == 0:
        return
    # the T8 bar, stated in PERF.md: where libdevice's sin/cos in the kernel
    # and in PyTorch's own kernels disagree, a path may follow a 1-2 ulp
    # different direction from then on
    for k, key in enumerate(irows):
        m = int(bad_i[k].sum())
        if m:
            print(f"    int record {key}: {m} rays differ")
    for k, key in enumerate(frows):
        m = int(bad_f[k].sum())
        if m:
            print(f"    float record {key}: {m} rays differ, max "
                  f"{int(ulps(fk[k], fp[k]).max())} ulp")
    if n_bad_int > (1.0 - T8_INT_BAR) * n:
        fail(f"K2 case {name!r}: integer records differ on {n_bad_int} of {n} rays")
    # earliest bounce of each differing ray: it must be a float record <= 2 ulp
    first_b = torch.full((n,), B, dtype=torch.int64, device=o.device)
    for k, (_, b) in enumerate(irows):
        first_b = torch.where(bad_i[k], torch.clamp_max(first_b, b), first_b)
    for k, (_, b) in enumerate(frows):
        first_b = torch.where(bad_f[k], torch.clamp_max(first_b, b), first_b)
    for k, (_, b) in enumerate(irows):
        if bool((bad_i[k] & (first_b == b)).any()):
            fail(f"K2 case {name!r}: a ray differs first in an integer record")
    for k, (_, b) in enumerate(frows):
        sel = bad_f[k] & (first_b == b)
        if bool(sel.any()) and int(ulps(fk[k], fp[k])[sel].max()) > 2:
            fail(f"K2 case {name!r}: a ray differs first by more than 2 ulp")
    print(f"    within the T8 bar: {n_bad} rays follow a <= 2 ulp float difference")


def check_probe(dev) -> dict:
    """K3 against chain_plain for every op class at each checked size, on
    >= 1M seeded elements (negatives and edge values included): float bits
    equal, NaNs in the same places; then the SASS check that each timed
    chain kept >= P*K instructions of its class in its loop."""
    props = torch.cuda.get_device_properties(dev)
    n = max(1 << 20, props.multi_processor_count * props.max_threads_per_multi_processor
            * k3.WAVES)
    x = k3.probe_input(n, 5, dev)
    res = {"mismatches": 0, "max_abs_err": 0.0, "elements": 0}
    print(f"phase 3: op-price probe K3 vs chain_plain ({len(k3.OPS)} op classes x "
          f"{len(PROBE_CHECKS)} sizes, {n} elements each; float bits equal, NaNs in the "
          f"same places)")
    for P, K, iters in PROBE_CHECKS:
        parts = []
        for op in k3.OPS:
            yk = k3.chain_launch(x, op, P, K, iters)
            yp = k3.chain_plain(x, op, P, K, iters)
            torch.cuda.synchronize()
            bad = int(((yk.view(torch.int32) != yp.view(torch.int32))
                       & ~(torch.isnan(yk) & torch.isnan(yp))).sum())
            fin = torch.isfinite(yk) & torch.isfinite(yp)
            err = float(torch.where(fin, (yk - yp).abs(), torch.zeros_like(yk)).max())
            res["mismatches"] += bad
            res["max_abs_err"] = max(res["max_abs_err"], err)
            res["elements"] += n
            parts.append(f"{op}={bad}")
        print(f"  P={P} K={K} iters={iters}: differing elements {' '.join(parts)}", flush=True)
    if res["mismatches"]:
        fail("K3 disagrees with its plain version")
    before = k3.chain_cuda.launches
    if k3.chain_cuda(x[:0], "f32add").numel() or k3.chain_cuda.launches != before:
        fail("an empty input must return an empty output and count no K3 launch")

    chk = k3.chain_sass_check(k3.sass_of(build.lib_path(k3.KERNEL)))
    print("phase 3: K3's timed chains in its SASS (instructions of the class's marker "
          "opcode inside the iteration loop / P*K needed)")
    folded = []
    res["sass"] = {}
    for P, K in ((k3.P_TIMED, k3.K_TIMED), (k3.P_TIMED, 1)):
        parts = []
        for op in k3.OPS:
            c = chk.get((op, P, K))
            if c is None:
                fail(f"no chain kernel ({op}, P={P}, K={K}) in the SASS of {k3.KERNEL}")
            parts.append(f"{op}:{c['marker']}={c['in_loop']}/{c['need']}")
            res["sass"][f"{op}/P{P}/K{K}"] = {k: c[k] for k in ("marker", "in_loop", "need",
                                                               "loop_instructions")}
            if not c["ok"]:
                folded.append((op, P, K, c))
        print(f"  P={P} K={K}: {' '.join(parts)}", flush=True)
    for op, P, K, c in folded:
        print(f"  folded: {op} P={P} K={K}: loop opcodes {c['loop_opcodes']}")
    if folded:
        fail("a timed chain of K3 was folded by the compiler (fewer than P*K "
             "instructions of its class in its loop)")
    return res


def profile_frame(scene, cam, cfg, label=None) -> None:
    """Device time of one steady frame by stage (the renderer's named
    ranges) and by kernel, from torch.profiler's device-side events."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        scene.render(*cam, 7, cfg)
        torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3
    on_device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    stages, kernels = defaultdict(float), defaultdict(float)
    counts = defaultdict(int)
    for e in on_device:
        ms = e.time_range.elapsed_us() / 1e3
        if getattr(e, "is_user_annotation", False):
            stages[e.name] += ms
        else:
            kernels[e.name] += ms
            counts[e.name] += 1
    busy = sum(kernels.values())
    if busy <= 0:
        fail("torch.profiler recorded no device time")
    label = label or ("fused" if cfg.pallas_fused else "staged")
    print(f"  profile of one frame ({label}): "
          f"host {wall:.1f} ms under the profiler, device busy {busy:.1f} ms in "
          f"{sum(counts.values())} kernel launches")
    for name in sorted(stages):
        print(f"    stage {name:<22s} {stages[name]:8.2f} ms")
    print("    top kernels by device time:")
    for name in sorted(kernels, key=kernels.get, reverse=True)[:10]:
        print(f"    {kernels[name]:8.2f} ms  x{counts[name]:<5d} {name[:90]}")


def render_frames(scene, cam, cfg, frames, **kw):
    """(frame times in ms, last frame) of `frames` frames; kw for frame 0."""
    out, times = None, []
    for f in range(frames):
        torch.cuda.synchronize()
        t0 = time.time()
        out = scene.render(*cam, f, cfg, **(kw if f == 0 else {}))
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
    return times, out


def check_frame(frame, cfg) -> None:
    if tuple(frame.shape) != (cfg.height, cfg.width, 4) or frame.dtype != torch.uint8:
        fail(f"frame has shape {tuple(frame.shape)} dtype {frame.dtype}")
    fr = frame.cpu().numpy()
    if not (fr[..., 3] == 255).all() or fr[..., :3].std() < 5.0 or len(np.unique(fr[..., :3])) < 32:
        fail("frame content is trivial")
    print(f"  frame ok: mean={fr[..., :3].mean():.2f} std={fr[..., :3].std():.2f}")


CONV_CHUNKS = 16               # passes of the converged frame: 16 x 8 spp = 128 spp
REPLAY_FRAMES = 2              # full-width frames of each replay configuration


def counts() -> tuple:
    return k2.trace_path_cuda.launches, k1.trace_proc_cuda.launches


def zero_counts() -> None:
    k1.trace_proc_cuda.launches = 0
    k2.trace_path_cuda.launches = 0


def converged_phase(scene, cam, cfg, card) -> dict:
    """A 128-spp converged frame of the graded scene through
    Scene.render_converged (16 passes of the main path on the device): 16 K2
    launches and no K1 launch, no host synchronisation inside the pass loop
    (it runs under torch.cuda.set_sync_debug_mode("error"), the camera given
    as device tensors), equal bit for bit to PathTracer's host loop."""
    print(f"phase 4b: converged frame, {CONV_CHUNKS} passes x {cfg.samples_per_pixel} spp "
          f"at {cfg.width}x{cfg.height} (Scene.render_converged; card: {card})", flush=True)
    pt = PathTracer.on_scene(scene, cfg)
    pose = CameraPose(*(np.asarray(v, np.float32) for v in cam))
    cam_dev = pose.arrays(scene.device)
    torch.cuda.synchronize()
    t0 = time.time()
    host = pt.render_converged(pose, total_spp=CONV_CHUNKS * cfg.samples_per_pixel, frame0=0)
    torch.cuda.synchronize()
    host_ms = (time.time() - t0) * 1e3
    # the detector is armed: a read-back to the host raises under it
    torch.cuda.set_sync_debug_mode("error")
    try:
        float(cam_dev[0].sum())
        fail("torch.cuda.set_sync_debug_mode('error') let a device-to-host read pass")
    except RuntimeError:
        pass
    finally:
        torch.cuda.set_sync_debug_mode(0)
    times, launches = [], []
    one = None
    for rep in range(2):
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        torch.cuda.set_sync_debug_mode("error")
        try:
            one = scene.render_converged(*cam_dev, 0, CONV_CHUNKS, cfg)
        except RuntimeError as e:
            fail(f"the converged pass loop synchronised with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        times.append((time.time() - t0) * 1e3)
        launches.append(counts())
    n2, n1 = launches[0]
    print(f"  converged frame: {[round(x, 1) for x in times]} ms "
          f"({times[-1] / CONV_CHUNKS:.2f} ms per pass) | K2 launches = {n2} "
          f"({CONV_CHUNKS} expected) | K1 launches = {n1} (0 expected) | host loop "
          f"{host_ms:.1f} ms | no host sync in the pass loop (sync debug mode 'error')")
    if launches[0] != (CONV_CHUNKS, 0) or launches[1] != (CONV_CHUNKS, 0):
        fail(f"expected {CONV_CHUNKS} K2 and 0 K1 launches per converged frame, "
             f"counted {launches}")
    check_frame(one, cfg)
    n_diff = int((one != host).sum())
    print(f"  one loop vs PathTracer host loop: {n_diff} differing bytes")
    if n_diff:
        fail("the converged frame differs from the host loop's")
    return {"chunks": CONV_CHUNKS, "spp": CONV_CHUNKS * cfg.samples_per_pixel,
            "frame_ms": times[-1], "frames_ms": times, "ms_per_pass": times[-1] / CONV_CHUNKS,
            "host_loop_ms": host_ms, "k2_launches": n2, "k1_launches": n1,
            "differing_bytes_vs_host_loop": n_diff, "card": card}


def plain_march(ps, o, d, t_min=0.001, t_max=1000.0, pd=None, tcap=None, **_):
    """K1's plain version with trace_proc_cuda's call signature."""
    return dda_proc.trace_proc(ps, o, d, t_min, t_max, pd, tcap)


def replay_phase(scene, cam, cfg, card, profile=False) -> dict:
    """The fused path's trace-record replay at full width: with
    pallas_inkernel_radiance=False 1 K2 launch (trace mode) and 0 K1 launches
    per frame; with pallas_inkernel_nee=False 1 K2 and 1 K1 launch (the
    shadow rays of every bounce). At 160x120 each is held kernel vs plain
    version (byte-identical) and against the in-kernel-radiance frame
    (+-1 u8 at >= 99 % of pixels)."""
    out = {}
    small = cfg.replace(width=160, height=120)
    f_ikr = scene.render(*cam, 0, small)
    for name, change, k1_per_frame in (
            ("replay_ikr_off", dict(pallas_inkernel_radiance=False), 0),
            ("replay_split_nee", dict(pallas_inkernel_nee=False), 1)):
        rc = cfg.replace(**change)
        print(f"phase 4b: trace-record replay {name} ({change}) at {cfg.width}x{cfg.height}, "
              f"{REPLAY_FRAMES} frames; 1 K2 and {k1_per_frame} K1 launches per frame "
              f"expected (card: {card})", flush=True)
        zero_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms, frame = render_frames(scene, cam, rc, REPLAY_FRAMES)
        n2, n1 = counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"  frames: {[round(x, 1) for x in ms]} ms | K2 launches = {n2} | K1 launches = "
              f"{n1} | peak memory {peak:.2f} GiB")
        if (n2, n1) != (REPLAY_FRAMES, k1_per_frame * REPLAY_FRAMES):
            fail(f"{name}: expected {REPLAY_FRAMES} K2 and {k1_per_frame * REPLAY_FRAMES} K1 "
                 f"launches, counted {n2} and {n1}")
        check_frame(frame, rc)
        rs = rc.replace(width=160, height=120)
        f_k = scene.render(*cam, 0, rs)
        f_p = scene.render(*cam, 0, rs, path_tracer=k2.trace_path_plain, march_tracer=plain_march)
        torch.cuda.synchronize()
        n_diff = int((f_k != f_p).sum())
        du8 = (f_k.to(torch.int16) - f_ikr.to(torch.int16)).abs().amax(-1)
        within1 = float((du8 <= 1).float().mean())
        print(f"  160x120: kernel vs plain version {n_diff} differing bytes; vs the "
              f"in-kernel-radiance frame {float((du8 == 0).float().mean()):.4f} of pixels "
              f"equal, {within1:.4f} within +-1 u8, max {int(du8.max())}")
        if n_diff:
            fail(f"{name}: kernel frame differs from the plain-version frame")
        if within1 < 0.99:
            fail(f"{name}: replay frame and in-kernel-radiance frame differ beyond +-1 u8 "
                 f"at 1 % of pixels")
        if profile:
            profile_frame(scene, cam, rc, label=name)
        steady = float(np.median(ms[1:])) if len(ms) > 1 else ms[0]
        out[name] = {"frame_ms": steady, "frames_ms": ms, "peak_gib": peak,
                     "k2_launches": n2, "k1_launches": n1,
                     "differing_bytes_vs_plain": n_diff, "within1_vs_ikr": within1,
                     "card": card}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only-kernel", action="store_true",
                    help="stop after the kernel-vs-plain phase (bring-up aid)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one full-width frame of each configuration (the "
                         "replays included) with torch.profiler and print device time "
                         "per stage and per kernel")
    args = ap.parse_args()
    t_start = time.time()

    # ---- phase 1: device ----
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    dev = torch.device("cuda")
    card = smi_line()
    print(f"phase 1: device {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # ---- phase 2: build + load ----
    # built anew even where a library of the same sources exists: the
    # registers and spills below are read from this build's ptxas report
    logs = build.build([k1.KERNEL, k2.KERNEL, k3.KERNEL], extra_flags=("-Xptxas", "-v"),
                       force=True)
    k1._kernel_fn()
    k2._kernel_fn()
    k3._kernel_fn()
    regs = {}
    builds = {}
    for name, log in logs.items():
        print(f"phase 2: built {name}.cu in {build.BUILD_SECONDS[name]:.1f} s "
              f"({' '.join(build.NVCC_FLAGS)})")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                regs.setdefault(name, []).append(line.strip())
                if name != k3.KERNEL:
                    print("   ", line.strip())
    for tag, mod in (("K1", k1), ("K2", k2)):
        ptxas = builds[mod.KERNEL] = k2_ab.ptxas_report(logs.get(mod.KERNEL, ""), mod.KERNEL)
        if not ptxas:
            fail(f"no ptxas report of {tag}'s kernel function in the build log")
        print(f"    {tag} {k2_ab.KERNEL_FUNCTION[mod.KERNEL]}: {ptxas['registers']} registers, "
              f"stack frame {ptxas['stack_bytes']} bytes, spill stores "
              f"{ptxas['spill_store_bytes']} bytes, spill loads {ptxas['spill_load_bytes']} bytes")
    k1_build, k2_build = builds[k1.KERNEL], builds[k2.KERNEL]
    occ1 = k1.occupancy(dev)
    warps1 = occ1["blocks_per_sm"] * occ1["threads"] // 32
    print(f"    K1 persistent grid: {occ1['grid']} blocks = {occ1['blocks_per_sm']} per SM (the "
          f"runtime's occupancy) x {occ1['sms']} SMs, {occ1['threads']} threads each -> "
          f"{warps1} resident warps per SM; {occ1['registers']} registers, "
          f"{occ1['local_bytes']} bytes of local memory (stack + spills) per thread, "
          f"{occ1['smem_bytes']} bytes of static shared memory per block")
    probe_log = logs.get(k3.KERNEL, "")
    probe_regs = [int(m) for m in re.findall(r"Used (\d+) registers", probe_log)]
    probe_spills = sum(int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", probe_log))
    print(f"    {k3.KERNEL}: {len(probe_regs)} chain kernels, registers "
          f"{min(probe_regs, default=0)}-{max(probe_regs, default=0)}, "
          f"spilled bytes {probe_spills}")
    sys.stdout.flush()

    # ---- phase 3: kernels vs plain versions ----
    G = 128
    cfg = RenderConfig(width=800, height=600, samples_per_pixel=8, max_bounces=4)
    staged_cfg = entry.STAGED_CONFIG
    ps0 = dda_proc.ProcStatic(
        seed=0, noise_scale=20.0, y_falloff=500.0, threshold=0.2,
        origin=(-G // 2,) * 3, shape=(G, G, G), grass=1, stone=5, air=7,
        n_edits=0, y_air=-1)
    results = {"mismatches": 0, "max_abs_err": 0.0, "rays": 0}
    print("phase 3: trace_proc kernel vs plain version (packed exact, t bit-equal)")
    eye = torch.tensor([64.0, 96.0, 20.0], device=dev)
    front = torch.tensor([0.0, -0.35, 0.94], device=dev)
    right = torch.tensor([-1.0, 0.0, 0.0], device=dev)
    up = torch.tensor([0.0, -0.94, -0.35], device=dev)
    oc, dc, sc = raygen(eye, front, right, up, 1280, 800, 1, 0)
    oc = oc.reshape(-1, 3).contiguous()
    dc = dc.reshape(-1, 3).contiguous()
    sc = sc.reshape(-1).contiguous()
    orand, drand = random_rays(1 << 20, G, 1, dev)
    compare_case("pristine/camera", ps0, None, oc, dc, None, results)
    compare_case("pristine/random", ps0, None, orand, drand, None, results)
    ps_y = ps0._replace(y_air=G // 2 + 8)   # a y_cut that does fire
    ps_e, pd_e = hand_edited_world(ps_y, dev)
    compare_case("hand-edited/camera", ps_e, pd_e, oc, dc, None, results)
    compare_case("hand-edited/random", ps_e, pd_e, orand, drand, None, results)
    tcap = torch.from_numpy(
        np.random.default_rng(2).uniform(0.0, 60.0, orand.shape[0]).astype(np.float32)
    ).to(dev)
    compare_case("hand-edited/random+tcap", ps_e, pd_e, orand, drand, tcap, results)
    before = k1.trace_proc_cuda.launches
    t_0, w_0 = k1.trace_proc_cuda_packed(ps_e, orand[:0], drand[:0], 0.001, 1000.0, pd_e, tcap[:0])
    if t_0.numel() or w_0.numel() or k1.trace_proc_cuda.launches != before:
        fail("an empty ray batch must return empty outputs and count no launch")

    scene, cam = entry.graded_scene(G, cfg, device=dev)
    ps_g, pd_g = scene.proc_static, scene.proc_arrays
    if ps_g is None or ps_g.n_edits == 0:
        fail("graded scene has no proc bundle / no edit list")
    eye_l = scene.camera_to_local(cam[0])
    cam_t = [torch.as_tensor(v, dtype=torch.float32, device=dev) for v in cam[1:]]
    og, dg, sg = raygen(eye_l, *cam_t, 1280, 800, 1, 0)
    og = og.reshape(-1, 3).contiguous()
    dg = dg.reshape(-1, 3).contiguous()
    sg = sg.reshape(-1).contiguous()
    compare_case("graded/camera", ps_g, pd_g, og, dg, None, results)
    compare_case("graded/random", ps_g, pd_g, orand, drand, None, results)
    compare_case("graded/random+tcap", ps_g, pd_g, orand, drand, tcap, results)
    # K1's persistent grid at its refill edges, in both worlds: fewer rays
    # than a warp, a block and a grid, n not a multiple of 32, and rays that
    # leave the world at once interleaved with rays that graze the terrain
    ol, dl, sl = leave_and_graze_rays(ps_g, 1 << 20, 6, dev)
    for world, ps_w, pd_w in (("pristine", ps0, None), ("graded", ps_g, pd_g)):
        for nn in (1, 33, 129):
            compare_case(f"{world}/leave+graze[1:{1 + nn}]", ps_w, pd_w, ol[1:1 + nn],
                         dl[1:1 + nn], None, results)
        compare_case(f"{world}/leave+graze", ps_w, pd_w, ol, dl, None, results)
    compare_case("pristine/random+tcap", ps0, None, orand, drand, tcap, results)
    # T3: the kernel's occupancy agrees with the scene's own prediction —
    # every cell the worldgen program and the tracer disagree on is an edit
    n_edit_rows = int((pd_g["edit_cells"][:, 0] >= 0).sum())
    print(f"  graded scene: edit rows in use = {n_edit_rows} (1 = the lamp only; "
          f"more would be worldgen/tracer drift absorbed as edits)")
    if n_edit_rows != 1:
        fail("the port's worldgen and its tracer's prediction disagree on this device")

    print("phase 3: path kernel K2 vs trace_path_plain (integer records exact, floats "
          "bit-equal NaN-aware, or the T8 bar)")
    res2 = {"mismatches": 0, "max_abs_err": 0.0, "rays": 0}
    cases2 = []
    B = cfg.max_bounces
    graded_kw = dict(inst=scene.instances_device, inst_static=scene.inst_static,
                     lights=scene.bvh_device["flat"])
    rad_kw = dict(radiance=True, light_em=scene.light_em,
                  nee_scale=cfg.nee_importance_scale, nee_clamp=cfg.nee_mis_clamp,
                  emission_gain=cfg.emission_gain)
    oe, de, se = edge_rays(1 << 20, G, 3, dev)
    for mode_kw, tag in ((dict(nee_pdf=True), "trace"), (rad_kw, "rad")):
        kw_p = {k: v for k, v in mode_kw.items() if k != "light_em"}
        compare_path(f"pristine/camera/{tag}", ps0, None, oc, dc, sc, B, res2, kw_p, cases2)
        compare_path(f"graded/camera/{tag}", ps_g, pd_g, og, dg, sg, B, res2,
                     {**graded_kw, **mode_kw}, cases2)
        compare_path(f"graded/edge/{tag}", ps_g, pd_g, oe, de, se, B, res2,
                     {**graded_kw, **mode_kw}, cases2)
    # the persistent grid's refill edges (the rays of K1's cases above)
    # K2 skips the instance test of a ray that misses the instances' widened
    # bounding box: rays aimed at them
    oi, di, si = instance_rays(scene, 1 << 20, 7, dev)
    for mode_kw, tag in ((dict(nee_pdf=True), "trace"), (rad_kw, "rad")):
        for nn in (1, 33, 129):
            compare_path(f"graded/leave+graze[1:{1 + nn}]/{tag}", ps_g, pd_g, ol[1:1 + nn],
                         dl[1:1 + nn], sl[1:1 + nn], B, res2, {**graded_kw, **mode_kw}, cases2)
        compare_path(f"graded/leave+graze/{tag}", ps_g, pd_g, ol, dl, sl, B, res2,
                     {**graded_kw, **mode_kw}, cases2)
        compare_path(f"graded/at-instances/{tag}", ps_g, pd_g, oi, di, si, B, res2,
                     {**graded_kw, **mode_kw}, cases2)
    scene_m, _ = entry.graded_scene(G, cfg, device=dev)
    place_mirror_and_glass(scene_m)
    m_kw = dict(inst=scene_m.instances_device, inst_static=scene_m.inst_static,
                lights=scene_m.bvh_device["flat"])
    for mode_kw, tag in ((dict(nee_pdf=True), "trace"), ({**rad_kw, "light_em": scene_m.light_em}, "rad")):
        compare_path(f"mirror+glass/camera/{tag}", scene_m.proc_static, scene_m.proc_arrays,
                     og, dg, sg, B, res2, {**m_kw, **mode_kw}, cases2)
    before = k2.trace_path_cuda.launches
    empty = k2.trace_path_cuda(ps_g, og[:0], dg[:0], sg[:0], B, pd=pd_g, raw=True,
                               **graded_kw, **rad_kw)
    if empty[1].numel() or empty[2].numel() or k2.trace_path_cuda.launches != before:
        fail("an empty ray batch must return empty records and count no K2 launch")

    res3 = check_probe(dev)
    if args.only_kernel:
        print(f"only-kernel run done in {time.time() - t_start:.1f} s; "
              f"K1 mismatches={results['mismatches']} K2 differing rays={res2['mismatches']} "
              f"K3 differing elements={res3['mismatches']}")
        return

    # ---- phase 4: the main path at full width ----
    print(f"phase 4: main path {cfg.width}x{cfg.height} spp={cfg.samples_per_pixel} "
          f"bounces={cfg.max_bounces} world={G}^3 (default RenderConfig: the fused "
          f"path kernel, in-kernel NEE and radiance, {cfg.pallas_tile} patches)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.trace_proc_cuda.launches = 0
    k2.trace_path_cuda.launches = 0
    path_log = []
    frame_ms, frame = render_frames(scene, cam, cfg, FRAMES, path_log=path_log)
    launches2 = k2.trace_path_cuda.launches
    launches1_fused = k1.trace_proc_cuda.launches
    print(f"  frames: {[round(x, 1) for x in frame_ms]} ms | K2 launches = {launches2} "
          f"(1 per frame expected) | K1 launches = {launches1_fused} (0 expected) | "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches2 != FRAMES or launches1_fused != 0:
        fail(f"expected {FRAMES} K2 and 0 K1 launches, counted {launches2} and {launches1_fused}")
    check_frame(frame, cfg)
    small = cfg.replace(width=160, height=120)
    f_k = scene.render(*cam, 0, small)
    f_p = scene.render(*cam, 0, small, path_tracer=k2.trace_path_plain)
    f_s = scene.render(*cam, 0, staged_cfg.replace(width=160, height=120))
    torch.cuda.synchronize()
    n_diff = int((f_k != f_p).sum())
    du8 = (f_k.to(torch.int16) - f_s.to(torch.int16)).abs().amax(-1)
    within1 = float((du8 <= 1).float().mean())
    exact = float((du8 == 0).float().mean())
    print(f"  160x120 fused frame, kernel vs plain version on the card: {n_diff} differing bytes")
    print(f"  160x120 fused vs staged frame on the card: {exact:.4f} of pixels equal, "
          f"{within1:.4f} within +-1 u8, max {int(du8.max())}")
    if n_diff:
        fail("fused kernel frame differs from the plain-version frame")
    if within1 < 0.99:
        fail("fused frame and staged frame differ beyond +-1 u8 at 1 % of pixels")
    if args.profile:
        profile_frame(scene, cam, cfg)

    print(f"phase 4: the staged configuration ({STAGED_FRAMES} frames; 5 K1 launches "
          f"per frame expected)")
    k1.trace_proc_cuda.launches = 0
    k2.trace_path_cuda.launches = 0
    trace_log = []
    staged_ms, frame_st = render_frames(scene, cam, staged_cfg, STAGED_FRAMES,
                                        trace_log=trace_log)
    launches1 = k1.trace_proc_cuda.launches
    per_frame1 = staged_cfg.max_bounces + 1
    print(f"  frames: {[round(x, 1) for x in staged_ms]} ms | K1 launches = {launches1} | "
          f"K2 launches = {k2.trace_path_cuda.launches}")
    if launches1 != per_frame1 * STAGED_FRAMES or k2.trace_path_cuda.launches != 0:
        fail(f"expected {per_frame1 * STAGED_FRAMES} K1 and 0 K2 launches")
    check_frame(frame_st, staged_cfg)
    f_k = scene.render(*cam, 0, staged_cfg.replace(width=160, height=120))
    f_p = scene.render(*cam, 0, staged_cfg.replace(width=160, height=120, proc_backend="xla",
                                                   beam_prepass=False))
    torch.cuda.synchronize()
    n_diff = int((f_k != f_p).sum())
    print(f"  160x120 staged frame, kernel vs plain version on the card: {n_diff} differing bytes")
    if n_diff:
        fail("staged kernel frame differs from the plain-version frame")
    if args.profile:
        profile_frame(scene, cam, staged_cfg)
    k1.trace_proc_cuda.launches = launches1  # the comparison frames do not count
    k2.trace_path_cuda.launches = launches2

    # ---- phase 4b: converged frame and the trace-record replays ----
    conv = converged_phase(scene, cam, cfg, card)
    replays = replay_phase(scene, cam, cfg, card, profile=args.profile)
    k1.trace_proc_cuda.launches = launches1
    k2.trace_path_cuda.launches = launches2

    # ---- phase 5: times at the main-path shapes ----
    print(f"phase 5: kernel times at the main path's shapes (card: {card})")
    if len(trace_log) != per_frame1:
        fail(f"trace log holds {len(trace_log)} launches, expected {per_frame1}")
    E = ps_g.n_edits
    ops_step = roofline.total(roofline.step_mix(E))
    per_launch = []
    k1_launches = []          # per-ray steps + kernel time, for the roofline
    for li, (o_l, d_l, tcap_l) in enumerate(trace_log):
        label = f"bounce{li}" if tcap_l is None else "shadow"
        n = o_l.shape[0]
        ms = event_ms(lambda: k1.trace_proc_cuda_packed(
            ps_g, o_l, d_l, staged_cfg.t_min, staged_cfg.t_max, pd_g, tcap_l), reps=3)
        stats, plain = {}, []
        plain_ms = event_ms(lambda: plain.append(dda_proc.trace_proc_packed(
            ps_g, o_l, d_l, staged_cfg.t_min, staged_cfg.t_max, pd_g, tcap_l, stats)),
            warmup=False)
        t_p, w_p = plain[0]
        t_k, w_k = k1.trace_proc_cuda_packed(ps_g, o_l, d_l, staged_cfg.t_min,
                                             staged_cfg.t_max, pd_g, tcap_l)
        bad = int((w_p != w_k).sum()) + int((t_p.view(torch.int32) != t_k.view(torch.int32)).sum())
        results["mismatches"] += bad
        results["max_abs_err"] = max(results["max_abs_err"], float((t_p - t_k).abs().max()))
        results["rays"] += n
        if bad:
            fail(f"kernel disagrees with its plain version on main-path launch {label}")
        ops = roofline.total(roofline.k1_ops(stats["steps"], n, E))
        k1_launches.append({"ray_steps": stats["ray_steps"], "ms": ms})
        nbytes = n * (24 + (4 if tcap_l is not None else 0) + 8)
        t_ops = ops / PEAK_FP32_OPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        per_launch.append({
            "launch": label, "rays": n, "grid": k1.grid(n, occ1), "steps": stats["steps"],
            "steps_per_ray": stats["steps"] / n, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops_bound_ms": t_ops, "bytes_bound_ms": t_bytes,
        })
        print(f"  K1 {label}: rays={n} steps/ray={stats['steps'] / n:.1f} kernel={ms:.2f} ms "
              f"grid={per_launch[-1]['grid']} blocks plain={plain_ms:.0f} ms "
              f"bound={max(t_ops, t_bytes):.3f} ms ({per_launch[-1]['bound_by']})", flush=True)
    k1.trace_proc_cuda.launches = launches1  # timing launches do not count
    ms_total = sum(p["ms"] for p in per_launch)
    plain_total = sum(p["plain_ms"] for p in per_launch)
    ops_total = sum(p["ops_bound_ms"] for p in per_launch)
    bytes_total = sum(p["bytes_bound_ms"] for p in per_launch)
    staged_steady = float(np.median(staged_ms[1:])) if len(staged_ms) > 1 else staged_ms[0]

    # K2 at the main path's launch: the frame-0 rays in the patch layout
    if len(path_log) != 1:
        fail(f"path log holds {len(path_log)} launches, expected 1")
    o_p, d_p, s_p = path_log[0]
    n2 = o_p.shape[0]
    fused_kw = dict(inst=scene.instances_device, inst_static=scene.inst_static,
                    lights=scene.bvh_device["flat"], **rad_kw)
    ps_f = ps_g._replace(use_coarse=False)
    # the launch alone: the call's static tables resolved once, as one frame's
    # call resolves them once (the whole wrapper call is the profile's
    # fused_path_radiance range)
    spec_t = k2._make_spec(ps_f, pd_g, B, dev, scene.instances_device, scene.inst_static,
                           scene.bvh_device["flat"], False, True, scene.light_em,
                           cfg.nee_importance_scale, cfg.nee_mis_clamp, cfg.emission_gain)
    ms2 = event_ms(lambda: k2._launch_flat(spec_t, ps_f, pd_g, o_p, d_p, s_p,
                                          cfg.t_min, cfg.t_max), reps=5)
    ms2_call = event_ms(lambda: k2.trace_path_cuda(ps_f, o_p, d_p, s_p, B, pd=pd_g, raw=True,
                                                  **fused_kw), reps=3)
    stats2, plain2 = {}, []
    plain_ms2 = event_ms(lambda: plain2.append(k2.trace_path_plain(
        ps_f, o_p, d_p, s_p, B, pd=pd_g, raw=True, stats=stats2, **fused_kw)), warmup=False)
    spec2, ip2, fp2 = plain2[0]
    _, ik2, fk2 = k2.trace_path_cuda(ps_f, o_p, d_p, s_p, B, pd=pd_g, raw=True, **fused_kw)
    torch.cuda.synchronize()
    bad2 = int(((ik2 != ip2).any(0) | ((fk2.view(torch.int32) != fp2.view(torch.int32))
                                       & ~(torch.isnan(fk2) & torch.isnan(fp2))).any(0)).sum())
    res2["mismatches"] += bad2
    res2["rays"] += n2
    print(f"  K2 main-path launch: kernel vs plain version: {bad2} rays differ")
    if bad2 > (1.0 - T8_INT_BAR) * n2:
        fail("K2 disagrees with its plain version on the main-path launch")
    k2.trace_path_cuda.launches = launches2
    path_steps = stats2["path"]["steps"]
    shadow_steps = stats2.get("shadow", {}).get("steps", 0)
    shadow_rays = stats2.get("shadow", {}).get("rays", 0)
    # what the radiance-mode shadow skip removed: trace mode marches every
    # sample's shadow ray (plain version, the same rays)
    stats_tr = {}
    k2.trace_path_plain(ps_f, o_p, d_p, s_p, B, pd=pd_g, raw=True, stats=stats_tr,
                        inst=scene.instances_device, inst_static=scene.inst_static,
                        lights=scene.bvh_device["flat"])
    skip = {"trace_mode_shadow_rays": stats_tr["shadow"]["rays"],
            "trace_mode_shadow_steps": stats_tr["shadow"]["steps"],
            "rays_removed": stats_tr["shadow"]["rays"] - shadow_rays,
            "steps_removed": stats_tr["shadow"]["steps"] - shadow_steps}
    _, words2, _, _ = k2.launch_args(spec_t, ps_f, pd_g, n2, cfg.t_min, cfg.t_max, o_p.device)
    occ = k2.occupancy(words2, o_p.device)
    warps_per_sm = occ["blocks_per_sm"] * occ["threads"] // 32
    print(f"  K2 persistent grid: {occ['grid']} blocks = {occ['blocks_per_sm']} per SM (the "
          f"runtime's occupancy) x {occ['sms']} SMs, {occ['threads']} threads each -> "
          f"{warps_per_sm} resident warps per SM; {occ['registers']} registers, "
          f"{occ['local_bytes']} bytes of local memory (stack + spills) per thread, "
          f"{occ['smem_bytes']} bytes of shared memory per block")
    print(f"  radiance-mode shadow skip: {shadow_rays} shadow rays and {shadow_steps} steps "
          f"marched, trace mode {skip['trace_mode_shadow_rays']} and "
          f"{skip['trace_mode_shadow_steps']}: removed {skip['rays_removed']} rays and "
          f"{skip['steps_removed']} steps")
    segs = stats2["segments"]
    n_tri = spec2.n_inst
    L = spec2.n_lights
    ops2 = roofline.total(roofline.k2_ops(path_steps, shadow_steps, segs, shadow_rays,
                                          n_tri, L, E, B))
    irows2, frows2 = k2.record_layout(spec2)
    bytes2 = n2 * (28 + 4 * (len(irows2) + len(frows2)))
    t_ops2 = ops2 / PEAK_FP32_OPS * 1e3
    t_bytes2 = bytes2 / PEAK_BYTES * 1e3
    frame_steady = float(np.median(frame_ms[1:])) if len(frame_ms) > 1 else frame_ms[0]
    print(f"  K2 radiance mode: rays={n2} (patch layout) live per bounce={segs} "
          f"path steps/ray={path_steps / n2:.2f} shadow rays={shadow_rays} "
          f"shadow steps/ray={shadow_steps / max(1, shadow_rays):.2f} kernel={ms2:.2f} ms "
          f"(whole wrapper call {ms2_call:.2f} ms) "
          f"plain={plain_ms2:.0f} ms bound={max(t_ops2, t_bytes2):.3f} ms "
          f"({'operations' if t_ops2 >= t_bytes2 else 'bytes'}; ops {t_ops2:.3f} ms, "
          f"bytes {t_bytes2:.3f} ms)", flush=True)
    print(f"  fused frame {frame_steady:.1f} ms (median of frames after the first; K2 "
          f"{ms2:.1f} ms of it) | staged frame {staged_steady:.1f} ms (K1 {ms_total:.1f} ms "
          f"of it) | card: {card}")

    # ---- phase 6: the kernel-pricing tool chain (the path of K3) ----
    print(f"phase 6: op prices (vpu_probe ops: K3 at P={k3.P_TIMED}, K={k3.K_TIMED} vs K=1, "
          f"{k3.ITERS} iterations), audit, roofline (card: {card})", flush=True)
    k3.chain_cuda.launches = 0
    prices = k3.cmd_ops(dev, out=lambda m: print("  " + m))
    launches3 = k3.chain_cuda.launches
    print(f"  K3 launches in the price table: {launches3}")
    if launches3 == 0:
        fail("the price table launched no K3 kernel")
    x3 = k3.probe_input(prices["n"], 0, dev)
    torch.cuda.synchronize()
    plain3 = {op: event_ms(lambda: k3.chain_plain(x3, op, k3.P_TIMED, k3.K_TIMED, k3.ITERS),
                           warmup=False) for op in k3.OPS}
    rows3 = prices["classes"]
    ms3 = sum(r["ms_k32"] for r in rows3.values())
    plain_ms3 = sum(plain3.values())
    chain_ops = k3.P_TIMED * k3.K_TIMED * k3.ITERS * prices["n"]
    # the bound as for K1 and K2: operations over the published fp32 peak;
    # beside it the CUDA Programming Guide's per-class rates, which the card beats for some
    # classes (int32 add)
    bound3 = len(rows3) * chain_ops / PEAK_FP32_OPS * 1e3
    bound3_guide = sum(chain_ops / r["published_ops_per_s"] for r in rows3.values()) * 1e3
    print(f"  K3, one K=32 launch per class: kernel {ms3:.3f} ms in all, plain version "
          f"{plain_ms3:.0f} ms, bound {bound3:.3f} ms (operations at the fp32 peak; at the "
          f"Programming Guide's per-class rates {bound3_guide:.3f} ms)")

    audit = k3.cmd_audit(dev, out=lambda m: print("  " + m))
    if not any(f.startswith(k1.KERNEL + ":") and h["loop"] for f, h in audit["sass"].items()):
        fail("no march loop found in the SASS of K1")
    roof = roofline.analyse(rows3, k1_launches,
                            {"stats": stats2, "n_tri": n_tri, "n_lights": L, "B": B, "ms": ms2},
                            E, audit["sass"])
    roofline.report(roof, out=lambda m: print("  " + m))
    roof1, roof2 = roof["k1"], roof["k2"]
    print(f"  K1 per staged launch at the measured class rates (card: {card}):")
    for p, r in zip(per_launch, roof1["per_launch"]):
        p["share_of_measured_rate_bound"] = r["share_of_bound"]
        print(f"    {p['launch']}: rays={p['rays']} steps/ray={p['steps_per_ray']:.1f} "
              f"kernel={p['ms']:.3f} ms grid={p['grid']} blocks bound at the measured rates "
              f"{r['bound_ms_measured_rates']:.3f} ms -> share {r['share_of_bound']:.1%} "
              f"(divergence of a static assignment {r['divergence']:.2f})")

    kernels = {"kernels": [
        {
            "name": "trace_proc", "route": "cuda",
            "source": "vrv_tpu_torch/csrc/trace_proc.cu",
            "replaces": "vrv_tpu/ops/pallas/trace_proc.py:560",
            "launches": launches1, "launches_per_frame": per_frame1,
            "path": "staged configuration (entry.STAGED_CONFIG)",
            "launches_by_path": {"staged": launches1, "converged": conv["k1_launches"],
                                 **{k: r["k1_launches"] for k, r in replays.items()}},
            "max_abs_err": results["max_abs_err"], "mismatches": results["mismatches"],
            "rays": results["rays"],
            "ms": ms_total, "plain_ms": plain_total,
            "bound_ms": max(ops_total, bytes_total),
            "bound_by": "operations" if ops_total >= bytes_total else "bytes",
            "library_ms": None,
            "bound_ms_measured_rates": roof1["bound_ms_measured_rates"],
            "warp_floor_ms": roof1["warp_floor_ms"], "divergence": roof1["divergence"],
            "busiest_pipe": roof1["per_launch"][0]["busiest_pipe"],
            "share_of_measured_rate_bound": roof1["share_of_bound"],
            "ops_per_step": ops_step, "per_launch": per_launch,
            "roofline_per_launch": roof1["per_launch"],
            "step_vs_sass": roof["step_vs_sass"],
            "frame_ms": staged_steady, "frames_ms": staged_ms,
            "registers": regs.get(k1.KERNEL), "build": k1_build, "occupancy": occ1,
            "resident_warps_per_sm": warps1, "card": card,
        },
        {
            "name": "path_proc", "route": "cuda",
            "source": "vrv_tpu_torch/csrc/path_proc.cu",
            "replaces": "vrv_tpu/ops/pallas/path_proc.py:143",
            "launches": launches2, "launches_per_frame": 1,
            "path": "main path, default RenderConfig",
            "launches_by_path": {"main": launches2, "converged": conv["k2_launches"],
                                 **{k: r["k2_launches"] for k, r in replays.items()}},
            "converged": conv, "replays": replays,
            "max_abs_err": res2["max_abs_err"], "mismatches": res2["mismatches"],
            "rays": res2["rays"], "cases": cases2,
            "ms": ms2, "call_ms": ms2_call, "plain_ms": plain_ms2,
            "bound_ms": max(t_ops2, t_bytes2),
            "bound_by": "operations" if t_ops2 >= t_bytes2 else "bytes",
            "library_ms": None,
            "bound_ms_measured_rates": roof2["bound_ms_measured_rates"],
            "warp_floor_ms": roof2["warp_floor_ms"], "divergence": roof2["divergence"],
            "busiest_pipe": roof2["busiest_pipe"],
            "lane_steps": roof2["lane_steps"], "warp_max_steps": roof2["warp_max_steps"],
            "ops_bound_ms": t_ops2, "bytes_bound_ms": t_bytes2,
            "path_steps": path_steps, "shadow_steps": shadow_steps,
            "shadow_rays": shadow_rays, "live_per_bounce": segs,
            "steps_per_ray": (path_steps + shadow_steps) / n2,
            "share_of_measured_rate_bound": roof2["share_of_bound"],
            "frame_ms": frame_steady, "frames_ms": frame_ms,
            "build": k2_build, "occupancy": occ, "resident_warps_per_sm": warps_per_sm,
            "shadow_skip": skip, "card": card,
        },
        {
            "name": "vpu_probe", "route": "cuda",
            "source": "vrv_tpu_torch/csrc/vpu_probe.cu",
            "replaces": "tools/vpu_probe.py:87",
            "launches": launches3,
            "path": "kernel-pricing tool chain (vrv_tpu_torch.tools.vpu_probe ops)",
            "max_abs_err": res3["max_abs_err"], "mismatches": res3["mismatches"],
            "elements": res3["elements"],
            "ms": ms3, "plain_ms": plain_ms3, "bound_ms": bound3, "bound_by": "operations",
            "library_ms": None, "bound_ms_guide_rates": bound3_guide,
            "shape": {"n": prices["n"], "P": k3.P_TIMED, "K": k3.K_TIMED, "iters": k3.ITERS,
                      "classes": len(k3.OPS)},
            "prices": rows3, "plain_ms_per_class": plain3, "sass": res3["sass"],
            "registers": [min(probe_regs, default=0), max(probe_regs, default=0)],
            "spilled_bytes": probe_spills, "card": card,
        },
    ]}
    elapsed = time.time() - t_start
    print(f"chip_smoke: all phases passed in {elapsed:.0f} s")
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
