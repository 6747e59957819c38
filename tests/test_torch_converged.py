"""Converged and progressive rendering: ``Scene.render_converged`` (one loop
of ``chunks`` sample passes on the device) and ``models.pathtracer``
(``PathTracer.render``, ``render_progressive``, ``reset_accumulation``,
``render_converged``, ``CameraPose``), on the CPU.

  - port ``render_converged`` vs JAX ``render_converged`` at 24x16, 1 spp,
    2 bounces, 4 passes (plain versions, split NEE, no beam pre-pass), with
    the lamp (the graded 32^3 scene) and without (a lamp-free 32^3
    worldgen scene): BGRA within +-1 u8 at >= 99 % of pixels;
  - the one loop equals ``PathTracer``'s host loop bit for bit (the staged
    plain configuration and the default fused one);
  - progressive accumulation reduces noise and resets; pass ids wrap mod
    2^32 as the JAX package's uint32 ids do;
  - the path kernel's launch tables are built once per scene state and
    configuration (what keeps the pass loop free of host copies on the
    card) and rebuilt when an input changes."""

import functools

import numpy as np
import pytest
import torch

from test_torch_replay import lamp_free
from test_torch_scene import scenes
from vrv_tpu_torch.config import RenderConfig
from vrv_tpu_torch.models.pathtracer import CameraPose, PathTracer
from vrv_tpu_torch.ops.pallas import path_proc

# one thread per test process: the suite runs several workers side by side
torch.set_num_threads(1)

CONV = dict(width=24, height=16, samples_per_pixel=1, max_bounces=2, tracer="proc",
            proc_backend="xla", nee_mode="split", beam_prepass=False)
CHUNKS = 4
# the default RenderConfig at a small size ('pallas' on CPU tensors: the path
# kernel's plain version)
FUSED = dict(width=24, height=16, samples_per_pixel=2, max_bounces=3, proc_backend="pallas")


def world(name):
    """(JAX scene, port scene, camera) of the graded or the lamp-free world."""
    jscene, cam, tscene = scenes()
    if name == "lamp-free":
        jscene, tscene = lamp_free()
    return jscene, tscene, cam


@functools.lru_cache(maxsize=None)
def jax_converged(name):
    from vrv_tpu.config import RenderConfig as JRenderConfig

    jscene, _, cam = world(name)
    return np.asarray(jscene.render_converged(*cam, 0, CHUNKS, JRenderConfig(**CONV)))


@pytest.mark.parametrize("name", ["graded", "lamp-free"])
def test_converged_vs_jax(name):
    _, tscene, cam = world(name)
    want = jax_converged(name)
    got = tscene.render_converged(*cam, 0, CHUNKS, RenderConfig(**CONV)).numpy()
    assert got.shape == want.shape == (16, 24, 4) and got.dtype == np.uint8
    assert (got[..., 3] == 255).all() and got[..., :3].std() > 5
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16)).max(axis=-1)
    print(f"converged vs JAX ({name}): {int((diff != 0).sum())} of {diff.size} pixels "
          f"differ, max {diff.max()} u8")
    assert (diff <= 1).mean() >= 0.99


def pose_of(cam) -> CameraPose:
    return CameraPose(*(np.asarray(v, np.float32) for v in cam))


def tracer_on(scene, cfg) -> PathTracer:
    return PathTracer.on_scene(scene, cfg)


@pytest.mark.parametrize("name,cfg", [("graded", CONV), ("graded", FUSED),
                                      ("lamp-free", FUSED)],
                         ids=["graded-staged", "graded-fused", "lamp-free-fused"])
def test_one_loop_equals_the_host_loop(name, cfg):
    """Scene.render_converged(frame=1, chunks=3) == PathTracer.render_converged
    over the same pass ids (3..5), bit for bit."""
    _, tscene, cam = world(name)
    cfg = RenderConfig(**cfg)
    chunks = 3
    one = tscene.render_converged(*cam, 1, chunks, cfg)
    host = tracer_on(tscene, cfg).render_converged(
        pose_of(cam), total_spp=chunks * cfg.samples_per_pixel, frame0=chunks)
    assert one.dtype == torch.uint8 and tuple(one.shape) == (16, 24, 4)
    assert one[..., :3].float().std() > 5
    assert torch.equal(one, host)
    # the camera as device tensors (what keeps the call free of host copies
    # on the card) renders the same bytes
    assert torch.equal(one, tscene.render_converged(*pose_of(cam).arrays("cpu"), 1,
                                                    chunks, cfg))


def test_pass_ids_wrap_mod_2_32():
    _, tscene, cam = world("lamp-free")
    cfg = RenderConfig(**FUSED)
    # frame * chunks = 2^32: the pass ids wrap to 0..3
    assert torch.equal(tscene.render_converged(*cam, 1 << 30, 4, cfg),
                       tscene.render_converged(*cam, 0, 4, cfg))


def test_progressive_accumulation_reduces_noise_and_resets():
    _, tscene, cam = world("graded")
    pt = tracer_on(tscene, RenderConfig(width=16, height=12, samples_per_pixel=2,
                                        max_bounces=3, proc_backend="pallas"))
    p = pose_of(cam)
    frames = [pt.render_progressive(p, i).numpy() for i in range(6)]
    single = [pt.render(p, i).numpy() for i in range(2)]
    # independent frames differ much more than late accumulations
    d_single = np.abs(single[0].astype(int) - single[1].astype(int)).mean()
    d_accum = np.abs(frames[-1].astype(int) - frames[-2].astype(int)).mean()
    print(f"mean |frame 1 - frame 0| = {d_single:.3f}, accumulated 6 vs 5: {d_accum:.3f}")
    assert d_accum < d_single
    pt.reset_accumulation()
    np.testing.assert_array_equal(pt.render_progressive(p, 0).numpy(), frames[0])
    # the first accumulated frame is the ordinary frame
    np.testing.assert_array_equal(frames[0], pt.render(p, 0).numpy())


def test_render_converged_chunks():
    """PathTracer.render_converged with total_spp = 4 passes of 4 spp: the
    frame's shape, and the same bytes as Scene.render_converged's loop."""
    _, tscene, cam = world("lamp-free")
    cfg = RenderConfig(width=12, height=8, samples_per_pixel=4, max_bounces=2,
                       proc_backend="pallas")
    pt = tracer_on(tscene, cfg)
    img = pt.render_converged(pose_of(cam), total_spp=16)
    assert tuple(img.shape) == (8, 12, 4) and img.dtype == torch.uint8
    assert torch.equal(img, tscene.render_converged(*cam, 0, 4, cfg))
    one = pt.render(pose_of(cam), 0)
    assert not torch.equal(img, one)


def test_camera_pose_looking_vs_jax():
    from vrv_tpu.models.pathtracer import CameraPose as JCameraPose

    for yaw, pitch in ((0.0, 0.0), (0.7, -0.4), (-2.1, 1.2)):
        got = CameraPose.looking([1.0, 2.0, 3.0], yaw=yaw, pitch=pitch)
        want = JCameraPose.looking([1.0, 2.0, 3.0], yaw=yaw, pitch=pitch)
        for f in ("eye", "front", "right", "up"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    arrs = got.arrays("cpu")
    assert all(a.dtype == torch.float32 and a.device.type == "cpu" for a in arrs)


def test_path_kernel_launch_tables_are_built_once_per_scene_state():
    _, tscene, _ = world("graded")
    ps = tscene.proc_static._replace(use_coarse=False)
    args = (ps, tscene.proc_arrays, 3, torch.device("cpu"), tscene.instances_device,
            tscene.inst_static, tscene.bvh_device["flat"], False, True, tscene.light_em,
            10.0, 0.5, 1000.0, 0.001, 1000.0)
    spec, la = path_proc._launch_tables(*args)
    again = path_proc._launch_tables(*args)
    assert again[1] is la and again[0] is spec
    # the same tables as the uncached construction
    tab = path_proc.launch_args(
        path_proc._make_spec(*args[:13]), ps, tscene.proc_arrays, 0, 0.001, 1000.0,
        torch.device("cpu"))
    assert torch.equal(tab[0], la[0]) and tab[1] == la[1]
    assert np.array_equal(tab[2], la[2]) and np.array_equal(tab[3], la[3])
    # a table written in place, or another config, builds anew
    flat = {k: v.clone() for k, v in tscene.bvh_device["flat"].items()}
    args2 = args[:6] + (flat,) + args[7:]
    first = path_proc._launch_tables(*args2)[1]
    flat["power"].mul_(2.0)
    second = path_proc._launch_tables(*args2)[1]
    assert second is not first and not torch.equal(second[0], first[0])
    assert path_proc._launch_tables(*(args[:7] + (True, False) + args[9:]))[1] is not la
