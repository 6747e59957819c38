"""State carried across: a port Scene built from a JAX Scene's plain numpy
state (vrv_tpu_torch.convert) derives the same tracer bundle, lights and
instance tables as the JAX Scene holds, and keeps them in step under edits."""

import functools

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from vrv_tpu.config import RenderConfig as JRenderConfig
from vrv_tpu_torch import entry
from vrv_tpu_torch.config import RenderConfig
from vrv_tpu_torch.convert import scene_from_jax_state
from vrv_tpu_torch.render.scene import Scene

# one thread per test process: the suite runs several workers side by side
torch.set_num_threads(1)

G = 32


def jax_state(jscene) -> dict:
    """What crosses over: numpy arrays and Python values only."""
    wc = jscene.world_cfg
    inst = jscene.instances_device
    return {
        "world_cfg": dict(size=tuple(wc.size), origin=tuple(wc.origin), seed=wc.seed,
                          noise_scale=wc.noise_scale, y_falloff=wc.y_falloff,
                          threshold=wc.threshold),
        "grid": np.array(jscene.grid_host),
        "instances": None if inst is None else {k: np.array(v) for k, v in inst.items()},
    }


@functools.lru_cache(maxsize=None)
def scenes():
    """(JAX graded scene at 32^3, its camera, the port scene built from it)."""
    jscene, cam = graft._scene_args(G, JRenderConfig())
    tscene = scene_from_jax_state(jax_state(jscene), device="cpu")
    return jscene, cam, tscene


def _eq(name, a, b):
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (name, a.shape, b.shape, a.dtype, b.dtype)
    assert np.array_equal(a, b), f"{name} differs"


# fields of ProcStatic that this slice fills (coarse_const waits for the
# kernel's air-region skips and stays ())
PS_FIELDS = ("seed", "noise_scale", "y_falloff", "threshold", "origin", "shape",
             "grass", "stone", "air", "n_edits", "lambert_only", "edits_lambert",
             "edit_mats", "edit_gate_mode", "edit_cmp", "edit_glass", "edits_fused",
             "lambert_blocks", "tex_dedup", "y_air")


def _check_same_state(jscene, tscene):
    for f in PS_FIELDS:
        assert getattr(tscene.proc_static, f) == getattr(jscene.proc_static, f), f
    assert tscene.proc_static.coarse_const == ()
    for k, v in jscene.proc_arrays.items():
        _eq(f"proc_arrays[{k}]", tscene.proc_arrays[k], v)
    assert (tscene.bvh_device is None) == (jscene.bvh_device is None)
    if jscene.bvh_device is not None:
        for k, v in jscene.bvh_device["flat"].items():
            _eq(f"flat[{k}]", tscene.bvh_device["flat"][k], v)
        for k in ("is_leaf", "left", "right", "aabb_min", "aabb_max", "lum6", "tri",
                  "lpa", "uv", "tex"):
            _eq(f"bvh[{k}]", tscene.bvh_device[k], jscene.bvh_device[k])
    assert tscene.bvh_max_depth == jscene.bvh_max_depth
    assert tscene.light_bvh.max_depth == jscene.light_bvh.max_depth
    assert tscene.light_tex_set == jscene.light_tex_set
    assert tscene.light_em == jscene.light_em
    assert tscene.inst_static == jscene.inst_static
    assert (tscene.instances_device is None) == (jscene.instances_device is None)
    if jscene.instances_device is not None:
        for k, v in jscene.instances_device.items():
            _eq(f"instances[{k}]", tscene.instances_device[k], v)
    _eq("grid", tscene.grid, np.asarray(jscene.grid))
    _eq("translucent", tscene.translucent, jscene.translucent)
    for k, v in jscene.materials.items():
        _eq(f"materials[{k}]", tscene.materials[k], v)


def test_graded_scene_state_equals_jax_scene():
    jscene, _, tscene = scenes()
    assert jscene.proc_static.n_edits == 4 and jscene.inst_static is not None
    _check_same_state(jscene, tscene)
    # the march's own packing of that state
    assert tscene.proc_arrays["y_cut"] >= tscene.proc_static.y_air or \
        tscene.proc_arrays["y_cut"] == 1 << 30
    ekey, eflg = tscene.proc_arrays["edit_smem"]
    assert ekey.dtype == torch.int32 and tuple(ekey.shape) == (4,)
    assert int((ekey != 0x3FFFFFFF).sum()) == 1


def test_port_entry_builds_the_same_graded_scene():
    """entry.graded_scene (the port of __graft_entry__._scene_args) on its
    own: same world, same lamp, same cube, same camera."""
    jscene, jcam, _ = scenes()
    tscene, tcam = entry.graded_scene(G, RenderConfig(), device="cpu")
    _check_same_state(jscene, tscene)
    for a, b in zip(tcam, jcam):
        assert np.array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))
    _eq("camera_to_local", tscene.camera_to_local(tcam[0]), jscene.camera_to_local(jcam[0]))


def test_set_block_get_block_round_trip_and_edit_sync():
    """A second and third edit on both scenes: edit list, lights and tables
    stay equal; removing the edit restores the first state."""
    jscene, _, _ = scenes()
    # fresh copies so the cached scenes stay as the other tests expect them
    jscene2, _ = graft._scene_args(G, JRenderConfig())
    tscene2 = scene_from_jax_state(jax_state(jscene2), device="cpu")
    t = tscene2.table
    lamp_world = None
    for c, b in tscene2._proc_diff.items():
        if b == t.block_idx("lamp"):
            lamp_world = np.array(c) + np.array(tscene2.world_cfg.origin)
    assert lamp_world is not None
    assert tscene2.get_block(lamp_world) == t.block_idx("lamp") == jscene2.get_block(lamp_world)
    assert tscene2.get_block([1000, 0, 0]) is None
    assert tscene2.set_block([1000, 0, 0], 1) is False

    glass = t.block_idx("glass")
    spot = lamp_world + np.array([2, 0, 1])
    old = tscene2.get_block(spot)
    for s in (jscene2, tscene2):
        assert s.set_block(spot, glass) is True
        assert s.set_block(lamp_world + np.array([0, 1, 0]), t.block_idx("lamp")) is True
    assert tscene2.get_block(spot) == glass
    assert int(tscene2.grid[tuple(int(v) for v in spot - np.array(tscene2.world_cfg.origin))]) == glass
    _check_same_state(jscene2, tscene2)
    assert tscene2.proc_static.edit_glass != () and not tscene2.proc_static.edits_lambert
    # the JAX scene also counted the lamp edit made before the hand-over
    assert tscene2.tlas_rebuilds == 2 and jscene2.tlas_rebuilds == 3
    # undo both: the diff map shrinks back to the lamp alone
    for s in (jscene2, tscene2):
        s.set_block(spot, old)
        s.set_block(lamp_world + np.array([0, 1, 0]), t.air)
    _check_same_state(jscene2, tscene2)
    _check_same_state(jscene, tscene2)


def test_foreign_grid_cells_become_edits():
    """A grid that differs from the port's own worldgen prediction (as a
    grid generated by another program may, near the threshold) is absorbed
    into the edit list — the tracer then matches the grid exactly."""
    _, _, tscene = scenes()
    grid = tscene.grid_host.copy()
    air = tscene.table.air
    c = tuple(int(v) for v in np.argwhere(grid == air)[11])
    grid[c] = tscene.table.block_idx("stone")
    s = Scene(tscene.world_cfg, grid=grid, device="cpu")
    assert c in s._proc_diff and len(s._proc_diff) == len(tscene._proc_diff) + 1


def test_default_device_is_cuda_and_its_absence_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here; the raise cannot be observed")
    _, _, tscene = scenes()
    with pytest.raises(RuntimeError, match="CUDA"):
        Scene(tscene.world_cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.graded_scene(G, RenderConfig())


def test_unported_scene_surfaces_raise():
    _, _, tscene = scenes()
    # render_converged is ported (tests/test_torch_converged.py); its sharded
    # form waits for the parallel slice
    for fn in (tscene.render_sharded, tscene.render_converged_sharded):
        with pytest.raises(NotImplementedError, match="ROADMAP: parallel"):
            fn()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tscene.set_grid(tscene.grid_host, (0, 0, 0))
