"""The fused path's trace-record replay: one path-kernel launch in trace-record
mode, then the shading in tensor code over its records (the port's
``render_samples`` with ``pallas_inkernel_radiance=False``, or lights without
emissive palettes, or ``pallas_inkernel_nee=False``), on the CPU where the
path kernel K2 and the march kernel K1 are their plain versions.

  - ``nee.sample_light_flat`` with the kernel's recorded light index,
    chosen importance and selection total vs the JAX function on 4 096
    points: integers exact, floats within rtol 1e-5;
  - the replay frame vs the JAX package's (48x32, 2 spp, 3 bounces, its
    Pallas kernels interpreted): radiance within rel 1e-5, packed frames
    within +-1 u8 with < 0.1 % of pixels differing;
  - replay vs in-kernel radiance, batched vs per-bounce shading, in-kernel
    NEE vs the batched shadow trace through K1, recorded pdf on vs off, and
    the route of a lit scene whose light palettes the kernel cannot hold —
    the JAX package's own gates of these pairs, on the graded 32^3 scene
    and a lamp-free one."""

import functools

import numpy as np
import pytest
import torch

from test_torch_scene import scenes
from vrv_tpu_torch.config import RenderConfig
from vrv_tpu_torch.ops import shade
from vrv_tpu_torch.ops.pallas import path_proc
from vrv_tpu_torch.render import megakernel

# one thread per test process: the suite runs several workers side by side
torch.set_num_threads(1)

# the JAX gates' configuration (tests/test_inkernel_radiance.py BASE): the
# kernels on CPU tensors are their plain versions
BASE = dict(width=48, height=32, samples_per_pixel=2, max_bounces=3, tracer="proc",
            pallas_unroll=1, proc_backend="pallas")
REPLAY = dict(BASE, pallas_inkernel_radiance=False)


@functools.lru_cache(maxsize=None)
def lamp_free():
    """A lamp-free 32^3 worldgen scene (JAX scene, port scene from its state)."""
    from test_torch_scene import jax_state
    from vrv_tpu.config import WorldConfig as JWorldConfig
    from vrv_tpu.render.scene import Scene as JScene
    from vrv_tpu_torch.convert import scene_from_jax_state

    g = 32
    jscene = JScene(JWorldConfig(size=(g, g, g), origin=(-g // 2,) * 3, seed=0))
    assert jscene.bvh_device is None
    return jscene, scene_from_jax_state(jax_state(jscene), device="cpu")


def cam_of(name):
    _, cam, tscene = scenes()
    return (tscene if name == "graded" else lamp_free()[1]), cam


def frame_samples(scene, cam, cfg, **kw):
    """(spp, H, W, 3) radiance through Scene.render's arguments (logs,
    path tracer), so the launches can be counted."""
    ps, pa = scene._proc_for(cfg)
    with torch.no_grad():
        return megakernel.render_samples(
            *scene._render_args(*cam, 1), cfg, proc_static=ps, proc=pa,
            light_tex_set=scene.light_tex_set, inst_static=scene.inst_static,
            light_em=kw.pop("light_em", scene.light_em), **kw).numpy()


def packed(x):
    return megakernel.pack_bgra(torch.from_numpy(x.mean(0))).numpy().astype(np.int32)


def check_pair(on, off):
    """The JAX package's in-kernel-radiance gate (_check): rel <= 1e-5,
    packed frames within +-1 u8 with < 0.1 % of pixels differing."""
    rel = np.abs(on - off) / np.maximum(np.abs(off), 1e-6)
    du8 = np.abs(packed(on) - packed(off))
    print(f"max rel {rel.max():.3g}, max u8 {du8.max()}, {(du8 != 0).sum()} of "
          f"{du8.size} bytes differ")
    assert rel.max() < 1e-5
    assert du8.max() <= 1
    assert (du8 != 0).mean() < 1e-3


def test_sample_light_flat_with_recorded_selection_vs_jax():
    import jax.numpy as jnp

    from vrv_tpu.ops import nee as jnee
    from vrv_tpu_torch.ops import nee

    jscene, _, tscene = scenes()
    flat_t = tscene.bvh_device["flat"]
    flat_j = jscene.bvh_device["flat"]
    L = int(flat_t["tri"].shape[0])
    r = np.random.default_rng(11)
    n = 4096
    ctr = flat_t["tri"].numpy().reshape(-1, 3).mean(0)
    pts = (ctr + r.uniform(-6.0, 6.0, (n, 3))).astype(np.float32)
    nrm = np.zeros((n, 3), np.float32)
    nrm[np.arange(n), r.integers(0, 3, n)] = r.choice([-1.0, 1.0], n)
    seeds = r.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    # the kernel's records: a light index (-1 = no sample, some out of the
    # list's padding) and, for the pdf form, its importance and total
    idx = r.integers(-1, L, n).astype(np.int32)
    imp = np.where(idx >= 0, r.uniform(0.0, 3.0, n), 0.0).astype(np.float32)
    tot = (imp + r.uniform(0.0, 5.0, n)).astype(np.float32)
    seeds_t = torch.from_numpy(seeds.view(np.int32).copy())
    for rec in ((idx, None, None), (idx, imp, tot)):
        got = nee.sample_light_flat(
            torch.from_numpy(pts), torch.from_numpy(nrm), seeds_t, flat_t,
            sel_idx=torch.from_numpy(rec[0]),
            sel_imp=None if rec[1] is None else torch.from_numpy(rec[1]),
            sel_W=None if rec[2] is None else torch.from_numpy(rec[2]))
        want = jnee.sample_light_flat(
            jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(seeds), flat_j,
            sel_idx=jnp.asarray(rec[0]),
            sel_imp=None if rec[1] is None else jnp.asarray(rec[1]),
            sel_W=None if rec[2] is None else jnp.asarray(rec[2]))
        for f in got._fields:
            a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            if a.dtype.kind in "biu":
                assert np.array_equal(a, b), f
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=f)
        assert got.valid.any() and (~got.valid).any()
        assert not got.valid.numpy()[idx < 0].any()


@functools.lru_cache(maxsize=None)
def jax_replay_samples():
    import vrv_tpu.ops.pallas.trace_proc as jtp
    from vrv_tpu.config import RenderConfig as JRenderConfig

    jscene, cam, _ = scenes()
    old = jtp.INTERPRET
    jtp.INTERPRET = True
    try:
        return np.asarray(jscene.render_samples(*cam, 0, JRenderConfig(**REPLAY)))
    finally:
        jtp.INTERPRET = old


def test_replay_frame_vs_jax():
    """48x32, 2 spp, 3 bounces, the graded scene: one K2 launch in trace
    mode and no K1 launch (in-kernel NEE) vs the JAX replay frame."""
    _, cam, tscene = scenes()
    want = jax_replay_samples()
    plog, tlog, modes = [], [], []

    def tracer(*a, **k):
        modes.append(k.get("radiance", False))
        return path_proc.trace_path_plain(*a, **k)

    ps, pa = tscene._proc_for(RenderConfig(**REPLAY))
    with torch.no_grad():
        got = megakernel.render_samples(
            *tscene._render_args(*cam, 0), RenderConfig(**REPLAY), proc_static=ps, proc=pa,
            light_tex_set=tscene.light_tex_set, inst_static=tscene.inst_static,
            light_em=tscene.light_em, path_log=plog, trace_log=tlog,
            path_tracer=tracer).numpy()
    assert modes == [False] and len(plog) == 1 and not tlog
    assert got.shape == want.shape == (2, 32, 48, 3)
    assert got.std() > 1.0
    check_pair(got, want)


@pytest.mark.parametrize("name", ["graded", "lamp-free"])
def test_replay_vs_inkernel_radiance(name):
    scene, cam = cam_of(name)
    on = frame_samples(scene, cam, RenderConfig(**BASE))
    off = frame_samples(scene, cam, RenderConfig(**REPLAY))
    assert on.std() > 1.0
    check_pair(on, off)


@pytest.mark.parametrize("name", ["graded", "lamp-free"])
def test_batched_vs_per_bounce_shading_bit_identical(name):
    """pallas_inkernel_nee=False (the split-NEE replay): batched shading (2
    shade_resolved calls with lights, 1 without) equals the per-bounce loop
    (B calls) bit for bit; each frame is one K2 launch plus, with lights,
    ONE K1 launch over every bounce's shadow rays."""
    scene, cam = cam_of(name)
    cfg = RenderConfig(**REPLAY).replace(pallas_inkernel_nee=False)
    lit = scene.bvh_device is not None
    calls = []
    real = shade.shade_resolved

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    out, counts = {}, {}
    try:
        shade.shade_resolved = spy
        for batched in (True, False):
            calls.clear()
            plog, tlog = [], []
            out[batched] = frame_samples(scene, cam, cfg.replace(pallas_batched_shade=batched),
                                         path_log=plog, trace_log=tlog)
            counts[batched] = (len(calls), len(plog), len(tlog))
    finally:
        shade.shade_resolved = real
    B = cfg.max_bounces
    assert counts[True] == ((2 if lit else 1), 1, 1 if lit else 0)
    assert counts[False] == (B, 1, 1 if lit else 0)
    if lit:
        n = 64 * 64    # 48 x (32*2) rays on 32x32 patches
        assert tlog[0][0].shape == ((B - 1) * n, 3) and tlog[0][2] is not None
    assert out[True].std() > 1.0
    assert np.array_equal(out[True].view(np.int32), out[False].view(np.int32))


def test_inkernel_nee_vs_k1_shadow_trace_and_record_pdf():
    """Graded scene, replay. pdf record off: in-kernel NEE (the kernel's
    light choice and visibility bits) vs the batched shadow trace through
    K1 — radiance within rel 1e-5, packed frames identical. In-kernel NEE
    with the pdf record on vs off: within 1 u8, >= 99 % of bytes equal."""
    _, cam, tscene = scenes()
    cfg = RenderConfig(**REPLAY).replace(pallas_nee_record_pdf=False)
    ik = frame_samples(tscene, cam, cfg)
    k1 = frame_samples(tscene, cam, cfg.replace(pallas_inkernel_nee=False))
    rel = np.abs(ik - k1) / np.maximum(np.abs(k1), 1e-6)
    print(f"in-kernel NEE vs K1 shadow trace: max rel {rel.max():.3g}")
    assert rel.max() < 1e-5
    assert np.array_equal(packed(ik), packed(k1))
    pdf = frame_samples(tscene, cam, cfg.replace(pallas_nee_record_pdf=True))
    rel = np.abs(pdf - ik) / np.maximum(np.abs(ik), 1e-4)
    diff = np.abs(packed(pdf) - packed(ik))
    print(f"pdf record on vs off: max rel {rel.max():.3g}, {(diff == 0).mean():.4f} equal")
    assert rel.max() < 1e-4
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
    assert ik.std() > 1.0


def test_lit_scene_without_light_palettes_takes_the_replay():
    """light_em=None (palettes the kernel cannot hold): the default config
    renders through the trace-record replay — one K2 launch in trace mode —
    and not through a raise; the frame equals the explicit replay frame."""
    _, cam, tscene = scenes()
    modes = []

    def tracer(*a, **k):
        modes.append(k.get("radiance", False))
        return path_proc.trace_path_plain(*a, **k)

    got = frame_samples(tscene, cam, RenderConfig(**BASE), light_em=None, path_tracer=tracer)
    assert modes == [False]
    want = frame_samples(tscene, cam, RenderConfig(**REPLAY))
    assert np.array_equal(got, want)
