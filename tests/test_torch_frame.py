"""The slices as a whole: the graded scene at 32^3 through the port's
Scene.render on the CPU vs the JAX package:

  - the staged path at 64x48, 2 spp, 2 bounces vs JAX's (tracer='proc',
    proc_backend='xla', nee_mode='split', no beam pre-pass);
  - the fused path (the default RenderConfig with the kernels' plain versions:
    one path-kernel call per frame) at 48x32, 2 spp, 3 bounces vs JAX's fused
    frame (proc_backend='pallas', the Pallas kernels in interpret mode).

Bars: BGRA frames equal within +-1 u8 at >= 99 % of pixels (the repo's
cross-configuration bar); bounce-0 TraceResults equal on >= 99.9 % of rays.
The two runtimes differ by an ulp in sin/cos/sqrt and in FMA contraction,
after which a secondary ray may resolve a tie the other way: single pixels
move, statistics do not."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_scene import scenes
from vrv_tpu.config import RenderConfig as JRenderConfig
from vrv_tpu.ops import dda_proc as jdp
from vrv_tpu.ops.camera_rays import raygen as jraygen
from vrv_tpu_torch.config import RenderConfig
from vrv_tpu_torch.render import megakernel

# one thread per test process: the suite runs several workers side by side
torch.set_num_threads(1)

SMALL = dict(width=64, height=48, samples_per_pixel=2, max_bounces=2, tracer="proc",
             proc_backend="xla", nee_mode="split", beam_prepass=False)
# the default RenderConfig at a small size; 'pallas' = the kernels, which on
# CPU tensors are their plain versions (JAX: the Pallas kernels interpreted)
FUSED = dict(width=48, height=32, samples_per_pixel=2, max_bounces=3,
             proc_backend="pallas", pallas_unroll=1)


@functools.lru_cache(maxsize=None)
def frames():
    jscene, cam, tscene = scenes()
    jf = np.asarray(jscene.render(*cam, 0, JRenderConfig(**SMALL)))
    log = []
    tf = tscene.render(*cam, 0, RenderConfig(**SMALL), trace_log=log).numpy()
    return jf, tf, log


def test_frame_vs_jax_staged_path():
    jf, tf, log = frames()
    assert tf.shape == (48, 64, 4) and tf.dtype == np.uint8 and jf.shape == tf.shape
    assert (tf[..., 3] == 255).all()
    assert tf[..., :3].std() > 20, "frame content is trivial"
    diff = np.abs(tf.astype(np.int16) - jf.astype(np.int16)).max(axis=-1)
    within1 = (diff <= 1).mean()
    exact = (diff == 0).mean()
    print(f"frame vs JAX staged path: {exact:.4f} of pixels equal, "
          f"{within1:.4f} within +-1 u8, max diff {diff.max()}")
    assert within1 >= 0.99
    # max_bounces march launches + one batched shadow launch
    assert len(log) == SMALL["max_bounces"] + 1
    assert log[-1][2] is not None and log[0][2] is None
    n = SMALL["width"] * SMALL["height"] * SMALL["samples_per_pixel"]
    assert log[0][0].shape == (n, 3) and log[-1][0].shape == ((SMALL["max_bounces"] - 1) * n, 3)


@functools.lru_cache(maxsize=None)
def fused_frames():
    import vrv_tpu.ops.pallas.trace_proc as jtp

    jscene, cam, tscene = scenes()
    old = jtp.INTERPRET
    jtp.INTERPRET = True
    try:
        jf = np.asarray(jscene.render(*cam, 0, JRenderConfig(**FUSED)))
    finally:
        jtp.INTERPRET = old
    plog, tlog = [], []
    tf = tscene.render(*cam, 0, RenderConfig(**FUSED), path_log=plog, trace_log=tlog).numpy()
    return jf, tf, plog, tlog


def test_fused_frame_vs_jax_fused_frame():
    jf, tf, plog, tlog = fused_frames()
    assert tf.shape == (32, 48, 4) and jf.shape == tf.shape
    assert tf[..., :3].std() > 20, "frame content is trivial"
    diff = np.abs(tf.astype(np.int16) - jf.astype(np.int16)).max(axis=-1)
    within1 = (diff <= 1).mean()
    print(f"fused frame vs JAX fused frame: {(diff == 0).mean():.4f} of pixels equal, "
          f"{within1:.4f} within +-1 u8, max diff {diff.max()}")
    assert within1 >= 0.99
    # ONE path-kernel call on the 32x32 patch layout (48x(32*2) rays padded
    # to 64x64), no single-segment march
    assert len(plog) == 1 and not tlog
    o, _, s = plog[0]
    assert o.shape == (64 * 64, 3) and s.shape == (64 * 64,)


def test_fused_frame_vs_the_ports_staged_frame():
    _, tf, _, _ = fused_frames()
    _, cam, tscene = scenes()
    staged = tscene.render(*cam, 0, RenderConfig(**FUSED).replace(
        pallas_fused=False, nee_mode="split")).numpy()
    diff = np.abs(tf.astype(np.int16) - staged.astype(np.int16)).max(axis=-1)
    print(f"fused vs staged frame: {(diff == 0).mean():.4f} of pixels equal")
    assert (diff <= 1).mean() >= 0.99
    occ = []
    smp = tscene.render_samples(*cam, 0, RenderConfig(**FUSED), occupancy_out=occ)
    assert tuple(smp.shape) == (2, 32, 48, 3)
    assert len(occ) == 3 and occ[0] == 2 * 32 * 48 and 0 < occ[2] < occ[1] < occ[0]
    assert torch.equal(megakernel.pack_bgra(smp.mean(dim=0)), torch.from_numpy(tf))


@pytest.mark.parametrize("layout", [dict(pallas_tile="8x128"), dict(pallas_prepad=False),
                                    dict(pallas_tile2d=False)])
def test_fused_frame_layouts_agree(layout):
    """The ray layout is scheduling: every layout renders the same bytes."""
    _, tf, _, _ = fused_frames()
    _, cam, tscene = scenes()
    got = tscene.render(*cam, 0, RenderConfig(**FUSED).replace(**layout)).numpy()
    assert np.array_equal(got, tf)


def test_bounce0_trace_results_vs_jax():
    jscene, cam, tscene = scenes()
    _, _, log = frames()
    cfg = JRenderConfig(**SMALL)
    jps = jscene.proc_static._replace(use_coarse=False)

    @jax.jit
    def bounce0(eye, front, right, up, pd):
        o, d, _ = jraygen(eye, front, right, up, cfg.width, cfg.height,
                          cfg.samples_per_pixel, jnp.uint32(0), jitter_scale=cfg.jitter_scale)
        return jdp.trace_proc(jps, o.reshape(-1, 3), d.reshape(-1, 3),
                              t_min=cfg.t_min, t_max=cfg.t_max, pd=pd)

    pd = {k: v for k, v in jscene.proc_arrays.items() if k != "edit_cboxes"}
    ref = bounce0(jscene.camera_to_local(cam[0]), *(jnp.asarray(v, jnp.float32) for v in cam[1:]), pd)
    from vrv_tpu_torch.ops.dda_proc import trace_proc

    o, d, _ = log[0]
    got = trace_proc(tscene.proc_static, o, d, t_min=cfg.t_min, t_max=cfg.t_max,
                     pd=tscene.proc_arrays)
    same = np.ones(o.shape[0], bool)
    for f in ("hit", "block", "face", "entering"):
        same &= np.asarray(getattr(ref, f)) == getattr(got, f).numpy()
    same &= (np.asarray(ref.cell) == got.cell.numpy()).all(-1)
    tr, tg = np.asarray(ref.t), got.t.numpy()
    same &= np.abs(tr - tg) <= 1e-5 * np.maximum(np.abs(tr), 1.0)
    print(f"bounce-0 TraceResults equal on {same.mean():.5f} of {len(same)} rays")
    assert same.mean() >= 0.999
    assert got.hit.float().mean() > 0.3


def test_samples_shape_occupancy_and_frame_determinism():
    _, cam, tscene = scenes()
    cfg = RenderConfig(**SMALL)
    occ = []
    smp = tscene.render_samples(*cam, 0, cfg, occupancy_out=occ)
    assert tuple(smp.shape) == (2, 48, 64, 3) and smp.dtype == torch.float32
    assert torch.isfinite(smp).all() and float(smp.min()) >= 0.0
    assert len(occ) == 2 and occ[0] == 2 * 48 * 64 and 0 < occ[1] < occ[0]
    again = tscene.render(*cam, 0, cfg)
    assert torch.equal(again, torch.from_numpy(frames()[1]))
    assert torch.equal(megakernel.pack_bgra(smp.mean(dim=0)), again)
    other = tscene.render(*cam, 1, cfg)
    assert not torch.equal(other, again)


def test_backends_dispatch_and_agree_on_cpu():
    """'pallas' on CPU tensors is the plain version (the wrapper's only way
    to it), 'auto' resolves by device: all three give the same bytes."""
    _, cam, tscene = scenes()
    cfg = RenderConfig(**SMALL).replace(pallas_fused=False)
    ref = torch.from_numpy(frames()[1])
    for backend in ("pallas", "auto"):
        assert torch.equal(tscene.render(*cam, 0, cfg.replace(proc_backend=backend)), ref)


@pytest.mark.parametrize("change,match", [
    (dict(proc_backend="xla", beam_prepass=True), "grid tracers"),
    (dict(nee_mode="mixture"), "mixture NEE"),
    (dict(nee_mode="auto"), "mixture NEE"),
    (dict(tracer="rows"), "grid tracers"),
    (dict(mode="wavefront"), "wavefront"),
    (dict(debug_view="albedo"), "debug views"),
    (dict(rng="pcg"), "pcg"),
])
def test_branches_that_wait_raise_and_name_the_roadmap(change, match):
    _, cam, tscene = scenes()
    cfg = RenderConfig(**SMALL).replace(**change)
    with pytest.raises(NotImplementedError, match=match):
        tscene.render(*cam, 0, cfg)


def test_progressive_flag_renders_the_ordinary_frame():
    """The renderer does not read cfg.progressive (as in the JAX package:
    only the progressive surfaces accumulate): the same bytes either way."""
    _, cam, tscene = scenes()
    want = torch.from_numpy(frames()[1])
    assert torch.equal(tscene.render(*cam, 0, RenderConfig(**SMALL).replace(progressive=True)),
                       want)


def test_pack_bgra_matches_jax():
    from vrv_tpu.render.megakernel import pack_bgra as jpack

    r = np.random.default_rng(0)
    c = r.uniform(-0.2, 1.4, (7, 9, 3)).astype(np.float32)
    c[0, 0] = [np.nan, np.inf, -np.inf]
    got = megakernel.pack_bgra(torch.from_numpy(c)).numpy()
    assert np.array_equal(got, np.asarray(jpack(jnp.asarray(c))))
