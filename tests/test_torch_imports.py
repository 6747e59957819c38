"""The port stands alone: importing every module of vrv_tpu_torch (and
chip_smoke.py up to its device check) loads neither jax nor the JAX package;
its entry points default to CUDA and raise without one."""

import os
import pkgutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, **kw):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"     # several test workers run side by side
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300, **kw)


def _modules():
    import vrv_tpu_torch

    return sorted(
        m.name for m in pkgutil.walk_packages(vrv_tpu_torch.__path__, "vrv_tpu_torch.")
    )


def test_package_has_the_slices_modules():
    mods = set(_modules())
    for want in ("config", "assets", "entry", "convert", "ops.rng", "ops.noise",
                 "ops.camera_rays", "game.chunk", "ops.dda", "ops.dda_proc",
                 "ops.pallas.trace_proc", "ops.pallas.build", "utils.geometry",
                 "ops.instances", "render.lightbvh", "ops.intersect", "ops.nee",
                 "ops.shade", "render.megakernel", "render.scene", "utils.image",
                 "utils.png", "ops.pallas.path_proc", "tools", "tools.vpu_probe",
                 "tools.roofline", "tools.k2_ab", "camera", "models",
                 "models.pathtracer"):
        assert "vrv_tpu_torch." + want in mods, want
    for src in ("trace_proc.cu", "path_proc.cu", "proc_common.cuh", "vpu_probe.cu"):
        assert os.path.exists(os.path.join(REPO, "vrv_tpu_torch", "csrc", src)), src


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"mods = {_modules()!r}\n"
        "for m in ['vrv_tpu_torch'] + mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'jaxlib' or k == 'vrv_tpu' or k.startswith('vrv_tpu.') or k == 'PIL'"
        " or k == 'triton')\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_imports_no_jax_and_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here; the failure cannot be observed")
    code = (
        "import sys, runpy\n"
        "try:\n"
        "    runpy.run_path('chip_smoke.py', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'vrv_tpu' or k.startswith('vrv_tpu.'))\n"
        "assert not bad, bad\n"
        "sys.exit(rc)\n"
    )
    out = _run(code)
    assert out.returncode not in (0, None), out.stdout + out.stderr
    assert '"ok"' not in out.stdout and "kernels" not in out.stdout
    assert "CUDA" in out.stderr


def test_source_has_no_jax_import():
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|vrv_tpu)(\.|\s|$)")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "vrv_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                assert not pat.match(line), f"{path}:{i}: {line.strip()}"


def test_entry_points_default_to_cuda_and_raise_without_it():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here; the raise cannot be observed")
    from vrv_tpu_torch import entry, resolve_device
    from vrv_tpu_torch.config import RenderConfig, WorldConfig
    from vrv_tpu_torch.game.chunk import generate_dense_grid
    from vrv_tpu_torch.render.scene import Scene

    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    wc = WorldConfig(size=(8, 8, 8), origin=(-4, -4, -4))
    with pytest.raises(RuntimeError, match="CUDA"):
        Scene(wc)
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_dense_grid(wc, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.graded_scene(8, RenderConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.render_graded(8)


def test_kernel_build_raises_without_nvcc(monkeypatch):
    import shutil

    from vrv_tpu_torch.ops.pallas import build

    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc exists here; the raise cannot be observed")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["trace_proc"])
    assert os.path.exists(build.source_path("trace_proc"))
    assert "-fmad=false" in build.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_path_kernel_entry_is_cuda_only(monkeypatch):
    """The path kernel's launcher takes CUDA tensors only (it raises, it never
    runs the plain version); its build needs nvcc like K1's."""
    import shutil

    import torch

    from vrv_tpu_torch.ops.pallas import build, path_proc
    from vrv_tpu_torch.ops.dda_proc import ProcStatic

    ps = ProcStatic(seed=0, noise_scale=20.0, y_falloff=500.0, threshold=0.2,
                    origin=(-4, -4, -4), shape=(8, 8, 8), grass=1, stone=5, air=7,
                    n_edits=0)
    spec = path_proc._make_spec(ps, None, 2, torch.device("cpu"), None, None, None,
                                False, True, None, 10.0, 0.5, 1000.0)
    o = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        path_proc._launch_flat(spec, ps, None, o, o, torch.zeros(4, dtype=torch.int32),
                               0.001, 1000.0)
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        return
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build([path_proc.KERNEL])


def test_march_kernel_entry_is_cuda_only(monkeypatch):
    """K1's launcher takes CUDA tensors only (it raises, it never runs the
    plain version); its two C entry points — the launch, which takes the ray
    pool's counter last, and the occupancy query — are bound by the wrapper;
    the query and the build need the card and nvcc."""
    import re
    import shutil

    import torch

    from vrv_tpu_torch.ops.dda_proc import ProcStatic
    from vrv_tpu_torch.ops.pallas import build
    from vrv_tpu_torch.ops.pallas import trace_proc as tp

    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here; the raise cannot be observed")
    ps = ProcStatic(seed=0, noise_scale=20.0, y_falloff=500.0, threshold=0.2,
                    origin=(-4, -4, -4), shape=(8, 8, 8), grass=1, stone=5, air=7,
                    n_edits=0)
    o = torch.zeros((4, 3))
    before = tp.trace_proc_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        tp.trace_proc_cuda_packed(ps, o, o, tcap=torch.ones(4))
    assert tp.trace_proc_cuda.launches == before
    with open(build.source_path(tp.KERNEL)) as f:
        src = f.read()
    entry = re.search(r'extern "C" int vrv_trace_proc\(([^)]*)\)', src).group(1)
    assert entry.split(",")[-1].strip() == "int* counter"
    assert 'extern "C" int vrv_trace_proc_occupancy(int* out)' in src
    assert f"n > 0x{tp.MAX_RAYS:X}LL" in src and tp.MAX_RAYS == 2 ** 31 - 2 ** 24
    assert f"constexpr int kThreads = {tp.THREADS};" in src
    with pytest.raises(Exception, match="CUDA"):
        tp.occupancy()
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        return
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tp._kernel_fn()


def test_probe_entry_points_are_cuda_only(monkeypatch):
    """The op-price probe's launcher takes CUDA tensors only, its commands
    and the roofline default to CUDA and raise without it, and its build
    needs nvcc like the other kernels'."""
    import shutil

    import torch

    from vrv_tpu_torch.ops.pallas import build
    from vrv_tpu_torch.tools import roofline, vpu_probe

    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here; the raise cannot be observed")
    with pytest.raises(ValueError, match="CUDA"):
        vpu_probe.chain_launch(torch.zeros(8), "f32add")
    for fn in (vpu_probe.cmd_ops, vpu_probe.cmd_audit):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
    with pytest.raises(RuntimeError, match="CUDA"):
        vpu_probe.main(["ops"])
    with pytest.raises(RuntimeError, match="CUDA"):
        roofline.main([])
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        return
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build([vpu_probe.KERNEL])
    with pytest.raises(RuntimeError, match="nvcc not found"):
        vpu_probe.cuobjdump()


def test_entry_cli_renders_a_png_on_the_cpu(tmp_path):
    out_png = str(tmp_path / "frame.png")
    out = _run(
        "import sys; from vrv_tpu_torch import entry; "
        f"entry.main(['--device','cpu','--grid','32','--width','48','--height','32',"
        f"'--spp','1','--bounces','2','--out',{out_png!r}])"
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "world (32, 32, 32)/render 48x32" in out.stdout
    assert "fps:" in out.stdout and f"wrote {out_png}" in out.stdout
    from vrv_tpu_torch.utils.png import read_png

    img = read_png(out_png)
    assert img.shape == (32, 48, 4) and img[..., :3].std() > 10
