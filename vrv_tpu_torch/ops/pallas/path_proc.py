"""The fused multi-bounce path kernel (K2) as a hand-written CUDA kernel.

Counterpart of ``vrv_tpu/ops/pallas/path_proc.py``: ``trace_path_cuda``
takes the place of ``trace_path_pallas`` (kernel ``_path_kernel``, source
here: ``csrc/path_proc.cu``), ``inst_smem_args`` and ``light_smem_args``
pack the instance and light rows the same way. Per ray the kernel runs a
whole B-bounce path: march (K1's step), retire (instance vs voxel, edit
material classes, cosine / mirror / transmit scatter), for non-last bounces
with lights a flat-list light sample and a shadow march capped at the light
distance, and per-bounce records in one of two modes:

  - trace mode: per bounce (packed, t), per later bounce the sampled
    direction, per bounce the instance record (prim or -1, u, v), per
    non-last bounce (light index or -1, vis) [+ (imp_c, W) with nee_pdf];
  - radiance mode (what the main path runs): per bounce (code, cos_in, sr),
    per non-last bounce with lights (w, cos_x/pi, geo, e_y rgb).

``trace_path_plain`` is the kernel's plain PyTorch version, written
bounce-synchronously: every bounce marches the live rays with K1's plain
march (``ops/dda_proc.trace_proc_packed``) plus the instance early exit,
one Moller-Trumbore pass per segment, the retire math as masked tensor code
and one capped shadow march. That is value-identical to the per-lane state
machine of the TPU kernel and to the CUDA kernel's persistent warps, which
refill finished lanes from a ray pool: a ray's records depend only on its
own inputs and seed, so which lane takes which ray is scheduling only. In
radiance mode both skip the shadow march of a sample whose light term is
not valid (``lvalid`` false): its ``geo`` record is 0 whatever the ray finds.
Trace mode marches it (it records ``vis``), as the JAX kernel does.

Dispatch rule: a CPU tensor goes to the plain version — the only way the
wrapper ever takes it; a CUDA tensor launches the kernel or raises. The
wrapper counts its launches in ``trace_path_cuda.launches``. The call's
static tables (``kernel_tables``, ``launch_args``) are built and copied to
the card once per scene state and configuration (``_launch_tables``): a
later launch with the same inputs moves nothing from the host, so a loop of
frames or sample passes never waits on a host copy.

Every constant division of the JAX kernel stays an IEEE division here
(``_div``: a tensor divisor, since PyTorch on CUDA turns division by a
Python scalar into a multiply by its reciprocal), so the kernel, built
without fast math, agrees with this file bit for bit on one device.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch

from vrv_tpu_torch.ops import dda, dda_proc, rng
from vrv_tpu_torch.ops.instances import InstanceHit
from vrv_tpu_torch.ops.noise import _seed_mix, simplex3_seeded
from vrv_tpu_torch.ops.pallas import build
from vrv_tpu_torch.ops.pallas.trace_proc import (
    MAX_EDITS,
    MAX_GRID,
    _check,
    edit_smem_args,
)

KERNEL = "path_proc"
_2PI = float(2.0 * np.pi)
_PI = float(np.pi)
EPS_BLOCK = 0.001          # intersect.EPSILON_BLOCK
# table limits of csrc/path_proc.cu
EM_MEMBERS = 8             # texture ids per light emissive group
EM_PAL = 32                # palette entries per group (Scene.light_em's cap)
EM_GROUP_WORDS = 1 + EM_MEMBERS + 64 + 1 + 3 * EM_PAL
MAT_WORDS = 1 + 6 + 6 * 64  # is_glass | metal x6 | alpha words x6x64
FACE_WORDS = 150           # normal | tangent x2 | bitangent x2 | cu | cv | axes
SLOT_WORDS = 15            # csrc/path_proc.cu kSlotWords: per-thread shared slot
BOX_WORDS = 6              # csrc/path_proc.cu kBoxWords: the instances' bounding box
THREADS = 128              # csrc/path_proc.cu kThreads
SMEM_LIMIT = 227 * 1024
MAX_RAYS = 0x7F000000      # ray ids are int32 (csrc/path_proc.cu)

_FN = None


def bind(lib: ctypes.CDLL, counter: bool = True):
    """The library's ``vrv_path_proc`` with its argument types; ``counter``:
    the entry point takes the ray pool's counter as its last argument."""
    fn = lib.vrv_path_proc
    p = ctypes.c_void_p
    fn.argtypes = [
        p, p, p, p, ctypes.c_int,           # o d seeds tab tab_words
        p, p, ctypes.c_longlong,            # iout fout n
        p, ctypes.c_int, p, ctypes.c_int,   # iparams n_ip fparams n_fp
        p,                                  # stream
    ] + ([p] if counter else [])            # counter
    fn.restype = ctypes.c_int
    return fn


def _kernel_fn():
    global _FN
    if _FN is None:
        _FN = bind(build.load(KERNEL))
    return _FN


def occupancy(tab_words: int, dev=None) -> dict:
    """What a K2 launch with a table buffer of ``tab_words`` words gets on the
    current card: resident blocks per SM (the runtime's occupancy query), SMs,
    the persistent grid, threads per block, registers per thread, local
    memory per thread (stack and spills) and dynamic shared memory per
    block."""
    fn = build.load(KERNEL).vrv_path_proc_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(dev or torch.cuda.current_device()):
        rc = fn(int(tab_words), out)
    if rc != 0:
        raise RuntimeError(f"path_proc occupancy query failed: CUDA error {rc}")
    keys = ("blocks_per_sm", "sms", "grid", "threads", "registers", "local_bytes",
            "smem_bytes")
    return dict(zip(keys, list(out)))


# ---------------------------------------------------------------------------
# row packers (the TPU kernel's SMEM arrays)
# ---------------------------------------------------------------------------


def inst_smem_args(inst, tex_ids):
    """Per-triangle rows for the in-kernel instance pass: one (cap*16,)
    float32 tensor, [v0(3) | v1(3) | v2(3) | texslot | uv(3x2)] per
    triangle; invalid (padding) rows are zeroed, which Moller-Trumbore
    rejects via det == 0. texslot indexes ``inst_static``'s tex-id tuple
    (first match, 0 when none)."""
    tri = inst["tri"].to(torch.float32)                       # (cap, 3, 3)
    ids = torch.tensor([int(t) for t in tex_ids], dtype=torch.int32,
                       device=tri.device)
    eq = (inst["t"].to(torch.int32)[:, None] == ids[None, :]).to(torch.int32)
    slot = eq.argmax(dim=1).to(torch.float32)
    row = torch.cat([
        tri.reshape(-1, 9),
        slot[:, None],
        inst["uv"].to(torch.float32).reshape(-1, 6),
    ], dim=1)
    row = torch.where(inst["valid"][:, None], row, torch.zeros_like(row))
    return (row.reshape(-1).contiguous(),)


def light_smem_args(flat):
    """Rows for in-kernel NEE, 18 floats per light of the flat list:
    [v0(3)|v1(3)|v2(3)|power|area|tex|uv0(2)|uv1(2)|uv2(2)]."""
    tri = flat["tri"].to(torch.float32)
    row = torch.cat([
        tri.reshape(-1, 9),
        flat["power"].to(torch.float32)[:, None],
        flat["area"].to(torch.float32)[:, None],
        flat["tex"].to(torch.float32)[:, None],
        flat["uv"].to(torch.float32).reshape(-1, 6),
    ], dim=1)
    return (row.reshape(-1).contiguous(),)


# ---------------------------------------------------------------------------
# the call's static description, shared by the kernel and the plain version
# ---------------------------------------------------------------------------


class _Spec(NamedTuple):
    B: int
    E: int
    n_inst: int
    n_lights: int
    rad: bool
    nee_pdf: bool
    inst_rows: Optional[torch.Tensor]    # (n_inst, 16) f32
    slot_alpha: Optional[torch.Tensor]   # (n_slot, 64) int32 alpha byte words
    slot_metal: Optional[torch.Tensor]   # (n_slot,) f32
    slot_tex: Optional[torch.Tensor]     # (n_slot,) int32 texture ids
    light_rows: Optional[torch.Tensor]   # (L, 18) f32
    em: tuple                            # ((members, words (64,) i32, pal (P,3) f32), ...)
    mat_map: Optional[torch.Tensor]      # (256,) int32 block id -> material entry or -1
    mat_glass: Optional[torch.Tensor]    # (K,) bool
    mat_metal: Optional[torch.Tensor]    # (K, 6) f32
    mat_words: Optional[torch.Tensor]    # (K, 6, 64) int32
    nee_scale: float
    nee_clamp: float
    gain: float
    edits: tuple                         # (ekey, eflg) int32 or ()


def _words_i32(words, dev) -> torch.Tensor:
    a = np.asarray([int(w) & 0xFFFFFFFF for w in words], np.uint32).view(np.int32)
    return torch.from_numpy(a.copy()).to(dev)


def _make_spec(ps, pd, B, dev, inst, inst_static, lights, nee_pdf, radiance,
               light_em, nee_scale, nee_clamp, emission_gain) -> _Spec:
    """trace_path_pallas's argument resolution (zero-row tables degrade to
    the feature-off path; lights only for B > 1; nee_pdf only in trace
    mode) plus the static tables as small tensors on ``dev``."""
    if ps.n_edits and not ps.edits_fused:
        raise ValueError(
            "path kernel requires air, opaque-lambert, constant-material "
            "(ps.edit_mats) or glass-class (ps.edit_glass) edits; use the "
            "staged kernels")
    if inst is not None and int(inst["tri"].shape[0]) == 0:
        inst = None
    if lights is not None and int(lights["tri"].shape[0]) == 0:
        lights = None
    f32 = torch.float32
    n_inst = 0
    inst_rows = slot_alpha = slot_metal = slot_tex = None
    if inst is not None:
        if inst_static is None:
            raise ValueError(
                "in-kernel instances need inst_static (tex ids + constant "
                "material tables from scene.set_instances)")
        n_inst = int(inst["tri"].shape[0])
        tex_ids, alpha_words, metals = inst_static
        inst_rows = inst_smem_args(inst, tex_ids)[0].to(dev).reshape(n_inst, 16)
        slot_alpha = torch.stack([_words_i32(w, dev) for w in alpha_words]) \
            if alpha_words else torch.zeros((0, 64), dtype=torch.int32, device=dev)
        slot_metal = torch.tensor([float(m) for m in metals], dtype=f32, device=dev)
        slot_tex = torch.tensor([int(t) for t in tex_ids], dtype=torch.int32, device=dev)
    n_lights = 0
    light_rows = None
    if lights is not None and B > 1:
        n_lights = int(lights["tri"].shape[0])
        light_rows = light_smem_args(lights)[0].to(dev).reshape(n_lights, 18)
    em = ()
    if radiance:
        if n_lights and not light_em:
            raise ValueError(
                "in-kernel radiance with lights needs the static light "
                "emissive palettes (Scene.light_em)")
        if n_lights:
            em = tuple(
                (tuple(int(m) for m in members), _words_i32(widx, dev),
                 torch.tensor([list(p) for p in pal], dtype=f32, device=dev).reshape(-1, 3))
                for members, widx, pal in light_em
            )
    E = int(ps.n_edits)
    mat_map = mat_glass = mat_metal = mat_words = None
    entries = []
    if E:
        for blk, mets in ps.edit_mats:
            entries.append((int(blk), False, mets, [(0,) * 64] * 6))
        for blk, mets, words6 in ps.edit_glass:
            entries.append((int(blk), True, mets, words6))
    if entries:
        mm = np.full(256, -1, np.int32)
        for k, (blk, _, _, _) in enumerate(entries):
            mm[blk] = k
        mat_map = torch.from_numpy(mm).to(dev)
        mat_glass = torch.tensor([g for _, g, _, _ in entries], dtype=torch.bool, device=dev)
        mat_metal = torch.tensor([list(m) for _, _, m, _ in entries], dtype=f32, device=dev)
        mat_words = torch.stack([
            torch.stack([_words_i32(w, dev) for w in words6]) for _, _, _, words6 in entries
        ])
    return _Spec(
        B=B, E=E, n_inst=n_inst, n_lights=n_lights, rad=bool(radiance),
        nee_pdf=bool(nee_pdf and n_lights and not radiance),
        inst_rows=inst_rows, slot_alpha=slot_alpha, slot_metal=slot_metal,
        slot_tex=slot_tex, light_rows=light_rows, em=em, mat_map=mat_map,
        mat_glass=mat_glass, mat_metal=mat_metal, mat_words=mat_words,
        nee_scale=float(nee_scale), nee_clamp=float(nee_clamp),
        gain=float(emission_gain),
        edits=edit_smem_args(ps, pd) if E else (),
    )


def record_layout(spec: _Spec):
    """(int rows, float rows) of the flat record buffers, in the order the
    TPU kernel writes its outputs (``_path_pallas_flat``)."""
    B = spec.B
    irows, frows = [], []
    if spec.rad:
        for b in range(B):
            irows.append(("code", b))
            frows += [("cos_in", b), ("sr", b)]
        if spec.n_lights:
            for b in range(B - 1):
                frows += [(k, b) for k in ("w", "cxp", "geo", "ey0", "ey1", "ey2")]
        return irows, frows
    for b in range(B):
        irows.append(("packed", b))
        frows.append(("t", b))
    for b in range(B - 1):
        frows += [("dx", b), ("dy", b), ("dz", b)]
    if spec.n_inst:
        for b in range(B):
            irows.append(("prim", b))
            frows += [("iu", b), ("iv", b)]
    if spec.n_lights:
        for b in range(B - 1):
            irows += [("lidx", b), ("vis", b)]
            if spec.nee_pdf:
                frows += [("impc", b), ("W", b)]
    return irows, frows


def _initial(name: str) -> int:
    """Value of a record slot that its path never reaches."""
    return -1 if name in ("prim", "lidx") else 0


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / float32(c) as an IEEE division on every device."""
    return x / torch.tensor(c, dtype=torch.float32, device=x.device)


_FACE_DEV: dict = {}


def _face_tables(dev):
    t = _FACE_DEV.get(dev)
    if t is None:
        f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)  # noqa: E731
        t = dict(
            normal=f(dda.FACE_NORMALS), tan0=f(dda.FACE_TANGENTS[:, 0]),
            tan1=f(dda.FACE_TANGENTS[:, 1]), bit0=f(dda.FACE_BITANGENTS[:, 0]),
            bit1=f(dda.FACE_BITANGENTS[:, 1]), cu=f(dda.FACE_U_AFFINE),
            cv=f(dda.FACE_V_AFFINE),
            axes=torch.from_numpy(np.asarray(dda.FACE_PLANE_AXES, np.int64)).to(dev),
        )
        _FACE_DEV[dev] = t
    return t


def _inst_intersect(rows, ox, oy, oz, dx, dy, dz, t_min, t_max):
    """Nearest instance-triangle hit (Moller-Trumbore over the rows, the
    JAX kernel's formula order, strict first minimum). Returns (hit, t,
    prim, u, v); without a hit t = 3e38, prim = 0 and (u, v) are row 0's."""
    best = None
    for j in range(rows.shape[0]):
        r = rows[j]
        v0x, v0y, v0z = r[0], r[1], r[2]
        e1x, e1y, e1z = r[3] - r[0], r[4] - r[1], r[5] - r[2]
        e2x, e2y, e2z = r[6] - r[0], r[7] - r[1], r[8] - r[2]
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = (e1x * px + e1y * py) + e1z * pz
        ok = det.abs() > 1e-9
        inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
        tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
        u = ((tvx * px + tvy * py) + tvz * pz) * inv
        qx = tvy * e1z - tvz * e1y
        qy = tvz * e1x - tvx * e1z
        qz = tvx * e1y - tvy * e1x
        v = ((dx * qx + dy * qy) + dz * qz) * inv
        t = ((e2x * qx + e2y * qy) + e2z * qz) * inv
        ok = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= t_min) & (t <= t_max)
        t = torch.where(ok, t, torch.full_like(t, 3e38))
        if best is None:
            best = [ok, t, torch.zeros_like(ox, dtype=torch.int32), u, v]
        else:
            bok, bt, bj, bu, bv = best
            better = t < bt
            best = [(better & ok) | (~better & bok), torch.where(better, t, bt),
                    torch.where(better, j, bj).to(torch.int32),
                    torch.where(better, u, bu), torch.where(better, v, bv)]
    return best


def _plain_flat(spec: _Spec, ps, pd, o, d, seeds, t_min, t_max, stats=None):
    """Records of the whole batch as (int rows (ni, n), float rows (nf, n))."""
    dev = o.device
    n = o.shape[0]
    f32, i32 = torch.float32, torch.int32
    B = spec.B
    pw = dda_proc.assemble(ps, pd)
    irows, frows = record_layout(spec)
    iout = torch.empty((len(irows), n), dtype=i32, device=dev)
    fout = torch.zeros((len(frows), n), dtype=f32, device=dev)
    for k, (name, _) in enumerate(irows):
        iout[k].fill_(_initial(name))
    irow = {key: k for k, key in enumerate(irows)}
    frow = {key: k for k, key in enumerate(frows)}
    ft = _face_tables(dev)
    gox, goy, goz = (float(v) for v in ps.origin)
    seed_mix = _seed_mix(ps.seed)
    path_stats = None if stats is None else stats.setdefault("path", {})
    shadow_stats = None if stats is None else stats.setdefault("shadow", {})
    if stats is not None:
        # per-ray steps in the launch order (the kernel's ray ids)
        path_rs = torch.zeros(n, dtype=i32, device=dev)
        shadow_rs = torch.zeros(n, dtype=i32, device=dev)
        launched = torch.zeros((max(B - 1, 0), n), dtype=torch.bool, device=dev)
    inf = torch.tensor(float("inf"), dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)

    live = torch.arange(n, device=dev)
    co = o
    cd = d
    for b in range(B):
        if live.numel() == 0:
            break
        if stats is not None:
            stats.setdefault("segments", []).append(live.numel())
        ox, oy, oz = co[:, 0], co[:, 1], co[:, 2]
        dx, dy, dz = cd[:, 0], cd[:, 1], cd[:, 2]
        seed0 = seeds[live]
        if spec.n_inst:
            ihit, it_, ij_, iu_, iv_ = _inst_intersect(
                spec.inst_rows, ox, oy, oz, dx, dy, dz, t_min, t_max)
            t_stop = torch.where(ihit, it_, inf)
        else:
            t_stop = None
        t, word = dda_proc.trace_proc_packed(pw, co, cd, t_min, t_max, pd, None,
                                             path_stats, t_stop)
        if stats is not None:
            path_rs[live] += path_stats["ray_steps"]
        mhit = (word & 1) != 0
        face = (word >> 2) & 7
        hx, hy, hz = (word >> 5) & 511, (word >> 14) & 511, (word >> 23) & 511
        if spec.n_inst:
            inst_wins = ihit & (~mhit | (it_ < t))
            vox_hit = mhit & ~inst_wins
            t_fin = torch.where(inst_wins, it_, t)
        else:
            inst_wins = torch.zeros_like(mhit)
            vox_hit = mhit
            t_fin = t
        advance = (mhit | inst_wins) & (b < B - 1)

        if not spec.rad:
            packed = (word & ~1) | vox_hit.to(i32)
            iout[irow[("packed", b)], live] = packed
            fout[frow[("t", b)], live] = t_fin
            if spec.n_inst:
                iout[irow[("prim", b)], live] = torch.where(inst_wins, ij_, -1).to(i32)
                fout[frow[("iu", b)], live] = torch.where(inst_wins, iu_, zero)
                fout[frow[("iv", b)], live] = torch.where(inst_wins, iv_, zero)

        seed_b = rng.murmur3_combine(seed0, b)
        r4 = rng.draw(seed_b, 4)
        r5 = rng.draw(seed_b, 5)
        hpx = ox + t_fin * dx
        hpy = oy + t_fin * dy
        hpz = oz + t_fin * dz
        frx = hpx - hx.to(f32)
        fry = hpy - hy.to(f32)
        frz = hpz - hz.to(f32)
        fi = face.to(torch.int64)
        a_ax = ft["axes"][fi, 0]
        b_ax = ft["axes"][fi, 1]

        def comp(ax_):
            return torch.where(ax_ == 0, frx, torch.where(ax_ == 1, fry, frz))

        tri1 = comp(a_ax) + comp(b_ax) > 1.0
        nrm = ft["normal"][fi]
        nx_, ny_, nz_ = nrm[:, 0], nrm[:, 1], nrm[:, 2]
        tg = torch.where(tri1[:, None], ft["tan1"][fi], ft["tan0"][fi])
        bt = torch.where(tri1[:, None], ft["bit1"][fi], ft["bit0"][fi])
        tx_, ty_, tz_ = tg[:, 0], tg[:, 1], tg[:, 2]
        bx_, by_, bz_ = bt[:, 0], bt[:, 1], bt[:, 2]

        def affine_uv(key):
            c = ft[key][fi]
            return c[:, 0] + ((c[:, 1] * frx + c[:, 2] * fry) + c[:, 3] * frz)

        # cosine-weighted hemisphere sample aligned to the face frame
        z = r4
        r = torch.sqrt(torch.clamp_min(1.0 - z, 0.0))
        phi = _2PI * r5
        h0 = r * torch.cos(phi)
        h1 = torch.sqrt(z)
        h2 = r * torch.sin(phi)
        ndx = h0 * tx_ + h1 * nx_ + h2 * bx_
        ndy = h0 * ty_ + h1 * ny_ + h2 * by_
        ndz = h0 * tz_ + h1 * nz_ + h2 * bz_
        ln = torch.sqrt(ndx * ndx + ndy * ndy + ndz * ndz)
        ndx, ndy, ndz = ndx / ln, ndy / ln, ndz / ln

        is_mirror = is_trans = None
        if spec.n_inst:
            rr = spec.inst_rows[ij_.to(torch.int64)]
            R = [rr[:, c] for c in range(16)]
            v0x, v0y, v0z = R[0], R[1], R[2]
            e1x, e1y, e1z = R[3] - R[0], R[4] - R[1], R[5] - R[2]
            e2x, e2y, e2z = R[6] - R[0], R[7] - R[1], R[8] - R[2]
            texslot = R[9].to(i32)
            b0u = 1.0 - iu_ - iv_
            u_i = (b0u * R[10] + iu_ * R[12]) + iv_ * R[14]
            v_i = (b0u * R[11] + iu_ * R[13]) + iv_ * R[15]
            tx16 = torch.clamp((u_i * 16.0).to(i32), 0, 15)
            ty16 = torch.clamp((v_i * 16.0).to(i32), 0, 15)
            texel = ty16 * 16 + tx16
            n_slot = spec.slot_metal.shape[0]
            in_slot = (texslot >= 0) & (texslot < n_slot)
            sl = torch.clamp(texslot, 0, max(n_slot - 1, 0)).to(torch.int64)
            if n_slot:
                aword = torch.where(in_slot, spec.slot_alpha[sl, (texel >> 2).to(torch.int64)], 0)
                metal = torch.where(in_slot, spec.slot_metal[sl], zero)
            else:
                aword = torch.zeros_like(texel)
                metal = torch.zeros_like(u_i)
            abyte = (aword >> (8 * (texel & 3))) & 0xFF
            ialpha = _div(abyte.to(f32), 255.0)
            nux = e1y * e2z - e1z * e2y
            nuy = e1z * e2x - e1x * e2z
            nuz = e1x * e2y - e1y * e2x
            nl = torch.clamp_min(torch.sqrt((nux * nux + nuy * nuy) + nuz * nuz), 1e-30)
            inx, iny, inz = nux / nl, nuy / nl, nuz / nl
            tl = torch.clamp_min(torch.sqrt((e1x * e1x + e1y * e1y) + e1z * e1z), 1e-30)
            itx, ity, itz = e1x / tl, e1y / tl, e1z / tl
            bux = nuy * e1z - nuz * e1y
            buy = nuz * e1x - nux * e1z
            buz = nux * e1y - nuy * e1x
            bl = torch.clamp_min(torch.sqrt((bux * bux + buy * buy) + buz * buz), 1e-30)
            ibx, iby, ibz = bux / bl, buy / bl, buz / bl
            b0 = 1.0 - iu_ - iv_
            ipx = (b0 * v0x + iu_ * R[3]) + iv_ * R[6]
            ipy = (b0 * v0y + iu_ * R[4]) + iv_ * R[7]
            ipz = (b0 * v0z + iu_ * R[5]) + iv_ * R[8]
            r0 = rng.draw(seed_b, 0)
            is_mirror = r0 < metal
            is_trans = (~is_mirror) & (r0 < metal + (1.0 - ialpha))
            ndotd = (inx * dx + iny * dy) + inz * dz
            rfx = dx - 2.0 * ndotd * inx
            rfy = dy - 2.0 * ndotd * iny
            rfz = dz - 2.0 * ndotd * inz
            ldx = h0 * itx + h1 * inx + h2 * ibx
            ldy = h0 * ity + h1 * iny + h2 * iby
            ldz = h0 * itz + h1 * inz + h2 * ibz
            ill = torch.sqrt(ldx * ldx + ldy * ldy + ldz * ldz)
            ldx, ldy, ldz = ldx / ill, ldy / ill, ldz / ill
            idx_ = torch.where(is_mirror, rfx, torch.where(is_trans, dx, ldx))
            idy_ = torch.where(is_mirror, rfy, torch.where(is_trans, dy, ldy))
            idz_ = torch.where(is_mirror, rfz, torch.where(is_trans, dz, ldz))
            ndx = torch.where(inst_wins, idx_, ndx)
            ndy = torch.where(inst_wins, idy_, ndy)
            ndz = torch.where(inst_wins, idz_, ndz)
            hpx = torch.where(inst_wins, ipx, hpx)
            hpy = torch.where(inst_wins, ipy, hpy)
            hpz = torch.where(inst_wins, ipz, hpz)

        edited = eblk = None
        if spec.E:
            edited, _, _, eblk = dda_proc._edit_match(pw, hx, hy, hz)
        vmirror = vtrans = None
        if spec.mat_map is not None:
            # edited-cell constant-material scatter (mirror class edit_mats,
            # glass class edit_glass): one draw branches mirror / transmit /
            # cosine exactly as shading does with the fetched texel
            ent = torch.where(edited, spec.mat_map[eblk.to(torch.int64) & 255], -1)
            has = ent >= 0
            ent_l = torch.clamp_min(ent, 0).to(torch.int64)
            metal_v = torch.where(has, spec.mat_metal[ent_l, fi], zero)
            gtx = torch.clamp((affine_uv("cu") * 16.0).to(i32), 0, 15)
            gty = torch.clamp((affine_uv("cv") * 16.0).to(i32), 0, 15)
            gtexel = gty * 16 + gtx
            aw = spec.mat_words[ent_l, fi, (gtexel >> 2).to(torch.int64)]
            ab = (aw >> (8 * (gtexel & 3))) & 0xFF
            alpha_v = torch.where(has & spec.mat_glass[ent_l], _div(ab.to(f32), 255.0),
                                  torch.ones_like(metal_v))
            r0v = rng.draw(seed_b, 0)
            vmirror = vox_hit & (r0v < metal_v)
            vdot = (nx_ * dx + ny_ * dy) + nz_ * dz
            ndx = torch.where(vmirror, dx - 2.0 * vdot * nx_, ndx)
            ndy = torch.where(vmirror, dy - 2.0 * vdot * ny_, ndy)
            ndz = torch.where(vmirror, dz - 2.0 * vdot * nz_, ndz)
            vtrans = vox_hit & ~vmirror & (r0v < metal_v + (1.0 - alpha_v))
            ndx = torch.where(vtrans, dx, ndx)
            ndy = torch.where(vtrans, dy, ndy)
            ndz = torch.where(vtrans, dz, ndz)

        if spec.n_lights and b < B - 1:
            vox_lam = vox_hit
            if vmirror is not None:
                vox_lam = vox_lam & ~vmirror & ~vtrans
            if spec.n_inst:
                nsx = torch.where(inst_wins, inx, nx_)
                nsy = torch.where(inst_wins, iny, ny_)
                nsz = torch.where(inst_wins, inz, nz_)
                lam = advance & (vox_lam | (inst_wins & ~is_mirror & ~is_trans))
            else:
                nsx, nsy, nsz = nx_, ny_, nz_
                lam = advance & vox_lam
            r7 = rng.draw(seed_b, 7)
            r8 = rng.draw(seed_b, 8)
            r9 = rng.draw(seed_b, 9)
            LR = spec.light_rows
            imps = []
            for j in range(spec.n_lights):
                lr = LR[j]
                vis_j = None
                for c in (0, 3, 6):
                    dp = ((lr[c] - hpx) * nsx + (lr[c + 1] - hpy) * nsy) + (lr[c + 2] - hpz) * nsz
                    vis_j = (dp >= EPS_BLOCK) if vis_j is None else (vis_j | (dp >= EPS_BLOCK))
                cxj = _div(lr[0] + lr[3] + lr[6], 3.0)
                cyj = _div(lr[1] + lr[4] + lr[7], 3.0)
                czj = _div(lr[2] + lr[5] + lr[8], 3.0)
                dcx, dcy, dcz = cxj - hpx, cyj - hpy, czj - hpz
                d2c = (dcx * dcx + dcy * dcy) + dcz * dcz
                imps.append(torch.where(vis_j, lr[9] / torch.clamp_min(d2c, 1e-30), zero))
            W = torch.zeros_like(hpx)
            for j in range(spec.n_lights):
                W = W + imps[j]
            rW = r7 * W
            cum = torch.zeros_like(hpx)
            found = torch.zeros_like(mhit)
            lidx = torch.full_like(face, -1)
            impc = torch.zeros_like(hpx)
            for j in range(spec.n_lights):
                cum = cum + imps[j]
                pick = (~found) & (cum > rW)
                lidx = torch.where(pick, j, lidx)
                impc = torch.where(pick, imps[j], impc)
                found = found | pick
            cs = torch.where(found[:, None], LR[torch.clamp_min(lidx, 0).to(torch.int64)], zero)
            C = [cs[:, c] for c in range(18)]
            su = torch.sqrt(r8)
            b0_ = 1.0 - su
            b1_ = su * (1.0 - r9)
            b2_ = su * r9
            yx = (b0_ * C[0] + b1_ * C[3]) + b2_ * C[6]
            yy = (b0_ * C[1] + b1_ * C[4]) + b2_ * C[7]
            yz = (b0_ * C[2] + b1_ * C[5]) + b2_ * C[8]
            tox, toy, toz = yx - hpx, yy - hpy, yz - hpz
            sdist = torch.sqrt((tox * tox + toy * toy) + toz * toz)
            sden = torch.clamp_min(sdist, 1e-30)
            sdx_, sdy_, sdz_ = tox / sden, toy / sden, toz / sden
            cosx_ = (sdx_ * nsx + sdy_ * nsy) + sdz_ * nsz
            stc_new = sdist - (1e-3 + 1e-3 * sdist)
            has_s = found & (impc > 0.0) & (sdist > 1e-6) & (cosx_ > 0.0)
            launch = lam & has_s
            if spec.rad:
                carea, ltex = C[10], C[11]
                le1x, le1y, le1z = C[3] - C[0], C[4] - C[1], C[5] - C[2]
                le2x, le2y, le2z = C[6] - C[0], C[7] - C[1], C[8] - C[2]
                lnx = le1y * le2z - le1z * le2y
                lny = le1z * le2x - le1x * le2z
                lnz = le1x * le2y - le1y * le2x
                lnn = torch.clamp_min(torch.sqrt((lnx * lnx + lny * lny) + lnz * lnz), 1e-30)
                lnx, lny, lnz = lnx / lnn, lny / lnn, lnz / lnn
                cos_l = -((sdx_ * lnx + sdy_ * lny) + sdz_ * lnz)
                w_ls = torch.clamp(_div(impc, spec.nee_scale), 0.0, spec.nee_clamp)
                lvalid = ((impc > 0.0) & (w_ls > 0.0) & (cos_l > 0.0)
                          & (sdist > 1e-6) & (carea > 0.0))
                # without a valid light term geo is 0 whatever the shadow
                # ray finds: no march
                launch = launch & lvalid
            if stats is not None:
                launched[b, live] = launch
            # the shadow sub-phase: march to the light distance; an occluder
            # is any voxel or instance hit strictly before it
            occl = torch.zeros_like(launch)
            li = torch.nonzero(launch).squeeze(1)
            if li.numel():
                so = torch.stack([hpx[li], hpy[li], hpz[li]], dim=-1)
                sd = torch.stack([sdx_[li], sdy_[li], sdz_[li]], dim=-1)
                stc = stc_new[li]
                s_stop = None
                if spec.n_inst:
                    sih, sit, _, _, _ = _inst_intersect(
                        spec.inst_rows, so[:, 0], so[:, 1], so[:, 2],
                        sd[:, 0], sd[:, 1], sd[:, 2], t_min, t_max)
                    s_stop = torch.where(sih, sit, inf)
                ts, ws = dda_proc.trace_proc_packed(pw, so, sd, t_min, t_max, pd, stc,
                                                    shadow_stats, s_stop)
                if stats is not None:
                    shadow_rs[live[li]] += shadow_stats["ray_steps"]
                oc = ((ws & 1) != 0) & (ts < stc)
                if spec.n_inst:
                    oc = oc | (sih & (sit < stc))
                occl[li] = oc
            sel = live[advance]
            if spec.rad:
                lsw = torch.where(lvalid, w_ls, zero)
                w_rec = torch.where(lam, lsw, zero)
                ok_ = lvalid & lam & (cosx_ > 0.0)
                inv_pdf = (carea * W) / torch.clamp_min(impc, 1e-30)
                geo = (cos_l * inv_pdf) / torch.clamp_min(sdist * sdist, 1e-12)
                geo_rec = torch.where(ok_ & ~(launch & occl), geo, zero)
                cxp_rec = _div(cosx_, _PI)
                uvy_u = (b0_ * C[12] + b1_ * C[14]) + b2_ * C[16]
                uvy_v = (b0_ * C[13] + b1_ * C[15]) + b2_ * C[17]
                ltx = torch.clamp((uvy_u * 16.0).to(i32), 0, 15)
                lty = torch.clamp((uvy_v * 16.0).to(i32), 0, 15)
                ltexel = lty * 16 + ltx
                te = [torch.zeros_like(hpx) for _ in range(3)]
                for members, widx, pal in spec.em:
                    mg = None
                    for mid in members:
                        mm = ltex == float(np.float32(mid))
                        mg = mm if mg is None else (mg | mm)
                    pword = widx[(ltexel >> 2).to(torch.int64)]
                    pidx = ((pword >> (8 * (ltexel & 3))) & 0xFF).to(torch.int64)
                    inpal = pidx < pal.shape[0]
                    prow = pal[torch.clamp_max(pidx, pal.shape[0] - 1)]
                    for c in range(3):
                        te[c] = torch.where(mg & inpal, prow[:, c], torch.where(mg, zero, te[c]))
                recs = (w_rec, cxp_rec, geo_rec,
                        (spec.gain * te[0]) * cos_l,
                        (spec.gain * te[1]) * cos_l,
                        (spec.gain * te[2]) * cos_l)
                for k, v in zip(("w", "cxp", "geo", "ey0", "ey1", "ey2"), recs):
                    fout[frow[(k, b)], sel] = v[advance]
            else:
                recorded = found & (impc > 0.0)
                iout[irow[("lidx", b)], sel] = torch.where(recorded, lidx, -1)[advance].to(i32)
                vis = torch.where(launch, (~occl).to(i32), 1)
                iout[irow[("vis", b)], sel] = vis[advance].to(i32)
                if spec.nee_pdf:
                    fout[frow[("impc", b)], sel] = torch.where(recorded, impc, zero)[advance]
                    fout[frow[("W", b)], sel] = W[advance]

        if spec.rad:
            u_v = affine_uv("cu")
            v_v = affine_uv("cv")
            vtx = torch.clamp((u_v * 16.0).to(i32), 0, 15)
            vty = torch.clamp((v_v * 16.0).to(i32), 0, 15)
            texel_v = vty * 16 + vtx
            # hit block id: worldgen grass/stone from the cell above (the
            # DIVISION form of the density, no edit override there) and the
            # edit override at the hit cell itself
            wxh = hx.to(f32) + gox
            wyh = hy.to(f32) + goy
            wzh = hz.to(f32) + goz
            dens_above = simplex3_seeded(
                _div(wxh, ps.noise_scale), _div(wyh + 1.0, ps.noise_scale),
                _div(wzh, ps.noise_scale), seed_mix,
            ) - _div(wyh + 1.0, ps.y_falloff)
            above = dens_above > ps.threshold
            blk = torch.where(above, ps.stone, ps.grass).to(i32)
            if spec.E:
                blk = torch.where(edited, eblk, blk)
            tmat = blk * 6 + face
            texel_r = texel_v
            br_code = torch.zeros_like(face)
            if vmirror is not None:
                br_code = torch.where(vmirror, 1, br_code)
                br_code = torch.where(vtrans, 2, br_code)
            if spec.n_inst:
                n_slot = spec.slot_tex.shape[0]
                tid_i = torch.where(in_slot, spec.slot_tex[sl], 0) if n_slot \
                    else torch.zeros_like(face)
                tmat = torch.where(inst_wins, tid_i, tmat)
                texel_r = torch.where(inst_wins, texel, texel_r)
                br_code = torch.where(inst_wins & is_mirror, 1,
                                      torch.where(inst_wins & is_trans, 2, br_code))
            hitb = vox_hit | inst_wins
            code = torch.where(
                hitb, hitb.to(i32) | (br_code << 1) | ((tmat * 256 + texel_r) << 3), 0)
            if spec.n_inst:
                nrx = torch.where(inst_wins, inx, nx_)
                nry = torch.where(inst_wins, iny, ny_)
                nrz = torch.where(inst_wins, inz, nz_)
            else:
                nrx, nry, nrz = nx_, ny_, nz_
            cosin = -((dx * nrx + dy * nry) + dz * nrz)
            ct = (ndx * nx_ + ndy * ny_) + ndz * nz_
            if spec.n_inst:
                ct = torch.where(inst_wins, (ldx * inx + ldy * iny) + ldz * inz, ct)
            ctp = _div(ct, _PI)
            sr_rec = ctp / ctp
            iout[irow[("code", b)], live] = code.to(i32)
            fout[frow[("cos_in", b)], live] = cosin
            fout[frow[("sr", b)], live] = sr_rec
        else:
            if b + 1 < B:
                sel = live[advance]
                fout[frow[("dx", b)], sel] = ndx[advance]
                fout[frow[("dy", b)], sel] = ndy[advance]
                fout[frow[("dz", b)], sel] = ndz[advance]

        live = live[advance]
        co = torch.stack([hpx[advance], hpy[advance], hpz[advance]], dim=-1)
        cd = torch.stack([ndx[advance], ndy[advance], ndz[advance]], dim=-1)
    if stats is not None:
        path_stats["ray_steps"] = path_rs
        shadow_stats["ray_steps"] = shadow_rs
        shadow_stats["launched"] = launched
    return iout, fout


# ---------------------------------------------------------------------------
# the kernel launch
# ---------------------------------------------------------------------------


def _f32_bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous().view(torch.int32).reshape(-1)


def kernel_tables(spec: _Spec, dev):
    """The kernel's loop-invariant tables as ONE int32 buffer (floats as
    their bit patterns), copied into shared memory once per block, and the
    offsets of its parts: the per-face constants (at 0, FACE_WORDS words),
    edit keys/flags, instance rows, per-slot alpha words / metallicity /
    texture id, light rows, light emissive groups, edited-block material
    entries."""
    ft = _face_tables(dev)
    face = torch.cat([
        _f32_bits(ft["normal"]), _f32_bits(ft["tan0"]), _f32_bits(ft["tan1"]),
        _f32_bits(ft["bit0"]), _f32_bits(ft["bit1"]), _f32_bits(ft["cu"]),
        _f32_bits(ft["cv"]), ft["axes"].to(torch.int32).reshape(-1),
    ])
    assert face.numel() == FACE_WORDS
    parts, offs = [face], {}
    pos = FACE_WORDS

    def add(name, t):
        nonlocal pos
        offs[name] = pos
        if t is not None and t.numel():
            t = t.reshape(-1).to(dev)
            parts.append(t)
            pos += t.numel()

    i32 = torch.int32
    if spec.E:
        add("ekey", spec.edits[0].to(i32))
        add("eflg", spec.edits[1].to(i32))
    else:
        add("ekey", None)
        add("eflg", None)
    if spec.n_inst:
        add("inst", _f32_bits(spec.inst_rows))
        add("slot_alpha", spec.slot_alpha.to(i32))
        add("slot_metal", _f32_bits(spec.slot_metal))
        add("slot_tex", spec.slot_tex.to(i32))
    else:
        for k in ("inst", "slot_alpha", "slot_metal", "slot_tex"):
            add(k, None)
    add("light", _f32_bits(spec.light_rows) if spec.n_lights else None)
    groups = []
    for members, widx, pal in spec.em:
        if len(members) > EM_MEMBERS or pal.shape[0] > EM_PAL:
            raise ValueError(
                f"light emissive group with {len(members)} members / {pal.shape[0]} "
                f"palette entries exceeds the kernel's {EM_MEMBERS} / {EM_PAL}")
        g = torch.zeros(EM_GROUP_WORDS, dtype=i32, device=dev)
        g[0] = len(members)
        mem = torch.tensor([float(np.float32(m)) for m in members], dtype=torch.float32,
                           device=dev)
        g[1:1 + len(members)] = _f32_bits(mem)
        g[1 + EM_MEMBERS:1 + EM_MEMBERS + 64] = widx.to(dev)
        g[1 + EM_MEMBERS + 64] = pal.shape[0]
        base = 2 + EM_MEMBERS + 64
        g[base:base + 3 * pal.shape[0]] = _f32_bits(pal)
        groups.append(g)
    add("em", torch.cat(groups) if groups else None)
    if spec.mat_map is not None:
        add("mat_map", spec.mat_map.to(i32))
        ents = torch.cat([
            spec.mat_glass.to(i32)[:, None],
            _f32_bits(spec.mat_metal).reshape(-1, 6),
            spec.mat_words.reshape(-1, 6 * 64).to(i32),
        ], dim=1)
        assert ents.shape[1] == MAT_WORDS
        add("mat", ents)
    else:
        add("mat_map", None)
        add("mat", None)
    return torch.cat(parts).contiguous(), offs, pos


def launch_args(spec: _Spec, ps, pd, n: int, t_min: float, t_max: float, dev):
    """Everything the kernel's C entry point takes besides the rays and the
    record buffers: (table buffer, its length in words, integer parameters,
    float parameters), in the order ``csrc/path_proc.cu`` reads them."""
    X, Y, Z = (int(s) for s in ps.shape)
    if max(X, Y, Z) > MAX_GRID:
        raise ValueError(f"grid {ps.shape} exceeds the packed word's {MAX_GRID}^3")
    if spec.E > MAX_EDITS:
        raise ValueError(f"{spec.E} edit rows exceed the kernel's {MAX_EDITS}")
    if spec.E:
        _check("edit_key", spec.edits[0], torch.int32, (spec.E,), dev)
        _check("edit_flags", spec.edits[1], torch.int32, (spec.E,), dev)
    tab, offs, words = kernel_tables(spec, dev)
    if 4 * (words + THREADS * SLOT_WORDS + BOX_WORDS) > SMEM_LIMIT:
        raise ValueError(f"kernel tables of {4 * words} bytes and the lanes' slots "
                         f"exceed shared memory")
    irows, frows = record_layout(spec)
    y_cut = dda_proc.derive_y_cut(ps, pd)
    ip = np.array([
        X, Y, Z, y_cut, spec.E, int(np.uint32(_seed_mix(ps.seed)).view(np.int32)),
        ps.grass, ps.stone, spec.B, spec.n_inst,
        0 if spec.slot_metal is None else spec.slot_metal.shape[0],
        spec.n_lights, len(spec.em),
        0 if spec.mat_map is None else spec.mat_glass.shape[0],
        int(spec.rad), int(spec.nee_pdf), words,
        offs["ekey"], offs["eflg"], offs["inst"], offs["slot_alpha"],
        offs["slot_metal"], offs["slot_tex"], offs["light"], offs["em"],
        offs["mat_map"], offs["mat"], len(irows), len(frows),
    ], dtype=np.int64).astype(np.int32)
    fp = np.array([
        *(float(v) for v in ps.origin),
        np.float32(1.0 / ps.noise_scale), np.float32(1.0 / ps.y_falloff),
        ps.threshold, t_min, t_max, ps.noise_scale, ps.y_falloff,
        spec.nee_scale, spec.nee_clamp, spec.gain,
    ], dtype=np.float32)
    return tab, words, ip, fp


_TABLES: "OrderedDict" = OrderedDict()
TABLE_CACHE = 8             # launch-table sets kept (scene states x configs)


def _fingerprint(x, keep: list):
    """Hashable description of an argument: tensors by identity and version
    counter (an in-place write bumps it), containers by their items. The
    tensors go to ``keep``, so while a cache entry holds them no other
    tensor can take their ids."""
    if isinstance(x, torch.Tensor):
        keep.append(x)
        return ("tensor", id(x), x._version)
    if isinstance(x, dict):
        return ("dict",) + tuple((k, _fingerprint(v, keep)) for k, v in sorted(x.items()))
    if isinstance(x, (tuple, list)):
        return ("seq",) + tuple(_fingerprint(v, keep) for v in x)
    return x


def _launch_tables(ps, pd, B, dev, inst, inst_static, lights, nee_pdf, radiance,
                   light_em, nee_scale, nee_clamp, emission_gain, t_min, t_max):
    """(spec, launch_args) of one call, built once per scene state and
    configuration: the tables are copied to the card at the first launch and
    reused by every later one with the same inputs (same tensors, none written
    since), so a launch moves nothing from the host and never waits on it."""
    keep: list = []
    key = (ps, int(B), str(dev), inst_static, light_em, bool(nee_pdf), bool(radiance),
           float(nee_scale), float(nee_clamp), float(emission_gain), float(t_min),
           float(t_max), _fingerprint(pd, keep), _fingerprint(inst, keep),
           _fingerprint(lights, keep))
    hit = _TABLES.get(key)
    if hit is not None:
        _TABLES.move_to_end(key)
        return hit[1], hit[2]
    spec = _make_spec(ps, pd, B, dev, inst, inst_static, lights, nee_pdf, radiance,
                      light_em, nee_scale, nee_clamp, emission_gain)
    args = launch_args(spec, ps, pd, 0, t_min, t_max, dev)
    _TABLES[key] = (keep, spec, args)
    while len(_TABLES) > TABLE_CACHE:
        _TABLES.popitem(last=False)
    return spec, args


def _launch_flat(spec: _Spec, ps, pd, o, d, seeds, t_min, t_max, args=None):
    """Launch the kernel on flat CUDA rays; raises on anything it does not
    take and never runs the plain version. args: ``launch_args``'s result
    for these inputs when the caller has it (``_launch_tables``)."""
    if not (isinstance(o, torch.Tensor) and o.is_cuda):
        raise ValueError("the path kernel takes CUDA tensors only")
    dev = o.device
    n = o.shape[0]
    _check("origin", o, torch.float32, (n, 3), dev)
    _check("direction", d, torch.float32, (n, 3), dev)
    _check("seeds", seeds, torch.int32, (n,), dev)
    tab, words, ip, fp = args or launch_args(spec, ps, pd, n, t_min, t_max, dev)
    irows, frows = record_layout(spec)
    iout = torch.empty((len(irows), n), dtype=torch.int32, device=dev)
    fout = torch.empty((len(frows), n), dtype=torch.float32, device=dev)
    if n == 0:
        return iout, fout       # nothing to launch, nothing to count
    if n > MAX_RAYS:
        raise ValueError(f"{n} rays exceed the kernel's {MAX_RAYS} (int32 ray ids)")
    fn = _kernel_fn()
    # the ray pool's next id, zeroed before every launch (persistent grid)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    # the launch is asynchronous: the table buffer, the counter and the
    # outputs stay valid because PyTorch's stream-ordered allocator hands
    # their memory out again only to work queued after the kernel; ip / fp
    # are read before the launch
    with torch.cuda.device(dev):
        rc = fn(
            o.data_ptr(), d.data_ptr(), seeds.data_ptr(), tab.data_ptr(), words,
            iout.data_ptr(), fout.data_ptr(), n,
            ip.ctypes.data, len(ip), fp.ctypes.data, len(fp),
            torch.cuda.current_stream(dev).cuda_stream, counter.data_ptr(),
        )
    if rc != 0:
        raise RuntimeError(f"path_proc kernel launch failed: CUDA error {rc}")
    trace_path_cuda.launches += 1
    return iout, fout


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def _structure(spec: _Spec, ps, pd, iout, fout, shape):
    """Flat record rows -> trace_path_pallas's return structures."""
    irows, frows = record_layout(spec)
    I = {key: iout[k].reshape(shape) for k, key in enumerate(irows)}  # noqa: E741
    F = {key: fout[k].reshape(shape) for k, key in enumerate(frows)}
    B = spec.B
    if spec.rad:
        codes = [I[("code", b)] for b in range(B)]
        cosins = [F[("cos_in", b)] for b in range(B)]
        srs = [F[("sr", b)] for b in range(B)]
        nrecs = None
        if spec.n_lights:
            nrecs = [tuple(F[(k, b)] for k in ("w", "cxp", "geo", "ey0", "ey1", "ey2"))
                     for b in range(B - 1)]
        return codes, cosins, srs, nrecs
    pw = dda_proc.assemble(ps, pd)
    traces = [dda_proc.unpack_result(pw, F[("t", b)].reshape(-1),
                                     I[("packed", b)].reshape(-1), shape)
              for b in range(B)]
    dirs = [torch.stack([F[("dx", b)], F[("dy", b)], F[("dz", b)]], dim=-1)
            for b in range(B - 1)]
    ihits = None
    if spec.n_inst:
        ihits = []
        for b in range(B):
            prim = I[("prim", b)]
            won = prim >= 0
            ihits.append(InstanceHit(
                hit=won,
                t=torch.where(won, traces[b].t, torch.zeros_like(traces[b].t)),
                prim=torch.clamp_min(prim, 0),
                bary=torch.stack([F[("iu", b)], F[("iv", b)]], dim=-1),
            ))
    nee = None
    if spec.n_lights:
        nee = []
        for b in range(B - 1):
            rec = (I[("lidx", b)], I[("vis", b)] != 0)
            if spec.nee_pdf:
                rec = rec + (F[("impc", b)], F[("W", b)])
            nee.append(rec)
    return traces, dirs, ihits, nee


def _run(impl, ps, origin, direction, seeds, n_bounces, t_min, t_max, pd, inst,
         inst_static, lights, nee_pdf, radiance, light_em, nee_scale, nee_clamp,
         emission_gain, stats, raw):
    shape = tuple(origin.shape[:-1])
    o = origin.reshape(-1, 3).to(torch.float32).contiguous()
    d = direction.reshape(-1, 3).to(torch.float32).contiguous()
    sd = seeds.reshape(-1)
    if sd.dtype != torch.int32:
        # uint32 words of any integer dtype -> their int32 bit patterns
        sd = (sd.to(torch.int64) & 0xFFFFFFFF).to(torch.int32)
    sd = sd.contiguous()
    if impl == "plain":
        spec = _make_spec(ps, pd, int(n_bounces), o.device, inst, inst_static, lights,
                          nee_pdf, radiance, light_em, nee_scale, nee_clamp,
                          emission_gain)
        iout, fout = _plain_flat(spec, ps, pd, o, d, sd, float(t_min), float(t_max), stats)
    else:
        spec, args = _launch_tables(ps, pd, int(n_bounces), o.device, inst, inst_static,
                                    lights, nee_pdf, radiance, light_em, nee_scale,
                                    nee_clamp, emission_gain, float(t_min), float(t_max))
        iout, fout = _launch_flat(spec, ps, pd, o, d, sd, float(t_min), float(t_max), args)
    if raw:
        return spec, iout, fout
    return _structure(spec, ps, pd, iout, fout, shape)


def trace_path_plain(ps, origin, direction, seeds, n_bounces, t_min=0.001,
                     t_max=1000.0, pd=None, inst=None, inst_static=None,
                     lights=None, nee_pdf=False, radiance=False, light_em=None,
                     nee_scale=10.0, nee_clamp=0.5, emission_gain=1000.0,
                     stats: Optional[dict] = None, raw: bool = False):
    """The plain PyTorch version of K2 on any device; same records as the
    kernel. stats: optional dict; receives the DDA steps of the path
    marches (``stats['path']``) and the shadow marches (``stats['shadow']``,
    whose ``rays`` is the number of shadow rays and ``launched`` the (B-1,
    n) bool of the bounces and rays that marched one), each with its total
    ``steps`` and ``ray_steps``, the (n,) int32 steps of each ray in the
    launch order, and the live rays per bounce (``stats['segments']``).
    raw=True returns ``(spec, int rows, float rows)`` — the record buffers
    the kernel writes — instead of the structures."""
    return _run("plain", ps, origin, direction, seeds, n_bounces, t_min, t_max, pd,
                inst, inst_static, lights, nee_pdf, radiance, light_em, nee_scale,
                nee_clamp, emission_gain, stats, raw)


def trace_path_cuda(ps, origin, direction, seeds, n_bounces, t_min=0.001,
                    t_max=1000.0, pd=None, interpret=False, unroll=None, hw=None,
                    retire_cond=True, inst=None, inst_static=None, step_cap=0,
                    lights=None, nee_pdf=False, march_opt=True, radiance=False,
                    light_em=None, nee_scale=10.0, nee_clamp=0.5,
                    emission_gain=1000.0, raw: bool = False):
    """Trace a full n_bounces path per ray — ``trace_path_pallas``'s
    signature and return structures: trace mode ``(traces, dirs, ihits,
    nee)``, radiance mode ``(codes, cos_ins, srs, nrecs)``.

    ``interpret``, ``unroll``, ``hw``, ``retire_cond``, ``march_opt`` and
    ``step_cap`` shape the TPU kernel only and are accepted and ignored:
    each is value-identical there (``step_cap``'s tail restart re-traces the
    unfinished lanes from scratch, bit-identical to one uncapped pass; the
    CUDA kernel's counterpart of both is its warps' refill of finished
    lanes from the ray pool). The
    caller runs without the constant air-region skips (the fused caller
    forces ``use_coarse=False``), and the per-chunk edit gate for large
    edit lists (value-identical) is left out, as in K1.

    Seeds are uint32 words (an int32 tensor holding the bit pattern, or any
    integer tensor)."""
    impl = "cuda" if origin.is_cuda else "plain"
    return _run(impl, ps, origin, direction, seeds, n_bounces, t_min, t_max, pd,
                inst, inst_static, lights, nee_pdf, radiance, light_em, nee_scale,
                nee_clamp, emission_gain, None, raw)


trace_path_cuda.launches = 0
