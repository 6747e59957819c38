"""Bounce shading: BSDF branches, texture fetch, split NEE.

Counterpart of ``vrv_tpu/ops/shade.py`` (``BounceResult``, ``ResolvedHit``,
``_fetch_atlas``, ``_FACE_CONST``, ``resolve_hit``, ``shade_resolved`` (also
with the path kernel's recorded light choices), ``do_bounce``) over a flat
ray batch:

  - miss -> sky emissivity, dead ray
  - material fetch at t = block*6 + face with nearest sampling of the 16x16
    atlas; emissivity = gain * emissive_tex * -dot(dir, normal)
  - one draw picks mirror / transmissive / lambertian
  - lambertian: reflectivity/pi; with lights, shadow-ray ("split") NEE over
    the flat light list with weight clamp(importance/10, 0, 0.5)

The JAX module's one-hot matrix products (``_FACE_CONST`` dot, the
``onehot``/``mxu``/``take``/``split`` fetch variants) are ways to avoid a
gather on a TPU; here each is ONE indexed fetch with the same values, and
``tex_fetch``, ``tex_set`` and ``light_tex_set`` are accepted and ignored.
``_fetch_set_texel`` (the fused path's per-bounce texel fetch over a small
texture set) is a row gather plus the set mask, with the one-hot form's
semantics: rows whose texture lies outside the set read 0.
Mixture NEE (``nee_mode='mixture'`` with lights) needs the BVH descent and
raises ``NotImplementedError`` (ROADMAP: mixture NEE + BVH descent).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from vrv_tpu_torch.ops import dda, nee, rng
from vrv_tpu_torch.ops.intersect import (
    _cross,
    _dot,
    aligned_cosine_sample,
    reflect,
)

_PI = float(np.pi)


class BounceResult(NamedTuple):
    emissivity: torch.Tensor     # (n, 3)
    reflectivity: torch.Tensor   # (n, 3) — already includes scatter_pdf/ray_pdf
    miss: torch.Tensor           # (n,) bool
    new_origin: torch.Tensor     # (n, 3)
    new_direction: torch.Tensor  # (n, 3)
    # split-NEE fields (None without lights). The caller traces the shadow
    # ray and adds  throughput * direct * visible  to the image; `w` is the
    # light-strategy weight the NEXT bounce's surface emission is
    # complemented by (1 - w).
    direct: Optional[torch.Tensor] = None        # (n, 3) pre-visibility direct term
    shadow_dir: Optional[torch.Tensor] = None    # (n, 3) unit dir (0 when no sample)
    shadow_dist: Optional[torch.Tensor] = None   # (n,) distance to the light point
    w: Optional[torch.Tensor] = None             # (n,) f32


def _fetch_atlas(atlas: torch.Tensor, t: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Nearest-neighbour fetch from (T, 16, 16, C): texel (floor(v*16),
    floor(u*16)). The float->int cast comes BEFORE the clip. Rows whose
    texture id lies outside the atlas (miss rays carry air's id) read a
    clamped row; every caller masks them by the hit flag."""
    size = atlas.shape[1]
    tx = torch.clamp((u * size).to(torch.int32), 0, size - 1)
    ty = torch.clamp((v * size).to(torch.int32), 0, size - 1)
    flat = atlas.reshape(-1, atlas.shape[-1])
    idx = (t.to(torch.int64) * size + ty) * size + tx
    return flat[torch.clamp(idx, 0, flat.shape[0] - 1)]


def _tex_groups(tex_set: tuple):
    """Normalize a tex_set whose entries are texture ids OR tuples of ids
    with byte-identical atlas content. Returns (groups, reps): tuple of
    id-tuples + each group's representative id."""
    groups = tuple((e,) if isinstance(e, int) else tuple(e) for e in tex_set)
    return groups, tuple(g[0] for g in groups)


def _group_mask(t: torch.Tensor, group: tuple) -> torch.Tensor:
    m = t == group[0]
    for tid in group[1:]:
        m = m | (t == tid)
    return m


def _fetch_set_texel(atlas: torch.Tensor, t: torch.Tensor, texel: torch.Tensor,
                     tex_set: tuple) -> torch.Tensor:
    """Texel rows of (T, 16, 16, C) for texture ids ``t`` and texel indices
    ``ty*16 + tx``, restricted to ``tex_set``: a row whose texture belongs
    to a group reads the group representative's texel (byte-identical
    content), every other row reads 0."""
    groups, reps = _tex_groups(tex_set)
    size2 = atlas.shape[1] * atlas.shape[2]
    flat = atlas.reshape(-1, atlas.shape[-1])
    rep = torch.full_like(t, -1)
    for g, r in zip(groups, reps):
        rep = torch.where(_group_mask(t, g), r, rep)
    found = rep >= 0
    idx = torch.clamp_min(rep, 0).to(torch.int64) * size2 + texel.to(torch.int64)
    rows = flat[torch.clamp(idx, 0, flat.shape[0] - 1)]
    return torch.where(found[:, None], rows, torch.zeros((), dtype=rows.dtype,
                                                          device=rows.device))


# Per-face constants packed into one (6, 29) matrix: columns =
# [cu(4) | cv(4) | normal(3) | tan0(3) | tan1(3) | bit0(3) | bit1(3) |
#  a_axis_onehot(3) | b_axis_onehot(3)]; a row is fetched by face index.
def _face_const_matrix() -> np.ndarray:
    a_oh = np.zeros((6, 3), np.float32)
    b_oh = np.zeros((6, 3), np.float32)
    for f in range(6):
        a_oh[f, dda.FACE_PLANE_AXES[f, 0]] = 1.0
        b_oh[f, dda.FACE_PLANE_AXES[f, 1]] = 1.0
    return np.concatenate(
        [
            dda.FACE_U_AFFINE,
            dda.FACE_V_AFFINE,
            dda.FACE_NORMALS,
            dda.FACE_TANGENTS[:, 0],
            dda.FACE_TANGENTS[:, 1],
            dda.FACE_BITANGENTS[:, 0],
            dda.FACE_BITANGENTS[:, 1],
            a_oh,
            b_oh,
        ],
        axis=1,
    ).astype(np.float32)


_FACE_CONST = _face_const_matrix()
_FACE_CONST_DEV = {}


def _face_const(device) -> torch.Tensor:
    t = _FACE_CONST_DEV.get(device)
    if t is None:
        t = torch.from_numpy(_FACE_CONST).to(device)
        _FACE_CONST_DEV[device] = t
    return t


def _sum3(x):
    return x[..., 0] + x[..., 1] + x[..., 2]


class ResolvedHit(NamedTuple):
    """Geometry-side bounce state: hit merge, tangent frame, uv, material
    id, next origin."""
    hit: torch.Tensor          # (n,) bool — voxel or instance
    use_inst: torch.Tensor     # (n,) bool
    new_origin: torch.Tensor   # (n, 3) — 0 for misses (the chain convention)
    normal: torch.Tensor       # (n, 3)
    tangent: torch.Tensor      # (n, 3)
    bitangent: torch.Tensor    # (n, 3)
    u: torch.Tensor            # (n,)
    v: torch.Tensor            # (n,)
    t_mat: torch.Tensor        # (n,) int32 texture id


def resolve_hit(
    origin: torch.Tensor,
    direction: torch.Tensor,
    tr: dda.TraceResult,
    inst: Optional[dict] = None,
    inst_hit=None,
) -> ResolvedHit:
    """Merge voxel + instance hits (nearest wins) and derive the shading
    frame: per-face constant tables for voxel hits, the hit triangle's frame
    and interpolated uv for instance hits. new_origin is zeroed for misses."""
    n = origin.shape[0]
    f32 = torch.float32

    if inst_hit is not None:
        use_inst = inst_hit.hit & (~tr.hit | (inst_hit.t < tr.t))
        hit = tr.hit | inst_hit.hit
        t_hit = torch.where(use_inst, inst_hit.t, tr.t)
    else:
        use_inst = torch.zeros((n,), dtype=torch.bool, device=origin.device)
        hit = tr.hit
        t_hit = tr.t
    hit_p = origin + t_hit[:, None] * direction

    face = tr.face
    frac = hit_p - tr.cell.to(f32)

    fc = _face_const(origin.device)[face.to(torch.int64)]      # (n, 29)
    cu, cv = fc[:, 0:4], fc[:, 4:8]
    normal = fc[:, 8:11]
    tan0, tan1 = fc[:, 11:14], fc[:, 14:17]
    bit0, bit1 = fc[:, 17:20], fc[:, 20:23]
    a_oh, b_oh = fc[:, 23:26], fc[:, 26:29]

    # uv from per-face affine tables
    u = cu[:, 0] + _sum3(cu[:, 1:] * frac)
    v = cv[:, 0] + _sum3(cv[:, 1:] * frac)

    # tangent frame: triangle picked by the quad diagonal in in-plane coords
    fa = _sum3(frac * a_oh)
    fb = _sum3(frac * b_oh)
    tri1_sel = (fa + fb > 1.0)[:, None]
    tangent = torch.where(tri1_sel, tan1, tan0)
    bitangent = torch.where(tri1_sel, bit1, bit0)

    t_mat = tr.block.to(torch.int32) * 6 + face
    new_origin = hit_p

    if inst_hit is not None:
        prim = inst_hit.prim.to(torch.int64)
        tri_i = inst["tri"][prim]                                  # (n, 3, 3)
        uv_i = inst["uv"][prim]                                    # (n, 3, 2)
        tmat_i = inst["t"][prim].to(torch.int32)
        bu, bv = inst_hit.bary[:, 0], inst_hit.bary[:, 1]
        bary3 = torch.stack([1.0 - bu - bv, bu, bv], dim=-1)       # (n, 3)
        w3 = bary3[..., None]
        uv_w = w3 * uv_i
        uv_interp = uv_w[:, 0] + uv_w[:, 1] + uv_w[:, 2]           # (n, 2)
        e01 = tri_i[:, 1] - tri_i[:, 0]
        e02 = tri_i[:, 2] - tri_i[:, 0]
        n_unnorm = _cross(e01, e02)
        n_i = n_unnorm / torch.clamp_min(
            torch.sqrt(_dot(n_unnorm, n_unnorm)), 1e-30
        )[:, None]
        t_i = e01 / torch.clamp_min(torch.sqrt(_dot(e01, e01)), 1e-30)[:, None]
        b_unnorm = _cross(n_unnorm, e01)
        b_i = b_unnorm / torch.clamp_min(
            torch.sqrt(_dot(b_unnorm, b_unnorm)), 1e-30
        )[:, None]
        # bary-interpolated hit point
        p_w = w3 * tri_i
        p_i = p_w[:, 0] + p_w[:, 1] + p_w[:, 2]

        m = use_inst[:, None]
        normal = torch.where(m, n_i, normal)
        tangent = torch.where(m, t_i, tangent)
        bitangent = torch.where(m, b_i, bitangent)
        u = torch.where(use_inst, uv_interp[:, 0], u)
        v = torch.where(use_inst, uv_interp[:, 1], v)
        t_mat = torch.where(use_inst, tmat_i, t_mat)
        new_origin = torch.where(m, p_i, new_origin)

    return ResolvedHit(
        hit=hit,
        use_inst=use_inst,
        new_origin=torch.where(hit[:, None], new_origin, torch.zeros_like(new_origin)),
        normal=normal,
        tangent=tangent,
        bitangent=bitangent,
        u=u,
        v=v,
        t_mat=t_mat,
    )


def shade_resolved(
    rh: ResolvedHit,
    direction: torch.Tensor,
    seed: torch.Tensor,
    materials: dict,
    bvh: Optional[dict],
    *,
    sky_emission: float = 50.0,
    emission_gain: float = 1000.0,
    nee_importance_scale: float = 10.0,
    nee_mis_clamp: float = 0.5,
    bvh_max_depth: int = 0,
    tex_set: Optional[tuple] = None,
    nee_mode: str = "mixture",
    w_prev: Optional[torch.Tensor] = None,
    light_tex_set: Optional[tuple] = None,
    flat_sel_idx: Optional[torch.Tensor] = None,
    flat_sel_imp: Optional[torch.Tensor] = None,
    flat_sel_W: Optional[torch.Tensor] = None,
    tex_fetch: str = "split",
) -> BounceResult:
    """Texture fetch + BSDF branch + NEE over pre-resolved hits.
    Row-independent (every output row depends only on that row's inputs), so
    one call over several bounces' concatenated rows equals one call per
    bounce bit for bit.

    flat_sel_idx / flat_sel_imp / flat_sel_W: the path kernel's in-kernel NEE
    records (light index, -1 = no sample; chosen importance; selection
    total), passed to ``nee.sample_light_flat`` in split mode: the direct
    term is then computed for exactly the light the kernel marched a shadow
    ray to, and the caller multiplies by the kernel's recorded visibility."""
    n = direction.shape[0]
    hit = rh.hit
    normal, tangent, bitangent = rh.normal, rh.tangent, rh.bitangent
    u, v, t_mat, new_origin = rh.u, rh.v, rh.t_mat, rh.new_origin

    if "packed" in materials:
        # one 8-wide row fetch: refl rgba | emis rgb | metal r
        tex = _fetch_atlas(materials["packed"], t_mat, u, v)
        tex0, tex1, tex2 = tex[:, :4], tex[:, 4:7], tex[:, 7:8]
    else:
        tex0 = _fetch_atlas(materials["reflectivity"], t_mat, u, v)
        tex1 = _fetch_atlas(materials["emissivity"], t_mat, u, v)
        tex2 = _fetch_atlas(materials["metallicity"], t_mat, u, v)

    reflectivity = tex0[:, :3]
    alpha = tex0[:, 3]
    emissivity = emission_gain * tex1 * (-_dot(direction, normal))[:, None]
    metallicity = tex2[:, 0]
    if w_prev is not None:
        # split NEE: the previous bounce already claimed `w_prev` of this
        # surface-emission pickup through its shadow ray
        emissivity = emissivity * (1.0 - w_prev)[:, None]

    # --- scatter-kind branch (one draw) ---
    scatter_rand = rng.draw(seed, 0)
    is_mirror = scatter_rand < metallicity
    is_transmissive = (~is_mirror) & (scatter_rand < metallicity + (1.0 - alpha))
    is_lambert = ~(is_mirror | is_transmissive)

    dir_mirror = reflect(direction, normal)
    dir_transmit = direction

    refl_lambert = reflectivity / _PI

    dir_hemi = aligned_cosine_sample(
        rng.draw(seed, 4), rng.draw(seed, 5), normal, tangent, bitangent
    )

    direct = sdir = sdist = w_out = None
    if bvh is not None and nee_mode == "split":
        # shadow-ray NEE: the continuation stays cosine; the direct term is
        #   w * (rho/pi) * (cos_x/pi) * E_y * cos_l / (pdf_A d^2)
        # with E_y = gain * tex * cos_l; the next bounce's emission pickup
        # is scaled by (1 - w). The caller multiplies by shadow-ray
        # visibility and path throughput.
        if bvh.get("flat") is None:
            raise NotImplementedError(
                "split NEE beyond the flat light list needs the light-BVH "
                "descent (ROADMAP: mixture NEE + BVH descent)"
            )
        ls = nee.sample_light_flat(
            new_origin, normal, seed, bvh["flat"],
            importance_scale=nee_importance_scale,
            mis_clamp=nee_mis_clamp,
            sel_idx=flat_sel_idx, sel_imp=flat_sel_imp, sel_W=flat_sel_W,
        )
        new_dir_l = dir_hemi
        cos_theta = _dot(new_dir_l, normal)
        # literal reference arithmetic: (cos/pi) / (cos/pi)
        spdf_over_rpdf = (cos_theta / _PI) / (cos_theta / _PI)
        if "packed" in materials:
            te = _fetch_atlas(
                materials["packed"], ls.tex, ls.uv[:, 0], ls.uv[:, 1]
            )[:, 4:7]
        else:
            te = _fetch_atlas(
                materials["emissivity"], ls.tex, ls.uv[:, 0], ls.uv[:, 1]
            )
        e_y = emission_gain * te * ls.cos_light[:, None]
        cos_x = _dot(ls.dir, normal)
        ok = ls.valid & is_lambert & hit & (cos_x > 0.0)
        geo = ls.cos_light * ls.inv_pdf_area / torch.clamp_min(
            ls.dist * ls.dist, 1e-12
        )
        direct = torch.where(
            ok[:, None],
            ls.w[:, None] * refl_lambert * (cos_x / _PI)[:, None]
            * e_y * geo[:, None],
            torch.zeros_like(refl_lambert),
        )
        # degenerate dir for unsampled rays: the tracer retires them at init
        sdir = torch.where(ok[:, None], ls.dir, torch.zeros_like(ls.dir))
        sdist = ls.dist
        w_out = torch.where(is_lambert & hit, ls.w, torch.zeros_like(ls.w))
    elif bvh is not None:
        raise NotImplementedError(
            "mixture NEE needs the light-BVH descent (ROADMAP: mixture NEE + "
            "BVH descent); use nee_mode='split'"
        )
    else:
        new_dir_l = dir_hemi
        cos_theta = _dot(new_dir_l, normal)
        spdf_over_rpdf = (cos_theta / _PI) / (cos_theta / _PI)

    # --- combine branches ---
    new_direction = torch.where(
        is_mirror[:, None],
        dir_mirror,
        torch.where(is_transmissive[:, None], dir_transmit, new_dir_l),
    )
    refl_out = torch.where(
        is_mirror[:, None],
        reflectivity,
        torch.where(
            is_transmissive[:, None],
            torch.ones_like(reflectivity),
            refl_lambert * spdf_over_rpdf[:, None],
        ),
    )

    # --- miss: sky ---
    sky = torch.full((n, 3), float(sky_emission), dtype=torch.float32,
                     device=direction.device)
    emissivity = torch.where(hit[:, None], emissivity, sky)
    refl_out = torch.where(hit[:, None], refl_out, torch.zeros_like(refl_out))
    # new_origin already zeroed for misses by resolve_hit
    new_direction = torch.where(hit[:, None], new_direction,
                                torch.zeros_like(new_direction))

    return BounceResult(
        emissivity=emissivity,
        reflectivity=refl_out,
        miss=~hit,
        new_origin=new_origin,
        new_direction=new_direction,
        direct=direct,
        shadow_dir=sdir,
        shadow_dist=sdist,
        w=w_out,
    )


def do_bounce(
    origin: torch.Tensor,
    direction: torch.Tensor,
    tr: dda.TraceResult,
    seed: torch.Tensor,
    materials: dict,
    bvh: Optional[dict],
    *,
    sky_emission: float = 50.0,
    emission_gain: float = 1000.0,
    nee_importance_scale: float = 10.0,
    nee_mis_clamp: float = 0.5,
    bvh_max_depth: int = 0,
    inst: Optional[dict] = None,
    inst_hit=None,
    tex_set: Optional[tuple] = None,
    nee_mode: str = "mixture",
    w_prev: Optional[torch.Tensor] = None,
    light_tex_set: Optional[tuple] = None,
    tex_fetch: str = "split",
) -> BounceResult:
    """One path-tracing bounce for a flat ray batch: resolve_hit +
    shade_resolved.

    materials: dict with 'reflectivity' (T,16,16,4), 'emissivity' (T,16,16,3),
    'metallicity' (T,16,16,1) float32 linear atlases and/or 'packed'
    (T,16,16,8). bvh: device light dict (with its 'flat' list) or None.
    inst/inst_hit: optional entity triangle set {'tri','t','uv','valid'} +
    ops.instances.InstanceHit; the nearer of the voxel and instance hits
    wins per ray."""
    rh = resolve_hit(origin, direction, tr, inst=inst, inst_hit=inst_hit)
    return shade_resolved(
        rh, direction, seed, materials, bvh,
        sky_emission=sky_emission,
        emission_gain=emission_gain,
        nee_importance_scale=nee_importance_scale,
        nee_mis_clamp=nee_mis_clamp,
        bvh_max_depth=bvh_max_depth,
        tex_set=tex_set,
        nee_mode=nee_mode,
        w_prev=w_prev,
        light_tex_set=light_tex_set,
        tex_fetch=tex_fetch,
    )
