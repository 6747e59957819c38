"""Next-event estimation: flat-list light sampling for split NEE.

Counterpart of ``vrv_tpu/ops/nee.py`` (``LightSample``,
``sample_light_flat`` with the ``sel_*`` inputs of the fused kernel's
records, ``EPSILON_BLOCK``). For the light counts the game plays at (a handful of
placed lamps + emissive entity faces) the importance of EVERY light triangle
is computed and one is picked with exact importance-proportional
probability; draw slots 7/8/9 pick the light and the point on it.

The JAX function reads the chosen light's features with a one-hot matrix
product; here the row is indexed directly (same values). The cumsum-then-
select semantics are kept: an exclusive one-hot over the running sum, and a
ray whose one-hot is empty gets all-zero features (``tex = 0``,
``area = 0``). With the path kernel's recorded light index (``sel_idx``,
-1 = no sample) the selection draw is skipped; with its recorded chosen
importance and selection total (``sel_imp``, ``sel_W``) the whole (n, L)
importance field is skipped too. ``torch.cumsum`` may associate differently on CUDA than on
the CPU, which can move the selection total ``W`` by an ulp between devices.
The stochastic BVH descent (``traverse``, ``sample_light``) is not ported
yet (ROADMAP: mixture NEE + BVH descent). Row-independent: large batches are
processed in chunks of rays (value-identical).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vrv_tpu_torch.ops import rng
from vrv_tpu_torch.ops.intersect import EPSILON_BLOCK, _cross, _dot

_CHUNK = 1 << 20


class LightSample(NamedTuple):
    """A sampled light point for the split-NEE direct term."""

    w: torch.Tensor          # (n,) f32 mixture weight clamp(imp/10, 0, .5)
    point: torch.Tensor      # (n, 3) sampled point on the light triangle
    dir: torch.Tensor        # (n, 3) unit shadow-ray direction (surface -> light)
    dist: torch.Tensor       # (n,) f32 |light - surface|
    cos_light: torch.Tensor  # (n,) f32 -dot(dir, light geometric normal)
    uv: torch.Tensor         # (n, 2) barycentric-interpolated uv at the point
    tex: torch.Tensor        # (n,) i32 light texture id
    inv_pdf_area: torch.Tensor  # (n,) f32 area / P(light): 1 / area-pdf
    valid: torch.Tensor      # (n,) bool — sample usable


def _sample_chunk(point, normal, seed, flat, importance_scale, mis_clamp,
                  sel_idx=None, sel_imp=None, sel_W=None) -> LightSample:
    tri = flat["tri"]            # (L, 3, 3) padded; pad rows power == 0
    power = flat["power"]        # (L,) luminance-per-area x full area
    area = flat["area"]          # (L,)
    uv3 = flat["uv"]             # (L, 3, 2)
    tex = flat["tex"]            # (L,) int32
    L = tri.shape[0]
    n = point.shape[0]
    f32 = torch.float32

    v0, v1, v2 = tri[:, 0], tri[:, 1], tri[:, 2]
    zero = torch.zeros((), dtype=f32, device=point.device)
    if sel_imp is not None:
        # the kernel recorded the chosen light's importance and the selection
        # total beside its index: only the chosen light's features are needed.
        # Unselected rows record imp_c = 0 -> w = 0 and valid = False, the
        # terminals an empty selection yields below
        assert sel_idx is not None and sel_W is not None
        any_sel = (sel_idx >= 0) & (sel_idx < L)
        idx = torch.clamp(sel_idx.to(torch.int64), 0, L - 1)
        imp_c_pre, W = sel_imp, sel_W
    else:
        ctr = (v0 + v1 + v2) / 3.0
        # epsilon-visibility: any vertex above the hemisphere plane
        pn = normal[:, None, :]
        vis = (
            (_dot(v0[None] - point[:, None], pn) >= EPSILON_BLOCK)
            | (_dot(v1[None] - point[:, None], pn) >= EPSILON_BLOCK)
            | (_dot(v2[None] - point[:, None], pn) >= EPSILON_BLOCK)
        )                                                   # (n, L)
        dc = ctr[None] - point[:, None]                     # (n, L, 3)
        d2c = _dot(dc, dc)
        imp = torch.where(vis, power[None] / torch.clamp_min(d2c, 1e-30), zero)

        cum = torch.cumsum(imp, dim=1)
        W = cum[:, -1]                                      # == selection total
        imp_c_pre = None
        if sel_idx is not None:
            # the kernel's recorded light (-1 = no sample) replaces the
            # draw-7 selection; the pdf bookkeeping is unchanged
            any_sel = (sel_idx >= 0) & (sel_idx < L)
            idx = torch.clamp(sel_idx.to(torch.int64), 0, L - 1)
        else:
            r = rng.draw(seed, 7) * W
            prev = torch.cat([torch.zeros((n, 1), dtype=f32, device=point.device),
                              cum[:, :-1]], dim=1)
            sel = (cum > r[:, None]) & (prev <= r[:, None])  # exclusive one-hot
            any_sel = sel.any(dim=1)
            idx = sel.to(torch.uint8).argmax(dim=1)         # the one-hot's index

    # chosen-light features by direct indexing; zero rows where nothing
    # was selected (what the all-false one-hot product yields)
    m1 = any_sel[:, None]
    cv0 = torch.where(m1, v0[idx], zero)
    cv1 = torch.where(m1, v1[idx], zero)
    cv2 = torch.where(m1, v2[idx], zero)
    cuv0 = torch.where(m1, uv3[idx, 0], zero)
    cuv1 = torch.where(m1, uv3[idx, 1], zero)
    cuv2 = torch.where(m1, uv3[idx, 2], zero)
    ctex = torch.where(any_sel, tex[idx].to(torch.int32),
                       torch.zeros((), dtype=torch.int32, device=point.device))
    carea = torch.where(any_sel, area[idx], zero)
    imp_c = (imp_c_pre if imp_c_pre is not None
             else torch.where(any_sel, imp.gather(1, idx[:, None])[:, 0], zero))

    # uniform point on the full triangle (sqrt warp)
    su = torch.sqrt(rng.draw(seed, 8))
    rb = rng.draw(seed, 9)
    b0 = (1.0 - su)[:, None]
    b1 = (su * (1.0 - rb))[:, None]
    b2 = (su * rb)[:, None]
    y = b0 * cv0 + b1 * cv1 + b2 * cv2
    uv_y = b0 * cuv0 + b1 * cuv1 + b2 * cuv2

    to = y - point
    dist = torch.sqrt(_dot(to, to))
    sdir = to / torch.clamp_min(dist, 1e-30)[:, None]
    e1 = cv1 - cv0
    e2 = cv2 - cv0
    nrm = _cross(e1, e2)
    nrm = nrm / torch.clamp_min(torch.sqrt(_dot(nrm, nrm)), 1e-30)[:, None]
    cos_l = -_dot(sdir, nrm)

    w = torch.clamp(imp_c / importance_scale, 0.0, mis_clamp)
    # 1/pdf of the point = area / P(choose this light)
    inv_pdf = carea * W / torch.clamp_min(imp_c, 1e-30)
    valid = (imp_c > 0.0) & (w > 0.0) & (cos_l > 0.0) & (dist > 1e-6) & (
        carea > 0.0
    )
    return LightSample(
        w=torch.where(valid, w, zero),
        point=y,
        dir=sdir,
        dist=dist,
        cos_light=cos_l,
        uv=uv_y,
        tex=ctex,
        inv_pdf_area=inv_pdf,
        valid=valid,
    )


def sample_light_flat(point, normal, seed, flat,
                      importance_scale: float = 10.0,
                      mis_clamp: float = 0.5,
                      sel_idx=None, sel_imp=None, sel_W=None) -> LightSample:
    """Flat-list light sampling for small light sets (<= ~64 triangles).

    importance_j = power_j * eps_visible_j / dist_c^2; the direct-term pdf
    is importance_j / W x 1 / area_j (uniform point on the full triangle).
    sel_idx: (n,) int32 light indices the path kernel recorded (-1 = no
    sample), replacing the selection draw; sel_imp / sel_W: its recorded
    chosen importance and selection total, replacing the importance field."""
    n = point.shape[0]
    sel = (sel_idx, sel_imp, sel_W)

    def part(x, i):
        return None if x is None else x[i:i + _CHUNK]

    if n <= _CHUNK:
        return _sample_chunk(point, normal, seed, flat, importance_scale, mis_clamp, *sel)
    parts = [
        _sample_chunk(point[i:i + _CHUNK], normal[i:i + _CHUNK], seed[i:i + _CHUNK],
                      flat, importance_scale, mis_clamp, *(part(x, i) for x in sel))
        for i in range(0, n, _CHUNK)
    ]
    return LightSample(*[torch.cat(xs) for xs in zip(*parts)])
