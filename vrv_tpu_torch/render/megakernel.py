"""Frame renderer ("megakernel" mode): the fused and the staged branches.

Counterpart of ``vrv_tpu/render/megakernel.py`` (``render_samples``,
``pack_bgra``, ``render_frame``): raygen, the bounce loop, radiance
accumulation ``color = sum_i E_i * prod_{j<i} R_j`` masked to the bounces a
path actually executed, split NEE, sample mean and BGRA u8 packing (linear
radiance hard-clipped, no transfer function).

Three branches are ported:

  - FUSED (the default configuration): ONE launch of the path kernel K2
    (``ops/pallas/path_proc.trace_path_cuda``) traces every bounce, the
    shadow rays and the instance test of every ray in radiance-record mode,
    on the 32x32-patch ray layout; the tensor code here is one texel fetch
    per bounce plus the exact accumulation chain over the records;
  - the fused path's TRACE-RECORD REPLAY (``pallas_inkernel_radiance=False``,
    or lights whose emissive palettes the kernel cannot hold, or
    ``pallas_inkernel_nee=False``): ONE K2 launch in trace-record mode, then
    the shading in tensor code over its per-bounce hits, sampled directions,
    instance records and (with in-kernel NEE) light choices and visibility
    bits — batched (``pallas_batched_shade``: one ``shade_resolved`` call
    over the NEE bounces' rows and one over the last bounce) or bounce by
    bounce; without in-kernel NEE the shadow rays of every bounce go through
    ONE launch of the march kernel K1;
  - STAGED (``pallas_fused=False``, ``nee_mode='split'``): every bounce and
    one batched shadow trace go through the single-segment march
    (``_trace_batch``), with shading in tensor code.

``RenderConfig.progressive`` is not read here (as in the JAX renderer: only
the progressive surfaces accumulate). The beam pre-pass of the plain
versions, the grid tracers, the debug views and the wavefront modes are not
ported yet; a config that asks for one of them raises
``NotImplementedError`` naming the ROADMAP item — it never renders through
another path silently.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.profiler import record_function

from vrv_tpu_torch.config import RenderConfig
from vrv_tpu_torch.ops import rng, shade
from vrv_tpu_torch.ops.camera_rays import raygen


def _check_tile(cfg: RenderConfig) -> None:
    """The tile knob is validated unconditionally, as in the JAX renderer."""
    if cfg.pallas_tile != "8x128":
        try:
            th_v, tw_v = (int(v) for v in cfg.pallas_tile.split("x"))
        except ValueError:
            raise ValueError(f"pallas_tile {cfg.pallas_tile!r}: expected 'THxTW'")
        if th_v * tw_v != 8 * 128:
            raise ValueError(f"pallas_tile {cfg.pallas_tile}: TH*TW must be 1024")


def _check_supported(cfg: RenderConfig, proc_static, nee_active: bool,
                     use_kernel: bool, inst, inst_static):
    """Resolve the configuration exactly as the JAX ``render_samples`` does
    and raise for every branch that is not ported; returns (split_nee,
    fused_eligible, inst_in_kernel)."""
    if cfg.mode != "megakernel":
        raise NotImplementedError(
            f"mode={cfg.mode!r}: the wavefront renderers are not ported "
            "(ROADMAP: wavefront)")
    if cfg.debug_view != "none":
        raise NotImplementedError(
            f"debug_view={cfg.debug_view!r}: the debug views are not ported "
            "(ROADMAP: debug views of the staged megakernel)")
    if cfg.rng != "murmur3":
        raise NotImplementedError(
            "rng='pcg' is not ported (ROADMAP Queue 1 item 5: debug views of the "
            "staged megakernel and rng='pcg')")
    if cfg.tracer != "proc" or proc_static is None:
        raise NotImplementedError(
            f"tracer={cfg.tracer!r} (or a scene without a proc bundle): the grid "
            "tracers are not ported (ROADMAP: grid tracers)")
    if cfg.proc_backend not in ("pallas", "xla", "auto"):
        raise ValueError(f"proc_backend {cfg.proc_backend!r}")
    if cfg.beam_prepass and not use_kernel:
        # the JAX renderer advances the primary rays by its distance-field
        # cone march wherever its kernels do not run; that pre-pass (and the
        # scene's distance field) belongs to the grid tracers
        raise NotImplementedError(
            "beam_prepass=True with the plain versions (proc_backend='xla', or "
            "'auto' off a CUDA device): the beam pre-pass is not ported (ROADMAP "
            "Queue 1 item 8: grid tracers); pass beam_prepass=False")
    inst_in_kernel = inst is not None and inst_static is not None and cfg.pallas_inst
    fused_candidate = (
        use_kernel
        and cfg.pallas_fused
        and (inst is None or inst_in_kernel)
        and proc_static.lambert_only
        and proc_static.edits_fused
    )
    split_nee = nee_active and (
        cfg.nee_mode == "split" or (cfg.nee_mode == "auto" and fused_candidate)
    )
    fused_eligible = fused_candidate and (not nee_active or split_nee)
    if nee_active and not split_nee:
        raise NotImplementedError(
            f"nee_mode={cfg.nee_mode!r} resolves to mixture NEE here, which needs "
            "the light-BVH descent (ROADMAP: mixture NEE + BVH descent); use "
            "nee_mode='split'")
    return split_nee, fused_eligible, inst_in_kernel


def tile_layout(x: torch.Tensor, R: int, W: int, th: int, tw: int) -> torch.Tensor:
    """(R*W, ...) rows in (row, column) order -> patch-major order of th x tw
    patches over the grid padded to (ceil(R/th)*th, ceil(W/tw)*tw): every
    consecutive th*tw rays are one patch. Padding rays are zeros (degenerate
    rays, which miss)."""
    Hp = (R + th - 1) // th * th
    Wp = (W + tw - 1) // tw * tw
    rest = tuple(x.shape[1:])
    shaped = x.reshape((R, W) + rest)
    if (Hp, Wp) != (R, W):
        padded = torch.zeros((Hp, Wp) + rest, dtype=x.dtype, device=x.device)
        padded[:R, :W] = shaped
        shaped = padded
    p = shaped.reshape((Hp // th, th, Wp // tw, tw) + rest)
    return p.transpose(1, 2).reshape((Hp * Wp,) + rest)


def untile_layout(x: torch.Tensor, R: int, W: int, th: int, tw: int) -> torch.Tensor:
    """Inverse of ``tile_layout``: patch-major rows -> (R*W, ...) rows."""
    Hp = (R + th - 1) // th * th
    Wp = (W + tw - 1) // tw * tw
    rest = tuple(x.shape[1:])
    p = x.reshape((Hp // th, Wp // tw, th, tw) + rest)
    return p.transpose(1, 2).reshape((Hp, Wp) + rest)[:R, :W].reshape((R * W,) + rest)


def pad_layout(x: torch.Tensor, R: int, W: int, Rp: int, Wp: int) -> torch.Tensor:
    """(R*W, ...) rows -> the (Rp, Wp) grid, zero padded, flattened."""
    rest = tuple(x.shape[1:])
    out = torch.zeros((Rp, Wp) + rest, dtype=x.dtype, device=x.device)
    out[:R, :W] = x.reshape((R, W) + rest)
    return out.reshape((Rp * Wp,) + rest)


def _tex_set(proc_static, inst_in_kernel: bool, inst_static) -> tuple:
    """Every texture a fused-path hit can carry, grouped by atlas content:
    grass/stone, with edits every opaque-lambert block plus the mirror- and
    glass-class blocks, with in-kernel instances their texture ids."""
    blocks = {proc_static.grass, proc_static.stone}
    if proc_static.n_edits:
        blocks |= set(proc_static.lambert_blocks)
        blocks |= {b for b, _ in proc_static.edit_mats}
        blocks |= {b for b, _, _ in proc_static.edit_glass}
    tex_ids = {b * 6 + f for b in sorted(blocks) for f in range(6)}
    if inst_in_kernel:
        tex_ids |= set(inst_static[0])
    dd = proc_static.tex_dedup
    groups: dict = {}
    for tid in sorted(tex_ids):
        canon = dd[tid] if tid < len(dd) else tid
        groups.setdefault(canon, []).append(tid)
    return tuple(tuple(g) for _, g in sorted(groups.items()))


def render_samples(
    grid,
    translucent,
    materials: dict,
    bvh: Optional[dict],
    bvh_max_depth: int,
    dist,
    inst: Optional[dict],
    rows,
    eye: torch.Tensor,
    front: torch.Tensor,
    right: torch.Tensor,
    up: torch.Tensor,
    frame,
    cfg: RenderConfig,
    y0=0,
    local_height: int = 0,
    s0=0,
    local_spp: int = 0,
    proc_static=None,
    proc=None,
    light_tex_set=None,
    inst_static=None,
    occupancy_out=None,
    light_em=None,
    trace_log: Optional[list] = None,
    path_log: Optional[list] = None,
    path_tracer=None,
    march_tracer=None,
) -> torch.Tensor:
    """Render linear radiance per sample: (spp, H, W, 3) float32.

    ``eye`` is in grid-local coordinates (world - grid origin); all tensors
    live on ``eye.device``. occupancy_out: optional list; appends the
    live-ray count entering each bounce. trace_log: optional list; appends
    ``(origin, direction, tcap)`` of every single-segment march launch (the
    staged branch and the replay's shadow trace), path_log: ``(origin,
    direction, seeds)`` of every path kernel launch (the fused branch and
    the replay), in order — the shapes a benchmark needs to time the kernels
    as the frame calls them. path_tracer: a callable with
    ``trace_path_cuda``'s signature that replaces it (e.g.
    ``trace_path_plain`` to render the fused frame through the kernel's
    plain version on the card); march_tracer: the same for the march kernel
    (``trace_proc_cuda``'s signature). ``dist``/``rows`` belong to branches
    that are not ported and are ignored."""
    W = cfg.width
    H = local_height or cfg.height
    S = local_spp or cfg.samples_per_pixel
    nee_active = bvh is not None and cfg.enable_nee
    dev = eye.device
    _check_tile(cfg)
    # backend resolution for the proc tracer: 'pallas' = the CUDA kernels,
    # 'xla' = the plain versions, 'auto' = the kernels exactly on CUDA tensors
    use_kernel = cfg.proc_backend == "pallas" or (
        cfg.proc_backend == "auto" and dev.type == "cuda"
    )
    split_nee, fused, inst_in_kernel = _check_supported(
        cfg, proc_static, nee_active, use_kernel, inst, inst_static)
    ikr = nee_in_kernel = False
    if fused:
        # in-kernel NEE: the kernel samples the flat light list and marches
        # the shadow rays as sub-phases of its per-ray state machine
        nee_in_kernel = (
            split_nee and cfg.pallas_inkernel_nee and cfg.pallas_batched_shade
            and cfg.max_bounces > 1 and bvh.get("flat") is not None
        )
        # in-kernel radiance: the kernel also resolves the material key, the
        # scatter branch and every NEE direct-term factor but the texel;
        # otherwise the trace records are replayed below
        ikr = (
            cfg.pallas_inkernel_radiance and "packed" in materials
            and (not split_nee or cfg.max_bounces == 1
                 or (nee_in_kernel and light_em is not None))
        )

    # the fused path's row-major layout: consecutive rows of the (H*S, W) ray
    # image hold the same pixels across samples
    ray_layout = "hsw" if (fused and cfg.pallas_tile2d) else "shw"
    o, d, sample_seed = raygen(
        eye, front, right, up, cfg.width, cfg.height, cfg.samples_per_pixel,
        frame, jitter_scale=cfg.jitter_scale,
        y0=y0, local_height=local_height, s0=s0, local_spp=local_spp,
        layout=ray_layout,
    )
    n = S * H * W
    o = o.reshape(n, 3).contiguous()
    d = d.reshape(n, 3).contiguous()
    seeds = sample_seed.reshape(n)

    if fused and ikr:
        return _render_fused(
            cfg, o, d, seeds, S, H, W, materials, bvh, inst, inst_static,
            inst_in_kernel, split_nee, proc_static, proc, light_em,
            ray_layout, occupancy_out, path_log, path_tracer,
        )

    trace = functools.partial(_trace_batch, cfg, use_kernel, proc_static, proc,
                              trace_log, march_tracer)
    fused_pad = None
    rec = None
    if fused:
        # the replay: ONE path-kernel launch in trace-record mode on the
        # radiance branch's ray layout; shading stays on that layout
        from vrv_tpu_torch.ops.pallas.path_proc import trace_path_cuda

        o, d, seeds, fused_pad = _fused_layout(cfg, o, d, seeds, S * H, W)
        if path_log is not None:
            path_log.append((o, d, seeds))
        tracer = path_tracer or trace_path_cuda
        with record_function("fused_path_trace"):
            rec = tracer(
                proc_static._replace(use_coarse=False), o, d, seeds, cfg.max_bounces,
                t_min=cfg.t_min, t_max=cfg.t_max, pd=proc,
                inst=inst if inst_in_kernel else None,
                inst_static=inst_static if inst_in_kernel else None,
                lights=bvh["flat"] if nee_in_kernel else None,
                nee_pdf=cfg.pallas_nee_record_pdf,
            )
    shade_kw = dict(
        materials=materials, bvh=bvh, bvh_max_depth=bvh_max_depth, inst=inst,
        split_nee=split_nee, light_tex_set=light_tex_set, n_real=n,
        occupancy_out=occupancy_out,
    )
    if rec is not None and cfg.pallas_batched_shade:
        color, split = _shade_batched(cfg, o, d, seeds, rec, inst_in_kernel, **shade_kw)
    else:
        color, split = _shade_loop(cfg, o, d, seeds, rec, trace, **shade_kw)
    if split_nee and split["direct"]:
        color = _add_direct(cfg, color, split, inst, trace)
    return _restore_layout(color, fused_pad, ray_layout, S, H, W)


def _trace_batch(cfg, use_kernel, proc_static, proc, trace_log, march_tracer,
                 o_tr, d_tr, tcap=None):
    """Dispatch a flat ray batch to the configured tracer — the bounce traces
    and the batched shadow rays use the same path. tcap: per-ray t ceiling
    (shadow rays pass their light distance)."""
    if trace_log is not None:
        trace_log.append((o_tr, d_tr, tcap))
    if use_kernel:
        from vrv_tpu_torch.ops.pallas.trace_proc import trace_proc_cuda

        return (march_tracer or trace_proc_cuda)(
            proc_static, o_tr, d_tr, t_min=cfg.t_min, t_max=cfg.t_max,
            pd=proc, tcap=tcap,
            unroll=cfg.pallas_unroll or None,
            march_opt=int(cfg.pallas_march_opt),
        )
    from vrv_tpu_torch.ops.dda_proc import trace_proc

    return trace_proc(
        proc_static._replace(use_coarse=cfg.proc_coarse),
        o_tr, d_tr, t_min=cfg.t_min, t_max=cfg.t_max, pd=proc, tcap=tcap,
    )


def _new_split() -> dict:
    """Split-NEE per-bounce records, consumed by ``_add_direct``: masked
    throughput, pre-visibility direct term, and either the shadow rays
    (origin, direction, light distance) or the kernel's visibility bits."""
    return {"T": [], "direct": [], "so": [], "sd": [], "dist": [], "kvis": []}


def _shade_loop(cfg, o, d, seeds, rec, trace, *, materials, bvh, bvh_max_depth,
                inst, split_nee, light_tex_set, n_real, occupancy_out):
    """Trace + shade bounce by bounce (the staged branch), or with ``rec`` =
    the path kernel's trace records, replay its hits, instance records and
    sampled directions bounce by bounce (the replay's per-bounce loop)."""
    n = o.shape[0]
    dev = o.device
    f32 = torch.float32
    fused_traces, fused_dirs, fused_ihits = rec[:3] if rec is not None else (None,) * 3
    color = torch.zeros((n, 3), dtype=f32, device=dev)
    throughput = torch.ones((n, 3), dtype=f32, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    zero3 = torch.zeros((), dtype=f32, device=dev)
    split = _new_split()
    w_prev = None

    for bounce in range(cfg.max_bounces):
        if occupancy_out is not None:
            # min() strips the padding rays, alive until bounce 0 misses them
            occupancy_out.append(min(int(alive.sum()), n_real))
        # named ranges make the per-stage costs legible in a profiler trace
        with record_function(f"trace_b{bounce}"):
            tr = fused_traces[bounce] if fused_traces is not None else trace(o, d)
        bounce_seed = rng.murmur3_combine(seeds, bounce)
        inst_hit = None
        if fused_ihits is not None:
            # the kernel resolved instance vs voxel per bounce and marched the
            # matching continuation; replay its records
            inst_hit = fused_ihits[bounce]
        elif inst is not None:
            from vrv_tpu_torch.ops.instances import trace_instances

            with record_function(f"instances_b{bounce}"):
                inst_hit = trace_instances(
                    o, d, inst["tri"], inst["valid"], t_min=cfg.t_min, t_max=cfg.t_max
                )
        # split mode truncates NEE at the last bounce: its direct term
        # stands in for the emission the chain would collect one bounce later
        last = bounce == cfg.max_bounces - 1
        bvh_b = None if (split_nee and last) else (bvh if cfg.enable_nee else None)
        with record_function(f"shade_b{bounce}"):
            br = shade.do_bounce(
                o, d, tr, bounce_seed, materials,
                bvh_b,
                sky_emission=cfg.sky_emission,
                emission_gain=cfg.emission_gain,
                nee_importance_scale=cfg.nee_importance_scale,
                nee_mis_clamp=cfg.nee_mis_clamp,
                bvh_max_depth=bvh_max_depth,
                inst=inst, inst_hit=inst_hit,
                nee_mode="split" if split_nee else "mixture",
                w_prev=w_prev,
                light_tex_set=light_tex_set if split_nee else None,
                tex_fetch=cfg.tex_fetch,
            )
        if split_nee and not last:
            split["T"].append(torch.where(alive[:, None], throughput, zero3))
            split["direct"].append(br.direct)
            split["so"].append(br.new_origin)
            split["sd"].append(br.shadow_dir)
            split["dist"].append(br.shadow_dist)
        w_prev = br.w
        color = color + torch.where(alive[:, None], throughput * br.emissivity, zero3)
        throughput = torch.where(alive[:, None], throughput * br.reflectivity, zero3)
        alive = alive & ~br.miss
        o = br.new_origin
        if fused_dirs is not None and bounce + 1 < cfg.max_bounces:
            # the direction the kernel actually marched for the next bounce
            d = fused_dirs[bounce]
        else:
            d = br.new_direction
    return color, split


def _shade_batched(cfg, o, d, seeds, rec, inst_in_kernel, *, materials, bvh,
                   bvh_max_depth, inst, split_nee, light_tex_set, n_real,
                   occupancy_out):
    """The replay with batched shading: the hit geometry resolved bounce by
    bounce (the origin chain is sequential), then ONE ``shade_resolved``
    call over the NEE bounces' concatenated rows and one over the last
    bounce (one call in all without lights), then the accumulation chain.
    ``shade_resolved`` is row-independent, so this equals the per-bounce
    loop bit for bit."""
    fused_traces, fused_dirs, fused_ihits, fused_nee = rec
    B = cfg.max_bounces
    n = o.shape[0]
    dev = o.device
    f32 = torch.float32
    zero3 = torch.zeros((), dtype=f32, device=dev)
    rhs, d_list, seed_list = [], [], []
    o_b, d_b = o, d
    for b in range(B):
        with record_function(f"resolve_b{b}"):
            rhs.append(shade.resolve_hit(
                o_b, d_b, fused_traces[b],
                inst=inst if inst_in_kernel else None,
                inst_hit=fused_ihits[b] if fused_ihits is not None else None,
            ))
        d_list.append(d_b)
        seed_list.append(rng.murmur3_combine(seeds, b))
        o_b = rhs[b].new_origin
        if b + 1 < B:
            d_b = fused_dirs[b]

    def _cat(xs):
        return xs[0] if len(xs) == 1 else torch.cat(xs, dim=0)

    # the last bounce shades without NEE (split mode truncates there), so it
    # gets its own small call; in scenes without lights one call covers all
    groups = ([(list(range(B - 1)), bvh), ([B - 1], None)]
              if (split_nee and B > 1) else [(list(range(B)), None)])
    brs = [None] * B
    for idx, bvh_g in groups:
        rh = shade.ResolvedHit(*[_cat([getattr(rhs[b], f) for b in idx])
                                 for f in shade.ResolvedHit._fields])
        rec_nee = fused_nee is not None and bvh_g is not None
        # with the kernel's recorded (imp_c, W) the sampler skips the whole
        # (n, L) importance field
        rec_pdf = rec_nee and len(fused_nee[0]) > 2
        with record_function("shade_batched"):
            br_g = shade.shade_resolved(
                rh, _cat([d_list[b] for b in idx]), _cat([seed_list[b] for b in idx]),
                materials, bvh_g,
                sky_emission=cfg.sky_emission,
                emission_gain=cfg.emission_gain,
                nee_importance_scale=cfg.nee_importance_scale,
                nee_mis_clamp=cfg.nee_mis_clamp,
                bvh_max_depth=bvh_max_depth,
                nee_mode="split" if split_nee else "mixture",
                w_prev=None,
                light_tex_set=light_tex_set if split_nee else None,
                flat_sel_idx=_cat([fused_nee[b][0] for b in idx]) if rec_nee else None,
                flat_sel_imp=_cat([fused_nee[b][2] for b in idx]) if rec_pdf else None,
                flat_sel_W=_cat([fused_nee[b][3] for b in idx]) if rec_pdf else None,
                tex_fetch=cfg.tex_fetch,
            )
        for j, b in enumerate(idx):
            brs[b] = shade.BounceResult(*[
                None if x is None else x[j * n:(j + 1) * n] for x in br_g])

    # the accumulation chain in the per-bounce loop's operation order; the
    # (1 - w_prev) emission complement moves here, masked to hits (exactly
    # the multiply the loop does inside the shading call)
    color = torch.zeros((n, 3), dtype=f32, device=dev)
    throughput = torch.ones((n, 3), dtype=f32, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    split = _new_split()
    w_prev = None
    for b in range(B):
        if occupancy_out is not None:
            occupancy_out.append(min(int(alive.sum()), n_real))
        br = brs[b]
        e_b = br.emissivity
        if split_nee and w_prev is not None:
            e_b = torch.where(br.miss[:, None], e_b, e_b * (1.0 - w_prev)[:, None])
        if split_nee and b < B - 1:
            split["T"].append(torch.where(alive[:, None], throughput, zero3))
            split["direct"].append(br.direct)
            if fused_nee is not None:
                # in-kernel NEE already marched the shadow rays; only its
                # recorded visibility feeds the direct term
                split["kvis"].append(fused_nee[b][1])
            else:
                split["so"].append(br.new_origin)
                split["sd"].append(br.shadow_dir)
                split["dist"].append(br.shadow_dist)
        w_prev = br.w
        color = color + torch.where(alive[:, None], throughput * e_b, zero3)
        throughput = torch.where(alive[:, None], throughput * br.reflectivity, zero3)
        alive = alive & ~br.miss
    return color, split


def _add_direct(cfg, color, split, inst, trace):
    """Add the split-NEE direct term of every non-last bounce: visibility
    from the kernel's recorded bits, or from ONE batched shadow trace over
    all bounces' shadow rays (independent of path continuation, so they
    never gate the chain)."""
    n = color.shape[0]
    if split["kvis"]:
        vis = torch.cat(split["kvis"])
    else:
        so_cat = torch.cat(split["so"])
        sd_cat = torch.cat(split["sd"])
        dist_cat = torch.cat(split["dist"])
        eps = 1e-3 + 1e-3 * dist_cat
        with record_function("nee_shadow_trace"):
            sh = trace(so_cat, sd_cat, tcap=dist_cat - eps)
        # visible iff nothing resolves strictly before the light point
        vis = (~sh.hit) | (sh.t >= dist_cat - eps)
        if inst is not None:
            # entity instances occlude shadow rays too
            from vrv_tpu_torch.ops.instances import trace_instances

            with record_function("nee_shadow_instances"):
                ish = trace_instances(
                    so_cat, sd_cat, inst["tri"], inst["valid"],
                    t_min=cfg.t_min, t_max=cfg.t_max,
                )
            vis = vis & ~(ish.hit & (ish.t < dist_cat - eps))
    with record_function("nee_direct_accum"):
        vis3 = vis.to(torch.float32)[:, None]
        for b in range(len(split["direct"])):
            color = color + (split["T"][b] * split["direct"][b] * vis3[b * n:(b + 1) * n])
    return color


def _fused_layout(cfg, o, d, seeds, R: int, W: int):
    """The fused path's ray layout: 32x32 (or the configured) pixel patches,
    or the rows padded to the (8, 128) grid, or unchanged. Returns (o, d,
    seeds, pad) with pad the description ``_restore_layout`` inverts."""
    if cfg.pallas_tile2d and cfg.pallas_prepad and cfg.pallas_tile != "8x128":
        # patch re-layout: every consecutive th*tw rays are one th x tw pixel
        # patch, so a warp of the kernel holds 32 neighbouring pixels
        th, tw = (int(v) for v in cfg.pallas_tile.split("x"))
        return (tile_layout(o, R, W, th, tw), tile_layout(d, R, W, th, tw),
                tile_layout(seeds, R, W, th, tw), ("tile", th, tw))
    if cfg.pallas_tile2d and cfg.pallas_prepad:
        Rp, Wp = (R + 7) // 8 * 8, (W + 127) // 128 * 128
        if (Rp, Wp) != (R, W):
            o, d, seeds = (pad_layout(x, R, W, Rp, Wp) for x in (o, d, seeds))
            return o, d, seeds, (Rp, Wp)
    return o, d, seeds, None


def _restore_layout(color, pad, ray_layout: str, S: int, H: int, W: int):
    """(rays, 3) radiance on the kernel's layout -> (S, H, W, 3)."""
    R = S * H
    if pad is not None and pad[0] == "tile":
        color = untile_layout(color, R, W, pad[1], pad[2])
    elif pad is not None:
        Rp, Wp = pad
        color = color.reshape(Rp, Wp, 3)[:R, :W].reshape(-1, 3)
    if ray_layout == "hsw":
        return color.reshape(H, S, W, 3).permute(1, 0, 2, 3)
    return color.reshape(S, H, W, 3)


def _render_fused(cfg, o, d, seeds, S, H, W, materials, bvh, inst, inst_static,
                  inst_in_kernel, split_nee, proc_static, proc, light_em,
                  ray_layout, occupancy_out, path_log, path_tracer):
    """The fused branch: ONE path-kernel launch in radiance-record mode, then
    one texel fetch per bounce and the exact accumulation chain over its
    records (formula order of the JAX in-kernel-radiance replay)."""
    from vrv_tpu_torch.ops.pallas.path_proc import trace_path_cuda

    n = S * H * W
    dev = o.device
    f32 = torch.float32
    o, d, seeds, fused_pad = _fused_layout(cfg, o, d, seeds, S * H, W)
    if path_log is not None:
        path_log.append((o, d, seeds))
    tracer = path_tracer or trace_path_cuda
    with record_function("fused_path_radiance"):
        codes, cosins, srs, nrecs = tracer(
            proc_static._replace(use_coarse=False), o, d, seeds, cfg.max_bounces,
            t_min=cfg.t_min, t_max=cfg.t_max, pd=proc,
            inst=inst if inst_in_kernel else None,
            inst_static=inst_static if inst_in_kernel else None,
            lights=bvh["flat"] if (split_nee and cfg.max_bounces > 1) else None,
            radiance=True, light_em=light_em,
            nee_scale=cfg.nee_importance_scale, nee_clamp=cfg.nee_mis_clamp,
            emission_gain=cfg.emission_gain,
        )
    n_pad = o.shape[0]
    tex_set = (_tex_set(proc_static, inst_in_kernel, inst_static)
               if cfg.pallas_onehot_tex else None)
    B = cfg.max_bounces
    pk = materials["packed"]
    packed_flat = pk.reshape(-1, pk.shape[-1])
    zero3 = torch.zeros((), dtype=f32, device=dev)
    color = torch.zeros((n_pad, 3), dtype=f32, device=dev)
    throughput = torch.ones((n_pad, 3), dtype=f32, device=dev)
    alive = torch.ones((n_pad,), dtype=torch.bool, device=dev)
    sky = torch.full((n_pad, 3), float(cfg.sky_emission), dtype=f32, device=dev)
    directs = []
    w_prev_r = None
    for b in range(B):
        if occupancy_out is not None:
            # min() strips the padding rays, alive until bounce 0 misses them
            occupancy_out.append(min(int(alive.sum()), n))
        code = codes[b]
        hitb = (code & 1) == 1
        branch = (code >> 1) & 3
        key = (code >> 3) & 0x3FFF
        with record_function(f"ikr_fetch_b{b}"):
            if tex_set is not None:
                row = shade._fetch_set_texel(pk, key >> 8, key & 255, tex_set)
            else:
                row = packed_flat[key.to(torch.int64)]
        refl = row[:, :3]
        em = row[:, 4:7]
        refl_lambert = refl / shade._PI
        e_hit = (cfg.emission_gain * em) * cosins[b][:, None]
        if split_nee and w_prev_r is not None:
            e_hit = e_hit * (1.0 - w_prev_r)[:, None]
        e_b = torch.where(hitb[:, None], e_hit, sky)
        r_lam = refl_lambert * srs[b][:, None]
        refl_out = torch.where(
            hitb[:, None],
            torch.where((branch == 1)[:, None], refl,
                        torch.where((branch == 2)[:, None], torch.ones_like(refl), r_lam)),
            zero3,
        )
        if split_nee and b < B - 1 and nrecs is not None:
            w_b, cxp_b, geo_b, ey0, ey1, ey2 = nrecs[b]
            tmp = w_b[:, None] * refl_lambert
            tmp = tmp * cxp_b[:, None]
            ey = torch.stack([ey0, ey1, ey2], dim=-1)
            dir_b = (tmp * ey) * geo_b[:, None]
            dir_b = torch.where((geo_b != 0.0)[:, None], dir_b, zero3)
            directs.append((torch.where(alive[:, None], throughput, zero3), dir_b))
            w_prev_r = w_b
        color = color + torch.where(alive[:, None], throughput * e_b, zero3)
        throughput = torch.where(alive[:, None], throughput * refl_out, zero3)
        alive = alive & hitb
    with record_function("ikr_direct_accum"):
        for T_b, dir_b in directs:
            color = color + T_b * dir_b

    return _restore_layout(color, fused_pad, ray_layout, S, H, W)


def pack_bgra(pixel_color: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) linear rgb -> (H, W, 4) u8 BGRA, hard clip."""
    c = torch.nan_to_num(pixel_color, nan=0.0, posinf=255.0, neginf=0.0)
    bgr = torch.clamp(c.flip(-1) * 255.0, 0.0, 255.0).to(torch.uint8)
    a = torch.full(bgr.shape[:-1] + (1,), 255, dtype=torch.uint8, device=bgr.device)
    return torch.cat([bgr, a], dim=-1)


def render_frame(
    grid, translucent, materials, bvh, bvh_max_depth, dist, inst, rows,
    eye, front, right, up, frame, cfg: RenderConfig,
    proc_static=None, proc=None, light_tex_set=None, inst_static=None,
    light_em=None, trace_log=None, path_log=None, path_tracer=None,
    march_tracer=None,
) -> torch.Tensor:
    """Full frame: average samples, pack BGRA u8 (H, W, 4)."""
    samples = render_samples(
        grid, translucent, materials, bvh, bvh_max_depth, dist, inst, rows,
        eye, front, right, up, frame, cfg,
        proc_static=proc_static, proc=proc, light_tex_set=light_tex_set,
        inst_static=inst_static, light_em=light_em, trace_log=trace_log,
        path_log=path_log, path_tracer=path_tracer, march_tracer=march_tracer,
    )
    return pack_bgra(samples.mean(dim=0))
