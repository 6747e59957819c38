"""Scene: device-resident world state + updates.

Counterpart of ``vrv_tpu/render/scene.py::Scene`` (``__init__``,
``set_instances``, ``_sync_proc``, ``_sync_proc_edit``, ``_proc_finalize``,
``_rebuild_lights``, ``_edit_touches_lights``, ``get_block``, ``set_block``,
``camera_to_local``, ``render``, ``render_samples``, ``render_converged``).
The scene is a handful of tensors on one device:

  - grid          (X,Y,Z) uint8 block ids (+ a host mirror for host queries)
  - translucent   (n_blocks+1,) bool LUT
  - materials     small float32 atlases
  - lights        host-built light BVH (depth/has_lights) + the flat light
                  list the split-NEE sampler reads, rebuilt only when an
                  edit touches an emissive block or its neighbours
  - proc bundle   ``proc_static`` (hashable worldgen parameters) +
                  ``proc_arrays`` (the edit list), what the march consumes

``set_block`` writes the cell in place. ``render_converged`` accumulates
``chunks`` passes of ``render_samples`` on the device (a plain loop: no host
round trip between passes). The distance field, the row tables,
``set_grid``, and the sharded renders belong to parts that are not ported
yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vrv_tpu_torch.assets import BlockTable, load_block_table
from vrv_tpu_torch.config import RenderConfig, WorldConfig
from vrv_tpu_torch.device import resolve_device
from vrv_tpu_torch.game import chunk as chunklib
from vrv_tpu_torch.ops import dda_proc
from vrv_tpu_torch.ops.pallas.trace_proc import edit_smem_args
from vrv_tpu_torch.render import lightbvh as lb
from vrv_tpu_torch.render import megakernel


def device_bvh(bvh: lb.LightBvh, device) -> Optional[dict]:
    """The light BVH's SoA arrays as tensors (None without lights). The
    packed node matrix of the descent is not built yet (ROADMAP: mixture NEE
    + BVH descent)."""
    if not bvh.has_lights:
        return None
    return {
        k: torch.tensor(np.asarray(getattr(bvh, k)), device=device)
        for k in ("is_leaf", "left", "right", "aabb_min", "aabb_max", "lum6",
                  "tri", "lpa", "uv", "tex")
    }


class Scene:
    """Mutable host handle around device tensors."""

    # beyond this many deviations from pristine worldgen the proc tracer is
    # disabled (and this slice has no other tracer to fall to)
    PROC_EDIT_CAP = 1024
    # beyond this many light triangles the flat split-NEE sampler stops
    # paying and sampling wants the stochastic BVH descent
    FLAT_LIGHT_CAP = 64

    def __init__(
        self,
        world_cfg: WorldConfig,
        table: Optional[BlockTable] = None,
        grid: Optional[np.ndarray] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.world_cfg = world_cfg
        self.table = table or load_block_table()
        if grid is None:
            grid = chunklib.generate_dense_grid(world_cfg, self.table, self.device)
        # host mirror: every host-side consumer (light scan, proc diff, edit
        # checks) reads this instead of fetching the device tensor
        self._grid_np = np.array(grid, dtype=np.uint8)
        self.grid = self._dev(self._grid_np)
        self.origin = np.asarray(world_cfg.origin, np.float32)
        self._origin_t = self._dev(self.origin)
        self.translucent = self._dev(self.table.translucent)
        packed_np = np.concatenate(
            [self.table.reflectivity, self.table.emissivity, self.table.metallicity],
            axis=-1,
        )
        self.materials = {
            "reflectivity": self._dev(self.table.reflectivity),
            "emissivity": self._dev(self.table.emissivity),
            "metallicity": self._dev(self.table.metallicity),
            # fused 8-channel atlas: refl rgba | emis rgb | metal r
            "packed": self._dev(packed_np),
        }
        self._emissive_blocks = np.nonzero(
            (self.table.texture_luminances.reshape(self.table.n_blocks, 6) > 0).any(1)
        )[0]
        # content dedup over the packed atlas: tex_dedup[tid] = lowest id
        # with byte-identical 8-channel texels
        by_content: dict = {}
        self.tex_dedup = tuple(
            by_content.setdefault(packed_np[i].tobytes(), i)
            for i in range(packed_np.shape[0])
        )
        self._pristine: Optional[np.ndarray] = None  # worldgen prediction cache
        self._pristine_key = None
        # emissive entity-instance triangles feeding the light structure
        self._inst_light_tri = np.zeros((0, 3, 3), np.float32)
        self._inst_light_lpa = np.zeros((0,), np.float32)
        self._inst_light_uv = np.zeros((0, 3, 2), np.float32)
        self._inst_light_tex = np.zeros((0,), np.int32)
        # tracers that are not ported: their tables stay absent
        self.dist = None
        self.rows = None
        self._rebuild_lights()
        self._sync_proc()
        self.instances_device: Optional[dict] = None
        self.inst_static = None  # static tex-id tuple when kernel-eligible
        self.tlas_rebuilds = 0  # observability: analog of TLAS dirty rebuilds

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A device tensor holding a COPY of a host array (on the CPU too, so
        no tensor aliases the host mirror or the cached block table)."""
        return torch.tensor(np.asarray(a), device=self.device)

    def set_instances(self, meshes) -> None:
        """Upload dynamic entity meshes (list of grid-LOCAL SoA meshes).
        Arrays are padded to power-of-two triangle capacities."""
        tris, ts, uvs = [], [], []
        for mesh in meshes:
            pos = np.asarray(mesh["positions"], np.float32).reshape(-1, 3, 3)
            tris.append(pos)
            ts.append(np.asarray(mesh["t"], np.uint32).reshape(-1, 3)[:, 0])
            uvs.append(np.asarray(mesh["uv"], np.float32).reshape(-1, 3, 2))
        if not tris:
            self.instances_device = None
            self.inst_static = None
            self._set_instance_lights(
                np.zeros((0, 3, 3), np.float32), np.zeros((0,), np.float32),
                np.zeros((0, 3, 2), np.float32), np.zeros((0,), np.int32),
            )
            return
        tri = np.concatenate(tris)
        t = np.concatenate(ts)
        uv = np.concatenate(uvs)
        # fused-kernel eligibility (carried for the fused path kernel): every
        # instance texture needs constant metallicity and byte-exact alpha
        tex_ids = sorted({int(x) for x in t})
        kernel_ok = True
        alpha_tables = []
        metal_vals = []
        n_tex = len(self.table.texture_luminances)
        for ti in tex_ids:
            if ti < 0 or ti >= n_tex:
                kernel_ok = False
                break
            m = self.table.metallicity[ti]
            if float(m.max()) != float(m.min()):
                kernel_ok = False
                break
            metal_vals.append(float(m.flat[0]))
            words = _alpha_words(self.table.reflectivity[ti][..., 3])
            if words is None:
                kernel_ok = False
                break
            alpha_tables.append(words)
        self.inst_static = (
            (tuple(tex_ids), tuple(alpha_tables), tuple(metal_vals))
            if kernel_ok else None
        )
        # emissive-instance lights: a triangle whose texture has positive
        # mean emissive power is an NEE light
        lum = self.table.texture_luminances
        tl = lum[np.clip(t.astype(np.int64), 0, len(lum) - 1)].astype(np.float32)
        em = tl > 0
        self._set_instance_lights(tri[em], tl[em], uv[em], t[em].astype(np.int32))
        n = len(tri)
        cap = max(16, 1 << (n - 1).bit_length())
        pad = cap - n
        self.instances_device = {
            "tri": self._dev(np.pad(tri, ((0, pad), (0, 0), (0, 0)))),
            "t": self._dev(np.pad(t, (0, pad)).astype(np.int32)),
            "uv": self._dev(np.pad(uv, ((0, pad), (0, 0), (0, 0)))),
            "valid": self._dev(np.arange(cap) < n),
        }

    # ------------------------------------------------------------------
    # procedural tracer bundle (ops/dda_proc.py)
    # ------------------------------------------------------------------

    def _sync_proc(self) -> None:
        """(Re)derive the procedural-tracer view of the current grid.

        The grid qualifies whenever it equals the tracer's own worldgen
        prediction plus at most PROC_EDIT_CAP cell edits. The edit list is
        the diff, which also absorbs any near-threshold cell where the
        program that generated the grid rounded the density differently
        than the tracer does on this device."""
        wc = self.world_cfg
        grid_np = self._grid_np
        key = (tuple(wc.origin), grid_np.shape, wc.seed)
        t = self.table

        def _block_lambert(b: int) -> bool:
            return all(
                float(t.metallicity[b * 6 + f].max()) == 0.0
                and float(t.reflectivity[b * 6 + f][..., 3].min()) == 1.0
                for f in range(6)
            )

        self._lambert_blocks = tuple(
            b for b in range(t.n_blocks) if b != t.air and _block_lambert(b)
        )
        lambert_only = all(
            b in self._lambert_blocks
            for b in (int(t.block_idx("grass")), int(t.block_idx("stone")))
        )
        ps0 = dda_proc.ProcStatic(
            seed=wc.seed, noise_scale=wc.noise_scale, y_falloff=wc.y_falloff,
            threshold=wc.threshold, origin=tuple(int(x) for x in wc.origin),
            shape=tuple(int(s) for s in grid_np.shape),
            grass=int(self.table.block_idx("grass")),
            stone=int(self.table.block_idx("stone")),
            air=int(self.table.air), n_edits=0,
            lambert_only=lambert_only,
            tex_dedup=self.tex_dedup,
        )
        if self._pristine_key != key:
            axes = [torch.arange(s, dtype=torch.int32, device=self.device)
                    for s in grid_np.shape]
            xs, ys, zs = torch.meshgrid(*axes, indexing="ij")
            self._pristine = (
                dda_proc.worldgen_blocks(ps0, xs.reshape(-1), ys.reshape(-1), zs.reshape(-1))
                .reshape(grid_np.shape).cpu().numpy()
            )
            self._pristine_key = key
        diff = np.argwhere(self._pristine != grid_np)
        self._proc_diff = {
            tuple(int(x) for x in c): int(grid_np[tuple(c)]) for c in diff
        }
        # highest pristine-solid y + 1 -> upward-exit certificate bound
        solid_ys = np.nonzero(
            (self._pristine != self.table.air).any(axis=(0, 2))
        )[0]
        ps0 = ps0._replace(
            y_air=int(solid_ys.max()) + 1 if len(solid_ys) else 0
        )
        self._proc_ps0 = ps0
        self._proc_finalize()

    def _sync_proc_edit(self, cell) -> None:
        """Incremental _sync_proc after one set_block: update the diff map
        at the edited cell only (the pristine prediction is cached)."""
        if self._pristine is None or not hasattr(self, "_proc_diff"):
            return self._sync_proc()
        key = (tuple(self.world_cfg.origin), self._grid_np.shape, self.world_cfg.seed)
        if self._pristine_key != key:
            return self._sync_proc()
        ct = tuple(int(x) for x in cell)
        new = int(self._grid_np[ct])
        if int(self._pristine[ct]) == new:
            self._proc_diff.pop(ct, None)
        else:
            self._proc_diff[ct] = new
        self._proc_finalize()

    def _proc_finalize(self) -> None:
        """Build (proc_static, proc_arrays) from the current diff map."""
        grid_np = self._grid_np
        ps0 = self._proc_ps0
        if len(self._proc_diff) > self.PROC_EDIT_CAP:
            self.proc_static = None
            self.proc_arrays = None
            return
        n = len(self._proc_diff)
        # pad to the next pow2 bucket, min 4 (the per-step compare is O(cap))
        cap = 0 if n == 0 else max(4, 1 << (n - 1).bit_length())
        cells = np.full((cap, 3), -(1 << 20), np.int32)  # sentinel: never matches
        blocks = np.full(cap, self.table.air, np.uint8)
        solidv = np.zeros(cap, bool)
        transl = np.ones(cap, bool)
        for i, (c, b) in enumerate(sorted(self._proc_diff.items())):
            cells[i] = c
            blocks[i] = b
            solidv[i] = b != self.table.air
            transl[i] = bool(self.table.translucent[b])
        coarse_np = dda_proc.build_coarse_dist(grid_np, self.table.air)
        # the constant air-region skip structures (ProcStatic.coarse_const)
        # are left () — the march kernel does not take them yet
        t = self.table

        def _const_opaque(b: int):
            mets = []
            for f in range(6):
                a = t.reflectivity[b * 6 + f][..., 3]
                m = t.metallicity[b * 6 + f]
                if float(a.min()) != 1.0 or float(a.max()) != 1.0:
                    return None
                if float(m.max()) != float(m.min()):
                    return None
                mets.append(float(m.flat[0]))
            return tuple(mets)

        def _glass_class(b: int):
            """(metal x6, alpha-words x6) for a TRANSLUCENT block with
            per-face constant metallicity and byte-exact per-texel alpha."""
            mets, words6 = [], []
            for f in range(6):
                m = t.metallicity[b * 6 + f]
                if float(m.max()) != float(m.min()):
                    return None
                mets.append(float(m.flat[0]))
                words = _alpha_words(t.reflectivity[b * 6 + f][..., 3])
                if words is None:
                    return None
                words6.append(words)
            return tuple(mets), tuple(words6)

        edits_lambert = True
        edit_mats = {}
        edit_glass = {}
        edits_fused = True
        for b in set(self._proc_diff.values()):
            if b == t.air or b in self._lambert_blocks:
                continue
            edits_lambert = False
            if bool(t.translucent[b]):
                gl = _glass_class(b)
                if gl is None:
                    edits_fused = False
                else:
                    edit_glass[int(b)] = gl
            else:
                mats = _const_opaque(b)
                if mats is None:
                    edits_fused = False
                else:
                    edit_mats[int(b)] = mats
        self.proc_static = ps0._replace(
            n_edits=cap,
            edits_lambert=edits_lambert,
            edits_fused=edits_fused,
            edit_mats=tuple(sorted(edit_mats.items())),
            edit_glass=tuple(
                (b, m, w) for b, (m, w) in sorted(edit_glass.items())
            ),
            lambert_blocks=self._lambert_blocks if cap else (),
        )
        self.proc_arrays = {
            "coarse": self._dev(coarse_np),
        }
        if cap:
            # per-coarse-block tight boxes of the edit set (what the edit
            # gate of the kernels reads; pad rows are impossible boxes)
            groups: dict = {}
            for c, _ in sorted(self._proc_diff.items()):
                groups.setdefault(
                    (c[0] >> 3, c[1] >> 3, c[2] >> 3), []
                ).append(c)
            nb = len(groups)
            cb_cap = max(4, 1 << max(0, (nb - 1)).bit_length()) if nb else 4
            big = 1 << 20
            cboxes = np.full((cb_cap, 6), big, np.int32)
            cboxes[:, 1::2] = -big
            for i, cells_g in enumerate(groups.values()):
                a = np.asarray(cells_g, np.int64)
                cboxes[i] = [a[:, 0].min(), a[:, 0].max(),
                             a[:, 1].min(), a[:, 1].max(),
                             a[:, 2].min(), a[:, 2].max()]
            self.proc_arrays.update(
                edit_cells=self._dev(cells),
                edit_blocks=self._dev(blocks),
                edit_solid=self._dev(solidv),
                edit_translucent=self._dev(transl),
                edit_cboxes=self._dev(cboxes),
            )
            # what the march kernel reads, packed once per edit instead of
            # once per launch: key/flag words and the certificate bound
            self.proc_arrays["edit_smem"] = edit_smem_args(
                self.proc_static, self.proc_arrays
            )
        y_cut = dda_proc.Y_CUT_OFF
        if 0 <= ps0.y_air < ps0.shape[1]:
            tops = [c[1] + 1 for c, b in self._proc_diff.items() if b != self.table.air]
            y_cut = max([ps0.y_air] + tops)
        self.proc_arrays["y_cut"] = int(y_cut)

    # ------------------------------------------------------------------
    # light structure
    # ------------------------------------------------------------------

    def _set_instance_lights(self, tri: np.ndarray, lpa: np.ndarray,
                             uv: np.ndarray, tex: np.ndarray) -> None:
        """Adopt the instance set's emissive triangles; rebuild the light
        structure only when they actually changed."""
        if (
            tri.shape == self._inst_light_tri.shape
            and np.array_equal(tri, self._inst_light_tri)
            and np.array_equal(lpa, self._inst_light_lpa)
            and np.array_equal(uv, self._inst_light_uv)
            and np.array_equal(tex, self._inst_light_tex)
        ):
            return
        self._inst_light_tri = np.ascontiguousarray(tri, np.float32)
        self._inst_light_lpa = np.ascontiguousarray(lpa, np.float32)
        self._inst_light_uv = np.ascontiguousarray(uv, np.float32)
        self._inst_light_tex = np.ascontiguousarray(tex, np.int32)
        self._rebuild_lights()

    def _rebuild_lights(self):
        tris, lpa, uv, tex = lb.emissive_lights(self._grid_np, self.table)
        if len(self._inst_light_tri):
            tris = np.concatenate([tris, self._inst_light_tri])
            lpa = np.concatenate([lpa, self._inst_light_lpa])
            uv = np.concatenate([uv, self._inst_light_uv])
            tex = np.concatenate([tex, self._inst_light_tex])
        self.light_bvh = lb.build_light_bvh(tris, lpa, uv=uv, tex=tex)
        self.bvh_device = device_bvh(self.light_bvh, self.device)
        # pow2 depth bucket (kept so the two packages' scenes compare 1:1)
        d = max(1, self.light_bvh.max_depth)
        self.bvh_max_depth = 1 << (d - 1).bit_length()
        if self.bvh_device is not None and 0 < len(tris) <= self.FLAT_LIGHT_CAP:
            # flat light list for ops/nee.sample_light_flat, padded to a
            # pow2 bucket; pad rows have power 0 -> never sampled
            L = len(tris)
            cap = max(4, 1 << (L - 1).bit_length())
            pad = cap - L
            areas = 0.5 * np.linalg.norm(
                np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]),
                axis=1,
            ).astype(np.float32)
            self.bvh_device["flat"] = {
                "tri": self._dev(np.pad(
                    tris.astype(np.float32), ((0, pad), (0, 0), (0, 0))
                )),
                "power": self._dev(np.pad(
                    (lpa.astype(np.float32) * areas), (0, pad)
                )),
                "area": self._dev(np.pad(areas, (0, pad))),
                "uv": self._dev(np.pad(
                    uv.astype(np.float32), ((0, pad), (0, 0), (0, 0))
                )),
                "tex": self._dev(np.pad(tex.astype(np.int32), (0, pad))),
            }
        # static texture-id set reachable by light samples, grouped by
        # atlas content (tex_dedup)
        if len(tex):
            groups: dict = {}
            for tid in sorted({int(x) for x in tex}):
                canon = (
                    self.tex_dedup[tid]
                    if tid < len(self.tex_dedup) else tid
                )
                groups.setdefault(canon, []).append(tid)
            self.light_tex_set = tuple(
                tuple(g) for _, g in sorted(groups.items())
            )
        else:
            self.light_tex_set = None
        # static emissive palettes per light-texture group (read by the
        # fused path kernel's radiance mode; carried for 1:1 comparison)
        self.light_em = None
        if self.light_tex_set is not None:
            tabs = []
            for group in self.light_tex_set:
                em = self.table.emissivity[group[0]].reshape(
                    -1, 3).astype(np.float32)
                pal, inv = np.unique(em, axis=0, return_inverse=True)
                if len(pal) > 32 or em.shape[0] != 256:
                    tabs = None
                    break
                words = np.zeros(64, np.uint32)
                for i, v in enumerate(inv.ravel()):
                    words[i >> 2] |= np.uint32(v) << np.uint32(8 * (i & 3))
                tabs.append((
                    tuple(int(t) for t in group),
                    tuple(int(w) for w in words),
                    tuple((float(r), float(g), float(b)) for r, g, b in pal),
                ))
            if tabs:
                self.light_em = tuple(tabs)

    def _edit_touches_lights(self, cell: np.ndarray, old: int, new: int) -> bool:
        if old in self._emissive_blocks or new in self._emissive_blocks:
            return True
        # neighbouring an emissive block changes its face set
        grid_np = self._grid_np
        size = np.asarray(grid_np.shape)
        for off in chunklib.FACE_NEIGHBOR:
            nb = cell + off
            if ((nb >= 0) & (nb < size)).all() and grid_np[tuple(nb)] in self._emissive_blocks:
                return True
        return False

    # ------------------------------------------------------------------
    # world edits (ids include air)
    # ------------------------------------------------------------------

    def get_block(self, global_coords) -> Optional[int]:
        cell = np.asarray(global_coords) - self.origin.astype(np.int64)
        size = np.asarray(self._grid_np.shape)
        if ((cell < 0) | (cell >= size)).any():
            return None
        return int(self._grid_np[tuple(cell)])

    @property
    def grid_host(self) -> np.ndarray:
        """Host mirror of the block grid, for per-frame host-side queries."""
        return self._grid_np

    def set_grid(self, grid: np.ndarray, origin) -> None:
        raise NotImplementedError(
            "Scene.set_grid (streaming-world recenter) is not ported "
            "(ROADMAP: game loop + app)")

    def set_block(self, global_coords, block_id: int) -> bool:
        """Grid edit in place; returns False if outside the world."""
        cell = np.asarray(global_coords, np.int64) - self.origin.astype(np.int64)
        size = np.asarray(self._grid_np.shape)
        if ((cell < 0) | (cell >= size)).any():
            return False
        old = int(self._grid_np[tuple(cell)])
        touches = self._edit_touches_lights(cell, old, block_id)
        self.grid[int(cell[0]), int(cell[1]), int(cell[2])] = int(block_id)
        self._grid_np[tuple(cell)] = block_id
        self.tlas_rebuilds += 1
        if touches:
            self._rebuild_lights()
        self._sync_proc_edit(cell)
        return True

    # ------------------------------------------------------------------
    # rendering
    # ------------------------------------------------------------------

    def camera_to_local(self, eye) -> torch.Tensor:
        """World-space eye -> grid-local, on the scene's device. A tensor
        already on the device stays there (no host round trip); the float32
        subtraction is the same either way."""
        if isinstance(eye, torch.Tensor):
            return eye.to(device=self.device, dtype=torch.float32) - self._origin_t
        return self._dev(np.asarray(eye, np.float32) - self.origin)

    def _proc_for(self, cfg: RenderConfig):
        """(proc_static, proc_arrays) when cfg wants — and the scene can
        back — the procedural tracer; (None, None) otherwise."""
        if cfg.tracer == "proc" and self.proc_static is not None:
            return self.proc_static, self.proc_arrays
        return None, None

    def _vec(self, v) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            return v.to(device=self.device, dtype=torch.float32)
        return self._dev(np.asarray(v, np.float32))

    def _render_args(self, eye, front, right, up, frame):
        return (
            self.grid, self.translucent, self.materials, self.bvh_device,
            self.bvh_max_depth, self.dist, self.instances_device, self.rows,
            self.camera_to_local(eye), self._vec(front), self._vec(right),
            self._vec(up), int(frame),
        )

    def render(self, eye, front, right, up, frame: int, cfg: RenderConfig,
               trace_log=None, path_log=None, path_tracer=None,
               march_tracer=None) -> torch.Tensor:
        """One frame -> (H, W, 4) u8 BGRA on the scene's device. The fused
        path gets the scene's instance tables (``inst_static``) and light
        emissive palettes (``light_em``); see ``megakernel.render_samples``
        for the logs, ``path_tracer`` and ``march_tracer``."""
        ps, pa = self._proc_for(cfg)
        with torch.no_grad():
            return megakernel.render_frame(
                *self._render_args(eye, front, right, up, frame), cfg,
                proc_static=ps, proc=pa, light_tex_set=self.light_tex_set,
                inst_static=self.inst_static, light_em=self.light_em,
                trace_log=trace_log, path_log=path_log, path_tracer=path_tracer,
                march_tracer=march_tracer,
            )

    def render_samples(self, eye, front, right, up, frame: int, cfg: RenderConfig,
                       trace_log=None, occupancy_out=None) -> torch.Tensor:
        """Linear radiance per sample -> (spp, H, W, 3) float32."""
        ps, pa = self._proc_for(cfg)
        with torch.no_grad():
            return megakernel.render_samples(
                *self._render_args(eye, front, right, up, frame), cfg,
                proc_static=ps, proc=pa, light_tex_set=self.light_tex_set,
                inst_static=self.inst_static, light_em=self.light_em,
                trace_log=trace_log, occupancy_out=occupancy_out,
            )

    def render_sharded(self, *a, **k):
        raise NotImplementedError("sharded rendering is not ported (ROADMAP: parallel)")

    def render_converged(self, eye, front, right, up, frame: int, chunks: int,
                         cfg: RenderConfig) -> torch.Tensor:
        """One converged frame of ``chunks`` accumulated sample passes ->
        (H, W, 4) u8 BGRA. Pass ids are ``frame*chunks + i`` (mod 2^32, as
        the JAX package's uint32 ids); radiance is summed over each pass's
        samples and accumulated from zero in pass order, then packed once —
        the same expressions as the host loop ``PathTracer.render_converged``,
        which this equals bit for bit. The arguments are resolved once, before
        the loop; the loop itself reads nothing back to the host (pass
        device tensors for the camera to keep the whole call free of host
        round trips)."""
        ps, pa = self._proc_for(cfg)
        args = self._render_args(eye, front, right, up, 0)[:-1]
        frame0 = int(frame) * int(chunks)
        with torch.no_grad():
            acc = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                              device=self.device)
            for i in range(int(chunks)):
                smp = megakernel.render_samples(
                    *args, (frame0 + i) & 0xFFFFFFFF, cfg,
                    proc_static=ps, proc=pa, light_tex_set=self.light_tex_set,
                    inst_static=self.inst_static, light_em=self.light_em,
                )
                acc = acc + smp.sum(dim=0)
            return megakernel.pack_bgra(acc / (chunks * cfg.samples_per_pixel))

    def render_converged_sharded(self, *a, **k):
        raise NotImplementedError("sharded rendering is not ported (ROADMAP: parallel)")


def _alpha_words(alpha: np.ndarray):
    """64 packed words of a 16x16 alpha table when every texel is k/255 in
    [0, 1] exactly (what the fused kernel reconstructs); None otherwise."""
    a_f32 = np.asarray(alpha, np.float32)
    if not (np.all(a_f32 >= 0.0) and np.all(a_f32 <= 1.0)):
        return None
    ab = np.round(a_f32.astype(np.float64) * 255.0).astype(np.uint32).ravel()
    if not np.array_equal(ab.astype(np.float32) / np.float32(255.0), a_f32.ravel()):
        return None
    return tuple(
        int(ab[4 * w] | (ab[4 * w + 1] << 8) | (ab[4 * w + 2] << 16) | (ab[4 * w + 3] << 24))
        for w in range(64)
    )
