"""RAD-NeRF field (port of ``geneface_tpu/models/radnerf/radnerf.py``).

A 3-D multi-resolution grid encodes the position; an ambient MLP maps
(position feature, condition feature) to 2-D ambient coordinates (tanh) that
index a second, 2-D grid; a sigma MLP gives density (``trunc_exp``) and a
geometry feature; a color MLP takes SH-4 directions, the geometry feature and
a per-frame individual code. Parameter names and shapes follow the JAX
parameter tree through :mod:`geneface_tpu_torch.convert`.

``grid_backend`` picks the grids' layout: ``fused`` (grouped tables, a
``ParameterDict`` of groups), or ``reference`` / ``block``, which share the
canonical ``[n_entries, C]`` table of the reference ``gridencoder`` (so a
checkpoint runs unchanged under either; an imported GeneFace checkpoint
needs one of them). ``grid_compute_dtype`` (``f32``, ``bf16``, ``mixed``)
and ``grid_bwd_dtype`` (``same``, ``bf16``) set the fused grids' compute
dtypes (:mod:`geneface_tpu_torch.ops.fused_grid`); the other layouts
ignore them, as in the JAX package.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from geneface_tpu_torch.models.radnerf.cond_encoder import MLP, AudioAttNet, AudioNet
from geneface_tpu_torch.ops import (
    dense_view,
    fused_grid_encode,
    make_fused_grid_meta,
    make_grid_meta,
    sh_encode,
    trunc_exp,
)
from geneface_tpu_torch.ops.encoders import fast_grid_encode, grid_encode, make_block_grid_meta
from geneface_tpu_torch.ops.fused_grid import table_shape

__all__ = ["RADNeRF", "COND_IN_DIMS", "GRID_BACKENDS"]

#: the grid layouts the port runs
GRID_BACKENDS = ("fused", "reference", "block")

COND_IN_DIMS = {
    "esperanto": 44,
    "deepspeech": 29,
    "idexp_lm3d_normalized": 68 * 3,
}


class RADNeRF(nn.Module):
    """Keyword arguments mirror the JAX module's fields (and the config keys
    of ``egs/egs_bases/radnerf/base.yaml``)."""

    def __init__(
        self,
        cond_type: str = "idexp_lm3d_normalized",
        cond_out_dim: int = 64,
        cond_win_size: int = 1,
        smo_win_size: int = 5,
        with_att: bool = True,
        bound: float = 1.0,
        grid_type: str = "tiledgrid",
        grid_interpolation_type: str = "linear",
        log2_hashmap_size: int = 16,
        desired_resolution: int = 2048,
        grid_num_levels: int = 8,
        grid_level_dim: int = 4,
        num_layers_ambient: int = 3,
        hidden_dim_ambient: int = 128,
        ambient_out_dim: int = 2,
        num_layers_sigma: int = 3,
        hidden_dim_sigma: int = 128,
        geo_feat_dim: int = 128,
        num_layers_color: int = 2,
        hidden_dim_color: int = 128,
        individual_embedding_num: int = 13000,
        individual_embedding_dim: int = 4,
        sh_degree: int = 4,
        dtype: torch.dtype = torch.bfloat16,
        fused_single_table: bool = False,
        fused_row_lanes: int = 256,
        fused_ungroup_coarse: int = 0,
        fused_coarse_run: int = 1,
        ambient_ungroup_coarse: int = -1,
        ambient_single_table: bool = False,
        grid_backend: str = "fused",
        grid_compute_dtype: str = "f32",
        grid_bwd_dtype: str = "same",
    ):
        super().__init__()
        if grid_backend not in GRID_BACKENDS:
            raise ValueError(f"grid_backend={grid_backend!r}: one of {GRID_BACKENDS}")
        self.grid_compute_dtype = grid_compute_dtype
        self.bound = bound
        self.with_att = with_att
        self.sh_degree = sh_degree
        self.dtype = dtype
        self.grid_backend = grid_backend
        gridtype = {"tiledgrid": "tiled", "hashgrid": "hash"}[grid_type]
        # equal parameter budget across level geometries: the hashmap cap is
        # scaled so that capped levels hold the reference's L=16/C=2 bytes
        cap = log2_hashmap_size - int(round(math.log2(grid_level_dim / 2)))
        common = dict(
            num_levels=grid_num_levels,
            level_dim=grid_level_dim,
            base_resolution=16,
            log2_hashmap_size=cap,
            gridtype=gridtype,
            interpolation=grid_interpolation_type,
        )
        pos_meta = make_grid_meta(
            input_dim=3, desired_resolution=int(desired_resolution * bound), **common
        )
        amb_meta = make_grid_meta(
            input_dim=ambient_out_dim, desired_resolution=desired_resolution, **common
        )
        self.pos_grid_meta, self.ambient_grid_meta = pos_meta, amb_meta
        self.pos_block_meta = make_block_grid_meta(pos_meta)
        self.ambient_block_meta = make_block_grid_meta(amb_meta)
        amb_ungroup = fused_ungroup_coarse if ambient_ungroup_coarse < 0 else ambient_ungroup_coarse
        self.pos_fused_meta = make_fused_grid_meta(
            pos_meta, single_table=fused_single_table, row_lanes=fused_row_lanes,
            ungroup_coarse=fused_ungroup_coarse, coarse_run=fused_coarse_run,
            compute=grid_compute_dtype, bwd_compute=grid_bwd_dtype,
        )
        self.ambient_fused_meta = make_fused_grid_meta(
            amb_meta, single_table=fused_single_table or ambient_single_table,
            row_lanes=fused_row_lanes, ungroup_coarse=amb_ungroup,
            coarse_run=fused_coarse_run, compute=grid_compute_dtype,
            bwd_compute=grid_bwd_dtype,
        )
        self.pos_embeddings = self._grid_params(pos_meta, self.pos_fused_meta)
        self.ambient_embeddings = self._grid_params(amb_meta, self.ambient_fused_meta)
        self.cond_prenet = AudioNet(COND_IN_DIMS[cond_type], cond_out_dim, cond_win_size)
        if with_att:
            self.cond_att_net = AudioAttNet(cond_out_dim, smo_win_size)
        pos_dim = pos_meta.output_dim
        self.ambient_net = MLP(
            pos_dim + cond_out_dim, ambient_out_dim, hidden_dim_ambient,
            num_layers_ambient, dtype, split_out=(1,) * ambient_out_dim,
        )
        self.sigma_net = MLP(
            pos_dim + amb_meta.output_dim, 1 + geo_feat_dim, hidden_dim_sigma,
            num_layers_sigma, dtype, split_out=(1, geo_feat_dim),
        )
        self.color_net = MLP(
            sh_degree**2 + geo_feat_dim + individual_embedding_dim, 3,
            hidden_dim_color, num_layers_color, dtype,
        )
        if individual_embedding_dim > 0:
            self.individual_embeddings = nn.Parameter(
                torch.zeros(individual_embedding_num, individual_embedding_dim)
            )
        else:
            self.individual_embeddings = None

    def _grid_params(self, meta, fmeta):
        """The grid's parameters: the fused groups, or the canonical table."""
        if self.grid_backend != "fused":
            return nn.Parameter(torch.zeros(meta.n_entries, meta.level_dim))
        return nn.ParameterDict(
            {
                f"group_{gi}": nn.Parameter(torch.zeros(table_shape(fmeta, gi)))
                for gi in range(len(fmeta.groups))
            }
        )

    @staticmethod
    def grid_tensors(grid) -> list:
        """The tables of one grid's parameters (fused groups or canonical)."""
        return list(grid.values()) if isinstance(grid, nn.ParameterDict) else [grid]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init in the JAX module's distributions: grid tables
        U(-1e-4, 1e-4), weights lecun-normal (std sqrt(1/fan_in)), biases 0,
        individual codes 0.1·N(0, 1)."""

        def normal(t, std):
            t.copy_(torch.randn(t.shape, generator=generator) * std)

        for table in self.grid_tensors(self.pos_embeddings) + self.grid_tensors(
                self.ambient_embeddings):
            table.copy_((torch.rand(table.shape, generator=generator) * 2 - 1) * 1e-4)
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d)):
                fan_in = m.weight[0].numel()
                normal(m.weight, math.sqrt(1.0 / fan_in))
                if m.bias is not None:
                    m.bias.zero_()
        if self.individual_embeddings is not None:
            normal(self.individual_embeddings, 0.1)

    # -- condition path ------------------------------------------------------
    def cal_cond_feat(self, cond: torch.Tensor) -> torch.Tensor:
        """``[B_smo, W, C_in]`` condition window → ``[1, cond_out_dim]``."""
        feat = self.cond_prenet(cond)
        if self.with_att:
            feat = self.cond_att_net(feat)[None]
        return feat

    # -- field queries -------------------------------------------------------
    def _grid_view(self, params, fmeta):
        """One grid's tables as the encoder reads them: the fused groups'
        fast views (dense groups expanded by :func:`dense_view`), or the
        canonical table itself."""
        if self.grid_backend != "fused":
            return params
        return [
            dense_view(params[f"group_{gi}"], fmeta, gi)
            if fmeta.modes[gi] == "dense"
            else params[f"group_{gi}"]
            for gi in range(len(fmeta.groups))
        ]

    def grid_tables(self) -> dict:
        """The tables of both grids as the encoder reads them; a
        per-checkpoint constant."""
        return {
            "pos": self._grid_view(self.pos_embeddings, self.pos_fused_meta),
            "ambient": self._grid_view(self.ambient_embeddings, self.ambient_fused_meta),
        }

    def _encode_grid(self, x01, tables, meta, bmeta, fmeta, input_grad: bool = True):
        """The backend's encoder of one grid → ``[M, L*C]`` float32."""
        if self.grid_backend == "fused":
            return fused_grid_encode(x01, tables, fmeta, need_input_grad=input_grad)
        if self.grid_backend == "block":
            return fast_grid_encode(x01, tables, bmeta)
        return grid_encode(x01, tables, meta)

    def _ambient_and_pos(self, position, cond_feat, tables):
        x01 = (position + self.bound) / (2 * self.bound)
        # the samples come from stop-gradient rays: no position input grads
        pos_feat = self._encode_grid(
            x01, tables["pos"], self.pos_grid_meta, self.pos_block_meta,
            self.pos_fused_meta, input_grad=False,
        )
        logits = self.ambient_net([pos_feat, cond_feat.reshape(1, -1)])
        tanhs = [torch.tanh(l.float()) for l in logits]
        if self.grid_backend == "fused":
            amb01 = tuple((t + 1.0) / 2.0 for t in tanhs)
        else:
            amb01 = (torch.stack(tanhs, dim=-1) + 1.0) / 2.0  # [M, 2]
        ambient_feat = self._encode_grid(
            amb01, tables["ambient"], self.ambient_grid_meta, self.ambient_block_meta,
            self.ambient_fused_meta,
        )
        return pos_feat, ambient_feat, torch.stack(tanhs, dim=-1)

    def density(self, position, cond_feat, tables=None) -> dict:
        tables = tables if tables is not None else self.grid_tables()
        pos_feat, ambient_feat, _ = self._ambient_and_pos(position, cond_feat, tables)
        sig, geo_feat = self.sigma_net([pos_feat, ambient_feat])
        return {"sigma": trunc_exp(sig), "geo_feat": geo_feat}

    def forward(
        self,
        position: torch.Tensor,  # [M, 3] in [-bound, bound]
        direction: torch.Tensor,  # [M, 3] unit
        cond_feat: torch.Tensor,  # [1, cond_out_dim]
        individual_code: torch.Tensor | None,  # [ind_dim] or None
        tables: dict | None = None,  # from grid_tables(); built here if None
    ):
        """→ (sigma [M], color [M, 3], ambient_pos [M, 2]), float32."""
        tables = tables if tables is not None else self.grid_tables()
        pos_feat, ambient_feat, ambient_pos = self._ambient_and_pos(
            position, cond_feat, tables
        )
        sig, geo_feat = self.sigma_net([pos_feat, ambient_feat])
        sigma = trunc_exp(sig)
        parts = [sh_encode(direction, self.sh_degree), geo_feat]
        if individual_code is not None:
            parts.append(individual_code.reshape(1, -1))
        color = torch.sigmoid(self.color_net(parts))
        return sigma, color, ambient_pos
