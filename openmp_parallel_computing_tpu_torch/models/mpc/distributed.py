"""Pod-scale scenario dispatch: the MPC solve sharded over a device mesh
(port of ``openmp_parallel_computing_tpu.models.mpc.distributed``).

BASELINE config 5 ("pod-scale MPC: 4096 scenarios sharded across hosts,
ADMM QP with ICI collectives, H=50"). The JAX package runs one function
per device under ``shard_map``; the port's single-controller mesh
(``parallel.mesh``) runs the same function for each shard in turn, on the
shard's device:

- **scenarios** shard over both mesh axes jointly: every shard owns an
  equal slice, data row by data row;
- **perception**: with ``model = 1`` each shard runs the fused perception
  kernel (``ops.pipeline.edge_pyramid_base``) on its copy of the frame.
  With ``model > 1`` the frame's rows are split over the model axis: a
  one-row halo exchange, the edge pass on the halo-extended block
  (``ops.pipeline.edge_pipeline``, ``border="none"``), the border mask,
  then each shard pools its rows by columns and scatters them into the
  16-row bands of the pyramid's base level, and a ``psum`` over the model
  axis assembles the base every shard of the group needs (a (68, 120)
  float32 payload at 1080p instead of the edge plane). The band sums are
  integers below 2^24, exact in float32 in any order, so the base is
  bit-equal to ``edge_pyramid_base``'s; the scatter is an ``index_add_``
  (no matmul: a TF32 matmul would round them);
- **the solve** is the port's batched solve (``solver._solve_batch_sweep``
  or ``_solve_batch_fused``) on the shard's scenarios, with no
  communication. Its adaptive-budget gate reads the shard's own residual,
  as the JAX solve inside ``shard_map`` does, so a sharded solve can run
  more ADMM iterations on some shards than the unsharded solve of the
  same batch. The reference backends run ``solver._solve_single``, as the
  JAX package does: ``admm_iters`` with no adaptive continuation, and the
  sequential Riccati backward for ``"assoc"`` too;
- the diagnostics (``pmean`` of the mean cost, ``pmax`` of the max primal
  residual over (data, model)) are the only mesh-wide reduction.

Multi-host: call ``parallel.initialize_multihost()`` first (one process
per host, each with its own local mesh); each process passes its local
scenario slice, and ``solve`` gathers the first controls of all of them.
"""

from __future__ import annotations

import torch

from openmp_parallel_computing_tpu_torch.models.mpc import costs
from openmp_parallel_computing_tpu_torch.models.mpc import solver as _solver
from openmp_parallel_computing_tpu_torch.models.mpc.solver import Scenario
from openmp_parallel_computing_tpu_torch.ops.pipeline import (
    edge_pipeline,
    edge_pyramid_base,
)
from openmp_parallel_computing_tpu_torch.parallel import collectives
from openmp_parallel_computing_tpu_torch.parallel.mesh import (
    DATA_AXIS as DATA,
    MODEL_AXIS as MODEL,
    Mesh,
    to_device,
)
from openmp_parallel_computing_tpu_torch.parallel.spatial import (
    _border_mask_rows,
    split_rows,
)
from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig


class DistributedMPC:
    """Scenario-sharded MPC over a (data, model) mesh."""

    def __init__(self, cfg: MPCConfig, mesh: Mesh):
        self.cfg = cfg
        self.mesh = mesh

    def _level0(self, frame_s: list[torch.Tensor]) -> tuple[list, tuple]:
        """Each shard's base pyramid level and the frame's (H, W)."""
        mesh, s0 = self.mesh, costs.PYRAMID_SCALES[0]
        n_model = mesh.local_shape[MODEL]
        if n_model == 1:
            return ([edge_pyramid_base(f, s=s0) for f in frame_s],
                    tuple(frame_s[0].shape[1:]))
        level0 = []
        for r in range(mesh.local_shape[DATA]):
            blocks = frame_s[r * n_model:(r + 1) * n_model]
            _, h_loc, w = blocks[0].shape
            h = h_loc * n_model
            tops, bottoms = collectives.halo_exchange_rows(blocks, MODEL, mesh)
            bands = []
            for j, (top, block, bottom) in enumerate(zip(tops, blocks,
                                                         bottoms)):
                ext = torch.cat([top, block, bottom], dim=1)
                rows = edge_pipeline(ext, border="none")[0, 1:-1]
                rows = _border_mask_rows(rows, h, w, j, h_loc).to(
                    torch.float32)
                # local column pooling (the full width is on the shard) ...
                wb = -(-w // s0)
                colpool = torch.nn.functional.pad(rows, (0, -w % s0))
                colpool = colpool.reshape(h_loc, wb, s0).sum(-1)
                # ... then the shard's rows added into the global bands
                band = (j * h_loc + torch.arange(h_loc, device=rows.device)
                        ) // s0
                bands.append(torch.zeros((-(-h // s0), wb),
                                         dtype=torch.float32,
                                         device=rows.device
                                         ).index_add_(0, band, colpool))
            level0 += [b / float(s0 * s0)
                       for b in collectives.psum(bands, MODEL, mesh)]
        return level0, (h, w)

    @torch.no_grad()
    def _run(self, frame_s, scen_s, full: bool):
        """The per-shard step over every shard of this process: per-shard
        lists of (u0, cost, primal residual) with ``full``, else of (u0,
        the mesh-wide mean cost, the mesh-wide max residual)."""
        cfg, mesh = self.cfg, self.mesh
        # The reference backends take JAX's path here: the fixed-budget
        # _solve_single with the sequential backward, "assoc" too, and no
        # adaptive gate (ROADMAP quirk 8, copied).
        solve_local = {"fused": _solver._solve_batch_fused,
                       "reference": _solver._solve_single,
                       "assoc": _solver._solve_single,
                       }.get(cfg.backend, _solver._solve_batch_sweep)
        level0, shape = self._level0(frame_s)
        sols = [solve_local(costs.pyramid_from_base(base), shape, scen, cfg)
                for base, scen in zip(level0, scen_s)]
        u0 = [s.us[:, 0] for s in sols]
        if full:
            return u0, [s.cost for s in sols], [s.primal_residual
                                                for s in sols]
        mean_cost = collectives.pmean([s.cost.mean() for s in sols],
                                      (DATA, MODEL), mesh)
        max_res = collectives.pmax([s.primal_residual.max() for s in sols],
                                   (DATA, MODEL), mesh)
        return u0, mean_cost, max_res

    def _step(self, frame_s, scen_s):
        return self._run(frame_s, scen_s, full=False)

    def _step_full(self, frame_s, scen_s):
        return self._run(frame_s, scen_s, full=True)

    def shard_scenarios(self, scen: Scenario) -> list[Scenario]:
        """A scenario batch split over every shard of this process (in
        ``mesh.flat`` order), each part on its shard's device. Across
        processes ``scen`` is this process's slice of the global batch."""
        n = self.mesh.size

        def parts(a):
            return [None] * n if a is None else list(a.chunk(n))

        return [Scenario(*(None if a is None else to_device(a, d)
                           for a in fields))
                for fields, d in zip(zip(*(parts(a) for a in scen)),
                                     self.mesh.flat)]

    def _prepare(self, frame, scen: Scenario):
        if scen.y0 is not None:
            # Dispatch-tier solves are cold-start by design (jobs arrive
            # without solver state), as in the JAX package.
            raise ValueError(
                "DistributedMPC solves cold-start; Scenario.y0 (dual "
                "warm start) applies to the receding-horizon loops")
        mesh = self.mesh
        n_dev = mesh.shape[DATA] * mesh.shape[MODEL]
        global_batch = scen.p0.shape[0] * mesh.processes
        if global_batch % n_dev:
            raise ValueError(
                f"global scenario batch {global_batch} not divisible by "
                f"device count {n_dev}")
        n_model = mesh.shape[MODEL]
        if n_model > 1 and frame.shape[1] % n_model:
            raise ValueError("frame height not divisible by model axis")
        frame = torch.as_tensor(frame)
        if n_model > 1:
            # Every process ingests the whole frame; each data row of the
            # mesh holds its rows split over the model axis.
            frame_s = [block for row in mesh.devices
                       for block in split_rows(frame, row, MODEL)]
        else:
            frame_s = [to_device(frame, d) for d in mesh.flat]
        return frame_s, self.shard_scenarios(scen)

    def _gather(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """Per-shard results in batch order on the first shard's device,
        then every process's in rank order."""
        out = self.mesh.flat[0]
        return collectives.all_gather_processes(
            torch.cat([p.to(out) for p in parts]))

    def solve(self, frame, scen: Scenario):
        """frame (C, H, W) u8, a scenario batch divisible by the device
        count. Returns (u0 batch, mean cost, max primal residual), on the
        first shard's device."""
        u0, mean_cost, max_res = self._step(*self._prepare(frame, scen))
        return self._gather(u0), mean_cost[0], max_res[0]

    def solve_full(self, frame, scen: Scenario):
        """Like ``solve`` but returns per-scenario tensors (u0 (B, 6),
        cost (B,), primal_residual (B,)): the result payload of the
        dispatch tier's MPC jobs."""
        return tuple(self._gather(parts) for parts in
                     self._step_full(*self._prepare(frame, scen)))

