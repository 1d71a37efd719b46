"""The visual-servo MPC engine (PyTorch port of
``openmp_parallel_computing_tpu.models.mpc.solver``): the sweep, fused,
reference and assoc backends, numerically equivalent.

Sweep backend (the default), per scenario batch:

    nominal rollout of the warm start
    ADMM (admm_iters, plus admm_iters_extra when the batch-max primal
    residual still exceeds admm_tol):
        edge_refresh "admm"/"solve": one multi_sweep kernel launch runs
        ilqr_iters iLQR sweeps (Riccati backward, 4-candidate line search,
        winner select) against a fixed edge linearization;
        edge_refresh "ilqr": per sweep, the edge linearization at the
        current nominal, one unified_sweep launch (or the backward_sweep +
        forward_sweep pair), then the first-wins pick of the candidates
        u^ = relax*us + (1-relax)*z;  z = clip(u^ + y);  y = y + u^ - z
    feasible rollout of z and its cost

With ``full_solve=True`` and ``edge_refresh="solve"`` everything after the
nominal rollout and the one edge linearization — the ADMM loop and the
feasible rollout — is one ``full_solve`` kernel launch; the duals then
start at zero and are not returned. A horizon too long for the one-launch
kernels' shared memory on the card takes the iteration-by-iteration path
instead (``_SweepLanes``).

Fused backend (``backend="fused"``, ``_solve_batch_fused``): the same ADMM
loop around an iLQR solve in the scenario-first layout, whose Riccati
backward is one ``riccati_lanes.backward_batched`` launch per sweep over the
dense linearization and cost expansion; the forward tries alpha =
(1, 0.5, 0.25) and keeps the best only if it lowers the cost. The
receding-horizon loops of this backend are a Python loop over whole
solves.

Reference backends (``backend="reference"``, and ``"assoc"`` with the
associative-scan Riccati backward; ``_solve_batch_ref``): the audit paths,
built from other parts than the kernels. Per iLQR sweep the rollout, the
analytic linearization, the cost expansion of the cost closures
(``costs.make_expansions``, the edge gradient by autodiff), the ADMM
penalty's expansion, ``riccati.backward`` (an unrolled Cholesky a step)
or ``riccati.backward_assoc``, three ``riccati.forward`` candidates scored
on the closures and the strict ``J < j0`` pick. The JAX package vmaps a
per-scenario solve; here every op takes the scenario axis leading. The
adaptive gate stays batch-global.

The edge linearization is the value + gradient of the pyramid edge cost,
taken once per ADMM iteration (``edge_refresh="admm"``), once per solve
at the warm-start trajectory (``"solve"``) or before every sweep
(``"ilqr"``). On the sweep backend ``edge_route`` picks its form from
what the solve can see:

- ``"kernel"``: on the card, a shared pyramid under
  ``edge_sampler="pallas"``, or under ``"analytic"`` with float32 storage,
  takes the gather sampler kernel (``sampler.sample``, ``csrc/sampler.cu``):
  one launch for the value and gradient, one for the value. Its two-texel
  lerps are the dense sampler's one-hot-pair contractions written out, so
  ``"analytic"`` keeps its mathematics and drops its dense weight products;
- ``"gather"``: ``"pallas"`` on the CPU, the same sampler's plain version;
- ``"autograd"``: ``"xla"`` on a shared pyramid, the dense sampler's value
  with its gradient by ``torch.autograd``;
- ``"dense"``: the dense analytic sampler (``costs.edge_vg_pyramid_xy``):
  ``"analytic"`` on the CPU (held there to the JAX package), with
  ``sampler_dtype="bfloat16"`` (weights and mean-centred levels stored in
  bfloat16, accumulation in float32), and every pyramid per scenario
  (levels (B, Hf, Wf): ``solve_batch_multi``, ``control_step_multi``, the
  serving micro-batch), in float32 whatever ``edge_sampler`` and
  ``sampler_dtype`` say, as in the JAX package.

Each edge evaluation on a dense form is counted in the metrics registry's
``mpc.edge_dense``, always on; one on the kernel is a launch,
``launch.sample_vg`` or ``launch.sample`` (the CPU's plain gather counts
in neither). The fused and reference backends keep their own dense
samplers.

On the card every nominal and final rollout is one ``sweep.rollout``
kernel launch, at every batch size. On the CPU the rollouts keep the JAX
package's two forms and threshold: the plain ``_dyn_step`` loop
(``sweep.rollout``'s plain version) up to ``ROLLOUT_SCAN_MAX_BP``
scenarios, and the zero-gain ``forward_sweep`` above it.

Solver state stays in the kernels' lanes layout — batch last, state axis
in split order — for the whole solve, and across control steps in the
receding-horizon loops. The batch is not padded.

The adaptive-budget gate is a host branch on ``resid.max().item()``: exact
(the same predicate JAX evaluates inside ``lax.cond``), and settled steps
skip the extra iterations' launches, at the cost of one device-to-host
sync per solve. Every backend counts its gate into the metrics registry:
``mpc.gate_checks`` a solve that evaluates it, ``mpc.gate_fired`` a solve
whose extra iterations run.

While a ``torch.profiler`` records, the step records the spans of
``SPANS`` (``utils.metrics.Metrics.span``: a range in the profiler's trace
and a record with host and device times): ``mpc.step`` a receding-horizon
step (``_receding``, ``_receding_lanes``, ``MPCRuntime.step``), and inside
it on the sweep backend the perception, the lanes conversions, the
rollouts, the edge linearizations, each ADMM iteration's sweep and update,
the gate, the final cost and the state's advance. No span opens inside a
per-time-step loop. With no profiler recording a span site costs one
predicate.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from openmp_parallel_computing_tpu_torch.models.mpc import (
    costs,
    dynamics,
    riccati,
    riccati_lanes,
    sampler,
    sweep,
)
from openmp_parallel_computing_tpu_torch.models.mpc.dynamics import CONTROL_DIM
from openmp_parallel_computing_tpu_torch.utils.config import MPCConfig
from openmp_parallel_computing_tpu_torch.utils.metrics import registry

# The spans the step records while a profiler records (module docstring).
SPANS = ("mpc.step", "mpc.perception", "mpc.layout", "mpc.rollout",
         "mpc.edge", "mpc.sweep", "mpc.admm_update", "mpc.gate",
         "mpc.final_cost", "mpc.advance")
span = registry.span

# Nominal-rollout form threshold (scenarios) of a CPU batch: up to this
# batch the rollout is the _dyn_step loop, above it the zero-gain
# forward_sweep. The JAX package's value. A batch on the card always takes
# the rollout kernel.
ROLLOUT_SCAN_MAX_BP = 8192

# The fused and reference backends' line-search candidates (the sweep
# kernels use sweep.ALPHAS = (0, 1, 0.5, 0.25)).
_ALPHAS = (1.0, 0.5, 0.25)


def edge_route(cfg: MPCConfig, batched: bool, device) -> str:
    """The form the sweep backend takes for the edge term of a pyramid on
    ``device``, shared or per scenario (``batched``): ``"kernel"``,
    ``"gather"``, ``"autograd"`` or ``"dense"`` (module docstring)."""
    if batched:
        return "dense"
    if cfg.edge_sampler == "xla":
        return "autograd"
    on_card = torch.device(device).type == "cuda"
    if cfg.edge_sampler == "pallas":
        return "kernel" if on_card else "gather"
    return ("kernel" if on_card and cfg.sampler_dtype == "float32"
            else "dense")


def _count_edge(route: str) -> None:
    """One edge evaluation on a dense form into the registry's
    ``mpc.edge_dense`` (the kernel's launches count themselves)."""
    if route not in ("kernel", "gather"):
        registry.inc("mpc.edge_dense")


def _to_split(a: torch.Tensor) -> torch.Tensor:
    """Trailing state axis from interleaved [x0, y0, x1, y1, ...] to split
    [x0..x_{m-1}, y0..y_{m-1}]."""
    s = a.shape
    return a.reshape(s[:-1] + (-1, 2)).transpose(-1, -2).reshape(s)


def _from_split(a: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_to_split`."""
    s = a.shape
    return a.reshape(s[:-1] + (2, -1)).transpose(-1, -2).reshape(s)


def _shift_tail_zero(a: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Receding-horizon shift: drop entry 0 along ``dim``, zero-fill the
    tail."""
    tail = a.narrow(dim, 1, a.shape[dim] - 1)
    return torch.cat([tail, torch.zeros_like(a.narrow(dim, 0, 1))], dim=dim)


def _pick_candidates(J: torch.Tensor, cand: torch.Tensor, a_axis: int,
                     n_batch_dims: int) -> torch.Tensor:
    """First-wins argmin-J candidate per scenario. J (A, *bshape); ``cand``
    has the A axis at ``a_axis`` and ``n_batch_dims`` trailing batch dims.
    Non-finite costs count as +inf; the select is a chain of masked
    ``where`` (a one-hot product would let 0 * NaN poison the winner)."""
    J = torch.where(torch.isfinite(J), J, torch.full_like(J, float("inf")))
    Jmin = J.min(dim=0).values
    cand = torch.movedim(cand, a_axis, 0)
    mshape = [1] * (cand.dim() - 1)
    mshape[len(mshape) - n_batch_dims:] = J.shape[1:]
    out = cand[0]
    taken = J[0] == Jmin
    for a in range(1, cand.shape[0]):
        hit = (J[a] == Jmin) & ~taken
        taken = taken | hit
        out = torch.where(hit.reshape(mshape), cand[a], out)
    return out


def _adaptive_extra(carry, us: torch.Tensor, z: torch.Tensor,
                    cfg: MPCConfig, run_extra):
    """Adaptive-budget gate: when the batch-max primal residual after the
    base iterations exceeds ``cfg.admm_tol``, return ``run_extra(carry)``,
    else the carry unchanged. A host branch (one sync), counted in
    ``mpc.gate_checks`` and ``mpc.gate_fired``; the ``mpc.gate`` span
    holds the residual and the wait for it."""
    with span("mpc.gate", on=us):
        fire = (us - z).abs().max().item() > cfg.admm_tol
    registry.inc("mpc.gate_checks")
    if fire:
        registry.inc("mpc.gate_fired")
        return run_extra(carry)
    return carry


def _perceive(frame: torch.Tensor):
    """A step's perception: the cost pyramid of a planar u8 frame, in the
    ``mpc.perception`` span."""
    with span("mpc.perception", on=frame):
        return costs.build_cost_pyramid_from_frame(frame)


class Scenario(NamedTuple):
    """A batch of MPC problems (leading axis B)."""

    p0: torch.Tensor        # (B, 2m) initial normalized feature coords
    target: torch.Tensor    # (B, 2m) desired feature coords
    depth: torch.Tensor     # (B, m) feature depths
    us0: torch.Tensor       # (B, H, 6) warm-start control sequence
    y0: torch.Tensor | None = None   # (B, H, 6) ADMM dual warm start


class Solution(NamedTuple):
    us: torch.Tensor        # (B, H, 6) projected, feasible controls
    ps: torch.Tensor        # (B, H+1, 2m) predicted feature trajectory
    cost: torch.Tensor      # (B,) final trajectory cost (unaugmented)
    primal_residual: torch.Tensor   # (B,) max |us - z| over the horizon
    # (B, H, 6) final scaled duals when Scenario.y0 was given; None on the
    # full_solve path
    dual: torch.Tensor | None = None


class _SweepLanes:
    """Lanes-layout machinery of the sweep backend for one pyramid: layout
    converters, the edge linearization, the whole ADMM + iLQR solve and
    the final cost.

    ``use_multi``: all sweeps of an ADMM iteration in one multi_sweep
    launch (the edge term is fixed across them), taken when the kernel's
    gains for the horizon fit one block's shared memory on the card
    (``sweep.group_sweep_fits``, as the JAX package admits its one-launch
    kernels by their VMEM estimates); else the per-sweep iteration runs.
    ``use_unified``: a
    per-sweep iteration runs the unified kernel, else the split backward +
    forward pair. The unified kernel runs at every horizon: its wrapper
    keeps the gains in shared memory where they fit the card and in global
    scratch where they do not, so it is taken for every configuration;
    setting the attribute to False (on an instance, or on the class for
    the solves of a loop) selects the split pair.
    ``use_full``: the whole ADMM loop in one full_solve launch
    (``full_solve=True`` with ``edge_refresh="solve"``), admitted the same
    way; else the loop of ADMM iterations runs."""

    use_unified = True

    def __init__(self, pyramid, shape, cfg: MPCConfig):
        self.pyramid = pyramid
        self.shape = tuple(int(v) for v in shape)
        self.cfg = cfg
        self.m = cfg.num_features
        self.qe = cfg.q_edge
        self.kw = dict(m=self.m, q=cfg.q_track, r=cfg.r_ctrl, rho=cfg.rho,
                       qe=self.qe, dt=cfg.dt)
        # Storage type of the dense samplers' weights on a shared pyramid;
        # a per-scenario pyramid samples in float32 (the JAX package's).
        self.batched = pyramid is not None and costs.pyramid_batched(pyramid)
        self.sampler_dt = (torch.bfloat16 if cfg.sampler_dtype == "bfloat16"
                           and not self.batched else None)
        dev = pyramid[0].device if pyramid else torch.device("cpu")
        self.route = edge_route(cfg, self.batched, dev)
        self.use_multi = (cfg.edge_refresh in ("admm", "solve")
                          and sweep.group_sweep_fits(
                              "multi_sweep", self.m, cfg.horizon, dev))
        self.use_full = (cfg.full_solve and cfg.edge_refresh == "solve"
                         and sweep.group_sweep_fits(
                             "full_solve", self.m, cfg.horizon, dev))
        if cfg.full_solve and cfg.admm_iters_extra:
            raise ValueError(
                "admm_iters_extra needs the iteration-by-iteration path (the "
                "adaptive continuation is a branch between iterations); "
                "full_solve runs a fixed budget inside one kernel: unset one "
                "of them")

    # -- layout ------------------------------------------------------------

    @staticmethod
    def lanes(a: torch.Tensor, ndim: int) -> torch.Tensor:
        """(B, *rest) -> (*rest, B), contiguous."""
        return a.permute(tuple(range(1, ndim)) + (0,)).contiguous()

    @staticmethod
    def unlanes(a_l: torch.Tensor, lead_dims: int) -> torch.Tensor:
        """(*lead, B) -> (B, *lead)."""
        return a_l.permute((lead_dims,) + tuple(range(lead_dims))).contiguous()

    @staticmethod
    def lanes_scenario(scen: Scenario):
        """Scenario -> (p0_l, target_l, izd_l, us_l) in split order."""
        lanes = _SweepLanes.lanes
        return (lanes(_to_split(scen.p0), 2), lanes(_to_split(scen.target), 2),
                lanes(1.0 / scen.depth, 2), lanes(scen.us0, 3))

    # -- edge term ----------------------------------------------------------

    def gather(self) -> bool:
        """True when the edge term goes through the gather sampler: its
        kernel on the card (``"pallas"``, or ``"analytic"`` in float32, on
        a shared pyramid) or its plain version on the CPU (``"pallas"``);
        see ``edge_route``."""
        return self.route in ("kernel", "gather")

    def edge_vals(self, ps_l: torch.Tensor) -> torch.Tensor:
        """Pyramid edge cost along a lanes trajectory -> (h+1, B)."""
        m = self.m
        with span("mpc.edge", on=ps_l):
            _count_edge(self.route)
            if self.gather():
                return sampler.edge_vals_lanes(self.pyramid, ps_l[:, :m],
                                               ps_l[:, m:], *self.shape)
            return costs.edge_cost_pyramid_xy(self.pyramid, ps_l[:, :m],
                                              ps_l[:, m:], *self.shape,
                                              dtype=self.sampler_dt)

    def edge_grads(self, ps_l: torch.Tensor) -> torch.Tensor:
        """Gradient of the summed edge cost along a lanes trajectory,
        (h+1, n, B), by the gather sampler (one launch on the card), by
        ``torch.autograd`` of ``edge_vals`` (``"autograd"``: the solves run
        under ``torch.no_grad()``, so the graph is built on a copy inside
        ``torch.enable_grad()``; ``edge_vals`` counts the evaluation) or by
        the dense analytic sampler."""
        if not self.qe:
            return torch.zeros_like(ps_l)
        m = self.m
        with span("mpc.edge", on=ps_l):
            if self.route == "autograd":
                with torch.enable_grad():
                    p = ps_l.detach().requires_grad_()
                    (g,) = torch.autograd.grad(self.edge_vals(p).sum(), p)
                return g
            _count_edge(self.route)
            if self.gather():
                _, g = sampler.sample(self.pyramid, ps_l[:, :m], ps_l[:, m:],
                                      *self.shape, grads=True)
                return g * (1.0 / (m * len(self.pyramid)))
            _, gx, gy = costs.edge_vg_pyramid_xy(self.pyramid, ps_l[:, :m],
                                                 ps_l[:, m:], *self.shape,
                                                 dtype=self.sampler_dt)
            return torch.cat([gx, gy], dim=1)

    # -- solve ---------------------------------------------------------------

    def rollout_nominal(self, p0_l, us_l, z_l, y_l, target_l,
                        izd_l) -> torch.Tensor:
        """Trajectory (h+1, n, B) of ``us_l`` from ``p0_l``: one
        ``sweep.rollout`` kernel launch on the card; on the CPU the
        ``_dyn_step`` loop up to ``ROLLOUT_SCAN_MAX_BP`` scenarios, else
        candidate 0 of a zero-gain ``forward_sweep`` (the JAX package's two
        forms; the ADMM pair only enters the discarded costs)."""
        with span("mpc.rollout", on=p0_l):
            if p0_l.is_cuda or us_l.shape[-1] <= ROLLOUT_SCAN_MAX_BP:
                return sweep.rollout(p0_l, us_l, izd_l, m=self.m,
                                     dt=self.cfg.dt)
            zeros = torch.zeros_like
            h, c, B = us_l.shape
            n = p0_l.shape[0]
            ps0 = p0_l.new_zeros((h + 1, n, B))
            K0 = p0_l.new_zeros((h, c, n, B))
            ps_c, _, _ = sweep.forward_sweep(p0_l, ps0, us_l, K0,
                                             zeros(us_l), z_l, y_l,
                                             zeros(ps0), target_l, izd_l,
                                             **self.kw)
            return ps_c[:, 0].contiguous()   # the kernels take whole arrays

    def solve(self, p0_l, target_l, izd_l, us_l, y0_l=None):
        """Full ADMM + iLQR solve in lanes layout.

        ``y0_l``: optional warm-start scaled duals (h, c, B); None = zeros.
        Returns ``(z_l, ps_final_l, resid_l, y_l)``: the feasible controls
        (h, c, B), their rollout (h+1, n, B), the per-scenario primal
        residual (B,) and the final scaled duals (h, c, B), None under
        ``use_full``."""
        cfg, kw = self.cfg, self.kw

        def ilqr_once(us_l, ps_l, z_l, y_l, g_fix=None):
            g_l = g_fix if g_fix is not None else self.edge_grads(ps_l)
            args = (z_l, y_l, g_l, target_l, izd_l)
            if self.use_unified:
                ps_c, us_c, J = sweep.unified_sweep(p0_l, ps_l, us_l, *args,
                                                    **kw)
            else:
                K, k = sweep.backward_sweep(ps_l, us_l, *args, **kw)
                ps_c, us_c, J = sweep.forward_sweep(p0_l, ps_l, us_l, K, k,
                                                    *args, **kw)
            return (_pick_candidates(J, us_c, 1, 1),
                    _pick_candidates(J, ps_c, 1, 1))

        def admm_body(carry):
            us_l, ps_l, z_l, y_l, g_solve = carry
            g_fix = (self.edge_grads(ps_l) if cfg.edge_refresh == "admm"
                     else g_solve)
            with span("mpc.sweep", on=p0_l):
                if self.use_multi:
                    ps_l, us_l = sweep.multi_sweep(p0_l, ps_l, us_l, z_l, y_l,
                                                   g_fix, target_l, izd_l,
                                                   sweeps=cfg.ilqr_iters,
                                                   **kw)
                else:
                    for _ in range(cfg.ilqr_iters):
                        us_l, ps_l = ilqr_once(us_l, ps_l, z_l, y_l, g_fix)
            with span("mpc.admm_update", on=p0_l):
                z_l, y_l = sweep.admm_update(us_l, z_l, y_l, cfg.admm_relax,
                                             cfg.u_limit)
            return us_l, ps_l, z_l, y_l, g_solve

        def run(carry, iters):
            for _ in range(iters):
                carry = admm_body(carry)
            return carry

        z0 = torch.clamp(us_l, -cfg.u_limit, cfg.u_limit)
        y0 = y0_l if y0_l is not None else torch.zeros_like(us_l)
        ps_l = self.rollout_nominal(p0_l, us_l, z0, y0, target_l, izd_l)
        g_solve0 = (self.edge_grads(ps_l) if cfg.edge_refresh == "solve"
                    else None)
        if self.use_full:
            if y0_l is not None:
                raise ValueError(
                    "full_solve starts its ADMM duals at zero inside the "
                    "kernel and cannot take a dual warm start: an explicit "
                    "Scenario.y0 cannot be honored with "
                    "MPCConfig.full_solve=True; unset one of them")
            ps_final_l, z_l, us_l = sweep.full_solve(
                p0_l, ps_l, us_l, g_solve0, target_l, izd_l,
                sweeps=cfg.ilqr_iters, admm_iters=cfg.admm_iters,
                u_limit=cfg.u_limit, relax=cfg.admm_relax, **kw)
            y_l = None
        else:
            carry = run((us_l, ps_l, z0, y0, g_solve0), cfg.admm_iters)
            if cfg.admm_iters_extra:
                carry = _adaptive_extra(
                    carry, carry[0], carry[2], cfg,
                    lambda c: run(c, cfg.admm_iters_extra))
            us_l, ps_l, z_l, y_l, _ = carry
            ps_final_l = self.rollout_nominal(p0_l, z_l, z_l, y_l, target_l,
                                              izd_l)
        resid_l = (us_l - z_l).abs().amax(dim=(0, 1))
        return z_l, ps_final_l, resid_l, y_l

    def final_cost(self, z_l, ps_final_l, target_l) -> torch.Tensor:
        """Unaugmented trajectory cost per scenario -> (B,)."""
        cfg = self.cfg
        with span("mpc.final_cost", on=z_l):
            track = cfg.q_track * ((ps_final_l - target_l[None]) ** 2).sum(
                dim=(0, 1))
            ctrl = cfg.r_ctrl * (z_l ** 2).sum(dim=(0, 1))
            if self.qe:
                edge = self.qe * self.edge_vals(ps_final_l).sum(dim=0)
            else:
                edge = torch.zeros_like(track)
            return track + ctrl + edge


def _solve_batch_sweep(pyramid, shape, scen: Scenario,
                       cfg: MPCConfig) -> Solution:
    """Interleaved-API wrapper around :meth:`_SweepLanes.solve`."""
    sw = _SweepLanes(pyramid, shape, cfg)
    with span("mpc.layout", on=scen.p0):
        p0_l, target_l, izd_l, us_l = sw.lanes_scenario(scen)
        y0_l = sw.lanes(scen.y0, 3) if scen.y0 is not None else None
    z_l, ps_final_l, resid_l, y_l = sw.solve(p0_l, target_l, izd_l, us_l,
                                             y0_l)
    cost = sw.final_cost(z_l, ps_final_l, target_l)
    with span("mpc.layout", on=z_l):
        return Solution(
            us=sw.unlanes(z_l, 2),
            ps=_from_split(sw.unlanes(ps_final_l, 2)),
            cost=cost,
            primal_residual=resid_l,
            dual=sw.unlanes(y_l, 2) if y0_l is not None else None,
        )


def _solve_batch_fused(pyramid, shape, scen: Scenario,
                       cfg: MPCConfig) -> Solution:
    """The fused backend's batched solve, scenario-first (B, H, ...): per
    iLQR sweep the rollout, the analytic linearization (smooth dynamics),
    the cost expansion (the constant Hessians as broadcasts), one
    ``backward_batched`` launch, three ``riccati.forward`` candidates and
    the strict ``J < j0`` pick; the ADMM loop with the shared adaptive
    gate; the feasible rollout of z and its cost. ``edge_sampler`` is not
    used: the edge term is the analytic dense sampler's, on a shared or a
    per-scenario pyramid (``costs.edge_vg_batch``)."""
    B, h = scen.us0.shape[0], cfg.horizon
    n, c = scen.p0.shape[-1], CONTROL_DIM
    p0, target, depth = scen.p0, scen.target, scen.depth
    rho, q, r, qe, dt = cfg.rho, cfg.q_track, cfg.r_ctrl, cfg.q_edge, cfg.dt
    f32 = dict(dtype=torch.float32, device=p0.device)
    eye_n = torch.eye(n, **f32)
    lxx = (2.0 * q * eye_n).expand(B, h, n, n)
    luu = ((2.0 * r + rho) * torch.eye(c, **f32)).expand(B, h, c, c)
    lux = torch.zeros((), **f32).expand(B, h, c, n)
    vxx = (2.0 * q * eye_n).expand(B, n, n)

    def step(p, u):
        return dynamics.step(p, u, depth, dt)

    def rollout(us):
        return dynamics.rollout(p0, us, depth, dt)

    def quad_cost(ps, us):              # (B, H+1, n), (B, H, c) -> (B,)
        return (q * ((ps - target[:, None]) ** 2).sum(dim=(1, 2))
                + r * (us ** 2).sum(dim=(1, 2)))

    def sample_edge(us):
        ps_s = rollout(us)
        if qe:
            return costs.edge_vg_batch(pyramid, ps_s, *shape)
        return ps_s.new_zeros(ps_s.shape[:2]), torch.zeros_like(ps_s)

    def ilqr_once(us, z, y, eg):
        ps = rollout(us)
        fx, fu = dynamics.linearize_analytic(ps[:, :-1], us, depth[:, None],
                                             dt)
        e_ref, g_ref = eg if eg is not None else sample_edge(us)
        lx = 2.0 * q * (ps[:, :-1] - target[:, None]) + qe * g_ref[:, :-1]
        lu = 2.0 * r * us + rho * (us - z + y)
        vx = 2.0 * q * (ps[:, -1] - target) + qe * g_ref[:, -1]
        K, kff = riccati_lanes.backward_batched(fx, fu, lx, lu, lxx, luu,
                                                lux, vx, vxx)

        def aug_cost_lin(ps_c, us_c):
            edge = qe * (e_ref.sum(dim=1)
                         + (g_ref * (ps_c - ps)).sum(dim=(1, 2)))
            admm = 0.5 * rho * ((us_c - z + y) ** 2).sum(dim=(1, 2))
            return quad_cost(ps_c, us_c) + edge + admm

        us_c, J_c = [], []
        for alpha in _ALPHAS:
            ps_a, us_a = riccati.forward(step, p0, ps, us,
                                         riccati.Gains(K, kff), alpha)
            us_c.append(us_a)
            J_c.append(aug_cost_lin(ps_a, us_a))
        J_c = torch.stack(J_c)                                  # (A, B)
        best = torch.argmin(J_c, dim=0)
        us_best = torch.stack(us_c)[best, torch.arange(B, device=p0.device)]
        # a NaN candidate makes the min NaN, and NaN < j0 keeps us
        improved = J_c.min(dim=0).values < aug_cost_lin(ps, us)
        return torch.where(improved[:, None, None], us_best, us)

    us0 = scen.us0
    eg_solve = sample_edge(us0) if cfg.edge_refresh == "solve" else None

    def run(carry, iters):
        us, z, y = carry
        for _ in range(iters):
            eg = sample_edge(us) if cfg.edge_refresh == "admm" else eg_solve
            for _ in range(cfg.ilqr_iters):
                us = ilqr_once(us, z, y, eg)
            z, y = sweep.admm_update(us, z, y, cfg.admm_relax, cfg.u_limit)
        return us, z, y

    z0 = torch.clamp(us0, -cfg.u_limit, cfg.u_limit)
    y0 = scen.y0 if scen.y0 is not None else torch.zeros_like(us0)
    us, z, y = run((us0, z0, y0), cfg.admm_iters)
    if cfg.admm_iters_extra:
        us, z, y = _adaptive_extra(
            (us, z, y), us, z, cfg, lambda c: run(c, cfg.admm_iters_extra))
    ps = rollout(z)
    if qe:
        edge = qe * costs.edge_val_batch(pyramid, ps, *shape).sum(dim=1)
    else:
        edge = torch.zeros(B, **f32)
    return Solution(us=z, ps=ps, cost=quad_cost(ps, z) + edge,
                    primal_residual=(us - z).abs().amax(dim=(1, 2)),
                    dual=y if scen.y0 is not None else None)


def _single_admm(pyramid, shape, scen: Scenario, cfg: MPCConfig,
                 backward_fn=None):
    """The reference backends' ADMM machinery as ``(init, run,
    finalize)`` closures over a scenario batch (leading axis B; the JAX
    package's per-scenario closures, vmapped there):
    ``init() -> (us, z, y)`` builds the ADMM carry, ``run(carry, n)``
    advances it ``n`` iterations and ``finalize(carry) -> Solution`` rolls
    out z and costs it. Split so that the adaptive budget can gate a
    continuation on the batch-max residual (``_solve_batch_ref``).

    ``backward_fn``: ``riccati.backward`` (None) or
    ``riccati.backward_assoc``. The pyramid is shared, or per scenario
    (levels (B, Hf, Wf))."""
    backward_fn = backward_fn or riccati.backward
    p0, target, depth, us0 = scen.p0, scen.target, scen.depth, scen.us0
    q, r, qe, rho, dt = (cfg.q_track, cfg.r_ctrl, cfg.q_edge, cfg.rho,
                         cfg.dt)
    h_img, w_img = shape
    eye_c = torch.eye(CONTROL_DIM, dtype=torch.float32, device=p0.device)

    def step_fn(p, u):
        return dynamics.step(p, u, depth, dt)

    def rollout(us):
        return dynamics.rollout(p0, us, depth, dt)

    stage = costs.make_stage_cost(pyramid, shape, target, q, r, qe)
    terminal = costs.make_terminal_cost(pyramid, shape, target, q, qe)
    # Quadratic-only twins: the line search scores the edge term on its
    # linearization and never samples the pyramid.
    stage_q = costs.make_stage_cost(pyramid, shape, target, q, r, 0.0)
    terminal_q = costs.make_terminal_cost(pyramid, shape, target, q, 0.0)
    expand = costs.make_expansions(pyramid, shape, target, q, r, qe)

    def sample_edge(us):
        """Edge value and gradient (autodiff) along the rollout of us:
        ((B, H+1), (B, H+1, n))."""
        ps_s = rollout(us)
        if qe:
            return costs.edge_value_grad(pyramid, ps_s, h_img, w_img)
        return ps_s.new_zeros(ps_s.shape[:-1]), torch.zeros_like(ps_s)

    def ilqr_once(us, z, y, eg):
        ps = rollout(us)
        fx, fu = dynamics.linearize_analytic(ps[:, :-1], us, depth[:, None],
                                             dt)
        e_ref, g_ref = eg if eg is not None else sample_edge(us)
        lx, lu, lxx, luu, lux, vx, vxx = expand(ps, us, edge_grads=g_ref)
        # the ADMM penalty 0.5 rho |u - z + y|^2
        lu = lu + rho * (us - z + y)
        luu = luu + rho * eye_c
        gains = backward_fn(fx, fu, lx, lu, lxx, luu, lux, vx, vxx)

        def aug_cost_lin(ps_c, us_c):
            quad = riccati.trajectory_cost(stage_q, terminal_q, ps_c, us_c)
            edge = qe * (e_ref + (g_ref * (ps_c - ps)).sum(-1)).sum(-1)
            admm = 0.5 * rho * ((us_c - z + y) ** 2).sum(dim=(-2, -1))
            return quad + edge + admm

        us_c, J_c = [], []
        for alpha in _ALPHAS:
            ps_a, us_a = riccati.forward(step_fn, p0, ps, us, gains, alpha)
            us_c.append(us_a)
            J_c.append(aug_cost_lin(ps_a, us_a))
        J_c = torch.stack(J_c)                                  # (A, B)
        best = torch.argmin(J_c, dim=0)
        us_best = torch.stack(us_c)[best, torch.arange(us.shape[0],
                                                       device=us.device)]
        # JAX's argmin takes a NaN; its J[best] < j0 then keeps us, and so
        # does the NaN that min propagates here
        improved = J_c.min(dim=0).values < aug_cost_lin(ps, us)
        return torch.where(improved[:, None, None], us_best, us)

    # edge_refresh="solve": one linearization at the warm start
    eg_solve = sample_edge(us0) if cfg.edge_refresh == "solve" else None

    def init():
        z0 = torch.clamp(us0, -cfg.u_limit, cfg.u_limit)
        y0 = scen.y0 if scen.y0 is not None else torch.zeros_like(us0)
        return us0, z0, y0

    def run(carry, iters: int):
        us, z, y = carry
        for _ in range(iters):
            eg = sample_edge(us) if cfg.edge_refresh == "admm" else eg_solve
            for _ in range(cfg.ilqr_iters):
                us = ilqr_once(us, z, y, eg)
            z, y = sweep.admm_update(us, z, y, cfg.admm_relax, cfg.u_limit)
        return us, z, y

    def finalize(carry) -> Solution:
        us, z, y = carry
        ps = rollout(z)
        return Solution(us=z, ps=ps,
                        cost=riccati.trajectory_cost(stage, terminal, ps, z),
                        primal_residual=(us - z).abs().amax(dim=(1, 2)),
                        dual=y if scen.y0 is not None else None)

    return init, run, finalize


def _solve_single(pyramid, shape, scen: Scenario, cfg: MPCConfig,
                  backward_fn=None) -> Solution:
    """The reference solve with a fixed budget of ``admm_iters`` and no
    adaptive gate (``DistributedMPC``'s reference path, as in JAX)."""
    init, run, finalize = _single_admm(pyramid, shape, scen, cfg,
                                       backward_fn)
    return finalize(run(init(), cfg.admm_iters))


def _solve_batch_ref(pyramid, shape, scen: Scenario, cfg: MPCConfig,
                     backward_fn=None) -> Solution:
    """The reference backends' batched solve: ``admm_iters`` iterations,
    then the adaptive continuation gated on the batch-max residual
    (``_adaptive_extra``, the gate every backend shares)."""
    init, run, finalize = _single_admm(pyramid, shape, scen, cfg,
                                       backward_fn)
    carry = run(init(), cfg.admm_iters)
    if cfg.admm_iters_extra:
        us, z, _ = carry
        carry = _adaptive_extra(carry, us, z, cfg,
                                lambda c: run(c, cfg.admm_iters_extra))
    return finalize(carry)


class VisualServoMPC:
    """Batched visual-servo MPC over Sobel edge-feature maps.

    Holds no parameters: ``cfg`` fixes the problem and the solver budget,
    ``device`` is where scenarios are made and where every input must
    lie: the card unless the caller asks for the CPU. On a CUDA device the
    perception, sampler, sweep and Riccati kernels run; on the CPU their
    plain PyTorch versions do."""

    def __init__(self, cfg: MPCConfig | None = None, device="cuda"):
        self.cfg = cfg or MPCConfig()
        self.device = torch.device(device)

    def _check(self, *tensors):
        for t in tensors:
            if t is not None and t.device.type != self.device.type:
                raise ValueError(f"input on {t.device}, solver on "
                                 f"{self.device}")

    # -- scenario construction -------------------------------------------

    def random_scenarios(self, n: int,
                         generator: torch.Generator | None = None) -> Scenario:
        """A batch of n scenarios (features in the central image), drawn on
        the CPU from ``generator`` and moved to the solver's device, so a
        seed gives the same scenarios on every device."""
        cfg = self.cfg
        m = cfg.num_features

        def uniform(shape, lo, hi):
            u = torch.rand(shape, generator=generator, dtype=torch.float32)
            return (lo + (hi - lo) * u).to(self.device)

        return Scenario(
            p0=uniform((n, 2 * m), -0.6, 0.6),
            target=uniform((n, 2 * m), -0.5, 0.5),
            depth=uniform((n, m), 1.0, 5.0),
            us0=torch.zeros((n, cfg.horizon, CONTROL_DIM),
                            dtype=torch.float32, device=self.device))

    # -- solving ----------------------------------------------------------

    @torch.no_grad()
    def solve_batch(self, edge_map: torch.Tensor, scen: Scenario) -> Solution:
        """edge_map (H, W) f32 and a scenario batch -> Solution batch; the
        cost pyramid is built once and shared by the batch."""
        self._check(edge_map, *scen)
        pyramid = costs.build_cost_pyramid(edge_map)
        return self._solve_pyramid(pyramid, edge_map.shape, scen)

    @torch.no_grad()
    def solve_batch_multi(self, edge_maps: torch.Tensor,
                          scen: Scenario) -> Solution:
        """edge_maps (B, H, W) f32: scenario b solves against map b (the
        JAX package's ``solve_batch_multi``). The pyramid levels carry a
        leading batch axis, sampled per scenario."""
        self._check(edge_maps, *scen)
        pyramid = costs.build_cost_pyramid(edge_maps)
        return self._solve_pyramid(pyramid, edge_maps.shape[1:], scen)

    def _solve_pyramid(self, pyramid, shape, scen: Scenario) -> Solution:
        """Backend dispatch over a prebuilt cost pyramid (shared, or with a
        leading per-scenario batch axis)."""
        if self.cfg.backend == "fused":
            return _solve_batch_fused(pyramid, shape, scen, self.cfg)
        if self.cfg.backend in ("reference", "assoc"):
            bwd = (riccati.backward_assoc if self.cfg.backend == "assoc"
                   else riccati.backward)
            return _solve_batch_ref(pyramid, shape, scen, self.cfg, bwd)
        return _solve_batch_sweep(pyramid, shape, scen, self.cfg)

    @torch.no_grad()
    def control_step(self, frame: torch.Tensor, scen: Scenario):
        """Planar (C, H, W) u8 frame -> (u0 (B, 6), Solution): perception
        kernel, pyramid, batched solve."""
        self._check(frame, *scen)
        sol = self._solve_pyramid(_perceive(frame), frame.shape[1:], scen)
        return sol.us[:, 0], sol

    @torch.no_grad()
    def control_step_multi(self, frames: torch.Tensor, scen: Scenario):
        """Frames (B, C, H, W) u8, one a scenario -> (u0 (B, 6), Solution):
        the perception kernel on each frame (B launches; B is the serving
        micro-batch), the levels pooled per frame, one batched solve with
        a pyramid per scenario (the JAX package's ``control_step_multi``)."""
        from openmp_parallel_computing_tpu_torch.ops.pipeline import (
            edge_pyramid_base)

        self._check(frames, *scen)
        base = torch.stack([edge_pyramid_base(f, s=costs.PYRAMID_SCALES[0])
                            for f in frames])
        pyramid = costs.pyramid_from_base(base)
        sol = self._solve_pyramid(pyramid, frames.shape[2:], scen)
        return sol.us[:, 0], sol

    def _seed_duals(self, scen: Scenario) -> Scenario:
        """With ``cfg.dual_warm_start``, start the receding loop's dual
        carry at zeros when the caller gave no ``Scenario.y0`` (a given y0
        is carried regardless); under ``cfg.full_solve`` there is no
        carry."""
        if (self.cfg.dual_warm_start and scen.y0 is None
                and not self.cfg.full_solve):
            return scen._replace(y0=torch.zeros_like(scen.us0))
        return scen

    def _advance(self, s: Scenario, sol: Solution):
        """One receding-horizon step: the first control applied to the
        true dynamics, the plan shifted, the decayed duals shifted when the
        carry is on. Returns (scenario', u0)."""
        with span("mpc.advance", on=s.p0):
            u0 = sol.us[:, 0]
            y0 = (self.cfg.dual_decay * _shift_tail_zero(sol.dual, 1)
                  if s.y0 is not None else None)
            return s._replace(p0=dynamics.step(s.p0, u0, s.depth,
                                               self.cfg.dt),
                              us0=_shift_tail_zero(sol.us, 1), y0=y0), u0

    def _receding(self, pyramid_at, shape, scen: Scenario, n_steps: int):
        """Receding-horizon loop; ``pyramid_at(step)`` gives each step's
        cost pyramid. The sweep backend keeps its state in lanes layout
        (``_receding_lanes``); the other backends loop over whole solves.
        Returns ``(u0s (T, B, c), costs (T, B), scen')``."""
        if self.cfg.backend == "sweep":
            return self._receding_lanes(pyramid_at, shape, scen, n_steps)
        s = self._seed_duals(scen)
        u0s, cost_seq = [], []
        for idx in range(n_steps):
            with span("mpc.step", on=s.p0, step=idx):
                sol = self._solve_pyramid(pyramid_at(idx), shape, s)
                s, u0 = self._advance(s, sol)
            u0s.append(u0)
            cost_seq.append(sol.cost)
        return torch.stack(u0s), torch.stack(cost_seq), s

    def _receding_lanes(self, pyramid_at, shape, scen: Scenario,
                        n_steps: int):
        """Receding-horizon loop with the scenario state kept in lanes
        layout across steps. ``pyramid_at(step)`` gives each step's cost
        pyramid. Returns ``(u0s (T, B, c), costs (T, B), scen')``."""
        cfg = self.cfg
        lanes, unlanes = _SweepLanes.lanes, _SweepLanes.unlanes
        if cfg.full_solve and scen.y0 is not None:
            raise ValueError("full_solve cannot honor Scenario.y0 (its ADMM "
                             "duals start at zero in the kernel): unset one "
                             "of them")
        y0 = self._seed_duals(scen).y0
        dual_carry = y0 is not None
        p0_l, target_l, izd_l, us_l = _SweepLanes.lanes_scenario(scen)
        y_l = lanes(y0, 3) if dual_carry else None
        u0s, cost_seq = [], []
        for idx in range(n_steps):
            with span("mpc.step", on=p0_l, step=idx):
                sw = _SweepLanes(pyramid_at(idx), shape, cfg)
                z_l, ps_final_l, _, y_out = sw.solve(p0_l, target_l, izd_l,
                                                     us_l, y_l)
                cost_seq.append(sw.final_cost(z_l, ps_final_l, target_l))
                with span("mpc.advance", on=p0_l):
                    u0_l = z_l[0]                           # (c, B)
                    u0s.append(u0_l)
                    p0_l = sweep._dyn_step(p0_l, u0_l, izd_l, cfg.dt, sw.m)
                    us_l = _shift_tail_zero(z_l, 0)
                    y_l = (cfg.dual_decay * _shift_tail_zero(y_out, 0)
                           if dual_carry else None)
        scen_out = scen._replace(
            p0=_from_split(unlanes(p0_l, 1)),
            us0=unlanes(us_l, 2),
            y0=unlanes(y_l, 2) if y_l is not None else scen.y0)
        return (torch.stack(u0s).permute(0, 2, 1).contiguous(),
                torch.stack(cost_seq), scen_out)

    @torch.no_grad()
    def receding_horizon(self, frame: torch.Tensor, scen: Scenario,
                         n_frames: int):
        """Closed receding-horizon loop on one fixed frame: the pyramid is
        built once, then ``n_frames`` warm-started solves, each applying
        its first control to the true dynamics."""
        self._check(frame, *scen)
        pyramid = costs.build_cost_pyramid_from_frame(frame)
        return self._receding(lambda i: pyramid, frame.shape[1:], scen,
                              n_frames)

    @torch.no_grad()
    def receding_horizon_frames(self, frames: torch.Tensor, scen: Scenario,
                                n_steps: int):
        """Closed receding-horizon loop over a ring of frames (F, C, H, W)
        u8: step t runs perception on frame ``t mod F``, builds the
        pyramid, solves, applies the first control to the true dynamics,
        and shifts the plan and the decayed duals.

        Returns ``(u0s (n_steps, B, c), costs (n_steps, B), scen')``."""
        self._check(frames, *scen)
        n_ring = frames.shape[0]
        return self._receding(lambda i: _perceive(frames[i % n_ring]),
                              frames.shape[2:], scen, n_steps)
