"""The program's entry points as the benchmark drives them, and the
checks of their answers against the plain reference.

A traffic file's ``entry`` names one of ``ENTRIES``. An entry is built
once from the configuration and the traffic (its set-up), draws one
request from a seeded generator (``draw``), sends it and reads the
answer back to the host (``call``), counts what the answer holds
(``count``), and judges sampled answers against the reference
(``check``). ``check`` with ``control=True`` puts the reference at
``Prec.control()`` in the program's place, for what the program derives
from its answer (a plan's trajectory and cost, a field): the control.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from benchmark import problems, reference as ref, reference_map as rmap


def _program_shape(cfg: dict, obj_path: str | None):
    """The program's robot for a configuration: a mesh robot, or the
    analytic body ``robot.body``, deformable under ``robot.scale``."""
    robot = cfg["robot"]
    if robot["body"] == "mesh":
        from svsdf_tpu_torch.models import mesh_sdf
        return mesh_sdf.shape_from_mesh(
            obj_path, resolution=robot["selfmapresu"],
            margin=robot["grid_margin"])
    from svsdf_tpu_torch.models import shapes
    if robot["body"] not in shapes.shape_names():
        raise ValueError(f"the program has no analytic body "
                         f"{robot['body']!r}")
    scale = robot.get("scale")
    if scale is None:
        return shapes.make_shape(robot["body"])
    # the reference's body, built first, holds the schedule to "breathing"
    return shapes.make_scaled_shape(
        robot["body"], shapes.breathing_scale(scale["amp"], scale["rate"]),
        kernel_scale=scale["kernel_scale"])


def robot_obj(cfg: dict, build_dir: str) -> str | None:
    """Write a mesh robot's .obj under ``build_dir`` (same content for
    every run) and return its path; None for an analytic robot."""
    robot = cfg["robot"]
    if robot["body"] != "mesh":
        return None
    os.makedirs(build_dir, exist_ok=True)
    path = os.path.join(build_dir, f"{cfg['name']}.obj")
    return problems.write_heart_prism(path, robot["contour_step"],
                                      robot["half_height"])


def _to(dev, *arrays, dtype=torch.float32):
    return [torch.as_tensor(a, dtype=dtype, device=dev) for a in arrays]


def _oracle(svsdf: dict, **over) -> ref.Oracle:
    """The reference's oracle for one of the configuration's settings."""
    d = {k: v for k, v in svsdf.items() if k in ref.Oracle.__dataclass_fields__}
    d["scan_bf16"] = svsdf.get("scan_dtype") == "bfloat16"
    d.update(over)
    return ref.Oracle(**d)


def _spread(name: str, gaps) -> dict:
    """The widest of per-answer gaps under ``name``, and beside it their
    50th, 90th, 99th and 99.9th percentiles (``name.q50`` ...)."""
    qs = (0.5, 0.9, 0.99, 0.999)
    q = torch.quantile(gaps.double().reshape(-1), torch.tensor(
        qs, dtype=torch.float64, device=gaps.device))
    return {name: float(gaps.max()), **{
        f"{name}.q{str(p)[2:].ljust(2, '0')}": float(v)
        for p, v in zip(qs, q)}}


def _svsdf_config(svsdf: dict):
    from svsdf_tpu_torch.ops.svsdf import SVSDFConfig
    return SVSDFConfig(**svsdf)


class Staged:
    """``parallel/batch.py::plan_batch_staged``: B independent back-end
    solves in lockstep, each request a batch of ``draw_problems``."""

    #: a sampled answer is one plan of a request
    whole = False

    def __init__(self, cfg: dict, traffic: dict, dev, obj_path=None):
        from svsdf_tpu_torch.parallel import batch as pb
        from svsdf_tpu_torch.planner import back_end
        from svsdf_tpu_torch.utils.config import PlannerConfig
        self.cfg, self.t, self.dev = cfg, traffic, dev
        self.n = cfg["pieces"]
        self.batch = traffic["batch"]
        self.body = ref.make_body(cfg, obj_path)
        self.shape = _program_shape(cfg, obj_path)
        self.pcfg = PlannerConfig(**cfg["planner"])
        self.stages = self.stages_of(cfg)
        self._pb, self._be = pb, back_end

    @staticmethod
    def stages_of(cfg: dict) -> tuple:
        """The program's stage schedule as the configuration states it."""
        return tuple(
            (_svsdf_config(s["svsdf"]), s["iters"], s["line_search"],
             s["ls_candidates"], s["frozen_ls"]) for s in cfg["stages"])

    def draw(self, rng):
        return problems.draw_problems(dict(self.t, pieces=self.n),
                                      self.batch, rng)

    def call(self, req):
        head, tail, obs, x0 = _to(self.dev, *req)
        out = self._pb.plan_batch_staged(
            self.shape, x0, self._be.BackEndProblem(head, tail, obs),
            self.pcfg, self.stages, self.n, device=self.dev)
        return {"x": out.opt_x.cpu().numpy(), "cost": out.cost.cpu().numpy(),
                "coeffs": out.traj.coeffs.cpu().numpy(),
                "durations": out.traj.durations.cpu().numpy(),
                "n_iters": out.n_iters.cpu().numpy()}

    def count(self, ans) -> int:
        return len(ans["cost"])

    rows = attempted = count

    def failed(self, ans) -> int:
        """Plans whose cost or decision vector is not finite."""
        return int((~(np.isfinite(ans["cost"])
                      & np.isfinite(ans["x"]).all(1))).sum())

    def check(self, reqs, answers, rows, dev, control=False):
        """Numbers of the sampled plans ``rows`` (request i, plan j):
        traj_gap_m, the widest gap in metres or radians between the
        trajectory the answer states and the one its decision vector gives
        (MINCO), at 64 times a plan; cost_gap_rel and its percentiles, the
        relative gaps between the stated cost and the cost of the decision
        vector; cost_left, the mean over them of the cost of the decision
        vector over the cost of its start (both the reference's, at the
        last stage's oracle), which a shortened or misdirected optimizer
        raises however consistent its answer; unsolved_share, the share
        of them whose decision vector did not leave its start, in %."""
        pick = lambda k, a: np.stack([a[i][k][j] for i, j in rows])
        head, tail, obs, x0 = (torch.as_tensor(
            np.stack([reqs[i][k][j] for i, j in rows]), dtype=torch.float64,
            device=dev) for k in range(4))
        cost_cfg = dict(self.cfg["planner"], mu=self.cfg["hinge_mu"])
        o = _oracle(self.cfg["stages"][-1]["svsdf"])
        r64 = ref.Prec.reference()
        t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
        x = t(pick("x", answers))
        f_r, c_r, d_r = ref.plan_cost(r64, self.body, x, head, tail, obs,
                                      self.n, cost_cfg, o)
        f_0 = ref.plan_cost(r64, self.body, x0, head, tail, obs, self.n,
                            cost_cfg, o)[0]
        if control:
            p = ref.Prec.control()
            f_p, c_p, d_p = (v.double() for v in ref.plan_cost(
                p, self.body, *(a.to(p.work) for a in (x, head, tail, obs)),
                self.n, cost_cfg, o))
        else:
            f_p, c_p, d_p = (t(pick(k, answers))
                             for k in ("cost", "coeffs", "durations"))
        moved = (x - x0).abs().amax(1) > 1e-6 * x0.abs().amax(1).clamp_min(1)
        ts = torch.linspace(0, 1, 64, dtype=torch.float64, device=dev)[None] \
            * d_r.sum(1, keepdim=True)
        pose = lambda c, d: ref.eval_traj(r64, c, d, ts)
        return {
            "traj_gap_m": float((pose(c_p, d_p) - pose(c_r, d_r)).abs().max()),
            **_spread("cost_gap_rel", (f_p - f_r).abs() / f_r.abs()),
            "cost_left": float((f_r / f_0).mean()),
            "unsolved_share": 100.0 * float((~moved).double().mean()),
        }


class Grid:
    """``ops/svsdf.py::svsdf_grid``: the swept-volume SDF of one
    trajectory on a points x points grid, each request one batch of axes
    ``grid_axes`` draws."""

    #: a sampled answer is a request's whole field
    whole = True

    def __init__(self, cfg: dict, traffic: dict, dev, obj_path=None):
        from svsdf_tpu_torch.ops import minco
        from svsdf_tpu_torch.ops.svsdf import svsdf_grid
        self.cfg, self.t, self.dev = cfg, traffic, dev
        self.body = ref.make_body(cfg, obj_path)
        self.shape = _program_shape(cfg, obj_path)
        self.knots = problems.grid_knots(traffic)
        self.traj = minco.solve(*_to(dev, *self.knots))
        self.svs = _svsdf_config(traffic["svsdf"])
        self._grid = svsdf_grid

    def draw(self, rng):
        return problems.grid_axes(self.t, rng)

    def call(self, req):
        xs, ys = _to(self.dev, *req)
        field = self._grid(self.shape, self.traj, xs, ys, self.svs)
        return {"field": field[0].cpu().numpy()}

    def count(self, ans) -> int:
        return ans["field"].size

    attempted = count

    def rows(self, ans) -> int:
        return 1

    def failed(self, ans) -> int:
        """Queries whose value is not finite."""
        return int((~np.isfinite(ans["field"])).sum())

    def check(self, reqs, answers, rows, dev, control=False, block=16384):
        """field_gap_m and its percentiles: the gaps in metres between the
        stated field and the reference's at every point of the sampled
        batches ``rows`` (request i, all its points)."""
        r64 = ref.Prec.reference()
        o = _oracle(self.t["svsdf"])
        knots = [torch.as_tensor(a, dtype=torch.float64, device=dev)
                 for a in self.knots]

        def field(p: ref.Prec, xs, ys):
            d, h, tl, w = (k.to(p.work) for k in knots)
            traj = ref.Traj(p, ref.minco(p, d, h, tl, w), d)
            gx, gy = torch.meshgrid(xs.to(p.work), ys.to(p.work),
                                    indexing="ij")
            pts = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)[None]
            return torch.cat([ref.tstar(self.body, traj, pts[:, s:s + block],
                                        o)[0]
                              for s in range(0, pts.shape[1], block)], 1)

        gaps = []
        for i, _ in rows:
            xs, ys = (torch.as_tensor(a, dtype=torch.float64, device=dev)
                      for a in reqs[i])
            want = field(r64, xs, ys)
            got = (field(ref.Prec.control(), xs, ys).double() if control else
                   torch.as_tensor(answers[i]["field"], dtype=torch.float64,
                                   device=dev).reshape(1, -1))
            gaps.append((got - want).abs().reshape(-1))
        return _spread("field_gap_m", torch.cat(gaps))


class E2E:
    """``parallel/batch.py::plan_batch_e2e``: B plans on one map, each
    request B start and goal cells drawn from the free cells connected to
    the map's middle free cell; the front end (wavefront field, descent,
    yaw bins, resample, harvest), the staged solve and the certificate."""

    #: a sampled answer is one plan of a request
    whole = False

    def __init__(self, cfg: dict, traffic: dict, dev, obj_path=None):
        from svsdf_tpu_torch.ops import kernels as kops
        from svsdf_tpu_torch.parallel import batch as pb
        from svsdf_tpu_torch.utils.config import PlannerConfig
        from svsdf_tpu_torch.utils.gridmap import GridMap
        self.cfg, self.t, self.dev = cfg, traffic, dev
        self.n, self.m = cfg["pieces"], traffic["obstacles"]
        self.batch = traffic["batch"]
        self.body = ref.make_body(cfg, obj_path)
        self.shape = _program_shape(cfg, obj_path)
        self.pcfg = PlannerConfig(**cfg["planner"])
        self.stages = Staged.stages_of(cfg)
        points = problems.forest_points(traffic["map"])
        # the program's map products
        grid = GridMap.from_points(points, traffic["voxel"],
                                   traffic["sta_threshold"])
        st = kops.rasterize_shape_kernels(
            self.shape, traffic["kernel_size"], traffic["yaw_num"],
            traffic["voxel"], traffic["safemargin"], device=dev)
        self.feas = kops.feasibility_maps(grid.occ2d.copy(), st, device=dev)
        self.occ_pts = torch.as_tensor(grid.occupied_centers_2d(), device=dev)
        self.res = grid.resolution
        self.xy_min = grid.xyz_min[:2].astype(np.float32)
        self._pb = pb
        # the benchmark's own: the reference's map, and the cells it draws
        occ, self.ref_lo = rmap.voxelize(points, traffic["voxel"],
                                         traffic["sta_threshold"])
        self.ref_occ2d = occ[:, :, 0]
        self.ref_feas = torch.as_tensor(rmap.feasibility(
            self.ref_occ2d, rmap.stencils(
                self.body, traffic["kernel_size"], traffic["yaw_num"],
                traffic["voxel"], traffic["safemargin"], dev).cpu().numpy()),
            device=dev)
        free = self.ref_feas.any(0)
        fi, fj = np.nonzero(free.cpu().numpy())
        mid = torch.as_tensor([[fi[len(fi) // 2], fj[len(fj) // 2]]],
                              device=dev)
        d = rmap.distance_field(free, mid)[0]
        self.cells = np.argwhere((free & (d < 1e8)).cpu().numpy())

    def draw(self, rng):
        pick = lambda: self.cells[rng.integers(0, len(self.cells),
                                               self.batch)]
        starts = pick()
        return starts, pick()

    def _run(self, starts, goals):
        return self._pb.plan_batch_e2e(
            self.shape, self.feas, self.occ_pts, starts, goals, self.pcfg,
            self.stages, self.n, self.m, self.res, self.xy_min,
            device=self.dev)

    def call(self, req):
        out = self._run(*req)
        keys = ("front_ok", "x", "cost", "cert_min", "head", "tail",
                "obstacles", "coeffs", "durations")
        return {k: getattr(out, k).cpu().numpy() for k in keys}

    def attempted(self, ans) -> int:
        return len(ans["cost"])

    rows = attempted

    def count(self, ans) -> int:
        """Certified plans: the front end reached the goal and the
        certificate is positive."""
        return int((ans["front_ok"] & (ans["cert_min"] > 0.0)).sum())

    def failed(self, ans) -> int:
        return self.attempted(ans) - self.count(ans)

    def beside_trace(self, rng, sync) -> dict:
        """The front end alone and a whole solve on the same draws, timed
        in turns (front_end_share.forest reads them)."""
        from benchmark.trace import timed_turns
        s, g = self.draw(rng)
        front = lambda: self._pb.front_end(
            self.feas, self.occ_pts, s, g, self.pcfg, self.n, self.m,
            self.res, self.xy_min, device=self.dev)
        return {"front_end_turns": timed_turns(
            {"front": front, "whole": lambda: self._run(s, g)},
            self.t["front_turns"], sync)}

    def check(self, reqs, answers, rows, dev, control=False):
        """Numbers of the sampled plans ``rows`` (request i, plan j):
        front_end_mismatches, the plans whose front end disagrees with the
        reference's (reached or not; head or tail states more than 1e-3
        apart; a harvested obstacle that is not among the nearest
        ``obstacles`` occupied cells to the reference's states, ties within
        1e-4 m allowed); traj_gap_m, cost_gap_rel and cost_left as the
        staged entry's (the start being the reference front end's),
        on the plan's own head, tail and obstacles; cert_gap_m and its
        percentiles, the gaps between the stated certificate and the least
        swept-volume SDF of the plan's obstacles; cert_overstated, the
        plans the program counts as certified (front end reached, stated
        certificate positive) whose reference certificate is not positive;
        unsolved_share, the share of them whose
        decision vector lies within 1e-3 of the start the reference's front
        end gives, in %."""
        r64 = ref.Prec.reference()
        t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
        pick = lambda k: t(np.stack([answers[i][k][j] for i, j in rows]))
        starts = t(np.stack([reqs[i][0][j] for i, j in rows])).long()
        goals = t(np.stack([reqs[i][1][j] for i, j in rows])).long()
        # the reference's front end
        free = self.ref_feas.any(0)
        x_, y_ = free.shape
        dist = rmap.distance_field(free, goals)
        path, length, reached = rmap.descend(dist, starts, 4 * (x_ + y_))
        states = rmap.resample(path, rmap.yaw_bins(self.ref_feas, path),
                               length, self.n, self.t["voxel"],
                               self.ref_lo[:2], self.t["yaw_num"])
        ii, jj = np.nonzero(self.ref_occ2d)
        occ = t(self.ref_lo[:2] + (np.stack([ii, jj], -1) + 0.5)
                * self.t["voxel"]).double()
        dd = rmap.harvest_distances(occ, states)                 # (S, Mocc)
        kth = dd.sort(dim=1).values[:, self.m - 1]
        obs = pick("obstacles").double()
        near, pos = (obs[:, :, None] - occ).norm(dim=-1).min(-1)
        d_obs = dd.gather(1, pos)
        harvest_bad = ((near > 1e-3) | (d_obs > kth[:, None] + 1e-4)).any(1)
        head, tail = pick("head").double(), pick("tail").double()
        ends_bad = torch.maximum(
            (head[:, 0] - states[:, 0]).abs().amax(1),
            (tail[:, 0] - states[:, -1]).abs().amax(1)) > 1e-3
        front_bad = (pick("front_ok") != reached) | ends_bad | harvest_bad
        # the back end on the plan's own head, tail and obstacles
        x = pick("x").double()
        cost_cfg = dict(self.cfg["planner"], mu=self.cfg["hinge_mu"])
        o = _oracle(self.cfg["stages"][-1]["svsdf"])
        oc = _oracle(self.cfg["stages"][-1]["svsdf"], use_inside=False,
                     scan_bf16=False,
                     coarse_n=max(192, self.cfg["stages"][-1]["svsdf"][
                         "coarse_n"]))
        f_r, c_r, d_r = ref.plan_cost(r64, self.body, x, head, tail, obs,
                                      self.n, cost_cfg, o)
        cert_r = ref.svsdf(self.body, ref.Traj(r64, c_r, d_r), obs,
                           oc).amin(1)
        if control:
            p = ref.Prec.control()
            f_p, c_p, d_p = (v.double() for v in ref.plan_cost(
                p, self.body, *(a.to(p.work) for a in (x, head, tail, obs)),
                self.n, cost_cfg, o))
            cert_p = ref.svsdf(self.body, ref.Traj(p, c_p.float(),
                                                   d_p.float()),
                               obs.float(), oc).amin(1).double()
        else:
            f_p, c_p, d_p, cert_p = (pick(k).double() for k in (
                "cost", "coeffs", "durations", "cert_min"))
        tau = torch.as_tensor(problems.tau_of(self.pcfg.inittime, self.n),
                              dtype=torch.float64, device=dev)
        x0 = torch.cat([tau.expand(len(rows), -1),
                        states[:, 1:-1].reshape(len(rows), -1)], 1)
        f_0 = ref.plan_cost(r64, self.body, x0, head, tail, obs, self.n,
                            cost_cfg, o)[0]
        ts = torch.linspace(0, 1, 64, dtype=torch.float64, device=dev)[None] \
            * d_r.sum(1, keepdim=True)
        pose = lambda c, d: ref.eval_traj(r64, c, d, ts)
        return {
            "front_end_mismatches": int(front_bad.sum()),
            "traj_gap_m": float((pose(c_p, d_p) - pose(c_r, d_r)).abs().max()),
            **_spread("cost_gap_rel", (f_p - f_r).abs() / f_r.abs()),
            **_spread("cert_gap_m", (cert_p - cert_r).abs()),
            "cert_overstated": int((pick("front_ok") & (cert_p > 0.0)
                                    & (cert_r <= 0.0)).sum()),
            "cost_left": float((f_r / f_0).mean()),
            "unsolved_share": 100.0 * float(
                ((x - x0).abs().amax(1) <= 1e-3).double().mean()),
        }


ENTRIES = {"staged": Staged, "grid": Grid, "e2e": E2E}


def sample_rows(counts, k: int, rng: np.random.Generator, whole: bool):
    """k sampled answers out of requests with ``counts`` rows each, drawn
    from ``rng``: (request, row) pairs. With ``whole`` a sample is a whole
    request (row None), and the last request is always in."""
    n = len(counts)
    if whole:
        pick = set(rng.choice(n, size=min(k, n), replace=False).tolist())
        pick.add(n - 1)
        return sorted((i, None) for i in pick)
    flat = np.concatenate([[0], np.cumsum(counts)])
    idx = rng.choice(flat[-1], size=min(k, flat[-1]), replace=False)
    rows = {(int(i), int(j - flat[i])) for j in idx
            for i in [int(np.searchsorted(flat, j, side="right") - 1)]}
    return sorted(rows)

