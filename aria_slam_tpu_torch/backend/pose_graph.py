"""SE3 pose-graph optimisation: Levenberg-Marquardt with matrix-free
block-Jacobi PCG (counterpart of the JAX package's backend/pose_graph.py).

Per-edge 6x6 Jacobian blocks come from autodiff of the residual, all
edges in one reverse pass (core/autodiff.py), the normal-equation
matvec is two index_add segment sums, and the solve is a fixed number
of preconditioned CG iterations. Capacities are padded; masked edges
carry zero weight. Updates are functional: each call returns a new
PoseGraph, as the reference does.

Residual (right perturbation): r_e = log(T_meas^-1 (T_i e^xi_i)^-1 (T_j e^xi_j)).
"""

from __future__ import annotations

import threading

import torch

from aria_slam_tpu_torch.config import PoseGraphConfig
from aria_slam_tpu_torch.core import lie
from aria_slam_tpu_torch.core.autodiff import row_jacobian
from aria_slam_tpu_torch.core.types import PoseGraph
from aria_slam_tpu_torch.ops.linalg import inv_psd
from aria_slam_tpu_torch.utils.profiling import count, span


def init_graph(cfg: PoseGraphConfig, device="cuda") -> PoseGraph:
    n, e = cfg.max_nodes, cfg.max_edges
    f32 = dict(dtype=torch.float32, device=device)
    eye4 = torch.eye(4, **f32)
    return PoseGraph(
        node_pose=eye4.repeat(n, 1, 1),
        node_valid=torch.zeros((n,), dtype=torch.bool, device=device),
        edge_i=torch.zeros((e,), dtype=torch.int32, device=device),
        edge_j=torch.zeros((e,), dtype=torch.int32, device=device),
        edge_rel=eye4.repeat(e, 1, 1),
        edge_weight=torch.zeros((e,), **f32),
        edge_twt=torch.ones((e,), **f32),
        edge_rwt=torch.ones((e,), **f32),
        edge_valid=torch.zeros((e,), dtype=torch.bool, device=device),
        num_nodes=torch.zeros((), dtype=torch.int32, device=device),
        num_edges=torch.zeros((), dtype=torch.int32, device=device),
    )


def _set(x: torch.Tensor, idx, value) -> torch.Tensor:
    out = x.clone()
    out[idx] = value
    return out


def set_node(g: PoseGraph, idx: int, pose: torch.Tensor) -> PoseGraph:
    """Parity: setInitialPose / vertex insert."""
    return g.replace(
        node_pose=_set(g.node_pose, idx, pose),
        node_valid=_set(g.node_valid, idx, True),
        num_nodes=torch.clamp(g.num_nodes, min=idx + 1),
    )


def _add_edge(g: PoseGraph, i, j, rel, weight, t_weight=1.0, r_weight=1.0) -> PoseGraph:
    """Append one edge at slot num_edges; a full buffer drops it."""
    slot = g.num_edges.long()
    cap = g.edge_i.shape[0]
    ok = slot < cap
    safe = torch.where(ok, slot, cap - 1)

    def put(x, value):
        value = torch.as_tensor(value, dtype=x.dtype, device=x.device)
        return _set(x, safe, torch.where(ok, value, x[safe]))

    return g.replace(
        edge_i=put(g.edge_i, i),
        edge_j=put(g.edge_j, j),
        edge_rel=put(g.edge_rel, rel),
        edge_weight=put(g.edge_weight, weight),
        edge_twt=put(g.edge_twt, t_weight),
        edge_rwt=put(g.edge_rwt, r_weight),
        edge_valid=put(g.edge_valid, True),
        num_edges=torch.where(ok, g.num_edges + 1, g.num_edges),
    )


def _put_rows(x: torch.Tensor, idx: torch.Tensor, values) -> torch.Tensor:
    """x with rows `idx` set to `values`; an index at or past the end is
    dropped (it lands in a scratch row that is cut off again), with no
    read of the index on the host."""
    n = x.shape[0]
    buf = torch.cat([x, x[:1]])
    buf[idx.long().clamp(max=n)] = values
    return buf[:n]


def extend_chain(g: PoseGraph, poses, rels, first_node,
                 t_weight=1.0, r_weight=1.0) -> PoseGraph:
    """Append C chain nodes and their odometry edges in one call: node
    ids first_node..first_node+C-1 with world poses `poses` (C, 4, 4) and
    edges (i-1 -> i) measuring `rels` (C, 4, 4) = T_{i-1}^-1 T_i.
    t_weight / r_weight: translation / rotation weight of the chain
    edges. Nodes and edges past the capacities are dropped."""
    c = poses.shape[0]
    dev = g.node_pose.device
    steps = torch.arange(c, dtype=torch.int32, device=dev)
    node_idx = torch.as_tensor(first_node, dtype=torch.int32, device=dev) + steps
    slots = g.num_edges + steps
    f32 = dict(dtype=torch.float32, device=dev)
    return g.replace(
        node_pose=_put_rows(g.node_pose, node_idx, poses),
        node_valid=_put_rows(g.node_valid, node_idx, True),
        edge_i=_put_rows(g.edge_i, slots, node_idx - 1),
        edge_j=_put_rows(g.edge_j, slots, node_idx),
        edge_rel=_put_rows(g.edge_rel, slots, rels),
        edge_weight=_put_rows(g.edge_weight, slots, 1.0),
        edge_twt=_put_rows(g.edge_twt, slots, torch.as_tensor(t_weight, **f32).expand(c)),
        edge_rwt=_put_rows(g.edge_rwt, slots, torch.as_tensor(r_weight, **f32).expand(c)),
        edge_valid=_put_rows(g.edge_valid, slots, True),
        num_nodes=torch.clamp(torch.maximum(g.num_nodes, node_idx[-1] + 1),
                              max=g.node_pose.shape[0]),
        num_edges=torch.clamp(g.num_edges + c, max=g.edge_i.shape[0]),
    )


def add_edges_batch(g: PoseGraph, i_idx, j_idx, rels, weight, valid,
                    t_weight=1.0) -> PoseGraph:
    """Append a batch of edges in one call. An entry with valid=False
    still takes a slot but carries edge_valid=False and weight 0; slots
    past the capacity are dropped."""
    e = i_idx.shape[0]
    dev = g.node_pose.device
    slots = g.num_edges + torch.arange(e, dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    w = torch.as_tensor(weight, **f32).expand(e)
    return g.replace(
        edge_i=_put_rows(g.edge_i, slots, torch.as_tensor(i_idx, device=dev).to(torch.int32)),
        edge_j=_put_rows(g.edge_j, slots, torch.as_tensor(j_idx, device=dev).to(torch.int32)),
        edge_rel=_put_rows(g.edge_rel, slots, rels),
        edge_weight=_put_rows(g.edge_weight, slots, torch.where(valid, w, 0.0)),
        edge_twt=_put_rows(g.edge_twt, slots, torch.as_tensor(t_weight, **f32).expand(e)),
        edge_rwt=_put_rows(g.edge_rwt, slots, 1.0),
        edge_valid=_put_rows(g.edge_valid, slots, valid),
        num_edges=torch.clamp(g.num_edges + e, max=g.edge_i.shape[0]),
    )


def add_odometry_edge(g: PoseGraph, i, j, rel, cfg: PoseGraphConfig,
                      r_weight=1.0) -> PoseGraph:
    """Parity: addOdometryEdge, weight 1; r_weight > 1 pins a gyro rotation."""
    return _add_edge(g, i, j, rel, 1.0, r_weight=r_weight)


def add_loop_edge(g: PoseGraph, i, j, rel, cfg: PoseGraphConfig,
                  t_weight=1.0) -> PoseGraph:
    """Parity: addLoopEdge at cfg.loop_edge_weight (10x)."""
    return _add_edge(g, i, j, rel, cfg.loop_edge_weight, t_weight)


def select(ok: torch.Tensor, a: PoseGraph, b: PoseGraph) -> PoseGraph:
    """Leaf-wise where(ok, a, b) over two graphs."""
    return PoseGraph(**{k: torch.where(ok, getattr(a, k), getattr(b, k))
                        for k in a.__dataclass_fields__})


# ------------------------------------------------------------------ residuals
def _edge_residual(Ti, Tj, Tm, xi_i, xi_j):
    Ti_p = Ti @ lie.se3_exp(xi_i)
    Tj_p = Tj @ lie.se3_exp(xi_j)
    return lie.se3_log(lie.se3_inverse(Tm) @ lie.se3_inverse(Ti_p) @ Tj_p)


def _edge_residuals_and_jacobians(node_pose, g: PoseGraph):
    """Residuals (E, 6) and Jacobian blocks (E, 6, 6) x 2 at xi = 0."""
    Ti = node_pose[g.edge_i.long()]
    Tj = node_pose[g.edge_j.long()]
    Tm = g.edge_rel
    zero = torch.zeros(Tm.shape[:-2] + (12,), dtype=node_pose.dtype,
                       device=node_pose.device)

    def rows(x):  # (E, C, 12) perturbations [xi_i, xi_j] -> (E, C, 6)
        return _edge_residual(Ti[:, None], Tj[:, None], Tm[:, None],
                              x[..., :6], x[..., 6:])

    r = _edge_residual(Ti, Tj, Tm, zero[:, :6], zero[:, 6:])
    J = row_jacobian(rows, zero, 6)  # (E, 6, 12)
    return r, J[..., :6], J[..., 6:]


def _edge_weight6(g: PoseGraph):
    """(E, 6) per-component weights: edge weight with the translation
    components scaled by edge_twt and the rotation ones by edge_rwt."""
    w = g.edge_weight * g.edge_valid.float()
    comp = torch.stack([g.edge_twt] * 3 + [g.edge_rwt] * 3, -1)
    return w[:, None] * comp


def _graph_cost(g: PoseGraph, node_pose):
    zero = torch.zeros(6, dtype=node_pose.dtype, device=node_pose.device)
    r = _edge_residual(node_pose[g.edge_i.long()], node_pose[g.edge_j.long()],
                       g.edge_rel, zero, zero)
    return torch.sum(_edge_weight6(g) * r * r)


# ---------------------------------------------------------------------- solve
def _solve_normal_eqs(g: PoseGraph, r, Ji, Jj, lam, cg_iters):
    """PCG on (J^T W J + lam I) x = -J^T W r with node 0 gauge-fixed."""
    n = g.node_pose.shape[0]
    dev = g.node_pose.device
    w6 = _edge_weight6(g)
    ei, ej = g.edge_i.long(), g.edge_j.long()
    free = g.node_valid & (torch.arange(n, device=dev) != 0)
    freef = free.float()[:, None]

    def scatter(idx, vals):
        return torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype,
                           device=dev).index_add_(0, idx, vals)

    def hvp(x):
        x = x * freef
        y = (torch.einsum("eab,eb->ea", Ji, x[ei])
             + torch.einsum("eab,eb->ea", Jj, x[ej])) * w6
        out = (scatter(ei, torch.einsum("eba,eb->ea", Ji, y))
               + scatter(ej, torch.einsum("eba,eb->ea", Jj, y)))
        return (out + lam * x) * freef

    wr = r * w6
    b = -(scatter(ei, torch.einsum("eba,eb->ea", Ji, wr))
          + scatter(ej, torch.einsum("eba,eb->ea", Jj, wr)))
    b = b * freef

    # block-Jacobi preconditioner: per-node 6x6 diagonal blocks
    blocks = (scatter(ei, torch.einsum("eba,ebc->eac", Ji, Ji * w6[:, :, None]))
              + scatter(ej, torch.einsum("eba,ebc->eac", Jj, Jj * w6[:, :, None])))
    blocks = blocks + (lam + 1e-6) * torch.eye(6, device=dev)
    Minv = inv_psd(blocks)

    def precond(x):
        return torch.einsum("nab,nb->na", Minv, x) * freef

    x = torch.zeros_like(b)
    rr = b
    z = precond(rr)
    p = z
    for _ in range(cg_iters):
        Ap = hvp(p)
        rz = torch.sum(rr * z)
        denom = torch.sum(p * Ap)
        alpha = rz / torch.where(torch.abs(denom) < 1e-20, 1e-20, denom)
        x = x + alpha * p
        rr = rr - alpha * Ap
        z = precond(rr)
        beta = torch.sum(rr * z) / torch.where(torch.abs(rz) < 1e-20, 1e-20, rz)
        p = z + beta * p
    return x


class _LMStep:
    """One LM iteration over buffers it updates in place: `graph` (the
    graph's fields, its node_pose the poses being optimised) and `lam`
    (the damping). Its three parts hand the residuals, the Jacobians and
    the step on through attributes. In place, so that a CUDA graph
    captured from a part reads and writes the same memory at every
    replay."""

    def __init__(self, graph: PoseGraph, lam: torch.Tensor, cg_iterations: int):
        self.graph, self.lam, self.cg_iterations = graph, lam, cg_iterations
        self.parts = (self.linearize, self.pcg, self.accept)

    def load(self, g: PoseGraph, init_lambda: float):
        """Copy g's fields into the buffers and reset the damping."""
        for f in PoseGraph.__dataclass_fields__:
            getattr(self.graph, f).copy_(getattr(g, f))
        self.lam.fill_(init_lambda)

    def linearize(self):
        self.r, self.Ji, self.Jj = _edge_residuals_and_jacobians(self.graph.node_pose,
                                                                 self.graph)

    def pcg(self):
        self.dx = _solve_normal_eqs(self.graph, self.r, self.Ji, self.Jj, self.lam,
                                    self.cg_iterations)

    def accept(self):
        poses, lam = self.graph.node_pose, self.lam
        trial = poses @ lie.se3_exp(self.dx)
        accept = _graph_cost(self.graph, trial) < _graph_cost(self.graph, poses)
        poses.copy_(torch.where(accept, trial, poses))
        lam.copy_(torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6))


def _static_step(g: PoseGraph, cfg: PoseGraphConfig) -> _LMStep:
    """An _LMStep over buffers of its own, shaped and filled as g."""
    own = {f: getattr(g, f).clone() for f in PoseGraph.__dataclass_fields__}
    lam = torch.full((), cfg.init_lambda, dtype=torch.float32, device=g.node_pose.device)
    return _LMStep(g.replace(**own), lam, cfg.cg_iterations)


# Captured LM iterations by what shapes them: (device, dtype, max_nodes,
# max_edges, cg_iterations) -> (_LMStep, its parts' replays). Kept for
# the process, since each sequence makes a fresh evaluator and graph; the
# lock keeps one caller at a time on an entry's buffers.
_CAPTURED: dict = {}
_CAPTURED_LOCK = threading.Lock()
WARMUP_ITERATIONS = 3
_SPANS = ("pose_graph.linearize", "pose_graph.pcg", "pose_graph.accept")


def _capture(g: PoseGraph, cfg: PoseGraphConfig):
    """An _LMStep on g's device with its three parts captured as CUDA
    graphs, after WARMUP_ITERATIONS eager iterations on a side stream (as
    torch asks before capturing autograd and cuBLAS work)."""
    step = _static_step(g, cfg)
    with torch.cuda.device(g.node_pose.device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP_ITERATIONS):
                for part in step.parts:
                    part()
        torch.cuda.current_stream().wait_stream(side)
        graphs = []
        for part in step.parts:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                part()
            graphs.append(graph)
    count("pose_graph.eager_iters", WARMUP_ITERATIONS)
    count("pose_graph.captures")
    return step, tuple(graph.replay for graph in graphs)


def _iterate(parts, iters: int):
    for _ in range(iters):
        for name, part in zip(_SPANS, parts):
            with span(name):
                part()


def optimize(g: PoseGraph, cfg: PoseGraphConfig, iterations: int | None = None) -> PoseGraph:
    """LM loop: each iteration solves the damped normal equations by PCG,
    retracts, and accepts or rejects by cost (_LMStep). On a CUDA device
    the iteration's three parts replay CUDA graphs, captured at the first
    call for the graph's device, dtype, capacities and cg_iterations and
    replayed by every later call, whatever its iteration count; elsewhere
    they run op by op. Each iteration's spans (utils/profiling.span,
    recorded while a profiler records): pose_graph.linearize (the
    residuals with their autodiff Jacobians), pose_graph.pcg
    (_solve_normal_eqs), pose_graph.accept (the retract, the two costs
    and the accept / reject). Counters: pose_graph.graphed_iters and
    pose_graph.eager_iters (iterations replayed and run op by op, a
    capture's warm-up among the latter), pose_graph.captures."""
    iters = cfg.lm_iterations if iterations is None else iterations
    if g.node_pose.is_cuda and iters > 0:
        key = (g.node_pose.device, g.node_pose.dtype, g.node_pose.shape[0],
               g.edge_i.shape[0], cfg.cg_iterations)
        with _CAPTURED_LOCK:
            if key not in _CAPTURED:
                _CAPTURED[key] = _capture(g, cfg)
            step, replays = _CAPTURED[key]
            step.load(g, cfg.init_lambda)
            count("pose_graph.graphed_iters", iters)
            _iterate(replays, iters)
            # a copy: the next call on this entry overwrites its buffers
            return g.replace(node_pose=step.graph.node_pose.clone())
    step = _static_step(g, cfg)
    count("pose_graph.eager_iters", iters)
    _iterate(step.parts, iters)
    return g.replace(node_pose=step.graph.node_pose)


def get_pose(g: PoseGraph, idx):
    """Parity: getOptimizedPose."""
    return g.node_pose[idx]
