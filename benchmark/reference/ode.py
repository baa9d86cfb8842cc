"""Plain explicit solvers of the reference: an adaptive Dormand-Prince 5(4)
with a clock and a step size of its own in every lane, and fixed-step RK4.

Nothing here comes from the program: the tableau, the controller and the
dense output are the textbook ones (Dormand & Prince 1980; the continuous
extension as Hairer, Norsett & Wanner II.6 and SciPy's RK45 give it).  The
clock is float64 whatever the working precision of the states, so a long
recording keeps its step sizes exact.
"""

from __future__ import annotations

import torch

C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
A = ((),
     (1 / 5,),
     (3 / 40, 9 / 40),
     (44 / 45, -56 / 15, 32 / 9),
     (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
     (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
     (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84))
B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
# fifth-order minus embedded fourth-order weights
E = (71 / 57600, 0.0, -71 / 16695, 71 / 1920, -17253 / 339200, 22 / 525,
     -1 / 40)
# continuous extension: y(t0 + s h) = y0 + h sum_i K_i sum_j P[i][j] s^(j+1)
P = ((1.0, -2.8535800653862835, 3.0717434641059005, -1.1270175653862835),
     (0.0, 0.0, 0.0, 0.0),
     (0.0, 4.023133379230305, -6.249321565289, 2.675424484351598),
     (0.0, -3.7324019615885042, 10.068970589843675, -5.685526961588504),
     (0.0, 2.5548038301849423, -6.399112377351017, 3.5219323679207912),
     (0.0, -1.3744241142186024, 3.272657752246729, -1.7672812570757455),
     (0.0, 1.3824689317781436, -3.764937863556287, 2.382468931778144))
SAFETY, FAC_MIN, FAC_MAX = 0.9, 0.2, 10.0


class Steps:
    """Every iteration of a lane solve: start time t0 [L, n] (float64),
    step h [L, n], start state y0 [L, n, S] and the dense-output
    coefficients q [L, n, 4, S].  An iteration in which a lane did not
    advance holds h = 1 and q = 0, so its dense output is its state."""

    def __init__(self, t0, h, y0, q, iterations: int, rejected: int):
        self.t0, self.h, self.y0, self.q = t0, h, y0, q
        self.iterations, self.rejected = iterations, rejected

    def at(self, lanes: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
        """States [len(lanes), M, S] of the given lanes at times tau
        [len(lanes), M] (float64), by the step that holds each time."""
        t0 = self.t0[lanes]
        idx = torch.searchsorted(t0, tau, right=True) - 1
        idx = idx.clamp(min=0)
        s = (tau - torch.gather(t0, 1, idx)) / torch.gather(self.h[lanes], 1,
                                                             idx)
        y0 = self.y0[lanes]
        q = self.q[lanes]
        n_s = y0.shape[-1]
        y = torch.gather(y0, 1, idx[..., None].expand(-1, -1, n_s))
        qi = torch.gather(q, 1, idx[..., None, None].expand(-1, -1, 4, n_s))
        h = torch.gather(self.h[lanes], 1, idx)
        s = s.to(y.dtype)[..., None]
        poly = qi[:, :, 3] * s
        for j in (2, 1, 0):
            poly = (poly + qi[:, :, j]) * s
        return y + h.to(y.dtype)[..., None] * poly


def dopri5_lanes(rhs, y0: torch.Tensor, t_end: torch.Tensor, *, rtol: float,
                 atol: float, h0: float, h_max: float,
                 max_iterations: int = 2_000_000, block: int = 64) -> Steps:
    """Solve dy/dt = rhs(t, y) from t = 0 to t_end [L] in every lane of y0
    [L, S], each lane with its own step size (no lane waits for another).
    rhs(t [L] float64, y [L, S]) -> [L, S].  Error norm: the RMS of err /
    (atol + rtol max(|y|, |y1|)) over a lane's states; a step is taken when
    it is <= 1.  Iterations run in blocks of ``block``; on a CUDA device
    each block after the first is one replay of a CUDA graph of the same
    operations (the launches, not the arithmetic, are what a block costs).
    Raises when a lane's step size collapses or the iteration budget runs
    out."""
    dev, dt = y0.device, y0.dtype
    n_lanes, n_s = y0.shape
    f64 = torch.float64
    st = {"t": torch.zeros(n_lanes, dtype=f64, device=dev),
          "h": torch.full((n_lanes,), float(h0), dtype=f64, device=dev),
          "y": y0.clone(),
          "rej": torch.zeros(n_lanes, dtype=torch.int64, device=dev)}
    st["f"] = rhs(st["t"], st["y"])
    t_end = t_end.to(f64)
    st["active"] = st["t"] < t_end
    pt = torch.tensor(P, dtype=dt, device=dev)               # [7, 4]
    rec = {"t0": torch.empty((n_lanes, block), dtype=f64, device=dev),
           "h": torch.empty((n_lanes, block), dtype=f64, device=dev),
           "y0": torch.empty((n_lanes, block, n_s), dtype=dt, device=dev),
           "q": torch.empty((n_lanes, block, 4, n_s), dtype=dt, device=dev)}

    def iteration(j: int) -> None:
        t, h, y, f, active = st["t"], st["h"], st["y"], st["f"], st["active"]
        h_eff = torch.minimum(h, t_end - t)
        h_eff = torch.where(active, h_eff, torch.ones_like(h_eff))
        hd = h_eff.to(dt)[:, None]
        ks = [f]
        for i in range(1, 7):
            yi = y
            for k, a in enumerate(A[i]):
                if a != 0.0:
                    yi = yi + (hd * a) * ks[k]
            ks.append(rhs(t + C[i] * h_eff, yi))
        y1 = y
        err = torch.zeros_like(y)
        for k in range(7):
            if B[k] != 0.0:
                y1 = y1 + (hd * B[k]) * ks[k]
            err = err + (hd * E[k]) * ks[k]
        scale = atol + rtol * torch.maximum(y.abs(), y1.abs())
        ratio = torch.sqrt(torch.mean((err / scale) ** 2, dim=-1))
        ratio = torch.where(torch.isfinite(ratio), ratio,
                            torch.full_like(ratio, 1e30)).to(f64)
        take = active & (ratio <= 1.0)
        q = torch.einsum("lis,ij->ljs", torch.stack(ks, dim=1), pt)
        rec["t0"][:, j] = t
        rec["h"][:, j] = torch.where(take, h_eff, torch.ones_like(h_eff))
        rec["y0"][:, j] = y
        rec["q"][:, j] = torch.where(take[:, None, None], q,
                                     torch.zeros_like(q))
        st["rej"].add_((active & ~take).to(torch.int64))
        t_new = torch.where(take, t + h_eff, t)
        t_new = torch.where(take & (t_end - t_new <= 1e-12 * t_end), t_end,
                            t_new)
        fac = SAFETY * ratio.clamp(min=1e-10) ** -0.2
        fac = torch.where(take, fac.clamp(FAC_MIN, FAC_MAX),
                          fac.clamp(FAC_MIN, 1.0))
        st["h"].copy_(torch.where(active, (h_eff * fac).clamp(max=h_max), h))
        st["y"].copy_(torch.where(take[:, None], y1, y))
        st["f"].copy_(torch.where(take[:, None], ks[6], f))
        st["t"].copy_(t_new)
        st["active"].copy_(t_new < t_end)

    def run_block() -> None:
        for j in range(block):
            iteration(j)

    graph = None
    blocks = []
    while True:
        if graph is not None:
            graph.replay()
        elif dev.type == "cuda":
            # the first block runs eagerly on a side stream (the capture's
            # warm-up), then the same block is captured, not run
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                run_block()
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                run_block()
        else:
            run_block()
        blocks.append({k: v.clone() for k, v in rec.items()})
        if not bool(st["active"].any()):
            break
        if len(blocks) * block >= max_iterations:
            raise RuntimeError(f"dopri5_lanes: {int(st['active'].sum())} "
                               f"lanes unfinished after {max_iterations} "
                               f"iterations")
        if bool((st["h"][st["active"]] < 1e-9).any()):
            raise RuntimeError("dopri5_lanes: a step size collapsed")
    cat = {k: torch.cat([b[k] for b in blocks], dim=1) for k in rec}
    return Steps(cat["t0"], cat["h"], cat["y0"], cat["q"],
                 iterations=len(blocks) * block,
                 rejected=int(st["rej"].max()))


def rk4_stage_times(ts, n_sub: int) -> torch.Tensor:
    """The times at which classical RK4 with n_sub equal steps on each
    output interval of ts evaluates its right-hand side, in order (t, t +
    h/2, t + h/2, t + h for each step), float64."""
    ts = ts.to(torch.float64)
    h = (ts[1:] - ts[:-1]) / n_sub                           # [T - 1]
    i = torch.arange(n_sub, dtype=torch.float64, device=ts.device)
    t = ts[:-1, None] + i[None] * h[:, None]                 # [T - 1, n]
    frac = torch.tensor([0.0, 0.5, 0.5, 1.0], dtype=torch.float64,
                        device=ts.device)
    return (t[..., None] + frac * h[:, None, None]).reshape(-1)


def rk4(rhs, y0: torch.Tensor, ts, n_sub: int) -> torch.Tensor:
    """Classical RK4 with n_sub equal steps on each output interval of ts
    (host floats): states [T, ...] at ts (y0 first).  rhs(j, y) is called
    with j, the index of its time in ``rk4_stage_times(ts, n_sub)``, so a
    driving input can be looked up there.  Differentiable by autograd."""
    ts = [float(x) for x in ts]
    ys, y, j = [y0], y0, 0
    for t0, t1 in zip(ts[:-1], ts[1:]):
        h = (t1 - t0) / n_sub
        for _ in range(n_sub):
            k1 = rhs(j, y)
            k2 = rhs(j + 1, torch.add(y, k1, alpha=h / 2))
            k3 = rhs(j + 2, torch.add(y, k2, alpha=h / 2))
            k4 = rhs(j + 3, torch.add(y, k3, alpha=h))
            y = torch.add(y, k1 + 2 * (k2 + k3) + k4, alpha=h / 6)
            j += 4
        ys.append(y)
    return torch.stack(ys)
