"""GPAD (Patrinos and Bemporad, IEEE TAC 59(1), 2014) on a condensed QP, plain.

The accelerated dual gradient projection of the paper's Algorithm 2, with
the schedule of its eq. (8e) and, where asked, O'Donoghue and Candes'
adaptive restart, batched over scenarios and run in float64 with plain
torch products. The dual gradient's Lipschitz constant is worked out here
from the QP: lambda_max(G H^-1 G') as the largest eigenvalue of
C^-1 G'G C^-T with H = C C'. Nothing of the program under test is used.

``tf32=True`` gives the same loop in float32 with every product's
operands rounded to the nearest TF32 value (10 explicit mantissa bits, the
precision one step below float32 with TF32 off): put in the program's
place, it is one of the benchmark's two controls (``control.py``), which
the comparison that decides ``correct`` has to fail.
"""

from __future__ import annotations

import numpy as np
import torch


def lipschitz(H: np.ndarray, G: np.ndarray) -> float:
    C = np.linalg.cholesky(H)
    W = np.linalg.solve(C, G.T)  # C^-1 G'
    return float(np.linalg.eigvalsh(W @ W.T)[-1])


def schedule(iterations: int) -> tuple[np.ndarray, np.ndarray]:
    """theta_0 = 1, theta_{k+1} = theta_k (sqrt(theta_k^2 + 4) - theta_k) / 2,
    beta_0 = 0, beta_k = theta_k (1 / theta_{k-1} - 1)."""
    theta = np.ones(iterations + 1)
    for k in range(iterations):
        t = theta[k]
        theta[k + 1] = t * (np.sqrt(t * t + 4.0) - t) / 2.0
    beta = np.zeros(iterations)
    beta[1:] = theta[1:iterations] * (1.0 / theta[:iterations - 1] - 1.0)
    return theta[:iterations], beta


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (ties away from zero)."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class Gpad:
    """The dual operands of one QP on ``device``, and the loop over them."""

    def __init__(self, qp, iterations: int, device, tf32: bool = False):
        self.iterations = iterations
        self.tf32 = tf32
        self.dtype = torch.float32 if tf32 else torch.float64
        self.n_u = qp.n_u
        L = lipschitz(qp.H, qp.G)
        theta, beta = schedule(iterations)

        def t(a):
            return torch.tensor(np.ascontiguousarray(a), dtype=self.dtype,
                                device=device)

        self.MG_T = t(np.linalg.solve(qp.H, qp.G.T).T)  # (m, n_z): rows H^-1 g_i
        self.GL_T = t(qp.G.T / L)  # (n_z, m)
        self.gP_map = t(np.linalg.solve(qp.H, qp.F.T).T)  # (n_x, n_z)
        self.pD_map = t(-qp.E.T / L)  # (n_x, m)
        self.pD_const = t(-qp.b0 / L)
        self.theta = t(theta)
        self.beta = t(beta)

    def _mm(self, a, b):
        if self.tf32:
            return round_tf32(a) @ round_tf32(b)
        return a @ b

    def solve(self, X0: torch.Tensor, y0: torch.Tensor | None = None,
              restart: bool = False):
        """z (B, n_z) and y (B, m) after the fixed budget, from y0 (or 0)
        for the dual and 0 for the primal average."""
        X0 = X0.to(self.dtype)
        g_P = X0 @ self.gP_map
        p_D = X0 @ self.pD_map + self.pD_const
        B, m = X0.shape[0], self.MG_T.shape[0]
        y = (torch.zeros((B, m), dtype=self.dtype, device=X0.device)
             if y0 is None else y0.to(self.dtype).clone())
        y_prev = y
        z = torch.zeros((B, self.MG_T.shape[1]), dtype=self.dtype,
                        device=X0.device)
        th = torch.ones(B, dtype=self.dtype, device=X0.device)
        th_prev = th
        for k in range(self.iterations):
            if restart:
                theta_k, beta_k = th[:, None], (th * (1.0 / th_prev - 1.0))[:, None]
            else:
                theta_k, beta_k = self.theta[k], self.beta[k]
            w = y + beta_k * (y - y_prev)
            zhat = -self._mm(w, self.MG_T) - g_P
            z = (1.0 - theta_k) * z + theta_k * zhat
            y_next = torch.clamp_min(w + self._mm(zhat, self.GL_T) + p_D, 0.0)
            if restart:
                # restart where the momentum opposes the gradient step
                reset = ((w - y_next) * (y_next - y)).sum(-1) > 0.0
                th, th_prev = (
                    torch.where(reset, 1.0, th * (torch.sqrt(th * th + 4.0) - th) / 2.0),
                    torch.where(reset, 1.0, th),
                )
                y_prev = torch.where(reset[:, None], y_next, y)
            else:
                y_prev = y
            y = y_next
        return z, y

    def replayed(self, batch: int, restart: bool, device):
        """``solve(X0, y0, restart)`` for ``batch`` scenarios, warm-started,
        as one CUDA graph of the same loop on a CUDA device (the loop's
        2,000 small launches a solve cost the host more than the card
        spends on them), or the loop itself elsewhere. Each call's results
        are overwritten by the next."""
        if torch.device(device).type != "cuda":
            return lambda X0, y0: self.solve(X0, y0, restart)
        X0 = torch.zeros((batch, self.gP_map.shape[0]), dtype=self.dtype,
                         device=device)
        y0 = torch.zeros((batch, self.MG_T.shape[0]), dtype=self.dtype,
                         device=device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self.solve(X0, y0, restart)  # warm-up before the capture
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = self.solve(X0, y0, restart)

        def run(X, y):
            X0.copy_(X)
            y0.copy_(y)
            graph.replay()
            return out
        return run
