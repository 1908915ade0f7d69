"""Reference-parity optimizers (host drivers + quadratic solvers).

Counterpart of ``pygpr_tpu/optimize/classic.py`` (NumPy and SciPy,
copied so that the port imports nothing of the JAX package), the
reference optimizer layer (``PyGPR/opt.py``) one for one:

  * :class:`CG` / :class:`NelderMead` — SciPy-backed drivers
    (``opt.py:29-78``, ``:81-122``) over a NumPy-facing loss
    (:class:`pygpr_torch.models.likelihood.MLE`: f64 NumPy in, the
    model's tensors on their device, f64 NumPy out).  These are the
    *validation* path; the production path is ``optimize.lbfgs``.
  * :func:`hessian` — FD Hessian from a jac callable (``opt.py:125-136``).
  * :class:`CGQuad` / :class:`BFGSQuad` — the reference's hand-rolled
    quadratic-objective linear-CG and BFGS (``opt.py:139-208``,
    ``:211-295``), including the forward-difference Hessian-vector
    product (``opt.py:161-163``) and the un-line-searched BFGS step
    (``opt.py:248-269``).

Behavioral parity notes: CG writes the result back into the model even
on optimizer failure (``opt.py:61-65``); Nelder-Mead does **not**
(``opt.py:111-114``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import scipy.optimize as scopt
import torch

from pygpr_torch.utils.trace import OptTrace


def _model_params(loss) -> np.ndarray:
    """The loss's model parameters as f64 NumPy (a tensor may live on
    the card)."""
    p = loss.model.params
    return np.asarray(p.detach().cpu() if isinstance(p, torch.Tensor) else p, dtype=np.float64)


class Opt:
    """Base optimizer (reference ``Opt``, ``opt.py:11-26``)."""

    def __init__(self, loss, par: Optional[np.ndarray] = None) -> None:
        self.loss = loss
        self.args: dict = {}
        self.x: Optional[np.ndarray] = None

    def minimize(self):
        raise NotImplementedError

    def step(self):
        raise NotImplementedError


class CG(Opt):
    """SciPy conjugate-gradient driver (reference ``CG``, ``opt.py:29-78``)."""

    def __init__(self, loss, trace_path: str = "opt.dat") -> None:
        super().__init__(loss)
        self.args = {
            "gtol": 1e-4,
            "maxiter": 1000,
            "disp": False,
            "return_all": True,
        }
        self.res = None
        self.trace_path = trace_path

    def minimize(self) -> None:
        params = _model_params(self.loss)

        with OptTrace(self.trace_path) as tr:

            def callback(p):
                gn = (
                    np.linalg.norm(self.loss.grad_value)
                    if self.loss.grad_value is not None
                    else None
                )
                tr.log(p, self.loss.loss_value, gn)

            self.res = scopt.minimize(
                self.loss.loss_and_grad,
                params,
                method="CG",
                jac=True,
                callback=callback,
                options=self.args,
            )

        # Parity: write back even on failure (opt.py:61-65).
        self.loss.model.set_params(self.res.x)
        self.x = self.res.x
        if not self.res.success:
            print("Optimizer Failed")


class NelderMead(Opt):
    """SciPy Nelder-Mead driver (reference ``Nelder_Mead``,
    ``opt.py:81-122``)."""

    def __init__(self, loss, trace_path: str = "opt.dat") -> None:
        super().__init__(loss)
        self.args = {
            "fatol": 1e-4,
            "maxiter": 1000,
            "disp": False,
            "return_all": True,
        }
        self.res = None
        self.trace_path = trace_path

    def minimize(self) -> None:
        params = _model_params(self.loss)
        with OptTrace(self.trace_path) as tr:
            self.res = scopt.minimize(
                self.loss.loss,
                params,
                method="Nelder-Mead",
                callback=lambda p: tr.log(p, self.loss.loss_value),
                options=self.args,
            )
        self.x = self.res.x
        if self.res.success:
            # Parity: NM does NOT write back on failure (opt.py:111-114).
            self.loss.model.set_params(self.res.x)
        else:
            print("Optimizer Failed")


def hessian(
    x: np.ndarray, jac: Callable[..., np.ndarray], eps: float
) -> np.ndarray:
    """Dense forward-difference Hessian (reference ``opt.py:125-136``)."""
    dim = x.shape[-1]
    hess = np.empty([dim, dim])
    for i in range(dim):
        x_eps = np.copy(x)
        x_eps[i] += eps
        hess[:, i] = (jac(x_eps) - jac(x)) / eps
    return hess


class CGQuad(Opt):
    """Linear conjugate gradient for quadratic objectives
    (reference ``CG_Quad``, ``opt.py:139-208``)."""

    def __init__(self, loss, gtol=1e-4, max_iter=100, fd_eps=1e-5,
                 trace_path: str = "opt.dat"):
        super().__init__(loss)
        self.eps = fd_eps
        self.max_iter = max_iter
        self.gtol = gtol
        self.r = None
        self.p = None
        self.trace_path = trace_path

    def hessian_product(self, par, v, eps):
        """Hv ≈ (∇f(x+εv) − ∇f(x)) / ε (``opt.py:161-163``)."""
        return (self.loss.grad(par + eps * v) - self.loss.grad(par)) / eps

    def step(self) -> None:
        r, p, x = self.r, self.p, self.x
        Hp = self.hessian_product(x, p, eps=self.eps)
        rr = np.dot(r, r)
        alp = rr / np.dot(p, Hp)
        x = x + alp * p
        r = r + alp * Hp
        bet = np.dot(r, r) / rr
        p = bet * p - r
        self.r, self.p, self.x = r, p, x

    def minimize(self, par: Optional[np.ndarray] = None) -> int:
        self.x = (
            _model_params(self.loss)
            if par is None
            else np.asarray(par, dtype=np.float64)
        )
        self.r = self.loss.grad(self.x)
        self.p = -1.0 * self.r

        k = 0
        gnorm = np.linalg.norm(self.r)
        with OptTrace(self.trace_path) as tr:
            while gnorm > self.gtol and k < self.max_iter:
                self.step()
                gnorm = np.linalg.norm(self.r)
                k += 1
                tr.log(np.asarray([k]), grad_norm=gnorm)

        if getattr(self.loss, "model", None) is not None:
            self.loss.model.set_params(self.x)
        return k


class BFGSQuad(Opt):
    """Hand-rolled BFGS with full (un-line-searched) steps
    (reference ``BFGS_Quad``, ``opt.py:211-295``)."""

    def __init__(self, loss, gtol=1e-4, max_iter=100, fd_eps=1e-5,
                 trace_path: str = "opt.dat"):
        super().__init__(loss)
        self.eps = fd_eps
        self.gtol = gtol
        self.max_iter = max_iter
        self.r = None
        self.HI = None
        self.trace_path = trace_path

    @staticmethod
    def hessian_inv_update(HI, s, y):
        """H⁺ = G·H·Gᵀ + ρ·ssᵀ, G = I − ρ·syᵀ (``opt.py:233-246``)."""
        Id = np.identity(HI.shape[-1])
        rho = 1.0 / np.dot(y, s)
        G = Id - rho * np.outer(s, y)
        GT = Id - rho * np.outer(y, s)
        return G @ HI @ GT + rho * np.outer(s, s)

    def step(self) -> None:
        HI, r, x = self.HI, self.r, self.x
        s = np.copy(x)
        y = np.copy(r)
        p = -1.0 * (HI @ r)
        x = x + p
        r = self.loss.grad(x)
        s = x - s
        y = r - y
        self.HI = self.hessian_inv_update(HI, s, y)
        self.x, self.r = x, r

    def minimize(self, par=None, H0=None) -> int:
        self.x = (
            _model_params(self.loss)
            if par is None
            else np.asarray(par, dtype=np.float64)
        )
        self.r = self.loss.grad(self.x)
        self.HI = (
            np.identity(self.x.shape[-1]) if H0 is None else np.linalg.inv(H0)
        )

        k = 0
        gnorm = np.linalg.norm(self.r)
        with OptTrace(self.trace_path) as tr:
            while gnorm > self.gtol and k < self.max_iter:
                self.step()
                gnorm = np.linalg.norm(self.r)
                k += 1
                tr.log(np.asarray([k]), grad_norm=gnorm)

        if getattr(self.loss, "model", None) is not None:
            self.loss.model.set_params(self.x)
        return k
