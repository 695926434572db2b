"""The paper's two-layer sigmoid MLP (Eq. 4/5) and its gradient descent,
Listing 2's NumPy training written in PyTorch: the loss is the sum over
rows of (m(x) - y)^2, so each iteration is

    a_xh = sig(x w_xh); a_ho = sig(a_xh w_ho)
    d_ho = 2 (a_ho - y) a_ho (1 - a_ho);   d_xh = (d_ho w_hoᵀ) a_xh (1 - a_xh)
    w_ho -= lr a_xhᵀ d_ho;                 w_xh -= lr xᵀ d_xh
"""
from __future__ import annotations

import torch

from .numerics import exact_float32, product


def _dtype(precision: str) -> torch.dtype:
    return torch.float64 if precision == "float64" else torch.float32


def train(x, labels, w0: dict, lr: float, n_iters: int,
          precision: str = "float64") -> list[dict]:
    """The weights before and after each of ``n_iters`` iterations."""
    mm = product(precision)
    dt = _dtype(precision)
    with exact_float32():
        x = x.to(dt)
        y = torch.nn.functional.one_hot(labels.long(),
                                        w0["w_ho"].shape[1]).to(dt)
        w_xh, w_ho = w0["w_xh"].to(dt).clone(), w0["w_ho"].to(dt).clone()
        out = [{"w_xh": w_xh.clone(), "w_ho": w_ho.clone()}]
        for _ in range(n_iters):
            a_xh = torch.sigmoid(mm(x, w_xh))
            a_ho = torch.sigmoid(mm(a_xh, w_ho))
            d_ho = 2.0 * (a_ho - y) * a_ho * (1.0 - a_ho)
            d_xh = mm(d_ho, w_ho.T) * a_xh * (1.0 - a_xh)
            w_ho = w_ho - lr * mm(a_xh.T, d_ho)
            w_xh = w_xh - lr * mm(x.T, d_xh)
            out.append({"w_xh": w_xh.clone(), "w_ho": w_ho.clone()})
    return out
