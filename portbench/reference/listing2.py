"""Listing 2 of the paper, NumPy training of the two-layer sigmoid MLP
(the port's ``core.nn2sql.numpy_train``), frozen here with the weights
handed in: the test that holds ``reference.mlp`` to it."""
from __future__ import annotations

import numpy as np


def numpy_train(x: np.ndarray, y_onehot: np.ndarray, w_xh: np.ndarray,
                w_ho: np.ndarray, n_iters: int, lr: float) -> dict:
    w_xh, w_ho = w_xh.copy(), w_ho.copy()
    for _ in range(n_iters):
        a_xh = 1.0 / (1.0 + np.exp(-x.dot(w_xh)))
        a_ho = 1.0 / (1.0 + np.exp(-a_xh.dot(w_ho)))
        l_ho = 2.0 * (a_ho - y_onehot)
        d_ho = l_ho * a_ho * (1.0 - a_ho)
        l_xh = d_ho.dot(w_ho.T)
        d_xh = l_xh * a_xh * (1.0 - a_xh)
        w_ho -= lr * a_xh.T.dot(d_ho)
        w_xh -= lr * x.T.dot(d_xh)
    return {"w_xh": w_xh, "w_ho": w_ho}
