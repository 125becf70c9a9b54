"""
Polynomial + harmonic detrending kernels.

Device equivalent of the reference's detrended-baseline engine
(``marEx/detect.py:2061-2296``): the tiny design matrix and its pseudo-inverse
are built host-side in float64; the two heavy steps — the least-squares fit
``coeffs = pinv(M) @ data`` and the model subtraction ``data - M @ coeffs`` —
are (K,T)x(T,S) / (T,K)x(K,S) matmuls, run at full float32 precision.
"""

from __future__ import annotations

from functools import partial
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.timeaxis import TimeIndexInfo


def build_design_matrix(
    tinfo: TimeIndexInfo,
    detrend_orders: List[int],
    remove_harmonics: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """
    Build the (K, T) model matrix and its pseudo-inverse (T, K), in float64.

    Components match the reference (detect.py:2143-2166): a constant row,
    centred ``decimal_year**k`` rows for each requested order, optional annual
    and semi-annual sin/cos harmonics; each non-constant row is then
    orthogonalised against the constant row.
    """
    dy = tinfo.decimal_year
    rows = [np.ones(len(dy))]
    centered = dy - dy.mean()
    for order in detrend_orders:
        rows.append(centered**order)
    if remove_harmonics:
        rows.extend(
            [
                np.sin(2 * np.pi * dy),
                np.cos(2 * np.pi * dy),
                np.sin(4 * np.pi * dy),
                np.cos(4 * np.pi * dy),
            ]
        )
    model = np.array(rows)
    for i in range(1, model.shape[0]):
        model[i] = model[i] - model[i].mean() * model[0]
    pmodel = np.linalg.pinv(model)
    return model, pmodel


@jax.jit
def detrend_subtract(data: jax.Array, model: jax.Array, pmodel: jax.Array) -> jax.Array:
    """
    Remove the fitted model from the data.

    Parameters
    ----------
    data : (T, *spatial) float32 — any trailing spatial shape (NaN over land
        propagates to NaN anomalies there). Keeping the caller's natural
        layout avoids a (T, S) relayout copy where the backend's tiled
        layouts make a reshape a real copy of the whole field.
    model : (K, T) float32
    pmodel : (T, K) float32 — pseudo-inverse of model

    Returns
    -------
    (T, *spatial) anomalies = data - model.T @ (pmodel.T @ data)
    """
    # HIGHEST: float32 products, never TF32 (~3 digits) on GPUs that offer it
    hi = jax.lax.Precision.HIGHEST
    coeffs = jnp.tensordot(pmodel, data, axes=((0,), (0,)), precision=hi, preferred_element_type=jnp.float32)
    fit = jnp.tensordot(model, coeffs, axes=((0,), (0,)), precision=hi, preferred_element_type=jnp.float32)
    return data - fit


@partial(jax.jit, static_argnames=())
def remove_time_mean(data: jax.Array) -> jax.Array:
    """Force zero mean over time (nan-aware), cf. detect.py:2223-2224."""
    finite = jnp.isfinite(data)
    n = jnp.sum(finite, axis=0)
    mean = jnp.sum(jnp.where(finite, data, 0.0), axis=0) / jnp.maximum(n, 1)
    mean = jnp.where(n > 0, mean, 0.0)
    return data - mean[None]
