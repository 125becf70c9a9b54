"""float32 accuracy of the device kernels on GPUs.

Every float32 matrix product on the detect and property paths asks for
``Precision.HIGHEST``: without it XLA may run them in TF32 on GPUs that
offer it (~3 significant digits), which breaks the anomalies-within-1e-5
contract and shifts centroids. The CPU backend always computes in full
float32, so these tests read the request off the lowered program. The
windowed means of the shifting baseline are checked against float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from marex_tpu.core.timeaxis import daily_times, decompose_time
from marex_tpu.ops import climatology as clim
from marex_tpu.ops import detrend, march, properties


def _dot_precisions(jaxpr):
    """Precision config of every dot_general in ``jaxpr`` and its sub-jaxprs."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in v if isinstance(v, (list, tuple)) else [v]:
                inner = getattr(sub, "jaxpr", None)
                if inner is not None:
                    out.extend(_dot_precisions(getattr(inner, "jaxpr", inner)))
    return out


def _all_highest(fn, *args):
    precisions = _dot_precisions(jax.make_jaxpr(fn)(*args).jaxpr)
    assert precisions, "expected at least one dot_general"
    hi = jax.lax.Precision.HIGHEST
    return all(p is not None and all(q == hi for q in (p if isinstance(p, tuple) else (p,))) for p in precisions)


def _detrend_args():
    tinfo = decompose_time(daily_times("2000-01-01", 400))
    model, pmodel = detrend.build_design_matrix(tinfo, [1])
    data = jnp.ones((400, 3, 5), jnp.float32)
    return data, jnp.asarray(model, jnp.float32), jnp.asarray(pmodel, jnp.float32)


CASES = {
    "detrend": (lambda d, m, p: detrend.detrend_subtract(d, m, p), _detrend_args),
    "grid_label_comps": (
        lambda lab: properties.grid_label_comps(lab, 3),
        lambda: (jnp.zeros((4, 6, 8), jnp.int32),),
    ),
    "grid_label_props": (
        lambda lab: properties.grid_label_props(lab, 3, True),
        lambda: (jnp.zeros((4, 6, 8), jnp.int32),),
    ),
    "unstructured_label_comps": (
        lambda lab, la, lo, a: properties.unstructured_label_comps(lab, la, lo, a, 3),
        lambda: (jnp.zeros((4, 10), jnp.int32), jnp.zeros(10), jnp.zeros(10), jnp.ones(10)),
    ),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_matmuls_request_highest_precision(name):
    fn, make_args = CASES[name]
    assert _all_highest(fn, *make_args())


def test_march_partition_contractions_request_highest_precision():
    """Both partition kernels of the merge march contract their lane one-hot
    with the property weights in one einsum each."""
    import inspect

    for kernel in (march._partition_batch, march._partition_batch_unstr):
        src = inspect.getsource(kernel)
        assert src.count("jnp.einsum(") == src.count("precision=jax.lax.Precision.HIGHEST") >= 1


def _sst_like(T=3 * 365, n=64, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    x = 20.0 + 8.0 * rng.random(n)[None] + 3.0 * np.cos(2 * np.pi * t / 365.25)[:, None]
    x = x + rng.standard_normal((T, n))
    x[:, :3] = np.nan  # land columns
    x[100:105, 5] = np.nan  # a gap
    return x.astype(np.float32)


def test_centered_rolling_mean_within_1e5_of_float64():
    x = _sst_like()
    w = 21
    got = np.asarray(clim.centered_rolling_mean_time(jnp.asarray(x), w))
    x64 = x.astype(np.float64)
    ref = np.full_like(x64, np.nan)
    for i in range(w // 2, x.shape[0] - (w - w // 2 - 1)):
        ref[i] = x64[i - w // 2 : i + w - w // 2].mean(axis=0)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert np.nanmax(np.abs(got - ref)) < 1e-5


def test_rolling_climatology_within_1e5_of_float64():
    rng = np.random.default_rng(1)
    ymd = (25.0 + rng.standard_normal((12, 366, 16))).astype(np.float32)
    ymd[3, 10:20] = np.nan
    got = np.asarray(clim.rolling_climatology_ymd(jnp.asarray(ymd), 5))
    ref = np.full(ymd.shape, np.nan)
    y64 = ymd.astype(np.float64)
    for y in range(5, 12):
        with np.errstate(invalid="ignore"):
            ref[y] = np.nanmean(y64[y - 5 : y], axis=0)
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    assert np.nanmax(np.abs(got - ref)) < 1e-5
