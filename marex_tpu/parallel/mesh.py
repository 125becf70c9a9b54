"""
Device-mesh and sharding helpers.

Device replacement of the reference's Dask scale-out layer
(helper.py:232-639 — LocalCluster/SLURMCluster over chunked arrays): here
parallelism is SPMD over a ``jax.sharding.Mesh``.  The dominant data-parallel
axes mirror the reference's chunking strategy (SURVEY §2.4):

* detect stage: every op is pointwise over *space* (climatology, detrending,
  thresholds reduce over time/years per point) -> shard the flattened space
  axis ("space" mesh axis); XLA inserts no collectives at all.
* track stage: morphology/CCL need whole-space stencils per timestep ->
  shard *time* ("time" mesh axis); temporal closing and 3-D labeling
  communicate +-T_fill / +-1 halo slices between devices (NVLink collectives
  on a multi-GPU host), which XLA generates from the sharding annotations on
  the shifted operands. The cards of one host are joined all to all, so the
  mesh follows the algorithm's axes rather than a physical torus.

Use :func:`detect_sharding` / :func:`track_sharding` to place arrays, and
:func:`constrain` inside jitted code to re-shard between pipeline stages
(the moral equivalent of the reference's rechunk from (time-chunked, space
whole) to (time whole, space-chunked), detect.py:2617-2631).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    n_time: Optional[int] = None,
    n_space: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """
    Build a ("time", "space") device mesh.  Defaults to all devices on the
    time axis — the dominant batch dimension of the tracker, matching the
    reference's time-chunk data parallelism.
    """
    devs = np.array(devices if devices is not None else jax.devices())
    if n_time is None:
        n_time = len(devs) // n_space
    devs = devs[: n_time * n_space].reshape(n_time, n_space)
    return Mesh(devs, axis_names=("time", "space"))


def detect_sharding(mesh: Mesh) -> NamedSharding:
    """(T, S) arrays sharded over space — detect-stage layout (pointwise in
    space, reductions over local time)."""
    return NamedSharding(mesh, P(None, ("time", "space")))


def track_sharding(mesh: Mesh, spatial_ndim: int = 2) -> NamedSharding:
    """(T, ...) arrays sharded over time — track-stage layout (whole-space
    stencils per timestep, halo exchange in time)."""
    return NamedSharding(mesh, P(("time", "space"), *([None] * spatial_ndim)))


def replicated(mesh: Mesh, ndim: int) -> NamedSharding:
    """Fully replicated arrays (coordinates, small tables)."""
    return NamedSharding(mesh, P(*([None] * ndim)))


def constrain(x: jax.Array, sharding: NamedSharding) -> jax.Array:
    """In-jit sharding constraint (stage-boundary reshard between devices)."""
    return jax.lax.with_sharding_constraint(x, sharding)


def shard_put(x, sharding: NamedSharding) -> jax.Array:
    """Host->device placement with an explicit sharding."""
    return jax.device_put(x, sharding)


# ----------------------------------------------------------------------------
# Default-mesh context: lets the public pipeline (preprocess_data, tracker)
# run multi-device without threading a mesh through every internal call —
# the device analogue of the reference's ambient Dask client
# (helper.py:232-411: a started cluster is process-global).
# ----------------------------------------------------------------------------

_default_mesh: Optional[Mesh] = None


def set_default_mesh(mesh: Optional[Mesh]) -> None:
    """Set (or clear, with None) the process-global default mesh."""
    global _default_mesh
    _default_mesh = mesh


def get_default_mesh() -> Optional[Mesh]:
    return _default_mesh


class use_mesh:
    """Context manager scoping the default mesh: every pipeline stage entered
    inside places its arrays with the detect/track shardings of this mesh."""

    def __init__(self, mesh: Optional[Mesh]):
        self.mesh = mesh
        self._prev: Optional[Mesh] = None

    def __enter__(self):
        global _default_mesh
        self._prev = _default_mesh
        _default_mesh = self.mesh
        return self.mesh

    def __exit__(self, *exc):
        global _default_mesh
        _default_mesh = self._prev
        return False


def shard_if_divisible(x, sharding: NamedSharding):
    """
    Place ``x`` with ``sharding`` when every sharded dimension divides evenly
    across its mesh axes; otherwise leave placement to the default device
    (XLA requires even shards for device_put, and the pipeline must accept
    arbitrary shapes).
    """
    spec = sharding.spec
    mesh = sharding.mesh
    for dim, names in enumerate(spec):
        if names is None:
            continue
        names = (names,) if isinstance(names, str) else tuple(names)
        extent = int(np.prod([mesh.shape[n] for n in names]))
        if x.shape[dim] % extent != 0:
            return jax.device_put(x)
    return jax.device_put(x, sharding)


def pad_to_multiple(x: np.ndarray, axis: int, multiple: int, fill=0) -> Tuple[np.ndarray, int]:
    """
    Pad ``axis`` up to a multiple of the mesh extent so shards are equal
    (XLA requires evenly divisible sharded dimensions). Returns the padded
    array and the original length.
    """
    n = x.shape[axis]
    target = int(-(-n // multiple) * multiple)
    if target == n:
        return x, n
    pads = [(0, 0)] * x.ndim
    pads[axis] = (0, target - n)
    if np.issubdtype(x.dtype, np.floating):
        out = np.pad(x, pads, constant_values=np.nan if fill is None else fill)
    else:
        out = np.pad(x, pads, constant_values=fill)
    return out, n
