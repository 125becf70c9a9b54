"""
Runtime / deployment helpers for marex_tpu.

Role-equivalent of the reference's ``marEx/helper.py`` (Dask cluster
configuration, SLURM launch, checkpoint-to-zarr): here the runtime is JAX
SPMD, so the helpers configure the XLA backend, build device meshes, report
device inventory instead of dashboards, and checkpoint Fields
to zarr-lite stores.

``configure_dask`` / ``start_local_cluster`` / ``start_distributed_cluster``
are kept as API-compatible shims so scripts written against the reference
keep running: they configure the JAX runtime and return a lightweight
ClusterInfo handle.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np

from .core.field import Field, FieldSet
from .logging_config import get_logger

logger = get_logger(__name__)

# Default runtime knobs (role of DEFAULT_DASK_CONFIG, helper.py:44-67)
DEFAULT_RUNTIME_CONFIG: Dict[str, Any] = {
    "jax.transfer_guard": "allow",
    "jax.default_matmul_precision": "default",
    "host.memory_fraction_warn": 0.9,
}


@dataclass
class ClusterInfo:
    """Description of the active accelerator 'cluster' (device inventory)."""

    backend: str
    n_devices: int
    n_local_devices: int
    device_kind: str
    process_index: int = 0
    n_processes: int = 1
    coords: Optional[list] = None
    extra: Dict[str, Any] = field(default_factory=dict)

    def __str__(self) -> str:  # pragma: no cover
        return (
            f"ClusterInfo(backend={self.backend}, devices={self.n_devices} "
            f"({self.device_kind}), processes={self.n_processes})"
        )

    # Dask-client-compatible no-ops so pipeline scripts keep working
    def close(self) -> None:
        pass

    def restart(self) -> None:
        pass


def configure_dask(config: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """
    API-compatible shim for the reference's ``configure_dask``
    (helper.py:90-138): applies runtime configuration to the JAX backend.
    Returns the effective config dict.
    """
    cfg = dict(DEFAULT_RUNTIME_CONFIG)
    if config:
        cfg.update(config)
    # map recognised knobs onto jax.config
    import jax

    if "jax.default_matmul_precision" in cfg and cfg["jax.default_matmul_precision"] != "default":
        jax.config.update("jax_default_matmul_precision", cfg["jax.default_matmul_precision"])
    logger.debug(f"Runtime configured: {cfg}")
    return cfg


configure_devices = configure_dask  # preferred name


def get_cluster_info(client: Optional[ClusterInfo] = None) -> ClusterInfo:
    """Inventory of the active JAX backend (role of helper.py:141-229)."""
    import jax

    devices = jax.devices()
    local = jax.local_devices()
    info = ClusterInfo(
        backend=jax.default_backend(),
        n_devices=len(devices),
        n_local_devices=len(local),
        device_kind=local[0].device_kind if local else "none",
        process_index=jax.process_index(),
        n_processes=jax.process_count(),
        coords=[getattr(d, "coords", None) for d in local],
    )
    logger.info(str(info))
    return info


def start_local_cluster(
    n_workers: Optional[int] = None,
    threads_per_worker: int = 1,
    memory_limit: Optional[str] = None,
    **kwargs: Any,
) -> ClusterInfo:
    """
    Single-host runtime startup (role of helper.py:232-411).

    There is no scheduler to start; this validates the backend, warms
    up the compiler, and returns the device inventory. ``n_workers`` maps to
    a virtual CPU device count when running on the CPU backend (useful for
    testing sharded code without hardware).
    """
    if n_workers is not None and os.environ.get("JAX_PLATFORMS", "") == "cpu":
        import jax

        try:  # must run before the backend initialises
            jax.config.update("jax_num_cpu_devices", int(n_workers))
        except Exception:  # pragma: no cover - backend already up
            pass

    configure_dask()
    import jax
    import jax.numpy as jnp

    # compiler warm-up
    jax.jit(lambda x: x * 2)(jnp.ones((8, 8))).block_until_ready()
    return get_cluster_info()


def start_distributed_cluster(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs: Any,
) -> ClusterInfo:
    """
    Multi-host runtime startup (role of the reference's SLURMCluster launch,
    helper.py:414-639): initialises ``jax.distributed`` so all processes
    (one per GPU, or one per host) join a single SPMD program. Without
    arguments it initialises only when ``COORDINATOR_ADDRESS`` is set.
    """
    import jax

    # NOTE: jax.process_count() (or any other backend query) must NOT run
    # before jax.distributed.initialize — it initialises XLA and makes
    # initialize() raise. Decide from the arguments/environment alone.
    should_init = bool(
        coordinator_address or os.environ.get("COORDINATOR_ADDRESS") or num_processes is not None
    )
    if should_init:
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
            )
            logger.info(
                f"jax.distributed initialised: process {jax.process_index()} of {jax.process_count()}"
            )
        except RuntimeError as e:  # already initialised (or backend touched)
            logger.warning(f"jax.distributed.initialize skipped: {e}")
    configure_dask()
    return get_cluster_info()


# ----------------------------------------------------------------------------
# Checkpointing
# ----------------------------------------------------------------------------


def checkpoint_to_zarr(
    data: Any,
    name: str = "checkpoint",
    timedim: str = "time",
    temp_dir: Optional[str] = None,
) -> Any:
    """
    Write a Field/FieldSet to a zarr-lite store and reload it
    (role of helper.py:642-777; here it materialises device buffers to disk
    for resumability rather than breaking a task graph).
    """
    import tempfile

    from .io.zarr_lite import open_zarr, to_zarr

    if temp_dir is not None:
        base = temp_dir
        os.makedirs(base, exist_ok=True)
    else:
        # unique per call: a fixed $TMPDIR path would collide across
        # concurrent runs (the reference takes an explicit directory)
        base = tempfile.mkdtemp(prefix="marex_tpu_ckpt_")
    path = os.path.join(base, f"marex_tpu_{name}.zarr")
    to_zarr(data, path, mode="w")
    reloaded = open_zarr(path)
    if isinstance(data, Field) and isinstance(reloaded, FieldSet):
        key = data.name or "data"
        return reloaded[key]
    return reloaded


def fix_dask_tuple_array(da: Any) -> Any:
    """Compatibility no-op (the reference works around a dask-zarr bug here,
    helper.py:780-821; there is no task graph in this framework)."""
    return da


def memory_summary() -> Dict[str, float]:
    """Host + device memory snapshot in MB."""
    out: Dict[str, float] = {}
    try:
        import psutil

        out["host_rss_mb"] = psutil.Process().memory_info().rss / 2**20
        out["host_available_mb"] = psutil.virtual_memory().available / 2**20
    except Exception:  # pragma: no cover
        pass
    try:
        import jax

        for d in jax.local_devices():
            stats = getattr(d, "memory_stats", lambda: None)() or {}
            if "bytes_in_use" in stats:
                out[f"device{d.id}_in_use_mb"] = stats["bytes_in_use"] / 2**20
    except Exception:  # pragma: no cover
        pass
    return out


# ----------------------------------------------------------------------------
# Failure detection / elastic recovery
# ----------------------------------------------------------------------------
#
# The reference inherits worker-failure tolerance from Dask's nanny processes
# (helper.py:49-66: dead workers restart and their tasks reschedule). A JAX
# SPMD runtime has no task graph to reschedule, so the equivalent envelope is
# built from three pieces: explicit device *health checks* (failure
# detection), a *retry wrapper* that re-dispatches a failed stage after
# clearing compiled state (recovery), and configuration-fingerprinted stage
# checkpoints with ``tracker(checkpoint='auto')`` (crash resume).


def check_device_health(raise_on_error: bool = True) -> Dict[str, Any]:
    """
    Probe every local accelerator device with a tiny compiled program.

    Returns a dict with per-device ``ok`` status and error strings. With
    ``raise_on_error`` a failing device raises :class:`DeviceError`
    carrying the probe failures in its context.
    """
    import jax
    import jax.numpy as jnp

    from .exceptions import DeviceError

    report: Dict[str, Any] = {"devices": [], "ok": True}
    for d in jax.local_devices():
        entry: Dict[str, Any] = {"id": d.id, "kind": getattr(d, "device_kind", "?"), "ok": True}
        try:
            x = jax.device_put(jnp.arange(8, dtype=jnp.float32), d)
            val = float(jax.jit(lambda v: jnp.sum(v * 2.0))(x))
            if val != 56.0:
                entry["ok"] = False
                entry["error"] = f"probe returned {val}, expected 56.0"
        except Exception as e:  # pragma: no cover - only on real device failure
            entry["ok"] = False
            entry["error"] = f"{type(e).__name__}: {e}"
        report["devices"].append(entry)
        report["ok"] &= entry["ok"]
    if not report["ok"]:
        bad = [e for e in report["devices"] if not e["ok"]]
        logger.error(f"Device health check failed on {len(bad)} device(s): {bad}")
        if raise_on_error:
            raise DeviceError(
                "Accelerator device health check failed",
                details=f"{len(bad)} of {len(report['devices'])} local devices failed the compute probe",
                suggestions=[
                    "Restart the process to reinitialise the failed device",
                    "Check host-side accelerator driver logs",
                ],
                context={"failed_devices": bad},
            )
    return report


def enable_compile_cache(root: str) -> str:
    """Turn on JAX's persistent compilation cache for a script run from a
    checkout; returns the directory in use.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is left to JAX. Otherwise the
    cache lives at the fixed path ``<root>/.jax_cache`` (listed in
    ``.gitignore``): the path is part of the cache key, so a per-process
    or temporary directory would never hit. The library itself sets no
    cache; ``bench.py`` and ``chip_smoke.py`` call this at start-up.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR", "").strip()
    if env:
        return env
    import jax

    path = os.path.join(os.path.abspath(root), ".jax_cache")
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path


_LINK_BW_CACHE: Optional[tuple] = None


def measured_link_bandwidth(probe_mb: float = 8.0, refresh: bool = False) -> tuple:
    """
    Measured host<->device link bandwidth ``(up_MB_per_s, down_MB_per_s)``.

    The host/device work-placement cutovers (host CCL vs the device label
    fixpoint, ``track.py``) depend on the real link rate, so the cutover
    probes ONCE per process with a ~``probe_mb`` MB round trip and caches
    the result.

    Env override ``MAREX_LINK_BW_MBPS="up[,down]"`` skips the probe (useful in
    tests and when the probe cost itself matters); any failure returns a
    conservative ``(100.0, 100.0)``.
    """
    global _LINK_BW_CACHE
    env = os.environ.get("MAREX_LINK_BW_MBPS", "").strip()
    if env:
        try:
            parts = [float(p) for p in env.split(",")]
            return (parts[0], parts[-1])
        except ValueError:
            logger.warning(f"Ignoring unparsable MAREX_LINK_BW_MBPS={env!r}")
    if _LINK_BW_CACHE is not None and not refresh:
        return _LINK_BW_CACHE
    import time as _time

    import jax

    try:
        # Two-size differential measurement: every transfer carries a fixed
        # dispatch latency, so a single small transfer reads below the
        # sustained rate. Timing a small AND a large transfer and dividing
        # the SIZE difference by the TIME difference cancels it.
        n_small = max(int(probe_mb * 1e6) // 16, 1024) // 4
        n_big = max(int(probe_mb * 1e6), 4096) // 4
        # warm the dispatch path so the probe measures transfer, not init
        jax.block_until_ready(jax.device_put(np.zeros((16,), np.float32)))

        def _one(n):
            host = np.zeros((n,), np.float32)
            t0 = _time.perf_counter()
            dev = jax.device_put(host)
            jax.block_until_ready(dev)
            t_up = _time.perf_counter() - t0
            t0 = _time.perf_counter()
            np.asarray(dev)
            return t_up, _time.perf_counter() - t0

        us, ds = _one(n_small)
        ub, db = _one(n_big)
        dmb = (n_big - n_small) * 4 / 1e6
        up = dmb / max(ub - us, 1e-6)
        down = dmb / max(db - ds, 1e-6)
        # fall back to the plain big-transfer rate if timing noise made the
        # difference negative/unstable
        if ub <= us:
            up = n_big * 4 / 1e6 / max(ub, 1e-6)
        if db <= ds:
            down = n_big * 4 / 1e6 / max(db, 1e-6)
        _LINK_BW_CACHE = (float(up), float(down))
        logger.info(f"Measured host<->device link bandwidth: up={up:.1f} MB/s down={down:.1f} MB/s")
    except Exception as e:  # pragma: no cover - only on device failure
        logger.warning(f"Link bandwidth probe failed ({type(e).__name__}: {e}); assuming 100 MB/s")
        _LINK_BW_CACHE = (100.0, 100.0)
    return _LINK_BW_CACHE


def _default_retry_exceptions() -> tuple:
    from .exceptions import DeviceError

    excs = [DeviceError, OSError]
    try:
        import jax

        # XlaRuntimeError moved between modules across jax versions
        err = getattr(getattr(jax, "errors", None), "JaxRuntimeError", None)
        if err is not None:
            excs.append(err)
        from jax._src.lib import _jax  # type: ignore

        xla_err = getattr(_jax, "XlaRuntimeError", None)
        if xla_err is not None:
            excs.append(xla_err)
    except Exception:  # pragma: no cover
        pass
    return tuple(excs)


def run_with_retries(
    fn,
    *args,
    retries: int = 2,
    retry_exceptions: Optional[tuple] = None,
    on_retry=None,
    health_check: bool = True,
    **kwargs,
):
    """
    Execute ``fn(*args, **kwargs)``, re-dispatching on device/runtime
    failures — the stage-level recovery envelope (reference analogue: Dask
    reschedules tasks of dead workers, helper.py:49-66).

    Between attempts the JAX compiled-program caches are cleared (a failed
    executable can poison retries) and the devices are health-checked so a
    genuinely dead accelerator fails fast with a :class:`DeviceError`
    instead of burning retries. ``on_retry(attempt, exc)`` runs before each
    retry (e.g. to reload a stage checkpoint).
    """
    if retry_exceptions is None:
        retry_exceptions = _default_retry_exceptions()
    last: Optional[BaseException] = None
    for attempt in range(retries + 1):
        try:
            return fn(*args, **kwargs)
        except retry_exceptions as e:  # type: ignore[misc]
            last = e
            if attempt >= retries:
                break
            logger.warning(
                f"Stage '{getattr(fn, '__name__', 'fn')}' failed on attempt {attempt + 1}/{retries + 1} "
                f"({type(e).__name__}: {e}); retrying"
            )
            try:
                import jax

                jax.clear_caches()
            except Exception:  # pragma: no cover
                pass
            if health_check:
                check_device_health(raise_on_error=True)
            if on_retry is not None:
                on_retry(attempt, e)
    assert last is not None
    raise last
