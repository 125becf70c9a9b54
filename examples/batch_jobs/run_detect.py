"""Batch detect job (role-equivalent of the reference's batch run_detect.py).

Environment knobs mirror the reference's SLURM scripts:
  MAREX_INPUT   zarr store with the raw variable        (required)
  MAREX_VAR     variable name                           (default "sst")
  MAREX_OUTPUT  output zarr store                       (default extremes.zarr)
  MAREX_PCTL    threshold percentile                    (default 95)
  MAREX_DEVICES virtual CPU devices when no GPU present (optional)
  MAREX_MESH    1 = shard over every visible device     (default 0)
"""

import os

import jax

if os.environ.get("MAREX_DEVICES"):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", int(os.environ["MAREX_DEVICES"]))

import marex_tpu as marEx
from marex_tpu.io import open_zarr, to_zarr

marEx.configure_logging(verbose=bool(os.environ.get("MAREX_VERBOSE")))
marEx.helper.start_local_cluster()

store = open_zarr(os.environ["MAREX_INPUT"])
da = store[os.environ.get("MAREX_VAR", "sst")]

extremes = marEx.preprocess_data(
    da,
    method_anomaly=os.environ.get("MAREX_ANOMALY", "shifting_baseline"),
    method_extreme=os.environ.get("MAREX_EXTREME", "hobday_extreme"),
    threshold_percentile=float(os.environ.get("MAREX_PCTL", "95")),
    method_percentile="approximate",
    mesh=True if os.environ.get("MAREX_MESH") == "1" else None,
)

to_zarr(extremes, os.environ.get("MAREX_OUTPUT", "extremes.zarr"))
print("detect complete:", dict(extremes.sizes))
