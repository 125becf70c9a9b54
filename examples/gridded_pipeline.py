"""Full gridded pipeline example: synthetic SST -> extremes -> tracked events.

Role-equivalent of the reference's gridded example notebooks
(01_preprocess_extremes / 02_id_track_events / 03_visualise_events).
"""

import numpy as np

import marex_tpu as marEx
from marex_tpu import Field, PlotConfig
from marex_tpu.core.timeaxis import daily_times, decompose_time
from marex_tpu.io import to_zarr

# ----------------------------------------------------------------------------
# 0. Synthetic demo data (replace with your own ingest)
# ----------------------------------------------------------------------------
n_years, ny, nx = 15, 90, 180
rng = np.random.default_rng(0)
times = daily_times("2000-01-01", int(n_years * 365.25))
lat = np.linspace(-89, 89, ny)
lon = np.linspace(0, 360, nx, endpoint=False)
doy = decompose_time(times).dayofyear

sst = np.broadcast_to(
    15
    + 10 * np.cos(np.deg2rad(lat))[None, :, None]
    + 1.5 * np.sin(np.deg2rad(lon))[None, None, :]
    + 3 * np.cos(2 * np.pi * (doy[:, None, None] - 30) / 365.25) * np.cos(np.deg2rad(lat))[None, :, None]
    + 0.02 * (np.arange(len(times)) / 365.25)[:, None, None],
    (len(times), ny, nx),
).astype(np.float32)
noise = rng.standard_normal(sst.shape).astype(np.float32)
for k in range(1, len(times)):
    noise[k] = 0.8 * noise[k - 1] + 0.6 * noise[k]
sst += noise
sst[:, 30:45, 20:50] = np.nan  # a continent

da = Field(sst, ("time", "lat", "lon"), coords={"time": times, "lat": lat, "lon": lon}, name="sst")

# ----------------------------------------------------------------------------
# 1. DETECT
# ----------------------------------------------------------------------------
extremes = marEx.preprocess_data(
    da,
    method_anomaly="shifting_baseline",
    method_extreme="hobday_extreme",
    threshold_percentile=95,
    window_year_baseline=10,
)
print(extremes)
to_zarr(extremes, "extremes_gridded.zarr")

# ----------------------------------------------------------------------------
# 2. TRACK
# ----------------------------------------------------------------------------
tr = marEx.tracker(
    extremes.extreme_events,
    extremes.mask,
    R_fill=8,
    T_fill=2,
    area_filter_quartile=0.5,
    allow_merging=True,
    nn_partitioning=True,
    grid_resolution=2.0,  # physical km^2 areas
)
events, merges = tr.run(return_merges=True)
to_zarr(events, "events_gridded.zarr")

print(f"{events.attrs['N_events_final']} events, {events.attrs['total_merges']} merges")

# ----------------------------------------------------------------------------
# 3. VISUALISE
# ----------------------------------------------------------------------------
snapshot = events.ID_field.isel(time=-1)
fig, ax, im = snapshot.plotX().single_plot(PlotConfig(plot_IDs=True, title="tracked events"))
fig.savefig("events_final.png", dpi=120)
