"""Regional (open-boundary) pipeline example: EURO-CORDEX-style domain.

Role-equivalent of the reference's regional example notebooks
(`examples/regional data/` — EURO-CORDEX): a limited-area grid with
non-periodic longitudes, explicit coordinate units, and absolute area
filtering via `regional_tracker` (reference track.py:5471-5558).

Key differences from the global pipeline:
  * `regional_mode=True` — morphology pads with `edge` instead of `wrap`,
    the CCL does not connect across the x boundary, and centroids are not
    longitude-wrapped;
  * `coordinate_units` is REQUIRED (no auto-detection on partial domains);
  * `area_filter_absolute` (cells) replaces the quartile filter — the
    production choice for regional studies (submit_track.sh:20-28).
"""

import numpy as np

import marex_tpu as marEx
from marex_tpu import Field
from marex_tpu.core.timeaxis import daily_times, decompose_time

# ----------------------------------------------------------------------------
# 0. Synthetic regional demo data (EURO-CORDEX-like domain: 27N-72N, 22W-45E)
# ----------------------------------------------------------------------------
n_years, ny, nx = 8, 90, 134
rng = np.random.default_rng(7)
times = daily_times("2010-01-01", int(n_years * 365.25))
lat = np.linspace(27.0, 72.0, ny)
lon = np.linspace(-22.0, 45.0, nx)
doy = decompose_time(times).dayofyear

sst = np.broadcast_to(
    12.0
    + 8.0 * np.cos(np.deg2rad(lat - 27.0))[None, :, None]
    + 1.0 * np.cos(np.deg2rad(lon))[None, None, :]
    + 4.0 * np.cos(2 * np.pi * (doy[:, None, None] - 45) / 365.25),
    (len(times), ny, nx),
).astype(np.float32)
noise = rng.standard_normal(sst.shape).astype(np.float32)
for k in range(1, len(times)):
    noise[k] = 0.8 * noise[k - 1] + 0.6 * noise[k]
sst += noise

# a Mediterranean-ish land mask block
sst[:, : ny // 6, nx // 2 :] = np.nan

da = Field(sst, ("time", "lat", "lon"), coords={"time": times, "lat": lat, "lon": lon}, name="sst")

# ----------------------------------------------------------------------------
# 1. Detect: anomalies + extreme events (same API as the global pipeline)
# ----------------------------------------------------------------------------
extremes_ds = marEx.preprocess_data(
    da,
    method_anomaly="detrend_harmonic",
    method_extreme="hobday_extreme",
    method_percentile="approximate",
    threshold_percentile=95,
    window_days_hobday=11,
)
print(f"extreme frequency: {float(np.asarray(extremes_ds.extreme_events.values).mean()):.4f}")

# ----------------------------------------------------------------------------
# 2. Track with the regional convenience wrapper: open boundaries, absolute
#    area filter (in cells), explicit units
# ----------------------------------------------------------------------------
tracker = marEx.regional_tracker(
    extremes_ds.extreme_events,
    extremes_ds.mask,
    R_fill=4,
    T_fill=2,
    area_filter_absolute=30,
    allow_merging=True,
    overlap_threshold=0.4,
    coordinate_units="degrees",
)
events_ds, merges_ds = tracker.run(return_merges=True)

print(f"tracked events: {events_ds.attrs['N_events_final']}")
print(f"recorded merges: {events_ds.attrs['total_merges']}")

# centroids stay inside the regional domain (no wrap into [0, 360))
clat = events_ds.centroid.values[0]
clon = events_ds.centroid.values[1]
present = events_ds.presence.values
assert np.nanmin(clon[present]) >= lon.min() and np.nanmax(clon[present]) <= lon.max()
assert np.nanmin(clat[present]) >= lat.min() and np.nanmax(clat[present]) <= lat.max()
print("centroids confined to the regional domain - OK")

# ----------------------------------------------------------------------------
# 3. Visualise (optional; requires matplotlib)
# ----------------------------------------------------------------------------
try:
    from marex_tpu import PlotConfig

    config = PlotConfig(plot_IDs=True, title="Regional extreme events")
    fig, ax, _ = events_ds.ID_field.isel(time=-1).plotX.single_plot(config)
    fig.savefig("regional_events.png", dpi=110)
    print("wrote regional_events.png")
except Exception as e:  # matplotlib/cartopy optional
    print(f"plotting skipped: {e}")
