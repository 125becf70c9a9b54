"""Unstructured (triangular mesh) pipeline example: ICON/FESOM-style data.

Role-equivalent of the reference's unstructured example notebooks.
Builds a small Delaunay mesh so the script is self-contained; with real model
output, load `(time, ncells)` data plus the grid's `(nv=3, ncells)` neighbour
table and cell areas instead.
"""

import numpy as np
from scipy.spatial import Delaunay

import marex_tpu as marEx
from marex_tpu import Field
from marex_tpu.core.field import Coord

# ----------------------------------------------------------------------------
# 0. A small triangular mesh + synthetic daily data
# ----------------------------------------------------------------------------
rng = np.random.default_rng(0)
gx, gy = np.meshgrid(np.linspace(0, 355, 24), np.linspace(-60, 60, 24))
pts = np.column_stack([gx.ravel(), gy.ravel()]) + rng.uniform(-2, 2, (24 * 24, 2))
tri = Delaunay(pts)
cells = pts[tri.simplices].mean(axis=1)
lon_c, lat_c = cells[:, 0].astype(np.float32), cells[:, 1].astype(np.float32)
neighbours = (tri.neighbors.T + 1).astype(np.int32)  # 1-based, 0 = none
p = pts[tri.simplices]
cell_areas = (
    0.5
    * np.abs(
        (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
        - (p[:, 2, 0] - p[:, 0, 0]) * (p[:, 1, 1] - p[:, 0, 1])
    ).astype(np.float32)
)

n_years = 12
times = daily_times("2000-01-01", int(n_years * 365.25))
doy = decompose_time(times).dayofyear
C = len(lat_c)
sst = (
    15
    + 3 * np.cos(2 * np.pi * (doy[:, None] - 30) / 365.25) * np.cos(np.deg2rad(lat_c))[None, :]
).astype(np.float32)
noise = rng.standard_normal(sst.shape).astype(np.float32)
for k in range(1, len(times)):
    noise[k] = 0.8 * noise[k - 1] + 0.6 * noise[k]
sst += noise

da = Field(
    sst,
    ("time", "ncells"),
    coords={"time": times, "lat": Coord("ncells", lat_c), "lon": Coord("ncells", lon_c)},
    name="to",
)

# ----------------------------------------------------------------------------
# 1. DETECT (note explicit dims/coords for the mesh)
# ----------------------------------------------------------------------------
extremes = marEx.preprocess_data(
    da,
    method_anomaly="shifting_baseline",
    method_extreme="hobday_extreme",
    window_year_baseline=8,
    threshold_percentile=95,
    dimensions={"x": "ncells"},
    coordinates={"x": "lon", "y": "lat"},
    neighbours=Field(neighbours, ("nv", "ncells")),
    cell_areas=Field(cell_areas, ("ncells",)),
)

# ----------------------------------------------------------------------------
# 2. TRACK with neighbour-graph morphology + BFS partitioning
# ----------------------------------------------------------------------------
tr = marEx.tracker(
    extremes.extreme_events,
    extremes.mask,
    R_fill=2,
    T_fill=2,
    area_filter_quartile=0.5,
    unstructured_grid=True,
    nn_partitioning=True,
    coordinate_units="degrees",
    dimensions={"x": "ncells"},
    coordinates={"x": "lon", "y": "lat"},
    neighbours=extremes.neighbours,
    cell_areas=extremes.cell_areas,
    temp_dir="/tmp",
)
events, merges = tr.run(return_merges=True)
print(f"{events.attrs['N_events_final']} events, {events.attrs['total_merges']} merges")

# ----------------------------------------------------------------------------
# 3. VISUALISE on the native triangulation
# ----------------------------------------------------------------------------
from marex_tpu import PlotConfig
from marex_tpu.core.timeaxis import daily_times, decompose_time

snapshot = events.ID_field.isel(time=-1)
fig, ax, im = snapshot.plotX(dimensions={"time": "time", "x": "ncells"}).single_plot(
    PlotConfig(plot_IDs=True, title="tracked mesh events")
)
fig.savefig("events_mesh.png", dpi=120)
