#!/bin/bash
# GPU batch submission (role-equivalent of the reference's SLURM
# submit_track.sh). Runs the detect and track batch jobs on one GPU host:
# ONE JAX process drives every visible GPU through a device mesh
# (MAREX_MESH=1), since a JAX process reserves 75% of each card it opens
# and the batch jobs write their outputs from host-assembled arrays.
#SBATCH --job-name=marex
#SBATCH --nodes=1
#SBATCH --ntasks-per-node=1
#SBATCH --gres=gpu:4
#SBATCH --time=01:00:00

set -euo pipefail

export MAREX_INPUT=${MAREX_INPUT:-sst_global_daily.zarr}
export MAREX_PCTL=${MAREX_PCTL:-95}
export MAREX_R_FILL=${MAREX_R_FILL:-12}
export MAREX_T_FILL=${MAREX_T_FILL:-4}
export MAREX_AREA_FILTER=${MAREX_AREA_FILTER:-600}
export MAREX_OVERLAP=${MAREX_OVERLAP:-0.25}
export MAREX_GRID_RES=${MAREX_GRID_RES:-0.25}
export MAREX_MESH=${MAREX_MESH:-1}
export MAREX_QUIET=1

# persistent XLA compile cache shared by both stages and later runs
export JAX_COMPILATION_CACHE_DIR=${JAX_COMPILATION_CACHE_DIR:-$PWD/.jax_cache}

python examples/batch_jobs/run_detect.py
python examples/batch_jobs/run_track.py
