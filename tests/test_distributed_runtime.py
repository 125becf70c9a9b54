"""Multi-process runtime tests (VERDICT round-1 item 8).

Exercises ``helper.start_distributed_cluster`` with REAL ``jax.distributed``
processes: two local workers join a coordinator, see a 2-process global
topology, and run a cross-process collective — the multi-process analogue of the
reference's SLURM cluster launch (helper.py:414-639). The workers are
subprocesses because jax.distributed.initialize must run before the backend
initialises in each process.
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent(
    """
    import os, sys
    pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, %r)
    import jax
    jax.config.update("jax_platforms", "cpu")
    from marex_tpu.helper import start_distributed_cluster
    info = start_distributed_cluster(
        coordinator_address=f"127.0.0.1:{port}", num_processes=nproc, process_id=pid
    )
    import jax.numpy as jnp
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == nproc
    from jax.experimental import multihost_utils
    total = float(multihost_utils.process_allgather(jnp.ones(()) * (pid + 1)).sum())
    assert total == nproc * (nproc + 1) / 2, total
    print(f"worker {pid} OK total={total}")
    """
    % REPO
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class TestDistributedRuntime:
    def test_two_process_cluster(self, tmp_path):
        script = tmp_path / "worker.py"
        script.write_text(WORKER)
        port = _free_port()
        env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_FLAGS")}
        env["JAX_PLATFORMS"] = "cpu"
        procs = [
            subprocess.Popen(
                [sys.executable, str(script), str(i), "2", str(port)],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                env=env,
            )
            for i in range(2)
        ]
        outs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=240)
            except subprocess.TimeoutExpired:
                p.kill()
                pytest.fail("distributed worker hung")
            outs.append(out.decode(errors="replace"))
        for i, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"worker {i} failed:\n{out[-2000:]}"
            assert f"worker {i} OK total=3.0" in out

    def test_single_process_noop(self):
        # without coordinator args/env the call must not try to initialise
        from marex_tpu.helper import start_distributed_cluster

        env_backup = os.environ.pop("COORDINATOR_ADDRESS", None)
        try:
            info = start_distributed_cluster()
            assert info.n_devices >= 1
            assert info.n_processes == 1
        finally:
            if env_backup is not None:
                os.environ["COORDINATOR_ADDRESS"] = env_backup
