"""Multi-host execution test: a REAL 2-process jax.distributed cluster
(localhost coordinator, gloo CPU collectives, 2 virtual devices per
process -> a 4-device global mesh) running dist_match and dist_BA
through sfm_jax.parallel.mesh.{init_distributed,make_global_mesh}.

This is the distributed-communication-backend commitment of SURVEY.md
§2.6/§5 exercised across actual process boundaries — the one path the
single-process virtual-mesh tests (test_parallel.py) cannot reach.
NO reference counterpart: the reference is single-GPU
(src/main.cpp:175), with no NCCL/MPI.
"""

import pathlib

import pytest
import socket
import subprocess
import sys

WORKER = pathlib.Path(__file__).resolve().parent / "multihost_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_cpu_cluster():
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(port), str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in range(2)
    ]
    outs = []
    for i, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, (
            f"process {i} rc={p.returncode}\nstdout:\n{out}\nstderr:\n{err}"
        )
        ok_lines = [l for l in out.splitlines() if l.startswith("MULTIHOST_OK")]
        assert ok_lines, f"process {i} produced no OK line:\n{out}\n{err}"
        outs.append(ok_lines[0])
    # Both processes computed the same replicated BA cost trajectory.
    assert outs[0] == outs[1], outs
