"""≥2-process jax.distributed execution test (BASELINE scaling-gate
correctness witness).

Launches two real OS processes on localhost, each with 4 virtual CPU
devices, forming one 8-device cluster.  The worker
(``tests/multihost_worker.py``) exercises ``parallel.distributed`` +
``transport_ensemble`` + ``make_ensemble_train_step`` +
``sample_gp_posterior`` on the multi-host mesh and asserts numerical
equality with the single-process result.
"""
import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_distributed_matches_single_process(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "multihost_worker.py")
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own device count
    # stdout goes straight to files so a timeout still shows each worker's
    # per-stage progress markers (PIPE would buffer until communicate())
    logs = [tmp_path / f"worker{i}.log" for i in range(2)]
    handles = [open(l, "w") for l in logs]
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", str(port)],
            cwd=root,
            env=env,
            stdout=h,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i, h in zip(range(2), handles)
    ]
    # deadline sized for a 2-core CI box: two processes trace + compile the
    # same programs concurrently (the persistent compile cache makes reruns
    # far faster than the cold first run)
    deadline = 900
    try:
        for p in procs:
            p.communicate(timeout=deadline)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for h in handles:
            h.close()
        pytest.fail(
            "multihost workers timed out:\n"
            + "\n---\n".join(l.read_text() for l in logs)
        )
    for h in handles:
        h.close()
    for i, (p, l) in enumerate(zip(procs, logs)):
        out = l.read_text()
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"MULTIHOST_OK process={i}" in out, out
