"""Multi-process (2-host-shaped) mesh integration test (VERDICT r2 #1).

Spawns 2 worker processes x 4 virtual CPU devices each, connected through
``jax.distributed.initialize`` (TCP coordinator + gloo CPU collectives),
and runs both sharded receivers SER-gated across the process boundary —
the execution shape of a 2-host scale-out, without the hardware. The
workers are separate interpreters (the
multi-controller runtime requires one process per host), so this test
drives them via subprocess rather than in-process fixtures.
"""
import os
import socket
import subprocess
import sys


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_mesh_chains():
    coord = "localhost:%d" % _free_port()
    worker = os.path.join(os.path.dirname(__file__), "mp_worker.py")
    env = dict(os.environ)
    # the workers configure their own platform/device count through the
    # config API (init_distributed); scrub the test-session forcing so the
    # two layers cannot fight
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(worker))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, worker, str(i), "2", coord],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, \
            "worker %d failed (rc=%s):\n%s" % (i, p.returncode, out[-4000:])
        assert "MP_WORKER_OK process=%d" % i in out, out[-4000:]
