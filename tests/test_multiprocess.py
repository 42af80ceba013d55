"""Multi-process (multi-host shape) consensus execution.

The reference's one distributed scheme is shared-memory OpenMP
(reference: src/PADMMBase.h:180-213); the rebuild's claim is that the
same fused psum scales past one host.  This test PROVES the
shape: two OS processes, each owning 4 virtual CPU devices, joined by
``jax.distributed`` (Gloo collectives — the CPU stand-in for the
inter-host network), run
the consensus Lasso path over the global 8-device mesh and assert
numerical agreement with the serial solver in every process.
"""
import os
import subprocess
import sys

def test_two_process_consensus_matches_serial():
    script = os.path.join(os.path.dirname(__file__),
                          "multiproc_consensus_worker.py")
    port = 12000 + os.getpid() % 2000
    # The workers set their own virtual-device count and stay on the
    # CPU backend (jax_platforms), so no second process opens a GPU.
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen(
        [sys.executable, script, str(i), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"
        assert "MULTIPROC_OK" in out, out
