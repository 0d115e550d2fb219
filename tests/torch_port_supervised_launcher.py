"""A supervised command for ``tests/test_torch_port_supervisor.py``'s
resize case (not a test module itself):

    python tests/torch_port_supervised_launcher.py TMP CK OUT

starts ``BIGDL_TORCH_AUTOSCALE_WORLD`` ranks of
``tests/torch_port_distri_worker.py`` over gloo and a ``FileStore``
under TMP.  The first launch (``BIGDL_TORCH_ELASTIC_ATTEMPT`` 0) runs
the worker's ``ckpt`` case (one epoch, checkpointed into CK), writes
``TMP/ready`` and waits for the supervisor's SIGTERM, then exits 170
(the preemption exit a resize stops a child with).  A later launch runs
the ``resume`` case from CK at its world and writes rank 0's arrays to
OUT.  A SIGTERM is passed on to the ranks.  Imports neither JAX nor the
JAX package.
"""

import os
import signal
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_port_distri_worker.py")


def main(tmp, ck, out):
    world = int(os.environ["BIGDL_TORCH_AUTOSCALE_WORLD"])
    attempt = int(os.environ["BIGDL_TORCH_ELASTIC_ATTEMPT"])
    case = "ckpt" if attempt == 0 else "resume"
    store = os.path.join(tmp, f"store{attempt}")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), str(world), store,
         ck if case == "ckpt" else
         (out if r == 0 else os.path.join(tmp, f"x{r}.npz")), case]
        + ([ck] if case == "resume" else []), cwd=os.path.dirname(HERE))
        for r in range(world)]
    stop = []

    def forward(signum, frame):
        stop.append(signum)
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    signal.signal(signal.SIGTERM, forward)
    rcs = [p.wait(timeout=300) for p in procs]
    if any(rcs):
        return max(rcs)
    if attempt == 0:
        with open(os.path.join(tmp, "ready"), "w") as f:
            f.write(str(world))
        deadline = time.time() + 120
        while not stop and time.time() < deadline:
            time.sleep(0.02)
        return 170 if stop else 1
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:4]))
