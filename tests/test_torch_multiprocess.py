"""Two real processes on the process mesh (gloo), against the local mesh.

Counterpart of tests/test_multiprocess.py: the JAX package starts two
``jax.distributed`` processes of 4 fake CPU devices each; the port starts
two processes that join one gloo group through a file store under
``tmp_path`` (no TCP port, so parallel test workers never collide), one
shard each (``tests/torch_multiproc_worker.py``). Across the process
boundary they run the per-process memmap row loading, the halo plan kept
by rank, one ``halo_attention_ell`` gradient step (within 1e-5 of the
local mesh at P = 2, and on a 2-D edge × head process mesh), two epochs of ``fit_edge_partitioned`` (within
1e-5), ``fit_sampled_dp`` at P = 2 (equal to the local mesh bit for bit:
each shard's gradient is computed alone and the mean is taken in shard
order) and a ``torch.save`` checkpoint of each rank's shards. Each child
has a time limit and is killed when it runs over.
"""

import os
import subprocess
import sys

import numpy as np

TIMEOUT_S = 90


def test_two_real_processes(tmp_path):
    rng = np.random.default_rng(0)
    np.save(tmp_path / "feats.npy",
            rng.normal(size=(256, 8)).astype(np.float32))
    worker = os.path.join(os.path.dirname(__file__),
                          "torch_multiproc_worker.py")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, worker, str(i),
                               str(tmp_path)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for i in range(2)]
    outs = []
    try:
        for pr in procs:
            out, _ = pr.communicate(timeout=TIMEOUT_S)
            outs.append(out)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    for i, (pr, out) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0, f"worker {i} failed:\n{out}"
        for tag in ("ROWRANGE", "PLAN", "STEP", "MESH2D", "FIT", "DP", "CKPT",
                    "PASS"):
            assert f"{tag} {i}" in out, (tag, out)
    # Both ranks report the same global loss.
    losses = [float(line.split("loss=")[1]) for out in outs
              for line in out.splitlines() if line.startswith("STEP")]
    assert len(losses) == 2 and losses[0] == losses[1], losses
