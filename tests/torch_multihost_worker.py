"""Worker process for the port's multi-process frame-sharding test.

Launched N times by tests/test_torch_multihost.py (argv: process_id
num_processes port out_dir).  Every worker holds only ITS slice of a
deterministic global clip (uneven: the last process holds fewer frames),
joins a gloo process group, runs `sangnom2_multihost` over CPU meshes and
saves its local output shards to ``out_dir`` for the parent to hold
against the single-process call and the TPU package.  Imports neither JAX
nor the TPU package.  Prints CASE_*_OK markers and the collective counts.
"""

import sys

import numpy as np

from sangnom_tpu_torch import Clip, get_format
from sangnom_tpu_torch.parallel import multihost as mh

pid, n_proc, port, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
mh.initialize_distributed(f"127.0.0.1:{port}", n_proc, pid, timeout_s=60)


def global_planes():
    """The global clip of the test, seed 7: 2*n_proc+1 frames of 64x24."""
    rng = np.random.default_rng(7)
    n = 2 * n_proc + 1
    planes = [rng.integers(0, 256, (n, 24, 64)).astype(np.uint8),
              rng.integers(0, 256, (n, 12, 32)).astype(np.uint8),
              rng.integers(0, 256, (n, 12, 32)).astype(np.uint8)]
    return planes, rng.integers(0, 2, (n,)).astype(bool)


planes, parity = global_planes()
mine = np.array_split(np.arange(planes[0].shape[0]), n_proc)[pid]
lo, hi = int(mine[0]), int(mine[-1]) + 1
local = Clip.from_numpy([p[lo:hi] for p in planes], get_format("YUV420P8"),
                        device="cpu", parity=parity[lo:hi])
CPU2 = ["cpu", "cpu"]  # two slots of this process's CPU


def save(name, out):
    np.savez(f"{out_dir}/{name}_{pid}.npz", lo=lo, hi=hi,
             **{f"p{i}": p.numpy() for i, p in enumerate(out.planes)})


# Case A: pure frame sharding across both processes (order=0: the
# per-frame parity of the local shard)
mesh = mh.multihost_mesh(local_devices=CPU2)  # (n_proc*2) x 1
c0 = mh.COLLECTIVES
save("A", mh.sangnom2_multihost(local, mesh, order=0, dh=True))
print(f"CASE_A_OK collectives mesh={c0} call={mh.COLLECTIVES - c0}", flush=True)

# Case B: frames across processes x width inside each process
mesh2 = mh.multihost_mesh(space=2, local_devices=CPU2)  # n_proc x 2
c0 = mh.COLLECTIVES
save("B", mh.sangnom2_multihost(local, mesh2, order=1, aa=0, aac=24,
                                space_axis="space"))
print(f"CASE_B_OK collectives call={mh.COLLECTIVES - c0}", flush=True)

# The three refusals, each raised in every process alike
errors = []
for make in (lambda: mh.multihost_mesh(local_devices=["cpu"] * (pid + 1)),
             lambda: mh.multihost_mesh(space=3, local_devices=CPU2),
             lambda: mh.sangnom2_multihost(
                 local, mh.multihost_mesh(data=1, local_devices=CPU2))):
    try:
        make()
    except ValueError as e:
        errors.append(str(e))
print("ERRORS " + " | ".join(errors), flush=True)
mh.dist.destroy_process_group()
