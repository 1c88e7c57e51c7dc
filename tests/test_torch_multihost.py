"""The port's multi-process frame sharding (sangnom_tpu_torch.parallel.
multihost) in real processes over torch.distributed.

Spawns 2 OS processes (tests/torch_multihost_worker.py, which imports no
JAX), each owning only its uneven slice of the clip, joined by a gloo
process group on a free local port.  The parent holds each worker's
output shard against the port's single-process call, and that against
``sangnom_tpu.sangnom2``, bit for bit; and counts the collectives: one to
build a mesh and one a call.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

N_PROC = 2
WORKER = os.path.join(os.path.dirname(__file__), "torch_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("multihost")
    env = dict(os.environ)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(WORKER)))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, WORKER, str(i), str(N_PROC), str(port),
                               str(out_dir)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env)
             for i in range(N_PROC)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
    return out_dir, outs


def _expected():
    """The global clip of the worker, through the port's single-process
    call and the TPU package's, which must agree."""
    import sangnom_tpu as J

    import sangnom_tpu_torch as T

    rng = np.random.default_rng(7)
    n = 2 * N_PROC + 1
    planes = [rng.integers(0, 256, (n, 24, 64)).astype(np.uint8),
              rng.integers(0, 256, (n, 12, 32)).astype(np.uint8),
              rng.integers(0, 256, (n, 12, 32)).astype(np.uint8)]
    parity = rng.integers(0, 2, (n,)).astype(bool)
    want = {}
    for case, kw in (("A", dict(order=0, dh=True)), ("B", dict(order=1, aa=0, aac=24))):
        port = T.sangnom2(T.Clip.from_numpy(planes, "YUV420P8", device="cpu",
                                            parity=parity), **kw)
        jax = J.sangnom2(J.Clip.from_numpy(planes, "YUV420P8", parity=parity), **kw)
        for a, b in zip(port.planes, jax.planes):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        want[case] = [p.numpy() for p in port.planes]
    return want


@pytest.mark.parametrize("case", ["A", "B"])
def test_multihost_shards_equal_single_process(workers, case):
    out_dir, outs = workers
    want = _expected()[case]
    covered = []
    for pid in range(N_PROC):
        assert f"CASE_{case}_OK" in outs[pid], outs[pid]
        got = np.load(out_dir / f"{case}_{pid}.npz")
        lo, hi = int(got["lo"]), int(got["hi"])
        covered += list(range(lo, hi))
        for i in range(3):
            np.testing.assert_array_equal(got[f"p{i}"], want[i][lo:hi],
                                          err_msg=f"case {case} process {pid} plane {i}")
    assert covered == list(range(2 * N_PROC + 1))  # uneven: 3 + 2 frames


def test_multihost_one_collective_a_call(workers):
    _, outs = workers
    for out in outs:
        assert "CASE_A_OK collectives mesh=1 call=1" in out, out
        assert "CASE_B_OK collectives call=1" in out, out


def test_multihost_refusals_keep_the_reference_messages(workers):
    _, outs = workers
    for out in outs:
        line = next(ln for ln in out.splitlines() if ln.startswith("ERRORS "))
        assert line == (
            "ERRORS uneven device counts: 3 devices over 2 processes | "
            "space=3 does not divide the 2 local devices of each process; halo "
            "exchange would cross the DCN | data axis (1) must be a multiple of "
            "the process count (2) for process-contiguous frame shards"), line
