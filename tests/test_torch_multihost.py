"""The port's multi-process groups: two local processes join a gloo group
over localhost (``parallel/multihost.py``), build the global ``files`` mesh
from the CPU shards each contributes, and answer ``sharded_sweep_step``
over their own rows, gathering the results with ``process_allgather`` —
the mirror of tests/test_multihost.py (its archive case is in
tests/test_torch_mesh_database.py).  The children import torch and the
port only.  Each child has its own time limit; nothing here skips.
"""

import os
import socket
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: seconds a child may take (a group of two forms in about a second here)
_CHILD_LIMIT = 120

_CHILD = r"""
import sys
import numpy as np

repo, coord = sys.argv[1], sys.argv[2]
pid, ndev, total, nfiles, hit = map(int, sys.argv[3:8])
sys.path.insert(0, repo)

from strugatzki_tpu_torch.analysis.correlation import InputTemplate
from strugatzki_tpu_torch.kernels import corr as K
from strugatzki_tpu_torch.parallel.multihost import (global_files_mesh,
                                                     initialize,
                                                     process_allgather)
from strugatzki_tpu_torch.parallel.sweep import pad_stack, sharded_sweep_step

initialize(coordinator_address=coord, num_processes=2, process_id=pid,
           device="cpu", initialization_timeout=60)
mesh = global_files_mesh(["cpu"] * ndev)
assert mesh.size == total, mesh.size
assert mesh.spans_processes and len(mesh.local) == ndev

# every process builds the SAME dataset and steps the rows of its shards
rng = np.random.default_rng(0)
C, T, L = 14, 96, 24
files = [np.abs(0.5 + 0.1 * rng.standard_normal((C, T))).astype(np.float32)
         for _ in range(nfiles)]
tmpl = InputTemplate(files[hit][:, 17:17 + L].copy())
prepared, shifts = [], []
for f in files:
    xs, sh_t, _ = K.shift_per_group(f)
    prepared.append(xs)
    shifts.append(sh_t)
xs_b, lens = pad_stack(prepared)
shifts = np.asarray(shifts, np.float32)
per = nfiles // mesh.size
lo, hi = mesh.local[0] * per, (mesh.local[-1] + 1) * per

step = sharded_sweep_step(mesh)
vals, idx = step(xs_b[lo:hi], tmpl.temporal_centered, tmpl.spectral_centered,
                 tmpl.temporal_std, tmpl.spectral_std, tmpl.ln_avg_loudness,
                 shifts[lo:hi], lens[lo:hi], 0.5, 8.0)
vals_all = process_allgather(vals)
idx_all = process_allgather(idx)
assert vals_all.shape == (nfiles, 4), vals_all.shape
assert idx_all[hit, 0] == 17, idx_all[hit]
assert abs(vals_all[hit, 0] - 1.0) < 1e-3, vals_all[hit]
print("proc %d ok: global mesh %d, hit @ %d" % (pid, mesh.size,
                                               idx_all[hit, 0]))
"""

_CHILD_MISSING = r"""
import sys
sys.path.insert(0, sys.argv[1])
from strugatzki_tpu_torch.parallel.multihost import initialize
try:
    initialize(coordinator_address=sys.argv[2], num_processes=2,
               process_id=0, device="cpu", initialization_timeout=5)
except Exception as e:
    print("clean failure:", type(e).__name__, str(e)[:200])
    sys.exit(3)
print("unexpectedly initialized")
"""


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def _env() -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="2")
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID"):
        env.pop(k, None)
    return env


def _run(args_per_proc):
    procs = [subprocess.Popen([sys.executable, *args], env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for args in args_per_proc]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=_CHILD_LIMIT)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _assert_ok(outs, marker):
    assert len(outs) == 2
    for rc, out, err in outs:
        assert rc == 0, err[-3000:]
        assert marker in out, (out, err[-1000:])


def test_two_process_sharded_step():
    """4 + 4 CPU shards → an 8-shard global mesh; the planted hit lives on
    process 0's rows and both processes gather every row."""
    coord = _free_port()
    _assert_ok(_run([["-c", _CHILD, _REPO, coord, str(i), "4", "8", "8",
                      "3"] for i in range(2)]), "ok: global mesh 8")


def test_uneven_process_device_counts():
    """4 + 2 shards → a 6-shard mesh: 12 files, 2 rows a shard, process 0
    steps rows 0-7 and process 1 rows 8-11, where the hit lives."""
    coord = _free_port()
    _assert_ok(_run([["-c", _CHILD, _REPO, coord, str(i), str(n), "6",
                      "12", "9"] for i, n in ((0, 4), (1, 2))]),
               "ok: global mesh 6")


def test_missing_worker_fails_cleanly():
    """Process 0 waits for a process 1 that never starts: the group's
    timeout bounds the wait and the failure is a catchable exception."""
    coord = _free_port()
    [(rc, out, err)] = _run([["-c", _CHILD_MISSING, _REPO, coord]])
    assert rc == 3 and "clean failure:" in out, (rc, out, err[-2000:])


def test_single_process_is_a_no_op(monkeypatch):
    """Without arguments or environment, and with one process, nothing is
    joined; the global mesh is then this process's."""
    import numpy as np
    import torch.distributed as dist

    from strugatzki_tpu_torch.parallel import multihost as MH

    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES"):
        monkeypatch.delenv(k, raising=False)
    MH.initialize(device="cpu")
    MH.initialize(num_processes=1, device="cpu")
    assert not dist.is_initialized()
    mesh = MH.global_files_mesh(["cpu"] * 3)
    assert mesh.size == 3 and not mesh.spans_processes
    x = np.arange(6).reshape(3, 2)
    assert np.array_equal(MH.process_allgather(x), x)
