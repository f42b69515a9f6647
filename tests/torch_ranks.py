"""Runs a script as the ranks of a ``torch.distributed`` world on the CPU
(gloo), for the port's multi-process tests: one subprocess a rank, the
world's rendezvous through a ``FileStore`` under the test's ``tmp_path``
(no TCP port, so parallel test workers cannot collide), a 60 s timeout on
every collective and one deadline on the whole world, so that a hung
collective fails its test instead of holding the suite.

In the script, ``RANK``, ``WORLD`` and ``OUT`` (the test's directory) are
set and the process group is initialised; it is destroyed after."""
import os
import subprocess
import sys
import textwrap
import uuid

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")

PRELUDE = """
import datetime, os, sys
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD, OUT = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), os.environ["OUT"]
dist.init_process_group("gloo", store=dist.FileStore(os.environ["STORE_FILE"], WORLD),
                        rank=RANK, world_size=WORLD, timeout=datetime.timedelta(seconds=60))
"""
EPILOGUE = """
dist.destroy_process_group()
"""


def run_ranks(code: str, world: int, out_dir, timeout: float = 120.0) -> list:
    """Run ``code`` as ``world`` ranks; returns each rank's stdout.  Fails
    (AssertionError) when a rank exits non-zero or the world outlives
    ``timeout`` seconds, after killing every rank."""
    store = os.path.join(str(out_dir), f"store_{uuid.uuid4().hex}")
    script = PRELUDE + textwrap.dedent(code) + EPILOGUE
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
               WORLD_SIZE=str(world), STORE_FILE=store, OUT=str(out_dir),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", script], env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    outs = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{err[-3000:]}"
            outs.append(out)
    except subprocess.TimeoutExpired:
        raise AssertionError(f"the world of {world} ranks outlived {timeout} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def run_reference(code: str, devices: int, args=()):
    """Start ``code`` with the reference package on ``devices`` forced host
    devices (``XLA_FLAGS``), as the reference's own multi-device tests do,
    with ``args`` as its ``sys.argv[1:]``; :func:`finish` waits for it."""
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code), *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish(proc, timeout: float = 300.0) -> str:
    """Wait for a :func:`run_reference` process; its stdout, or a failure."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"the reference's process outlived {timeout} s") from None
    assert proc.returncode == 0, err[-3000:]
    return out


def unflatten_paths(flat: dict, sep: str = "/") -> dict:
    """A nested dict from ``{"a/b/c": leaf}`` (a reference tree saved with
    ``np.savez`` under its key paths joined by ``sep``)."""
    tree = {}
    for path, leaf in flat.items():
        node = tree
        *head, last = path.split(sep)
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree
