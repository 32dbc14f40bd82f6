"""Process fleets for the port's mesh tests, on the CPU.

``run_fleet(body, n, tmp_path, *args)`` runs ``body`` (the source of a
``main(rank, world, args)`` function, with any imports it needs) in ``n``
fresh processes that share a gloo default group over a ``FileStore`` under
``tmp_path``; each process destroys its group in a ``finally``. ``world1``
gives one in-process group of a single rank for the same reason: no group
outlives its test on an xdist worker. ``ref_subprocess`` runs reference
package code with forced host devices, which need their own process."""
import contextlib
import itertools
import os
import subprocess
import sys
import textwrap

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")

_SEQ = itertools.count()

PRELUDE = """
import os, sys
sys.path.insert(0, {src!r})
import torch
torch.set_num_threads(1)
import torch.distributed as dist
"""

EPILOGUE = """
if __name__ == "__main__":
    _rank, _world, _store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", store=dist.FileStore(_store, _world),
                            rank=_rank, world_size=_world)
    try:
        main(_rank, _world, sys.argv[4:])
    finally:
        dist.destroy_process_group()
"""


def _env(extra=None) -> dict:
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("LOCAL_RANK", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC, env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    env.update(extra or {})
    return env


def run_fleet(body: str, n: int, tmp_path, *args, env=None,
              timeout: float = 300) -> list:
    """[(returncode, stdout + stderr), ...] of the ``n`` processes."""
    tag = f"fleet{next(_SEQ)}"
    script = os.path.join(tmp_path, f"{tag}.py")
    with open(script, "w") as f:
        f.write(PRELUDE.format(src=SRC) + textwrap.dedent(body) + EPILOGUE)
    store = os.path.join(tmp_path, f"{tag}.store")
    procs = [subprocess.Popen(
        [sys.executable, script, str(r), str(n), store,
         *[str(a) for a in args]], env=_env(env), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    out = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=timeout)
            out.append((p.returncode, text))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def ref_subprocess(code: str, n_devices: int, *args, timeout: float = 300):
    """Run reference-package ``code`` with ``n_devices`` forced host
    devices; returns the CompletedProcess."""
    prelude = (f"import os\nos.environ['XLA_FLAGS'] = "
               f"'--xla_force_host_platform_device_count={n_devices}'\n"
               f"os.environ['JAX_PLATFORMS'] = 'cpu'\n")
    return subprocess.run(
        [sys.executable, "-c", prelude + textwrap.dedent(code),
         *[str(a) for a in args]], env=_env(), capture_output=True,
        text=True, timeout=timeout)


@contextlib.contextmanager
def world1(tmp_path, shape=(1,), names=("data",)):
    """A one-rank gloo group (FileStore under ``tmp_path``) and a CPU
    DeviceMesh of ``shape`` over it; the group is destroyed on exit."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp_path, "w1.store"), 1),
        rank=0, world_size=1)
    try:
        yield DeviceMesh("cpu", torch.zeros(shape, dtype=torch.int64),
                         mesh_dim_names=names)
    finally:
        dist.destroy_process_group()
