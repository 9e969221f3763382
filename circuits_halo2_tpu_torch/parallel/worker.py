"""Start a ``torch.distributed`` world of worker processes, one a rank, and
collect what each rank's task returns.

    results = launch(4, "gloo", "cpu", "path/to/tasks.py:kernels", {"seed": 1}, timeout=600)

``launch`` holds a ``TCPStore`` on a free port (bound to port 0, so two
launches at once never collide) and starts ``world`` processes of

    python -m circuits_halo2_tpu_torch.parallel.worker --rank R ...

Each rank joins the process group through that store (with a timeout),
builds the mesh of the default group on its device (``cuda:{rank %
device_count}``, or the CPU when asked), calls the task
(``"module:function"`` or ``"file.py:function"``) as
``task(mesh, **args)`` and prints its JSON-able result as the last line.
If a rank fails, the others are killed and that rank's output, traceback
included, is raised. The ranks load the CUDA kernels but never build them:
``launch`` builds them first in the calling process.
"""

from __future__ import annotations

import argparse
import datetime
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch
import torch.distributed as dist

from .sharding import default_device, make_mesh

MODULE = "circuits_halo2_tpu_torch.parallel.worker"
RESULT = "RANK_RESULT "
ROOT = Path(__file__).resolve().parents[2]  # the directory that holds the package


def launch(world: int, backend: str, device: str, task: str, args: dict | None = None,
           timeout: float = 900.0, threads: int | None = None,
           popen=subprocess.Popen) -> list:
    """Run ``task`` on ``world`` ranks over ``backend`` ("gloo" or "nccl")
    with every rank on ``device`` ("cuda": each rank's card; "cpu") and
    return the ranks' results in rank order. ``threads`` is each rank's
    torch thread count (default: the cores shared out); ``popen`` starts a
    process (a caller that tracks its children passes its own)."""
    if device == "cuda":
        from .. import build

        build.compile_cuda()
    threads = threads or max(1, (os.cpu_count() or 1) // world)
    store = dist.TCPStore("localhost", 0, None, True,
                          timeout=datetime.timedelta(seconds=timeout), wait_for_workers=False)
    procs, outputs, readers = [], [], []
    try:
        for rank in range(world):
            cmd = [sys.executable, "-m", MODULE, "--rank", str(rank),
                   "--world", str(world), "--port", str(store.port), "--backend", backend,
                   "--device", device, "--task", task, "--args", json.dumps(args or {}),
                   "--threads", str(threads), "--timeout", str(timeout)]
            procs.append(popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True))
            outputs.append([])
            readers.append(threading.Thread(target=lambda p=procs[-1], o=outputs[-1]:
                                            o.append(p.stdout.read()), daemon=True))
            readers[-1].start()
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes):
                break
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or time.monotonic() > deadline:
                for p in procs:
                    p.kill()
                for t in readers:
                    t.join(10)
                if failed:
                    r = failed[0]
                    raise RuntimeError(f"rank {r} of {world} exited with {codes[r]}:\n"
                                       + "".join(outputs[r])[-8000:])
                raise TimeoutError(f"the {world}-rank world did not finish in {timeout} s")
            time.sleep(0.05)
        for t in readers:
            t.join(60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, out in enumerate(outputs):
        lines = [x for x in "".join(out).splitlines() if x.startswith(RESULT)]
        if not lines:
            raise RuntimeError(f"rank {r} printed no result:\n" + "".join(out)[-8000:])
        results.append(json.loads(lines[-1][len(RESULT):]))
    return results


def _load(task: str):
    """``module:function`` or ``path/to/file.py:function``."""
    module, _, name = task.rpartition(":")
    if module.endswith(".py"):
        spec = importlib.util.spec_from_file_location(Path(module).stem, module)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(module)
    return getattr(mod, name)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one rank of a launch() world")
    for flag in ("--rank", "--world", "--port", "--threads"):
        ap.add_argument(flag, type=int, required=True)
    for flag in ("--backend", "--device", "--task", "--args"):
        ap.add_argument(flag, required=True)
    ap.add_argument("--timeout", type=float, required=True)
    opts = ap.parse_args(argv)
    torch.set_num_threads(opts.threads)
    device = torch.device("cpu") if opts.device == "cpu" else default_device(opts.rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=opts.timeout)
    store = dist.TCPStore("localhost", opts.port, None, False, timeout=timeout)
    dist.init_process_group(opts.backend, store=store, rank=opts.rank,
                            world_size=opts.world, timeout=timeout)
    # a failing task exits with its traceback and leaves the group as it is:
    # launch() kills the other ranks
    result = _load(opts.task)(make_mesh(device=device), **json.loads(opts.args))
    print(RESULT + json.dumps(result), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
