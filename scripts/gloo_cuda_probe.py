"""Which collectives a gloo world takes on CUDA tensors: two rank processes
on one card (as ``chip_smoke.py`` phases 12a and 14 start them), one
collective a world, each in processes of its own so that a crash names
its op.  Each op runs on the ranks' main thread and then from a second
thread (the autograd engine issues a backward's collectives from its
device thread).

    python scripts/gloo_cuda_probe.py

Prints one JSON line: per op, each rank's exit code (a negative code is
the signal that ended it) and whether the values came out right.
"""
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor")

RANK = r"""
import datetime, sys, threading
import torch
import torch.distributed as dist

op, rank, store = sys.argv[1], int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2,
                        timeout=datetime.timedelta(seconds=60))
x = torch.arange(8, dtype=torch.float32, device="cuda") + 8 * rank
ok = []


def run():
    if op == "all_reduce":
        y = x.clone()
        dist.all_reduce(y)
        ok.append(torch.equal(y.cpu(), (2 * torch.arange(8) + 8).float()))
    elif op == "all_gather_into_tensor":
        y = torch.empty(16, device="cuda")
        dist.all_gather_into_tensor(y, x)
        ok.append(torch.equal(y.cpu(), torch.arange(16).float()))
    else:
        y = torch.empty(4, device="cuda")
        dist.reduce_scatter_tensor(y, x)
        want = (torch.arange(8) * 2 + 8).float()[4 * rank:4 * rank + 4]
        ok.append(torch.equal(y.cpu(), want))


run()
worker = threading.Thread(target=run)
worker.start()
worker.join()
dist.destroy_process_group()
print(all(ok) and len(ok) == 2, flush=True)
"""


def main():
    out = {}
    for op in OPS:
        with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
            store = os.path.join(d, "store")
            procs = [subprocess.Popen([sys.executable, "-c", RANK, op, str(r), store],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True) for r in range(2)]
            res = []
            for p in procs:
                try:
                    so, se = p.communicate(timeout=120)
                except subprocess.TimeoutExpired:
                    p.kill()
                    so, se = p.communicate()
                res.append({"rc": p.returncode, "right": so.strip() == "True",
                            "stderr": se.strip().splitlines()[-1:]})
            out[op] = res
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    main()
