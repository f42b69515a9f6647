"""Where K6's backward spends its time, by phase, on the card:

    python scripts/k6_bwd_phases.py

Copies ``src`` to ``build/k6_bwd_phases/src`` and there adds clock()
counters to ``rwkv6_scan_bwd_kernel`` (``csrc/model_kernels.cu``) at the
boundaries of its phases: the forward pass; in each reverse chunk the wait
for its copies, the CTA barrier, the next chunk's copies, beta and dd, the
finalize's operands, the recompute, the walk, the cluster wait, the cluster
arrive and the finalize; the tail.  Warp 0 of every CTA adds up the cycles
of each phase, and the first 16 threads of cluster rank 0 write them in
place of their rows' du partials (the variant's du is not a gradient).
Builds the variant into its own library, runs it at ``chip_smoke``'s
phase-3c shapes (``RWKV_BWD_SHAPE``, ``RWKV_BWD_OTHER_SHAPES``) and prints
one JSON line a shape: SM cycles a CTA by phase, averaged over the heads
(and the batch).  The counters cost a few percent; the phases of a CTA add
up to its run, not to the kernel's (CTAs share the SMs).  Needs a CUDA card.
"""
import importlib.util
import json
import os
import shutil
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREE = os.path.join(ROOT, "build", "k6_bwd_phases")
KERNEL = os.path.join("src", "repro_torch", "csrc", "model_kernels.cu")
PHASES = ["forward pass", "copy wait", "", "CTA barrier", "copies", "beta and dd",
          "finalize operands", "recompute", "walk", "cluster wait", "cluster arrive",
          "finalize", "tail", "total"]
# (text in the kernel, the same text with counters)
PATCHES = [
    ("  if (tid < HD) fu[tid] = p.u[h * HD + tid];  // NT = 2 HD\n",
     "  if (tid < HD) fu[tid] = p.u[h * HD + tid];  // NT = 2 HD\n"
     "  unsigned pc_[16] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  unsigned t_a = (unsigned)clock(), t_b;\n  const unsigned t_start = t_a;\n"
     "#define TICK(k) { t_b = (unsigned)clock(); pc_[k] += t_b - t_a; t_a = t_b; }\n"),
    ("  __syncthreads();  // the ring's memory becomes the reverse pass's buffers\n",
     "  __syncthreads();  // the ring's memory becomes the reverse pass's buffers\n  TICK(0)\n"),
    ("    rb_wait_copies<0>();\n    __syncthreads();",
     "    rb_wait_copies<0>();\n    TICK(1)\n    __syncthreads();"),
    ("    if (c > 0) issue_rev(c - 1);\n    commit();\n",
     "    TICK(3)\n    if (c > 0) issue_rev(c - 1);\n    commit();\n    TICK(4)\n"),
    ("    {\n      float* fc = fin + par * 4 * CK * COLS;",
     "    TICK(5)\n    {\n      float* fc = fin + par * 4 * CK * COLS;"),
    ("    // S_{t-1} of the chunk's steps in registers",
     "    TICK(6)\n    // S_{t-1} of the chunk's steps in registers"),
    ("    // the walk backward.  A step past T", "    TICK(7)\n    // the walk backward.  A step past T"),
    ("    if (c < NC - 1) rb_cluster_wait();", "    TICK(8)\n    if (c < NC - 1) rb_cluster_wait();"),
    ("    rb_cluster_arrive();                // ... and of chunk c\n",
     "    TICK(9)\n    rb_cluster_arrive();                // ... and of chunk c\n    TICK(10)\n"),
    ("    if (c < NC - 1) finalize(c + 1);\n  }", "    if (c < NC - 1) finalize(c + 1);\n    TICK(11)\n  }"),
    ("  if (tid < COLS) p.du_part[(size_t)bh * HD + c0 + tid] = du_acc;\n}",
     "  TICK(12)\n  pc_[13] = (unsigned)clock() - t_start;\n  if (tid < COLS) {\n"
     "    float v_ = du_acc * 0.f;\n#pragma unroll\n"
     "    for (int k_ = 0; k_ < 16; ++k_) if (tid == k_) v_ = (float)pc_[k_];\n"
     "    p.du_part[(size_t)bh * HD + c0 + tid] = v_;\n  }\n}"),
]


def make_variant():
    shutil.rmtree(TREE, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "src"), os.path.join(TREE, "src"))
    path = os.path.join(TREE, KERNEL)
    with open(path) as f:
        text = f.read()
    for old, new in PATCHES:
        if text.count(old) != 1:
            sys.exit(f"the kernel no longer has this phase boundary: {old!r}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    make_variant()
    sys.path.insert(0, os.path.join(TREE, "src"))
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_bwd_cuda

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for label, (b, h, t, hd) in [cs.RWKV_BWD_SHAPE, *cs.RWKV_BWD_OTHER_SHAPES.items()]:
        view = lambda z: z.transpose(1, 2)  # noqa: E731
        r, k, v = (view(torch.randn((b, t, h, hd), generator=gen, device="cuda").bfloat16())
                   for _ in range(3))
        w = view(torch.exp(-torch.exp(torch.empty((b, t, h, hd), device="cuda")
                                      .uniform_(-8.0, -4.0, generator=gen))))
        u = 0.1 * torch.randn((h, hd), generator=gen, device="cuda")
        do = view(torch.randn((b, t, h, hd), generator=gen, device="cuda"))
        rwkv6_scan_bwd_cuda(r, k, v, w, u, do)  # warm-up
        du = rwkv6_scan_bwd_cuda(r, k, v, w, u, do)[4]
        torch.cuda.synchronize()
        cycles = (du[:, :len(PHASES)] / b).mean(0).tolist()  # du sums the batch
        print(json.dumps({"shape": label, "dims": [b, h, t, hd], "cycles_a_cta": {
            name: round(x) for name, x in zip(PHASES, cycles) if name}}), flush=True)
    print(json.dumps({"card": cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()}))


if __name__ == "__main__":
    main()
