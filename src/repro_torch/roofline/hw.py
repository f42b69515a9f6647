"""NVIDIA H100 SXM5 80 GB constants: the roofline's peaks, memory and links
(the reference's ``roofline/hw.py`` holds another accelerator's; none of its
numbers is used here).

Peaks are the dense (no sparsity) figures of NVIDIA's H100 datasheet for the
SXM5 part; the links are NVLink 4 inside a node of 8 cards and one NDR
InfiniBand port a card between nodes.
"""

# NVIDIA H100 Tensor Core GPU datasheet, SXM5 column, dense: FP32 on the
# CUDA cores 67 TFLOP/s; BF16 tensor cores 1,979 / 2 = 989 TFLOP/s; INT8
# tensor cores 3,958 / 2 = 1,979 TOP/s
PEAK_FLOPS_F32 = 67e12
PEAK_FLOPS_BF16 = 989e12
PEAK_OPS_INT8 = 1979e12
# the same datasheet: FP64 on the CUDA cores 34 TFLOP/s (67 on the tensor
# cores, which no kernel of the port uses for f64)
PEAK_FLOPS_F64 = 34e12
# the same datasheet: HBM3, 3.35 TB/s
HBM_BW = 3.35e12
# ``torch.cuda.get_device_properties(0).total_memory`` of an NVIDIA H100 80GB
# HBM3 (power limit 700.00 W, torch 2.11.0+cu128), which ``chip_smoke.py``
# phase 1 prints
HBM_BYTES = 85_017_493_504
# NVLink 4: 900 GB/s a card in both directions together, 450 GB/s each way,
# all to all inside an HGX node of 8 cards
NVLINK_BW = 450e9
GPUS_PER_NODE = 8
# between nodes: one ConnectX-7 NDR port a card, 400 Gb/s = 50 GB/s each way
NET_BW = 50e9
# the production mesh's pod: 16 x 16 ranks (``launch.mesh.make_production_mesh``)
CHIPS_PER_POD = 256

# the peak a kernel's work is held to, by the type its products run in
PEAKS = {"fp32": PEAK_FLOPS_F32, "bf16": PEAK_FLOPS_BF16, "int8": PEAK_OPS_INT8}


def link_bw(ranks) -> float:
    """Bytes/s each way of the link a collective over ``ranks`` crosses:
    NVLink when every rank lies in one node of ``GPUS_PER_NODE``
    consecutive ranks, else the network."""
    nodes = {int(r) // GPUS_PER_NODE for r in ranks}
    return NVLINK_BW if len(nodes) <= 1 else NET_BW
