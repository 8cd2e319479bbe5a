"""Hardware constants for the roofline analysis: one NVIDIA H100 SXM5
80 GB, from NVIDIA's H100 Tensor Core GPU data sheet (the twin of the JAX
package's ``repro.roofline.constants``, which holds a TPU's).

The collective links: NVLink 4 joins the 8 GPUs of a node at 450 GB/s a
direction a GPU; across nodes each GPU has one 400 Gb/s NDR InfiniBand
port, 50 GB/s.  The rule the dry run applies: a mesh axis of at most
``GPUS_PER_NODE`` ranks runs its collectives over NVLink, and a longer one
crosses nodes (the innermost mesh axis is laid out inside a node, as
``init_device_mesh`` lays out consecutive ranks).
"""

PEAK_FLOPS_BF16 = 989.4e12    # dense bf16 on the tensor cores, per GPU
HBM_BW = 3.35e12              # bytes/s of HBM3 per GPU
HBM_PER_CHIP = 80 * 10**9     # the data sheet's 80 GB of HBM3 per GPU

GPUS_PER_NODE = 8
NVLINK_BW = 450e9             # bytes/s a direction per GPU, inside a node
NETWORK_BW = 50e9             # bytes/s per GPU across nodes (400 Gb/s NDR)

# the scalar (non-tensor-core) 32-bit rate, used for integer and fp32
# work; the special-function units give 16 exponentials a clock per SM
# (compute capability 9.0), at the clock nvidia-smi reports
SCALAR_OPS_PER_S = 67e12
SFU_PER_CLOCK_PER_SM = 16
H100_SMS = 132


def link_bw(axis_size: int) -> float:
    """Bytes/s per GPU of a mesh axis of ``axis_size`` ranks: NVLink
    inside a node, the network beyond it."""
    return NVLINK_BW if axis_size <= GPUS_PER_NODE else NETWORK_BW
