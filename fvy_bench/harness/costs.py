"""The yardstick's arithmetic: an H100's published peaks, the operations
and bytes of the port's kernels and models from their shapes, and the
device-operation categories of a trace.

Copies, held to their originals by tests/test_fvy_bench_copies.py:
`conv_cost`, `block_cost` and `bound` of chip_smoke.py, `category` of
face_vijnana_yolov3_tpu_torch/profile_detect.py, and the arithmetic of
bench.py's `detector_flops_per_image` (there over the JAX package's graph
and a TPU's peaks; here over the graph of configs/<config>.json).
"""

from __future__ import annotations

# Published dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet) and
# its memory rate.
PEAK_INT8 = 1979e12  # int8 tensor-core operations / s
PEAK_BF16 = 989e12  # bf16 tensor-core operations / s
PEAK_F32 = 67e12  # f32 operations / s outside the tensor cores (TF32 off)
HBM = 3.35e12  # bytes / s


def bound(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    """(least time in ms, what bounds it) for moving `nbytes` once and doing
    `ops` at `peak` operations per second."""
    t_bytes, t_ops = nbytes / HBM * 1e3, ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def conv_cost(b, h, w, cin, cout, k, stride, skip):
    """(bytes, int8 operations) of one conv_int8 call: each input read
    once, the output written once; 2 operations per multiply-add."""
    ho = (h + 2 * (k // 2) - k) // stride + 1
    wo = (w + 2 * (k // 2) - k) // stride + 1
    out = b * ho * wo * cout
    nbytes = b * h * w * cin + cout * k * k * cin + 12 * cout + out * (2 if skip else 1)
    nbytes += 4 * cout if skip else 0
    return nbytes, 2 * out * k * k * cin


def block_cost(b, h, w, c, ch):
    nbytes = 2 * b * h * w * c + 10 * c * ch + 12 * ch + 16 * c
    return nbytes, 2 * b * h * w * (c * ch + 9 * ch * c)


def category(name: str) -> str:
    n = name.lower()
    for own in ("block_int8", "conv_int8", "nms_sweep", "front_fused"):
        if own in n:
            return own
    if "conv_tma_kernel" in n or "conv_gather_kernel" in n:  # csrc/conv_int8.cu
        return "conv_int8"
    if "memcpy" in n or "memset" in n:
        return "copy"
    if "conv" in n or "xmma" in n or "gemm" in n or "winograd" in n or "fft" in n:
        return "conv/matmul"
    if "elementwise" in n or "vectorized" in n:
        return "elementwise"
    return "other"


# ------------------------------------------------------------------ graphs

def trunk_convs(arch: dict) -> list[dict]:
    """The truncated Darknet-53 trunk of a configuration file as a list of
    convs in graph order: {"idx", "cin", "cout", "k", "stride", "hw_in",
    "block": None | (position in block, block number)}. `arch` holds
    "image_size" and "trunk": [[out_c, k, stride] for the stem convs and
    [n_blocks, c_half, c_full] for each residual stage, in order]."""
    convs: list[dict] = []
    c, hw, idx, nb = 3, arch["image_size"], 0, 0
    for entry in arch["trunk"]:
        if entry[0] == "conv":
            _, out_c, k, stride = entry
            convs.append(dict(idx=idx, cin=c, cout=out_c, k=k, stride=stride,
                              hw_in=hw, block=None))
            hw //= stride
            c, idx = out_c, idx + 1
        else:
            _, n_blocks, c_half, c_full = entry
            for _ in range(n_blocks):
                convs.append(dict(idx=idx, cin=c, cout=c_half, k=1, stride=1,
                                  hw_in=hw, block=(0, nb)))
                convs.append(dict(idx=idx + 1, cin=c_half, cout=c_full, k=3,
                                  stride=1, hw_in=hw, block=(1, nb)))
                c, idx, nb = c_full, idx + 3, nb + 1
    return convs


def conv_flops(cv: dict) -> float:
    """2·H·W·k²·Cin·Cout at the conv's output size (bench.py's count)."""
    hw = cv["hw_in"] // cv["stride"]
    return 2 * hw * hw * cv["k"] * cv["k"] * cv["cin"] * cv["cout"]


def detector_flops_per_image(arch: dict) -> float:
    """MAC-based FLOPs of one detector forward: the trunk's convs and the
    linear 3x3 head (bench.py's `detector_flops_per_image`)."""
    g = arch["image_size"] // 32
    head = 2 * g * g * 3 * 3 * arch["trunk_channels"] * arch["head_channels"]
    return sum(conv_flops(cv) for cv in trunk_convs(arch)) + head
