"""Where the time of the NMS sweep (B) and the fused front (C) goes, by
ablation: each kernel is rebuilt with one phase compiled out and timed.

    python -m face_vijnana_yolov3_tpu_torch.ablate_kernels [--front-batch 32]
        [--nms-batch 128]

Each variant is the kernel's source (csrc/front_fused.cu, csrc/nms_sweep.cu)
with a text substitution that removes one phase, built by nvcc with the
library's flags into build/ablate/ (all variants at once) and run in a
process of its own (a variant computes garbage, and must not disturb the
others). A variant's device time is a replayed CUDA graph of 20 launches
over the count, on seeded random inputs at 416² (front) and N = 169 (NMS);
the full kernels are also held against their plain twins. The difference
between the full kernel and a variant is what that phase costs where it
does not overlap with the rest. A substitution that no longer matches its
source fails loudly: update it with the kernel. Prints one JSON line per
variant, then the card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from face_vijnana_yolov3_tpu_torch import kernels

OUT = kernels.BUILD_DIR.parent / "ablate"
FRONT = {
    "full": [],
    "no TMA (the consumers' own loader)": [
        ("sh.use_tma = s % 4 == 0;", "sh.use_tma = 0;")],
    "no bf16 conversion of the patch": [
        ("for (int i = wtid; i < kXRw * kXC; i += 128) {",
         "for (int i = wtid; i < 0; i += 128) {")],
    "no conv_0 products": [
        ("wgmma_n32k16(acc, a[dy],", "if (0) wgmma_n32k16(acc, a[dy],")],
    "no conv_1 products": [
        ("wgmma_n64k16(acc, a[grp & 1][dx],", "if (0) wgmma_n64k16(acc, a[grp & 1][dx],")],
    "no output stores": [("if (p < sh.gs && q < sh.gs)", "if (p < 0)")],
}
NMS = {
    "full": [],
    "empty kernel": [("  extern __shared__ float4 smem[];",
                      "  if (n > 0) return;\n  extern __shared__ float4 smem[];")],
    "load only": [("  // 1. mask: warp-wide tasks", "  if (n > 0) return;\n  // 1. mask: warp-wide tasks")],
    "no mask build": [("for (int i = warp; i < n; i += kWarps) {",
                       "for (int i = warp; i < 0; i += kWarps) {")],
    "no scan and write": [("  // 2. scan: lane v holds",
                           "  if (n > 0 && mask[0] == 0x12345u) out[0] = 1.0f;\n"
                           "  if (n > 0) return;\n  // 2. scan: lane v holds")],
}
SOURCES = {"front": "front_fused.cu", "nms": "nms_sweep.cu"}
TABLES = {"front": FRONT, "nms": NMS}


def _lib_path(kind: str, i: int) -> Path:
    return OUT / f"{kind}_{i}.so"


def build() -> None:
    """Every variant's source and shared library under build/ablate/."""
    OUT.mkdir(parents=True, exist_ok=True)
    cmds = []
    for kind, table in TABLES.items():
        src = (kernels.CSRC / SOURCES[kind]).read_text()
        for i, subs in enumerate(table.values()):
            text = src
            for old, new in subs:
                if old not in text:
                    raise RuntimeError(f"ablate_kernels: {SOURCES[kind]} no longer holds "
                                       f"{old!r}; update the substitution")
                text = text.replace(old, new)
            cu = OUT / f"{kind}_{i}.cu"
            cu.write_text(text)
            cmds.append([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-I",
                         str(kernels.CSRC), "-o", str(_lib_path(kind, i)), str(cu)])
    kernels._run_all(cmds)


def graph_ms(fn, reps: int = 20) -> float:
    """Median device ms of one fn() over 6 replays of a graph of `reps` calls."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    times = []
    for _ in range(6):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[len(times) // 2]


def run_front(lib, batch: int) -> dict:
    from face_vijnana_yolov3_tpu_torch.ops.front_fused import (
        front_kernel_weights,
        fused_front_plain,
    )

    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fvy_front_fused.argtypes = [p] * 6 + [i] * 2 + [p]
    g = torch.Generator().manual_seed(0)
    s = 416
    x = torch.rand(batch, s, s, 3, generator=g).cuda()
    folded = {"conv_0": {"kernel": torch.randn(32, 3, 3, 3, generator=g) * 0.27,
                         "bias": torch.randn(32, generator=g) * 0.1},
              "conv_1": {"kernel": torch.randn(64, 32, 3, 3, generator=g) * 0.083,
                         "bias": torch.randn(64, generator=g) * 0.1}}
    folded = {k: {n: t.cuda() for n, t in v.items()} for k, v in folded.items()}
    w = front_kernel_weights(folded)
    out = torch.empty(batch, s // 2, s // 2, 64, dtype=torch.bfloat16, device="cuda")

    def call():
        rc = lib.fvy_front_fused(x.data_ptr(), *(t.data_ptr() for t in w), out.data_ptr(),
                                 batch, s, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fvy_front_fused returned {rc}")

    ms = graph_ms(call)
    call()
    d = (out.float() - fused_front_plain(x, folded).float()).abs()
    return {"ms": ms, "max_abs_diff": float(d.max()), "fraction_differing": float((d > 0).float().mean())}


def run_nms(lib, batch: int) -> dict:
    from face_vijnana_yolov3_tpu_torch.ops.nms_sweep import nms_sweep_reference

    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fvy_nms_sweep.argtypes = [p, p, p, i, i, f, p]
    g = torch.Generator().manual_seed(0)
    n = 169
    mins = torch.floor(torch.rand(batch, n, 2, generator=g) * 300)
    sizes = torch.floor(torch.rand(batch, n, 2, generator=g) * 110 + 10)
    boxes = torch.cat([mins, mins + sizes], -1).cuda()
    scores = torch.rand(batch, n, generator=g) * 0.99 + 0.01
    scores[:, ::9] = 0.0
    scores = (-torch.sort(-scores, -1).values).cuda()
    out = torch.empty_like(scores)

    def call():
        rc = lib.fvy_nms_sweep(boxes.data_ptr(), scores.data_ptr(), out.data_ptr(), batch,
                               n, 0.5, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fvy_nms_sweep returned {rc}")

    ms = graph_ms(call)
    call()
    return {"ms": ms, "equal": bool(torch.equal(out, nms_sweep_reference(boxes, scores, 0.5)))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--front-batch", type=int, default=32)
    ap.add_argument("--nms-batch", type=int, default=128)
    ap.add_argument("--variant", nargs=2, metavar=("KIND", "INDEX"), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ablate_kernels: no CUDA device is visible", file=sys.stderr)
        return 2
    if args.variant:  # one variant, in its own process
        kind, i = args.variant[0], int(args.variant[1])
        lib = ctypes.CDLL(str(_lib_path(kind, i)))
        rec = (run_front(lib, args.front_batch) if kind == "front"
               else run_nms(lib, args.nms_batch))
        print(json.dumps(rec))
        return 0
    build()
    for kind, table in TABLES.items():
        for i, name in enumerate(table):
            proc = subprocess.run(
                [sys.executable, "-m", "face_vijnana_yolov3_tpu_torch.ablate_kernels",
                 "--front-batch", str(args.front_batch), "--nms-batch", str(args.nms_batch),
                 "--variant", kind, str(i)], capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"{kind} variant {name!r} failed:\n{proc.stderr[-2000:]}")
            rec = {"kernel": kind, "variant": name,
                   "batch": args.front_batch if kind == "front" else args.nms_batch,
                   **json.loads(proc.stdout.strip().splitlines()[-1])}
            print(json.dumps(rec))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
