"""`train_mfu`: the training step's share of the H100's f32 peak (67
TFLOP/s; TF32 is off), in %: the forward and backward conv FLOPs of the
images trained in the traced window (the driver's `train_flops_per_image`),
over its seconds."""

from fvy_bench.harness.costs import PEAK_F32


def read(run: dict):
    rec = run["record"]
    if not rec.get("images"):
        return None
    return 100.0 * rec["train_flops_per_image"] * rec["images"] / rec["window_s"] / PEAK_F32
