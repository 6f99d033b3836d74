"""Darknet binary weight reader (numpy only) → port state-dict arrays.

Port of face_vijnana_yolov3_tpu/core/weights.py:23-83. Format: 3 int32 header
fields (major/minor/revision), then 8 bytes (seen-images counter) when
major*10+minor >= 2 else 4, then a flat float32 stream. Per conv, in the
order of `conv_layout(ops)`: for BN convs beta, gamma, moving mean, moving
variance (C floats each), then the kernel as [out, in, k, k] row-major; for
bias convs, bias then kernel. [out, in, k, k] is already PyTorch's OIHW, so
the kernel needs no transpose here (the JAX reader transposes it to HWIO).
`save_darknet_weights` writes the same format (header 0.2.0, a zero
seen-images counter), so seeded random weights can go through the paths
that read a `yolov3.weights` file.
"""

from __future__ import annotations

import struct

import numpy as np

from face_vijnana_yolov3_tpu_torch.models.darknet import conv_layout


class DarknetWeightStream:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            major = struct.unpack("i", f.read(4))[0]
            minor = struct.unpack("i", f.read(4))[0]
            struct.unpack("i", f.read(4))[0]  # revision
            if (major * 10 + minor) >= 2 and major < 1000 and minor < 1000:
                f.read(8)
            else:
                f.read(4)
            self.data = np.frombuffer(f.read(), dtype=np.float32)
        self.offset = 0

    def take(self, n: int) -> np.ndarray:
        out = self.data[self.offset : self.offset + n]
        if out.shape[0] != n:
            raise ValueError(
                f"darknet weight file exhausted: wanted {n} floats at offset "
                f"{self.offset}, have {self.data.shape[0]}"
            )
        self.offset += n
        return out


def load_darknet_weights(path: str, ops: list[tuple]) -> dict[str, np.ndarray]:
    """Read a darknet .weights file into `{state-dict key: f32 array}` for the
    graph IR `ops` (the trunk's convs are a prefix of the full YOLOv3 file)."""
    stream = DarknetWeightStream(path)
    sd: dict[str, np.ndarray] = {}
    for idx, in_c, out_c, k, _stride, bn in conv_layout(ops):
        if bn:
            for field in ("beta", "gamma", "mean", "var"):
                sd[f"bnorm_{idx}.{field}"] = stream.take(out_c).copy()
        else:
            sd[f"conv_{idx}.bias"] = stream.take(out_c).copy()
        sd[f"conv_{idx}.weight"] = (
            stream.take(out_c * in_c * k * k).reshape(out_c, in_c, k, k).copy())
    return sd


def save_darknet_weights(path: str, state_dict: dict, ops: list[tuple]) -> None:
    """Write `state_dict` (the keys `load_darknet_weights` gives) as a
    darknet .weights file for the graph IR `ops`; it reads back equal."""
    chunks = []
    for idx, _in_c, _out_c, _k, _stride, bn in conv_layout(ops):
        if bn:
            chunks += [state_dict[f"bnorm_{idx}.{field}"]
                       for field in ("beta", "gamma", "mean", "var")]
        else:
            chunks.append(state_dict[f"conv_{idx}.bias"])
        chunks.append(state_dict[f"conv_{idx}.weight"])
    with open(path, "wb") as f:
        f.write(np.array([0, 2, 0], np.int32).tobytes())
        f.write(bytes(8))
        for c in chunks:
            a = c.detach().cpu().numpy() if hasattr(c, "detach") else np.asarray(c)
            f.write(np.ascontiguousarray(a, np.float32).tobytes())
