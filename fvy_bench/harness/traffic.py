"""The one traffic generator: seeded synthetic scenes in the UCCS layout,
drawn from the parameters of a traffic file (traffic/<name>.json).

A scene is face_vijnana_yolov3_tpu_torch/data/synthetic.make_dataset's
draw, copied (tests/test_fvy_bench_copies.py holds it to the original): a
textured background, uniform(lo, hi) + normal(0, std) per channel, then
`faces` bright disks of radius r in [r_lo, r_hi), centre in
[r + 2, side - r - 2), each disk a UCCS row (FACE_X = cx - r, FACE_Y =
cy - r, FACE_WIDTH = FACE_HEIGHT = 2r), clipped to uint8. The face counts,
radii and centres come from numpy's `default_rng(seed)` on the host; the
pixels from a `torch.Generator` on the device, a chunk at a time, so that a
ring of 720p chunks takes a fraction of a second. The same seed gives the
same scenes; every seed gives the same sizes and the same number of
chunks, so a seed changes the pictures and not the work.
"""

from __future__ import annotations

import numpy as np
import torch


def face_rows(params: dict, n: int, rng: np.random.Generator) -> list[np.ndarray]:
    """For each of n scenes, its faces as an (F, 3) int array (cx, cy, r),
    in make_dataset's draw order: the count, then r, cx, cy of each face."""
    h, w = params["height"], params["width"]
    f_lo, f_hi = params["faces_per_frame"]
    r_lo, r_hi = params["face_radius"]
    out = []
    for _ in range(n):
        faces = []
        for _ in range(int(rng.integers(f_lo, f_hi + 1))):
            r = int(rng.integers(r_lo, r_hi))
            cx = int(rng.integers(r + 2, w - r - 2))
            cy = int(rng.integers(r + 2, h - r - 2))
            faces.append((cx, cy, r))
        out.append(np.asarray(faces, np.int64).reshape(-1, 3))
    return out


def paint(n: int, faces: list[np.ndarray], params: dict, gen: torch.Generator,
          device) -> torch.Tensor:
    """(n, H, W, 3) uint8 scenes on `device`: the background draw, then the
    disks of `faces`."""
    h, w = params["height"], params["width"]
    lo, hi = params["background_uniform"]
    img = torch.rand((n, h, w, 3), generator=gen, device=device) * (hi - lo) + lo
    img += torch.randn((n, h, w, 3), generator=gen, device=device) * params["background_std"]
    color = torch.tensor(params["face_rgb"], dtype=img.dtype, device=device)
    for k, rows in enumerate(faces):
        for cx, cy, r in rows.tolist():
            y0, x0 = cy - r, cx - r
            yy = torch.arange(y0, cy + r + 1, device=device)[:, None]
            xx = torch.arange(x0, cx + r + 1, device=device)[None, :]
            disk = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
            region = img[k, y0:cy + r + 1, x0:cx + r + 1]
            region[disk] = color
    return img.clamp_(0, 255).to(torch.uint8)


def make_scenes(params: dict, seed: int, device, n: int | None = None):
    """(uint8 scenes (N, H, W, 3) on `device`, faces per scene) of a traffic
    file; N = chunk * ring_chunks unless given."""
    n = params["chunk"] * params["ring_chunks"] if n is None else n
    rng = np.random.default_rng(seed % (1 << 63))
    faces = face_rows(params, n, rng)
    gen = torch.Generator(device=device)
    gen.manual_seed((seed + 1) % (1 << 63))
    step = params["chunk"]
    frames = torch.cat([paint(min(step, n - s), faces[s:s + step], params, gen, device)
                        for s in range(0, n, step)])
    return frames, faces


def gt_tensor(faces: np.ndarray, image_size: int, grid: int, channels: int) -> np.ndarray:
    """One square scene's (grid, grid, channels) training target, the
    arithmetic of data/uccs.build_gt_tensor for an image of side
    `image_size` (no letterbox pad), copied."""
    cell = image_size // grid
    gt = np.zeros((grid, grid, channels), np.float64)
    for cx, cy, r in faces.tolist():
        x1, y1 = cx - r, cy - r
        x2, y2 = x1 + 2 * r - 1, y1 + 2 * r - 1
        x1_p, y1_p = int(x1 / image_size * image_size), int(y1 / image_size * image_size)
        x2_p, y2_p = int(x2 / image_size * image_size), int(y2 / image_size * image_size)
        xc_p, yc_p = (x1_p + x2_p) // 2, (y1_p + y2_p) // 2
        gx, gy = xc_p // cell, yc_p // cell
        gt[gy, gx] = (1.0, (xc_p - gx * cell) / cell, (yc_p - gy * cell) / cell,
                      2 * r / image_size, 2 * r / image_size, 1.0)
    return gt
