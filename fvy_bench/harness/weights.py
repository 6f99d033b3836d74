"""Seeded weights, made on the card in a few large draws.

The detector's weights under the port's state-dict names (`conv_{i}.weight`
OIHW, `bnorm_{i}.gamma/beta/mean/var`, `head.weight`, `head.bias`), drawn
as face_vijnana_yolov3_tpu_torch/models/darknet.py draws random weights for
its card runs: kernels uniform(±sqrt(6 / fan_in)) (`init_graph_params`),
BatchNorm statistics as `perturb_batchnorm` draws them (gamma U(0.5, 1.5),
U(0.05, 0.15) on the convs that end a residual branch, so the residual
stream stays O(1); beta and mean N(0, 0.1); var U(0.5, 1.5)); the
detector's glorot-uniform head with the configuration's assumed bias, the
identifier's glorot-uniform dense1. Both sides of a run (the program and
the reference) are handed these tensors.
"""

from __future__ import annotations

import math

import torch

from fvy_bench.harness.costs import trunk_convs


def _trunk(arch: dict, gen: torch.Generator, device, extra: tuple[int, ...]):
    """(The trunk's kernels and BatchNorm statistics, one more uniform
    (-1, 1) draw of shape `extra`), from `gen`."""
    convs = trunk_convs(arch)
    shapes = [(cv["cout"], cv["cin"], cv["k"], cv["k"]) for cv in convs]
    sizes = [math.prod(s) for s in shapes]
    # One draw for every kernel, then each kernel scaled to its limit.
    flat = torch.rand(sum(sizes) + math.prod(extra), generator=gen, device=device) * 2 - 1
    sd: dict[str, torch.Tensor] = {}
    off = 0
    for cv, shape, n in zip(convs, shapes, sizes):
        limit = math.sqrt(6.0 / (cv["k"] * cv["k"] * cv["cin"]))
        sd[f"conv_{cv['idx']}.weight"] = (flat[off:off + n] * limit).view(shape)
        off += n
    extra_draw = flat[off:].view(extra)
    # BatchNorm: four draws over every channel of the trunk.
    chans = [cv["cout"] for cv in convs]
    total = sum(chans)
    u_gamma = torch.rand(total, generator=gen, device=device)
    beta = torch.randn(total, generator=gen, device=device) * 0.1
    mean = torch.randn(total, generator=gen, device=device) * 0.1
    var = torch.rand(total, generator=gen, device=device) + 0.5
    off = 0
    for cv, c in zip(convs, chans):
        sl = slice(off, off + c)
        branch_end = cv["block"] is not None and cv["block"][0] == 1
        gamma = u_gamma[sl] * 0.1 + 0.05 if branch_end else u_gamma[sl] + 0.5
        name = f"bnorm_{cv['idx']}"
        sd[f"{name}.gamma"] = gamma
        sd[f"{name}.beta"] = beta[sl]
        sd[f"{name}.mean"] = mean[sl]
        sd[f"{name}.var"] = var[sl]
        off += c
    return sd, extra_draw


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    return gen


def detector_state_dict(arch: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The detector of configuration `arch` from `seed`, f32 on `device`:
    the trunk, a glorot-uniform 3x3 head and its assumed bias."""
    shape = (arch["head_channels"], arch["trunk_channels"], 3, 3)
    sd, u = _trunk(arch, _generator(seed, device), device, shape)
    limit = math.sqrt(6.0 / (9 * arch["trunk_channels"] + arch["head_channels"]))
    sd["head.weight"] = u * limit
    sd["head.bias"] = torch.tensor(arch["assumed"]["head_bias"], dtype=torch.float32,
                                   device=device)
    return {k: v.contiguous() for k, v in sd.items()}


def identifier_state_dict(arch: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The identifier of configuration `arch` from `seed`, f32 on `device`:
    the trunk and a glorot-uniform dense1 (D, flat) with a zero bias, its
    columns in the feature's (H, W, C) order."""
    g = arch["image_size"] // 32
    flat_dim = g * g * arch["trunk_channels"]
    d = arch["dense1_dim"]
    sd, u = _trunk(arch, _generator(seed, device), device, (d, flat_dim))
    sd["dense1.weight"] = u * math.sqrt(6.0 / (flat_dim + d))
    sd["dense1.bias"] = torch.zeros(d, device=device)
    return {k: v.contiguous() for k, v in sd.items()}
