"""JAX param/state trees ↔ torch state dicts.

The JAX package keeps `params[f"conv_{i}"] = {"kernel": HWIO[, "bias"]}`,
`params[f"bnorm_{i}"] = {"gamma", "beta"}`, `state[f"bnorm_{i}"] = {"mean",
"var"}` and `params["head"] = {"kernel", "bias"}` as host numpy (or jax)
arrays. The port's modules carry the same names as state-dict prefixes:
`conv_{i}.weight` (OIHW) / `conv_{i}.bias`, `bnorm_{i}.gamma/beta/mean/var`,
`head.weight` / `head.bias`. Both directions are exact copies, so the parity
tests hand both packages the same numpy weights. `folded_from_jax` and
`qparams_from_jax` carry the JAX package's folded and int8-quantized trees
over the same way, so the port's int8 path can run the JAX package's own
calibration.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(params_np: dict, state_np: dict) -> dict[str, torch.Tensor]:
    """(params, state) trees of numpy-convertible arrays → f32 CPU state dict."""

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    sd: dict[str, torch.Tensor] = {}
    for name, entry in params_np.items():
        if name.startswith("bnorm_"):
            sd[f"{name}.gamma"] = t(entry["gamma"])
            sd[f"{name}.beta"] = t(entry["beta"])
        else:
            sd[f"{name}.weight"] = t(entry["kernel"]).permute(3, 2, 0, 1).contiguous()
            if "bias" in entry:
                sd[f"{name}.bias"] = t(entry["bias"])
    for name, entry in state_np.items():
        sd[f"{name}.mean"] = t(entry["mean"])
        sd[f"{name}.var"] = t(entry["var"])
    return sd


def _oihw(kernel_hwio) -> torch.Tensor:
    return torch.from_numpy(np.array(kernel_hwio, dtype=np.float32)).permute(
        3, 2, 0, 1).contiguous()


def folded_from_jax(folded: dict) -> dict:
    """The JAX package's folded tree (`fold_graph_params` + "head":
    {"conv_i": {"kernel" HWIO, "bias"}}) → the port's ({"kernel" OIHW f32,
    "bias" f32} CPU tensors, same keys)."""
    return {name: {"kernel": _oihw(p["kernel"]),
                   "bias": torch.from_numpy(np.array(p["bias"], np.float32))}
            for name, p in folded.items()}


def qparams_from_jax(qparams: dict) -> dict:
    """The JAX package's int8 qparams (`quantize_folded`) → the port's.

    conv_i: kernel_q HWIO int8 → OHWI int8 (the layout of the port's int8
    kernels), w_scale and bias f32. act_scales stay float64 numpy vectors,
    exactly as the JAX calibration returns them: the walk takes every
    1/scale in float64 before casting it to f32 (quant.py:679, :795-796),
    and an f32 reciprocal would flip requant LSBs. "head", "tail" and "bf16"
    are folded trees (folded_from_jax); "tail_start" and "bf16_ops" are
    copied as ints.
    """
    out: dict = {}
    for name, v in qparams.items():
        if name == "act_scales":
            out[name] = [np.asarray(s, np.float64) for s in v]
        elif name == "tail_start":
            out[name] = int(v)
        elif name == "bf16_ops":
            out[name] = [int(i) for i in v]
        elif name in ("tail", "bf16"):
            out[name] = folded_from_jax(v)
        elif name == "head":
            out[name] = folded_from_jax({name: v})[name]
        else:
            out[name] = {
                "kernel_q": torch.from_numpy(
                    np.array(v["kernel_q"], np.int8)).permute(3, 0, 1, 2).contiguous(),
                "w_scale": torch.from_numpy(np.array(v["w_scale"], np.float32)),
                "bias": torch.from_numpy(np.array(v["bias"], np.float32)),
            }
    return out


def params_to_jax(module: torch.nn.Module) -> tuple[dict, dict]:
    """A port module's weights → (params, state) numpy trees in the JAX layout."""
    params: dict = {}
    state: dict = {}
    for key, value in module.state_dict().items():
        name, field = key.rsplit(".", 1)
        a = value.detach().cpu().numpy()
        if field == "weight":
            params.setdefault(name, {})["kernel"] = np.ascontiguousarray(
                a.transpose(2, 3, 1, 0))
        elif field == "bias":
            params.setdefault(name, {})["bias"] = a
        elif field in ("gamma", "beta"):
            params.setdefault(name, {})[field] = a
        else:
            state.setdefault(name, {})[field] = a
    return params, state
