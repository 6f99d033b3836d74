"""Keras-2.2.4-semantics Adam, written out (not torch.optim.Adam), and
optax's Adam (`OptaxAdam`, the optimizer of distillation QAT).

Port of face_vijnana_yolov3_tpu/train/optimizer.py:25-76. The reference
compiles every model with `optimizers.Adam(lr, beta_1, beta_2, decay)`;
Keras 2.2.4's update differs from torch.optim.Adam's in two places:

* inverse-time decay of the base lr: lr_t = lr / (1 + decay * t);
* epsilon outside the bias-corrected square root:
  p -= a_t * m / (sqrt(v) + eps), a_t = lr_t * sqrt(1 - b2^t) / (1 - b1^t),
  eps = 1e-7 (K.epsilon()).

The step arithmetic is f32 throughout, as in the JAX transformation (t, the
powers and a_t are f32 scalars); the moments update with `torch._foreach_*`
ops, one launch a group instead of one a tensor.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class AdamState:
    """The state of both optimizers. count: steps taken, as an int32
    tensor; mu/nu: first and second moments, one tensor a param, keyed like
    the params."""

    count: torch.Tensor
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


def init_adam_state(params: dict[str, torch.Tensor]) -> AdamState:
    """Step 0: zero moments, keyed like the params."""
    dev = next(iter(params.values())).device
    return AdamState(count=torch.zeros((), dtype=torch.int32, device=dev),
                     mu={k: torch.zeros_like(v) for k, v in params.items()},
                     nu={k: torch.zeros_like(v) for k, v in params.items()})


def coerce_adam_state(obj) -> AdamState | None:
    """An AdamState from a checkpoint's plain {"count", "mu", "nu"}
    dict (the JAX package restores its NamedTuple the same way)."""
    if obj is None or isinstance(obj, AdamState):
        return obj
    if isinstance(obj, dict) and {"count", "mu", "nu"} <= set(obj):
        return AdamState(count=torch.as_tensor(obj["count"], dtype=torch.int32),
                         mu=dict(obj["mu"]), nu=dict(obj["nu"]))
    raise TypeError(f"unrecognized optimizer state: {type(obj)}")


def adam_state_dict(state: AdamState) -> dict:
    """The plain-dict form `coerce_adam_state` reads (for checkpoints)."""
    return {"count": state.count, "mu": state.mu, "nu": state.nu}


class KerasAdam:
    """init(params) → state; update(grads, state) → (updates, new state),
    the optax GradientTransformation of the JAX package as two methods."""

    def __init__(self, lr: float, beta_1: float = 0.99, beta_2: float = 0.99,
                 decay: float = 0.0, epsilon: float = 1e-7):
        self.lr, self.beta_1, self.beta_2 = lr, beta_1, beta_2
        self.decay, self.epsilon = decay, epsilon

    def init(self, params: dict[str, torch.Tensor]) -> AdamState:
        return init_adam_state(params)

    def update(self, grads: dict[str, torch.Tensor], state: AdamState):
        keys = list(grads)
        count = state.count + 1
        t = count.to(torch.float32)
        lr_t = self.lr / (1.0 + self.decay * t) if self.decay > 0 else self.lr
        a_t = lr_t * torch.sqrt(1.0 - self.beta_2 ** t) / (1.0 - self.beta_1 ** t)
        g = [grads[k] for k in keys]
        mu = torch._foreach_add(torch._foreach_mul([state.mu[k] for k in keys], self.beta_1),
                                torch._foreach_mul(g, 1.0 - self.beta_1))
        nu = torch._foreach_add(torch._foreach_mul([state.nu[k] for k in keys], self.beta_2),
                                torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - self.beta_2))
        denom = torch._foreach_add(torch._foreach_sqrt(nu), self.epsilon)
        updates = torch._foreach_div(torch._foreach_mul(mu, -a_t), denom)
        return (dict(zip(keys, updates)),
                AdamState(count=count, mu=dict(zip(keys, mu)), nu=dict(zip(keys, nu))))


# optax.adam's defaults, the only values distillation QAT uses.
OPTAX_B1, OPTAX_B2, OPTAX_EPS = 0.9, 0.999, 1e-8


class OptaxAdam:
    """`optax.adam(lr)`, the optimizer of distillation QAT (models/qat.py):
    no lr decay, the bias correction of m and of v taken separately, eps
    outside the square root (optax's eps_root is 0):

      m = (1 - b1) g + b1 m,  v = (1 - b2) g² + b2 v,  t += 1
      update = -lr · (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)

    in f32, the moments with `torch._foreach_*` as KerasAdam's. Same
    init / update interface as KerasAdam."""

    def __init__(self, lr: float):
        self.lr = lr

    def init(self, params: dict[str, torch.Tensor]) -> AdamState:
        return init_adam_state(params)

    def update(self, grads: dict[str, torch.Tensor], state: AdamState):
        keys = list(grads)
        count = state.count + 1
        t = count.to(torch.float32)
        g = [grads[k] for k in keys]
        mu = torch._foreach_add(torch._foreach_mul(g, 1.0 - OPTAX_B1),
                                torch._foreach_mul([state.mu[k] for k in keys], OPTAX_B1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - OPTAX_B2),
                                torch._foreach_mul([state.nu[k] for k in keys], OPTAX_B2))
        mu_hat = torch._foreach_div(mu, 1.0 - OPTAX_B1 ** t)
        nu_hat = torch._foreach_div(nu, 1.0 - OPTAX_B2 ** t)
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), OPTAX_EPS)
        updates = torch._foreach_mul(torch._foreach_div(mu_hat, denom), -self.lr)
        return (dict(zip(keys, updates)),
                AdamState(count=count, mu=dict(zip(keys, mu)), nu=dict(zip(keys, nu))))
