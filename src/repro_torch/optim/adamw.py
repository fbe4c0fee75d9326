"""AdamW as the reference writes it (not ``torch.optim.AdamW``).

The two differ: here the weight decay ``wd * p`` is added into the update
``delta`` before it is scaled by ``lr``, and the gradients are first
clipped by their global norm, taken in f32 over every leaf.  The moments
``m`` and ``v`` are kept in ``state_dtype``.

Parameters are an ``nn.Module`` (or a dict of tensors); the moments and
gradients are dicts keyed by parameter name.  ``adamw_update`` updates the
parameters and the moments in place (the reference returns new trees).
With ``layerwise_threshold``, a leaf of 3 or more dimensions and at
least that many elements is updated one slice of its leading axis at a
time, as the reference does with its stacked leaves: the numbers are the
same, and the f32 temporaries are bounded by one slice.  In the port the
only such leaves are the MoE expert tensors (E, d, 2 ff) and (E, ff, d).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    """Peak lr, betas, eps, decoupled weight decay, global-norm clip and
    the dtype of the moments."""
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"   # 'float32' | 'bfloat16'
    layerwise_threshold: int = 1 << 24     # elements; 0 disables


def named_leaves(params) -> dict:
    """{name: tensor} of an ``nn.Module``'s parameters, or a dict as it is."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(params, cfg: AdamWConfig) -> dict:
    """Zero moments in ``state_dtype`` beside every parameter, and step 0."""
    dt = _DTYPES[cfg.state_dtype]
    leaves = named_leaves(params)
    zeros = lambda: {n: torch.zeros(p.shape, dtype=dt, device=p.device)
                     for n, p in leaves.items()}
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32)}


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, on the leaves'
    device."""
    total = None
    for g in tree.values():
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads: dict, state: dict, cfg: AdamWConfig,
                 lr_scale=1.0):
    """One AdamW step, in place on the parameters and on ``state``'s
    moments.  Returns (params, state, {"grad_norm", "lr"})."""
    leaves = named_leaves(params)
    dev = next(iter(leaves.values())).device
    f32 = torch.float32
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0) if cfg.grad_clip > 0
            else torch.ones((), dtype=f32, device=dev))
    b1, b2 = cfg.b1, cfg.b2
    step_f = step.to(f32)
    bc1 = (1.0 - torch.pow(torch.tensor(b1, dtype=f32), step_f)).to(dev)
    bc2 = (1.0 - torch.pow(torch.tensor(b2, dtype=f32), step_f)).to(dev)
    lr = (cfg.lr * torch.as_tensor(lr_scale, dtype=f32).cpu()).to(dev)
    sdt = _DTYPES[cfg.state_dtype]

    def update(p, g, m, v):
        g = g.to(f32) * clip
        m32 = b1 * m.to(f32) + (1 - b1) * g
        v32 = b2 * v.to(f32) + (1 - b2) * g * g
        mh = m32 / bc1
        vh = v32 / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.to(f32)
        p.copy_((p.to(f32) - lr * delta).to(p.dtype))
        m.copy_(m32.to(sdt))
        v.copy_(v32.to(sdt))

    for name, p in leaves.items():
        args = (p, grads[name], state["m"][name], state["v"][name])
        if (cfg.layerwise_threshold and p.dim() >= 3
                and p.numel() >= cfg.layerwise_threshold and p.shape[0] > 1):
            for i in range(p.shape[0]):
                update(*(a[i] for a in args))
        else:
            update(*args)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
