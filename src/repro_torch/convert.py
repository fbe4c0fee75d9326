"""Carry a JAX param pytree across to the port: the DiT
(``dit_params_from_numpy``), the LM (``lm_params_from_numpy``) and a
train state of either (``train_state_from_numpy``).

The input is the reference's params as numpy arrays (for example
``jax.tree.map(np.asarray, params)``), with the per-block tensors stacked
on a leading ``n_layers`` axis.  Every matrix that the reference applies as
``x @ w`` is stored ``(in, out)`` there; the port keeps it as an
``nn.Linear`` weight ``(out, in)``, so each such matrix is transposed.
Vectors (biases, LayerNorm scales), the alpha logits and the SLA
baseline's ``proj_l`` (applied as ``o_l @ proj_l`` on both sides) copy as
they are.
``train_state_from_numpy`` carries a whole train state across: the AdamW
moments and the EF buffers have the params' tree, so they go through the
same converter (and its transposes).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import sla2 as S
from repro_torch.core.router import RouterParams
from repro_torch.models import dit as D
from repro_torch.models import transformer as T


def _set(dst: torch.Tensor, src, transpose: bool = False) -> None:
    t = torch.from_numpy(np.array(src, dtype=np.float32))
    if transpose:
        t = t.T
    if tuple(t.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(t.shape)} does not fit "
                         f"{tuple(dst.shape)}")
    dst.copy_(t.to(dst.dtype))


def _linear(lin, w, b=None) -> None:
    _set(lin.weight, w, transpose=True)       # (in, out) -> (out, in)
    if b is not None:
        _set(lin.bias, b)


def dit_params_from_numpy(tree: dict, cfg: D.DiTConfig,
                          device="cuda") -> D.DiTParams:
    """Build ``DiTParams`` on ``device`` holding the reference's values."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = D.init_dit(g, cfg, dev)
    with torch.no_grad():
        _linear(params.patch_in, tree["patch_in"]["w"], tree["patch_in"]["b"])
        _linear(params.t_mlp_w1, tree["t_mlp"]["w1"])
        _linear(params.t_mlp_w2, tree["t_mlp"]["w2"])
        _set(params.final_ln.scale, tree["final_ln"]["scale"])
        _set(params.final_ln.bias, tree["final_ln"]["bias"])
        _linear(params.final_ada, tree["final_ada"]["w"],
                tree["final_ada"]["b"])
        _linear(params.patch_out, tree["patch_out"]["w"],
                tree["patch_out"]["b"])
        blocks = tree["blocks"]
        for li, bp in enumerate(params.blocks):
            at = lambda x: np.asarray(x)[li]
            for name in ("ln1", "ln_x", "ln2"):
                _set(getattr(bp, name).scale, at(blocks[name]["scale"]))
                _set(getattr(bp, name).bias, at(blocks[name]["bias"]))
            for name in ("wq", "wk", "wv", "wo", "xq", "xk", "xv", "xo"):
                _linear(getattr(bp, name), at(blocks[name]))
            _linear(bp.mlp.w_up, at(blocks["mlp"]["w_up"]))
            _linear(bp.mlp.w_down, at(blocks["mlp"]["w_down"]))
            _linear(bp.ada, at(blocks["ada"]["w"]), at(blocks["ada"]["b"]))
            if bp.sla2 is not None:
                _copy_sla2(bp.sla2, {"alpha_logit": at(
                    blocks["sla2"]["alpha_logit"]), "router": {
                        k: at(w) for k, w in
                        (blocks["sla2"].get("router") or {}).items()}})
            if bp.sla is not None:
                _set(bp.sla.proj_l, at(blocks["sla"]["proj_l"]))
    return params


def _copy_sla2(dst: S.SLA2Params, tree: dict) -> None:
    _set(dst.alpha_logit, tree["alpha_logit"])
    router = tree.get("router") or {}
    if dst.router is not None and router:
        _linear(dst.router.proj_q, router["proj_q"])
        _linear(dst.router.proj_k, router["proj_k"])


def sla2_params_from_numpy(tree: dict, device="cuda") -> S.SLA2Params:
    """One SLA2 layer's params ({"router": {"proj_q", "proj_k"},
    "alpha_logit"}) as ``SLA2Params`` on ``device``."""
    dev = resolve_device(device)
    alpha = np.asarray(tree["alpha_logit"])
    router = None
    if tree.get("router"):
        head_dim = np.asarray(tree["router"]["proj_q"]).shape[0]
        router = RouterParams(head_dim, device=dev)
    params = S.SLA2Params(router, torch.zeros(alpha.shape, device=dev))
    with torch.no_grad():
        _copy_sla2(params, tree)
    return params


def _params_from_numpy(tree: dict, cfg, dev):
    if isinstance(cfg, D.DiTConfig):
        return dit_params_from_numpy(tree, cfg, dev)
    return lm_params_from_numpy(tree, cfg, dev)


def _named_tensors(tree: dict, cfg, dtype: str, dev) -> dict:
    """A params-shaped tree as {parameter name: tensor} in ``dtype``."""
    mod = _params_from_numpy(tree, dataclasses.replace(cfg, dtype=dtype), dev)
    return {n: p.detach() for n, p in mod.named_parameters()}


def train_state_from_numpy(state: dict, cfg, device="cuda") -> dict:
    """A reference train state ({"params", "opt": {"m", "v", "step"}, and
    "ef" with EF compression}, as numpy) of the DiT (``DiTConfig``) or the
    LM (``ModelConfig``) as the port's train state on ``device``; the
    moments keep their dtype (``state_dtype``)."""
    dev = resolve_device(device)
    opt = state["opt"]
    if isinstance(cfg, D.DiTConfig):
        leaf = lambda tree: np.asarray(tree["patch_in"]["w"])
    else:
        leaf = lambda tree: np.asarray(tree["embed"]["table"])
    out = {"params": _params_from_numpy(state["params"], cfg, dev),
           "opt": {"m": _named_tensors(opt["m"], cfg,
                                       str(leaf(opt["m"]).dtype), dev),
                   "v": _named_tensors(opt["v"], cfg,
                                       str(leaf(opt["v"]).dtype), dev),
                   "step": torch.tensor(int(np.asarray(opt["step"])),
                                        dtype=torch.int32)}}
    if "ef" in state:
        out["ef"] = _named_tensors(state["ef"], cfg, "bfloat16", dev)
    return out


def lm_params_from_numpy(tree: dict, cfg: T.ModelConfig,
                         device="cuda") -> T.LMParams:
    """Build ``LMParams`` on ``device`` holding the reference LM's values.

    The reference stacks its layers in ``groups``: every leaf of
    ``groups["l<k>"]`` has a leading axis of ``n_groups``, and layer
    ``g * len(layer_kinds) + k`` is entry g of sub-key ``l<k>``.  Matrices
    applied as ``x @ w`` (in, out) are transposed into ``nn.Linear``
    weights (out, in); ``lm_head`` (d_model, vocab) likewise.  Only a
    ``mechanism="sla2"`` tree has ``sla2`` leaves, only an ``"sla"`` one
    ``sla``."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    params = T.init_model(g, cfg, dev)
    n_kinds = len(cfg.layer_kinds)
    with torch.no_grad():
        _set(params.embed, tree["embed"]["table"])
        _set(params.final_norm.scale, tree["final_norm"]["scale"])
        if params.lm_head is not None:
            _linear(params.lm_head, tree["lm_head"])
        for li, lp in enumerate(params.layers):
            grp, sub = divmod(li, n_kinds)
            at = lambda x: np.asarray(x)[grp]
            lt = tree["groups"][f"l{sub}"]
            _set(lp.ln1.scale, at(lt["ln1"]["scale"]))
            _set(lp.ln2.scale, at(lt["ln2"]["scale"]))
            at_ = lt["attn"]
            for name in ("wq", "wk", "wv", "wo"):
                _linear(getattr(lp.attn, name), at(at_[name]))
            for name in ("q_norm", "k_norm"):
                if getattr(lp.attn, name) is not None:
                    _set(getattr(lp.attn, name).scale, at(at_[name]["scale"]))
            if lp.attn.sla2 is not None:       # mechanism="full" has none
                _copy_sla2(lp.attn.sla2, {
                    "alpha_logit": at(at_["sla2"]["alpha_logit"]),
                    "router": {k: at(w) for k, w in
                               (at_["sla2"].get("router") or {}).items()}})
            if lp.attn.sla is not None:
                _set(lp.attn.sla.proj_l, at(at_["sla"]["proj_l"]))
            for name in ("w_up", "w_down", "w_gate"):
                _linear(getattr(lp.mlp, name), at(lt["mlp"][name]))
    return params
