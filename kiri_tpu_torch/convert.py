"""Carry JAX-package parameters across: a ``kiri_tpu`` variable tree
({"params", "batch_stats"} of numpy arrays, in that package's layout) ->
the port's torch-named state dict. A numpy copy of
``kiri_tpu/utils/convert.py::to_torch_state_dict``; layouts: HWIO convs ->
OIHW, [in, out] linears -> [out, in], q/k/v projections -> one fused
``in_proj_weight`` [3D, D].
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .models.layers import sinusoid_table

_STEM_TORCH_IDX = {0: 0, 1: 3, 2: 6, 3: 9}   # conv i -> stem.net.<idx>


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _lin(out, prefix, p):
    out[f"{prefix}.weight"] = _f32(p["w"]).T
    if "b" in p:
        out[f"{prefix}.bias"] = _f32(p["b"])


def _ln(out, prefix, p):
    out[f"{prefix}.weight"] = _f32(p["scale"])
    out[f"{prefix}.bias"] = _f32(p["bias"])


def _mha(out, prefix, p):
    out[f"{prefix}.in_proj_weight"] = np.concatenate(
        [_f32(p[k]["w"]).T for k in ("wq", "wk", "wv")], axis=0)
    if "b" in p["wq"]:
        out[f"{prefix}.in_proj_bias"] = np.concatenate(
            [_f32(p[k]["b"]) for k in ("wq", "wk", "wv")])
    _lin(out, f"{prefix}.out_proj", p["wo"])


def state_dict_from_jax(variables: Dict[str, Any], max_dec_len: int = 512,
                        use_dec_pos_enc: bool = True
                        ) -> Dict[str, torch.Tensor]:
    """``kiri_tpu`` variables -> the port's state dict (float32 tensors)."""
    params, stats = variables["params"], variables["batch_stats"]
    out: Dict[str, np.ndarray] = {}
    for i, ti in _STEM_TORCH_IDX.items():
        out[f"stem.net.{ti}.weight"] = _f32(
            params["stem"][f"conv{i}"]["w"]).transpose(3, 2, 0, 1)
        bn_p, bn_s = params["stem"][f"bn{i}"], stats["stem"][f"bn{i}"]
        pre = f"stem.net.{ti + 1}"
        out[f"{pre}.weight"] = _f32(bn_p["scale"])
        out[f"{pre}.bias"] = _f32(bn_p["bias"])
        out[f"{pre}.running_mean"] = _f32(bn_s["mean"])
        out[f"{pre}.running_var"] = _f32(bn_s["var"])
        out[f"{pre}.num_batches_tracked"] = np.asarray(0, np.int64)

    _ln(out, "enc_ln_in", params["enc_ln_in"])
    for i, lp in enumerate(params["enc_layers"]):
        pre = f"enc.layers.{i}"
        _ln(out, f"{pre}.norm1", lp["ln1"])
        _mha(out, f"{pre}.self_attn", lp["attn"])
        _ln(out, f"{pre}.norm2", lp["ln2"])
        _lin(out, f"{pre}.linear1", lp["ffn"]["lin1"])
        _lin(out, f"{pre}.linear2", lp["ffn"]["lin2"])
    _ln(out, "enc_ln", params["enc_ln"])

    if "ctc_head" in params:
        _ln(out, "ctc_head.0", params["ctc_head"]["ln"])
        _lin(out, "ctc_head.2", params["ctc_head"]["proj"])

    _lin(out, "mem_proj", params["mem_proj"])
    out["dec_emb.weight"] = _f32(params["dec_emb"]["emb"])
    for i, lp in enumerate(params["dec_layers"]):
        pre = f"dec.layers.{i}"
        _ln(out, f"{pre}.norm1", lp["ln1"])
        _mha(out, f"{pre}.self_attn", lp["self_attn"])
        _ln(out, f"{pre}.norm2", lp["ln2"])
        _mha(out, f"{pre}.multihead_attn", lp["cross_attn"])
        _ln(out, f"{pre}.norm3", lp["ln3"])
        _lin(out, f"{pre}.linear1", lp["ffn"]["lin1"])
        _lin(out, f"{pre}.linear2", lp["ffn"]["lin2"])
    _ln(out, "dec_ln", params["dec_ln"])
    _lin(out, "dec_head", params["dec_head"])
    if "lm_head" in params:
        _lin(out, "lm_head", params["lm_head"])
    if use_dec_pos_enc:
        d = out["dec_emb.weight"].shape[1]
        out["dec_pos_enc.pe"] = sinusoid_table(max_dec_len + 10, d)[None]
    return {k: torch.from_numpy(np.array(v, order="C"))
            for k, v in out.items()}


def flatten_params(variables: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A detector's nested ``{"params": {layer: {leaf: array}}}`` tree ->
    the flat ``params.<layer>.<leaf>`` arrays its checkpoint stores."""
    flat: Dict[str, np.ndarray] = {}

    def walk(prefix: str, node) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}.{k}", v)
        else:
            flat[prefix] = _f32(node)

    walk("params", variables["params"])
    return flat


def craft_state_dict_from_jax(variables: Dict[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """``kiri_tpu`` CRAFT variables (``init_craft_net`` or a loaded
    checkpoint) -> ``CRAFTNet``'s state dict (HWIO convs -> OIHW)."""
    from .detect.craft.net import state_dict_from_flat

    return state_dict_from_flat(flatten_params(variables))
