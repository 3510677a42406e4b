"""Carry JAX-package parameters across: a ``kiri_tpu`` variable tree
({"params", "batch_stats"} of numpy arrays, in that package's layout) ->
the port's torch-named state dict. A numpy copy of
``kiri_tpu/utils/convert.py::to_torch_state_dict``; layouts: HWIO convs ->
OIHW, [in, out] linears -> [out, in], q/k/v projections -> one fused
``in_proj_weight`` [3D, D]. Also the shape rule that gives a meta-less
checkpoint its config (``infer_cfg_from_state_dict``), and ``kiri_tpu``'s
calibrated int8 scales in the port's layout (``q8_scales_from_jax``).
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


def q8_scales_from_jax(scales: Dict[str, Any]) -> Dict[str, Any]:
    """``kiri_tpu``'s calibrated ``Q8Encoder.scales`` (numpy or JAX arrays)
    -> ``ops.quant8.Q8Encoder.scales``: per stem conv 1-3 the float32 ``inv``
    [Cin] and ``ws`` [Cout] and the int8 folded weights, HWIO ->
    [Cout, 9 * Cin] in (dy, dx, cin) order; the encoder's per-tensor scales
    as float32 values, one per ``kiri_tpu`` matmul."""
    stem = []
    for s in scales["stem"]:
        wq = np.asarray(s["wq"], np.int8)
        stem.append({
            "inv": torch.from_numpy(np.array(s["inv"], np.float32)),
            "wq": torch.from_numpy(np.ascontiguousarray(
                wq.reshape(-1, wq.shape[3]).T)),
            "ws": torch.from_numpy(np.array(s["ws"], np.float32).reshape(-1))})
    return {"stem": stem,
            "enc": [float(np.float32(a)) for a in scales["enc"]]}


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


def infer_cfg_from_state_dict(sd: Dict[str, Any], cfg):
    """``cfg`` with the architecture read off a torch-named state dict's
    shapes, for checkpoints without a meta (a copy of ``kiri_tpu``'s rule,
    after the reference's ``kiri_ocr/core.py:319-403``). Heads: a head of
    64, else of 32, else 8 heads; v13 (D 256, 8 heads) reads as 4."""
    kw = {}
    if "stem.net.9.weight" in sd:
        kw["ENC_DIM"] = int(sd["stem.net.9.weight"].shape[0])
    enc_layers = {int(k.split(".")[2]) for k in sd
                  if k.startswith("enc.layers.")}
    if enc_layers:
        kw["ENC_LAYERS"] = max(enc_layers) + 1
    dec_layers = {int(k.split(".")[2]) for k in sd
                  if k.startswith("dec.layers.")}
    if dec_layers:
        kw["DEC_LAYERS"] = max(dec_layers) + 1
    if "enc.layers.0.linear1.weight" in sd:
        kw["ENC_FF"] = int(sd["enc.layers.0.linear1.weight"].shape[0])
    if "dec_emb.weight" in sd:
        kw["DEC_DIM"] = int(sd["dec_emb.weight"].shape[1])
    if "dec.layers.0.linear1.weight" in sd:
        kw["DEC_FF"] = int(sd["dec.layers.0.linear1.weight"].shape[0])

    def _heads(key):
        total = sd[key].shape[0] // 3
        if total % 64 == 0:
            return total // 64
        if total % 32 == 0:
            return total // 32
        return 8

    if "enc.layers.0.self_attn.in_proj_weight" in sd:
        kw["ENC_HEADS"] = _heads("enc.layers.0.self_attn.in_proj_weight")
    if "dec.layers.0.self_attn.in_proj_weight" in sd:
        kw["DEC_HEADS"] = _heads("dec.layers.0.self_attn.in_proj_weight")
    return cfg.replace(**kw)
