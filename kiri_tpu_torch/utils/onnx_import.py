"""ONNX graph -> PyTorch interpreter (the port of
``kiri_tpu/utils/onnx_import.py``).

The reference's default DB detector is a pretrained PP-OCR ONNX file run by
onnxruntime. Here, as in ``kiri_tpu``, the graph itself is imported: the
protobuf is parsed without the ``onnx`` package (``onnx_pb.py``) and the
node list is interpreted op by op in torch, eagerly, on the card.

Interpretation, as in ``kiri_tpu``:

* Values are host numpy arrays (graph constants and everything computed
  only from them) or torch tensors. An op whose inputs are all host
  constants runs in numpy: that folds the Shape -> Gather -> Unsqueeze ->
  Concat -> Resize / Reshape chains of PP-OCR exports, since ``Shape`` of a
  tensor is a host constant in eager torch too. The card sees only tensor
  work and never syncs on a shape.
* Integer, boolean and tiny initializers (8 values or fewer) stay host
  constants (Reshape targets, Resize scales, Slice bounds); the others are
  the weights, ``OnnxModule.params``, float32 tensors moved to the device
  once by ``.to(device)``.
* Layout stays NCHW. Float32 convolutions run through cuDNN; callers scope
  TF32 off around ``apply`` (``device.no_tf32``), as the DB net does.
* Each op keeps ``kiri_tpu``'s attribute defaults and its subset of
  semantics (pooling's ``ceil_mode`` as extra end padding, Resize as
  ``jax.image.resize`` with its antialiased linear and Keys cubic kernels,
  nearest + asymmetric at integer factors as a repeat), and raises where it
  raises: an unknown op with the same message, grouped ConvTranspose.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import onnx_pb

#: Ops that run in numpy when every input is a host constant (the layer ops
#: run on the device whatever their inputs, as ``kiri_tpu`` traces them).
_HOST_FOLDED = frozenset((
    "Relu", "Sigmoid", "Tanh", "Exp", "Log", "Sqrt", "Neg", "Abs", "Floor",
    "Ceil", "Not", "Erf", "LeakyRelu", "PRelu", "Clip", "HardSigmoid",
    "HardSwish", "Softmax", "Softplus", "Add", "Sub", "Mul", "Div", "Pow",
    "Min", "Max", "Equal", "Greater", "Less", "And", "Or", "Where", "Sum",
    "Mean", "ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin",
    "ReduceProd", "ArgMax", "MatMul"))

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float32,   # as JAX without x64
                 np.dtype(np.float16): torch.float16,
                 np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.int8): torch.int8,
                 np.dtype(np.int16): torch.int16,
                 np.dtype(np.uint16): torch.int32,
                 np.dtype(np.int32): torch.int32,
                 np.dtype(np.uint32): torch.int64,
                 np.dtype(np.int64): torch.int64,
                 np.dtype(np.uint64): torch.int64,
                 np.dtype(np.bool_): torch.bool}


def _is_const(v) -> bool:
    return isinstance(v, (np.ndarray, np.generic, int, float, bool))


def _np(*vals) -> bool:
    return all(v is None or _is_const(v) for v in vals)


def _dec(v, default=None):
    if v is None:
        return default
    return v.decode() if isinstance(v, bytes) else v


class _Env:
    """Name -> value map with ONNX's empty-name-means-missing convention."""

    def __init__(self):
        self.d: Dict[str, Any] = {}

    def get(self, name: str):
        if name == "":
            return None
        return self.d[name]

    def put(self, name: str, value) -> None:
        if name:
            self.d[name] = value


def _pads(attrs, spatial: int):
    """ONNX pads [x1b, x2b, ..., x1e, x2e] -> ((b, e), ...) per spatial dim."""
    pads = attrs.get("pads", [0] * (2 * spatial))
    return tuple((int(pads[i]), int(pads[i + spatial]))
                 for i in range(spatial))


def _auto_pad(attrs, kshape, strides, dilations, xshape):
    """auto_pad (SAME_UPPER / SAME_LOWER / VALID) as explicit pads."""
    ap = _dec(attrs.get("auto_pad", b"NOTSET"))
    if ap in ("", "NOTSET"):
        return _pads(attrs, len(kshape))
    if ap == "VALID":
        return tuple((0, 0) for _ in kshape)
    out = []
    for i, k in enumerate(kshape):
        eff_k = (k - 1) * dilations[i] + 1
        in_sz = xshape[2 + i]
        out_sz = -(-in_sz // strides[i])
        total = max(0, (out_sz - 1) * strides[i] + eff_k - in_sz)
        if ap == "SAME_UPPER":
            out.append((total // 2, total - total // 2))
        else:
            out.append((total - total // 2, total // 2))
    return tuple(out)


def _torch_pad(pads) -> List[int]:
    """((b, e), ...) over the leading-to-trailing dims -> F.pad's list,
    trailing dim first."""
    out: List[int] = []
    for b, e in reversed(pads):
        out += [int(b), int(e)]
    return out


def _bias_shape(spatial: int):
    return (1, -1) + (1,) * spatial


class OnnxModule:
    """An imported ONNX graph: ``params`` (float32 tensors) and ``apply``.

    ``apply(params, *inputs)`` -> the graph's outputs (one output
    unwrapped); inputs in the order of the graph's inputs, initializers
    excluded. ``module(*inputs)`` runs on ``module.params``.
    """

    def __init__(self, model: Dict[str, Any]):
        g = model["graph"]
        self.graph = g
        self.opset = model.get("opset") or 13
        self.params: Dict[str, torch.Tensor] = {}
        self.consts: Dict[str, np.ndarray] = {}
        for k, v in g["initializers"].items():
            if v.dtype.kind in "iub" or v.size <= 8:
                self.consts[k] = v
            else:
                self.params[k] = torch.from_numpy(
                    np.array(v, dtype=np.float32))
        init_names = set(self.params) | set(self.consts)
        self.input_names: List[str] = [
            i["name"] for i in g["inputs"] if i["name"] not in init_names]
        self.output_names: List[str] = [o["name"] for o in g["outputs"]]
        self.input_shapes: Dict[str, List[Optional[int]]] = {
            i["name"]: i["shape"] for i in g["inputs"]
            if i["name"] not in init_names}
        self.device = torch.device("cpu")
        # BatchNormalization's folded (scale, shift) per node, for the
        # module's own params (they never change).
        self._bn: Dict[int, Any] = {}

    def to(self, device) -> "OnnxModule":
        self.device = torch.device(device)
        self.params = {k: v.to(self.device) for k, v in self.params.items()}
        self._bn.clear()
        return self

    # ------------------------------------------------------------------ run
    def apply(self, params: Dict[str, Any], *inputs):
        if len(inputs) != len(self.input_names):
            raise ValueError(
                f"expected {len(self.input_names)} inputs "
                f"{self.input_names}, got {len(inputs)}")
        env = _Env()
        for k, v in self.consts.items():
            env.put(k, v)
        for k, v in params.items():
            env.put(k, torch.as_tensor(v, device=self.device))
        for name, val in zip(self.input_names, inputs):
            # Inputs are tensors even when given as numpy: never folded.
            env.put(name, torch.as_tensor(val, device=self.device))
        own = params is self.params
        for i, node in enumerate(self.graph["nodes"]):
            ins = [env.get(n) for n in node["input"]]
            outs = self._exec(node, ins, i if own else None)
            if not isinstance(outs, (tuple, list)):
                outs = (outs,)
            for name, val in zip(node["output"], outs):
                env.put(name, val)
        result = tuple(self._t(env.get(n)) for n in self.output_names)
        return result[0] if len(result) == 1 else result

    def __call__(self, *inputs):
        return self.apply(self.params, *inputs)

    # --------------------------------------------------------------- helpers
    def _t(self, v, like: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A host constant as a tensor on the device (float64 as float32,
        as JAX without x64 takes it); a tensor as it is."""
        if isinstance(v, torch.Tensor):
            return v
        a = np.asarray(v)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        elif a.dtype.kind == "u" and a.dtype.itemsize > 1:
            a = a.astype(np.int64)
        return torch.from_numpy(np.array(a)).to(
            like.device if like is not None else self.device)

    def _tensors(self, *vals) -> List[torch.Tensor]:
        """The operands of an op as tensors on the device of its first
        tensor operand."""
        ref = next(v for v in vals if isinstance(v, torch.Tensor))
        return [self._t(v, ref) for v in vals]

    # ------------------------------------------------------------- node exec
    def _exec(self, node, ins, idx: Optional[int]):
        op = node["op_type"]
        attrs = node["attrs"]
        const = _np(*ins)

        # --- constants and shape machinery (host-side when foldable) ---
        if op == "Constant":
            for key in ("value", "value_float", "value_int"):
                if key in attrs:
                    return np.asarray(attrs[key])
            if "value_floats" in attrs:
                return np.asarray(attrs["value_floats"], np.float32)
            if "value_ints" in attrs:
                return np.asarray(attrs["value_ints"], np.int64)
            raise NotImplementedError("Constant without value")
        if op == "Shape":
            shape = np.asarray(tuple(ins[0].shape), np.int64)
            start = int(attrs.get("start", 0))
            end = attrs.get("end")
            return shape[start:int(end)] if end is not None else shape[start:]
        if op == "ConstantOfShape":
            val = attrs.get("value")
            fill = np.asarray(val).reshape(-1)[0] if val is not None else 0.0
            shp = tuple(int(v) for v in np.asarray(ins[0]).reshape(-1))
            return np.full(shp, fill)
        if op == "Range":
            return np.arange(int(ins[0]), int(ins[1]), int(ins[2]))
        if op in ("Identity", "Dropout"):
            return ins[0]
        if op == "Cast":
            to = onnx_pb.DTYPES[int(attrs["to"])]
            if const:
                return np.asarray(ins[0]).astype(to)
            return ins[0].to(_TORCH_DTYPES[np.dtype(to)])
        if op == "Reshape":
            target = [int(v) for v in np.asarray(ins[1]).reshape(-1)]
            cur = ins[0].shape
            if not attrs.get("allowzero", 0):
                target = [cur[i] if t == 0 else t
                          for i, t in enumerate(target)]
            if _np(ins[0]):
                return np.reshape(ins[0], target)
            return ins[0].reshape(target)
        if op == "Flatten":
            x = ins[0]
            ax = int(attrs.get("axis", 1)) % (x.ndim + 1)
            lead = int(np.prod(tuple(x.shape[:ax]), dtype=np.int64))
            return (np.reshape(x, (lead, -1)) if _np(x)
                    else x.reshape(lead, -1))
        if op == "Transpose":
            perm = attrs.get("perm")
            if perm is None:
                perm = list(range(ins[0].ndim))[::-1]
            perm = [int(p) for p in perm]
            return (np.transpose(ins[0], perm) if _np(ins[0])
                    else ins[0].permute(perm))
        if op == "Squeeze":
            axes = (list(np.asarray(ins[1]).reshape(-1))
                    if len(ins) > 1 and ins[1] is not None
                    else attrs.get("axes"))
            x = ins[0]
            if axes is None:
                return np.squeeze(x) if _np(x) else x.squeeze()
            axes = tuple(int(a) for a in axes)
            if _np(x):
                return np.squeeze(x, axis=axes)
            axes = tuple(a % x.ndim for a in axes)
            if any(x.shape[a] != 1 for a in axes):
                raise ValueError(f"Squeeze of axes {axes} of shape "
                                 f"{tuple(x.shape)}")
            return x.reshape([d for i, d in enumerate(x.shape)
                              if i not in axes])
        if op == "Unsqueeze":
            axes = (list(np.asarray(ins[1]).reshape(-1))
                    if len(ins) > 1 and ins[1] is not None
                    else attrs["axes"])
            y = ins[0]
            for a in sorted(int(a) for a in axes):
                y = np.expand_dims(y, a) if _np(y) else y.unsqueeze(a)
            return y
        if op == "Concat":
            ax = int(attrs.get("axis", 0))
            vals = [v for v in ins if v is not None]
            if _np(*vals):
                return np.concatenate([np.atleast_1d(np.asarray(v))
                                       for v in vals], axis=ax)
            ts = [t.reshape(-1) if t.ndim == 0 else t
                  for t in self._tensors(*vals)]
            dtype = functools.reduce(torch.promote_types,
                                     (t.dtype for t in ts))
            return torch.cat([t.to(dtype) for t in ts], dim=ax)
        if op == "Split":
            x = ins[0]
            ax = int(attrs.get("axis", 0))
            if len(ins) > 1 and ins[1] is not None:
                sizes = [int(v) for v in np.asarray(ins[1]).reshape(-1)]
            elif "split" in attrs:
                sizes = [int(v) for v in attrs["split"]]
            else:
                n = len(node["output"])
                sizes = [x.shape[ax] // n] * n
            idx_ = np.cumsum(sizes)[:-1].tolist()
            if _np(x):
                return tuple(np.split(x, idx_, axis=ax))
            return tuple(torch.tensor_split(x, idx_, dim=ax))
        if op == "Gather":
            ax = int(attrs.get("axis", 0))
            if const:
                return np.take(ins[0], np.asarray(ins[1]).astype(np.int64),
                               axis=ax)
            x = self._t(ins[0], ins[1] if isinstance(ins[1], torch.Tensor)
                        else None)
            ax %= x.ndim
            ind = self._t(ins[1], x).long()
            ind = torch.where(ind < 0, ind + x.shape[ax], ind)
            y = x.index_select(ax, ind.reshape(-1))
            return y.reshape(tuple(x.shape[:ax]) + tuple(ind.shape)
                             + tuple(x.shape[ax + 1:]))
        if op == "Expand":
            shp = [int(v) for v in np.asarray(ins[1]).reshape(-1)]
            x = ins[0]
            cur = list(x.shape)
            while len(cur) < len(shp):
                cur.insert(0, 1)
            full = [max(a, b) for a, b in zip(cur, shp)]
            if _np(x):
                return np.broadcast_to(np.reshape(x, cur), full)
            return x.reshape(cur).expand(full)
        if op == "Slice":
            return self._slice(ins[0], ins, attrs)
        if op == "Pad":
            return self._pad(ins, attrs)

        # --- elementwise, reductions, MatMul: numpy on host constants ---
        if const and op in _HOST_FOLDED:
            return self._exec_np(op, ins, attrs)
        x = ins[0]
        unary = {
            "Relu": torch.relu, "Sigmoid": torch.sigmoid, "Tanh": torch.tanh,
            "Exp": torch.exp, "Log": torch.log, "Sqrt": torch.sqrt,
            "Neg": torch.neg, "Abs": torch.abs, "Floor": torch.floor,
            "Ceil": torch.ceil, "Not": torch.logical_not, "Erf": torch.erf,
        }
        if op in unary:
            return unary[op](x)
        if op == "LeakyRelu":
            alpha = float(attrs.get("alpha", 0.01))
            return torch.where(x >= 0, x, alpha * x)
        if op == "PRelu":
            slope = self._t(ins[1], x)
            if slope.ndim and slope.shape[0] == x.shape[1]:
                slope = slope.reshape((1, -1) + (1,) * (x.ndim - 2))
            return torch.where(x >= 0, x, slope * x)
        if op == "Clip":
            lo = ins[1] if len(ins) > 1 and ins[1] is not None else (
                attrs.get("min", -np.inf))
            hi = ins[2] if len(ins) > 2 and ins[2] is not None else (
                attrs.get("max", np.inf))
            lo, hi = (v if isinstance(v, torch.Tensor) else float(v)
                      for v in (lo, hi))
            return torch.clamp(x, lo, hi)
        if op == "HardSigmoid":
            alpha = float(attrs.get("alpha", 0.2))
            beta = float(attrs.get("beta", 0.5))
            return torch.clamp(alpha * x + beta, 0.0, 1.0)
        if op == "HardSwish":
            return x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)
        if op == "Softmax":
            return torch.softmax(x, dim=int(attrs.get("axis", -1)))
        if op == "Softplus":
            return torch.log1p(torch.exp(x))
        binary = {"Add": torch.add, "Sub": torch.sub, "Mul": torch.mul,
                  "Div": torch.true_divide, "Pow": torch.pow,
                  "Min": torch.minimum, "Max": torch.maximum,
                  "Equal": torch.eq, "Greater": torch.gt, "Less": torch.lt,
                  "And": torch.logical_and, "Or": torch.logical_or}
        if op in binary:
            ts = self._tensors(*ins)
            return functools.reduce(binary[op], ts)
        if op == "Where":
            return torch.where(*self._tensors(*ins[:3]))
        if op in ("Sum", "Mean"):
            y = functools.reduce(torch.add, self._tensors(*ins))
            return y / len(ins) if op == "Mean" else y

        # --- reductions ---
        reductions = {"ReduceMean": "mean", "ReduceSum": "sum",
                      "ReduceMax": "amax", "ReduceMin": "amin",
                      "ReduceProd": "prod"}
        if op in reductions:
            axes = attrs.get("axes")
            if axes is None and len(ins) > 1 and ins[1] is not None:
                axes = [int(v) for v in np.asarray(ins[1]).reshape(-1)]
            kd = bool(attrs.get("keepdims", 1))
            ax = (tuple(int(a) % x.ndim for a in axes) if axes is not None
                  else tuple(range(x.ndim)))
            if op == "ReduceProd":
                for a in sorted(ax, reverse=True):
                    x = torch.prod(x, dim=a, keepdim=True)
                return x if kd else x.reshape([d for i, d in enumerate(
                    x.shape) if i not in ax])
            return getattr(torch, reductions[op])(x, dim=ax, keepdim=kd)
        if op == "ArgMax":
            ax = int(attrs.get("axis", 0))
            return torch.argmax(x, dim=ax, keepdim=bool(attrs.get(
                "keepdims", 1)))

        # --- linear algebra ---
        if op == "MatMul":
            a, b = self._tensors(ins[0], ins[1])
            return torch.matmul(a, b.to(a.dtype))
        if op == "Gemm":
            a, b = self._tensors(ins[0], ins[1])
            alpha = float(attrs.get("alpha", 1.0))
            beta = float(attrs.get("beta", 1.0))
            if attrs.get("transA", 0):
                a = a.T
            if attrs.get("transB", 0):
                b = b.T
            y = alpha * (a @ b.to(a.dtype))
            c = ins[2] if len(ins) > 2 else None
            if c is not None:
                y = y + beta * self._t(c, y).to(y.dtype)
            return y

        # --- NN layers ---
        if op == "Conv":
            return self._conv(ins, attrs)
        if op == "ConvTranspose":
            return self._conv_transpose(ins, attrs)
        if op == "BatchNormalization":
            return self._batch_norm(ins, attrs, idx)
        if op in ("InstanceNormalization", "LayerNormalization"):
            x = self._t(ins[0])
            eps = float(attrs.get("epsilon", 1e-5))
            if op == "InstanceNormalization":
                axes = tuple(range(2, x.ndim))
                shape = _bias_shape(x.ndim - 2)
            else:
                axes = tuple(range(int(attrs.get("axis", -1)) % x.ndim,
                                   x.ndim))
                shape = None
            mu = x.mean(dim=axes, keepdim=True)
            var = x.var(dim=axes, keepdim=True, unbiased=False)
            y = (x - mu) / torch.sqrt(var + eps)
            scale = self._t(ins[1], x).to(x.dtype)
            y = y * (scale.reshape(shape) if shape else scale)
            if len(ins) > 2 and ins[2] is not None:
                bias = self._t(ins[2], x).to(x.dtype)
                y = y + (bias.reshape(shape) if shape else bias)
            return y
        if op in ("MaxPool", "AveragePool"):
            return self._pool(self._t(ins[0]), attrs,
                              "max" if op == "MaxPool" else "avg")
        if op == "GlobalAveragePool":
            x = self._t(x)
            return x.mean(dim=tuple(range(2, x.ndim)), keepdim=True)
        if op == "GlobalMaxPool":
            x = self._t(x)
            return x.amax(dim=tuple(range(2, x.ndim)), keepdim=True)
        if op in ("Resize", "Upsample"):
            if op == "Upsample":
                scales = (ins[1] if len(ins) > 1 and ins[1] is not None
                          else attrs.get("scales"))
                return self._resize(self._t(x), scales, None, attrs)
            scales = ins[2] if len(ins) > 2 and ins[2] is not None else None
            sizes = ins[3] if len(ins) > 3 and ins[3] is not None else None
            if scales is not None and not np.size(np.asarray(
                    scales.cpu() if isinstance(scales, torch.Tensor)
                    else scales)):
                scales = None
            return self._resize(self._t(x), scales, sizes, attrs)
        raise self._unsupported(node)

    @staticmethod
    def _unsupported(node) -> NotImplementedError:
        return NotImplementedError(
            f"ONNX op {node['op_type']!r} (node {node['name']!r}) is not "
            f"supported by the importer; supported set covers PP-OCR "
            f"det/rec/cls graphs")

    @staticmethod
    def _exec_np(op, ins, attrs):
        """An elementwise, reduction or MatMul op on host constants, in
        numpy, as ``kiri_tpu`` folds it."""
        x = ins[0]
        simple = {
            "Relu": lambda v: np.maximum(v, 0),
            "Sigmoid": lambda v: 1.0 / (1.0 + np.exp(-v)),
            "Tanh": np.tanh, "Exp": np.exp, "Log": np.log, "Sqrt": np.sqrt,
            "Neg": lambda v: -v, "Abs": np.abs, "Floor": np.floor,
            "Ceil": np.ceil, "Not": lambda v: ~v,
        }
        if op in simple:
            return simple[op](x)
        if op == "Erf":
            from math import erf
            return np.vectorize(erf)(
                np.asarray(x, np.float64)).astype(np.float32)
        if op == "LeakyRelu":
            alpha = float(attrs.get("alpha", 0.01))
            return np.where(x >= 0, x, alpha * x)
        if op == "PRelu":
            slope = ins[1]
            if np.ndim(slope) and np.shape(slope)[0] == x.shape[1]:
                slope = np.reshape(slope, (1, -1) + (1,) * (x.ndim - 2))
            return np.where(x >= 0, x, slope * x)
        if op == "Clip":
            lo = ins[1] if len(ins) > 1 and ins[1] is not None else (
                attrs.get("min", -np.inf))
            hi = ins[2] if len(ins) > 2 and ins[2] is not None else (
                attrs.get("max", np.inf))
            return np.clip(x, lo, hi)
        if op == "HardSigmoid":
            alpha = float(attrs.get("alpha", 0.2))
            beta = float(attrs.get("beta", 0.5))
            return np.clip(alpha * x + beta, 0.0, 1.0)
        if op == "HardSwish":
            return x * np.clip(x / 6.0 + 0.5, 0.0, 1.0)
        if op == "Softmax":
            ax = int(attrs.get("axis", -1))
            z = np.exp(x - np.max(x, axis=ax, keepdims=True))
            return z / z.sum(axis=ax, keepdims=True)
        if op == "Softplus":
            return np.log1p(np.exp(x))
        binary = {"Add": "add", "Sub": "subtract", "Mul": "multiply",
                  "Div": "divide", "Pow": "power", "Min": "minimum",
                  "Max": "maximum", "Equal": "equal", "Greater": "greater",
                  "Less": "less", "And": "logical_and", "Or": "logical_or"}
        if op in binary:
            if op in ("Min", "Max") and len(ins) != 2:
                f = np.minimum if op == "Min" else np.maximum
                y = ins[0]
                for v in ins[1:]:
                    y = f(y, v)
                return y
            return getattr(np, binary[op])(ins[0], ins[1])
        if op == "Where":
            return np.where(ins[0], ins[1], ins[2])
        if op in ("Sum", "Mean"):
            y = ins[0]
            for v in ins[1:]:
                y = y + v
            return y / len(ins) if op == "Mean" else y
        reductions = {"ReduceMean": "mean", "ReduceSum": "sum",
                      "ReduceMax": "max", "ReduceMin": "min",
                      "ReduceProd": "prod"}
        if op in reductions:
            axes = attrs.get("axes")
            if axes is None and len(ins) > 1 and ins[1] is not None:
                axes = [int(v) for v in np.asarray(ins[1]).reshape(-1)]
            kd = bool(attrs.get("keepdims", 1))
            ax = tuple(int(a) for a in axes) if axes is not None else None
            return getattr(np, reductions[op])(x, axis=ax, keepdims=kd)
        if op == "ArgMax":
            ax = int(attrs.get("axis", 0))
            y = np.argmax(x, axis=ax)
            return np.expand_dims(y, ax) if attrs.get("keepdims", 1) else y
        assert op == "MatMul", op
        return x @ np.asarray(ins[1])

    # ------------------------------------------------------------ shape ops
    def _slice(self, x, ins, attrs):
        nd = x.ndim
        if len(ins) > 1 and ins[1] is not None:
            starts = np.asarray(ins[1]).reshape(-1).tolist()
            ends = np.asarray(ins[2]).reshape(-1).tolist()
            axes = (np.asarray(ins[3]).reshape(-1).tolist()
                    if len(ins) > 3 and ins[3] is not None else
                    list(range(len(starts))))
            steps = (np.asarray(ins[4]).reshape(-1).tolist()
                     if len(ins) > 4 and ins[4] is not None
                     else [1] * len(starts))
        else:
            starts = list(attrs["starts"])
            ends = list(attrs["ends"])
            axes = list(attrs.get("axes", range(len(starts))))
            steps = [1] * len(starts)
        sl = [slice(None)] * nd
        int_max = 1 << 62
        for st, en, ax, sp in zip(starts, ends, axes, steps):
            ax = int(ax) % nd
            st, en, sp = int(st), int(en), int(sp)
            en = min(max(en, -int_max), int_max)
            sl[ax] = slice(st, en, sp)
        if _np(x):
            return x[tuple(sl)]
        # torch slices take no negative step: gather those axes.
        for ax, s in enumerate(sl):
            if s.step is not None and s.step < 0:
                ind = torch.arange(*s.indices(x.shape[ax]), device=x.device)
                x = x.index_select(ax, ind)
                sl[ax] = slice(None)
        return x[tuple(sl)]

    def _pad(self, ins, attrs):
        mode = _dec(attrs.get("mode"), "constant")
        if len(ins) > 1 and ins[1] is not None:
            pads = [int(v) for v in np.asarray(ins[1]).reshape(-1)]
            cval = (float(np.asarray(ins[2]).reshape(-1)[0])
                    if len(ins) > 2 and ins[2] is not None else 0.0)
        else:
            pads = [int(v) for v in attrs["pads"]]
            cval = float(attrs.get("value", 0.0))
        x = ins[0]
        nd = x.ndim
        pw = [(pads[i], pads[i + nd]) for i in range(nd)]
        if _np(x):
            if mode == "constant":
                return np.pad(x, pw, constant_values=cval)
            return np.pad(x, pw, mode={"reflect": "reflect",
                                       "edge": "edge"}[mode])
        if mode == "constant":
            return F.pad(x, _torch_pad(pw), value=cval)
        tmode = {"reflect": "reflect", "edge": "replicate"}[mode]
        # F.pad pads the trailing dims of a batched tensor in these modes.
        lead = next((i for i, p in enumerate(pw) if p != (0, 0)), nd)
        n_sp = max(nd - lead, 1)
        if n_sp > 3:
            raise NotImplementedError(f"Pad mode {mode} over {n_sp} dims")
        shp = tuple(x.shape)
        y = x.reshape((-1, 1) + shp[nd - n_sp:])
        y = F.pad(y, _torch_pad(pw[nd - n_sp:]), mode=tmode)
        return y.reshape(shp[:nd - n_sp] + tuple(y.shape[2:]))

    # -------------------------------------------------------------- NN ops
    def _conv(self, ins, attrs):
        x = self._t(ins[0])
        w = self._t(ins[1], x).to(x.dtype)
        b = ins[2] if len(ins) > 2 else None
        group = int(attrs.get("group", 1))
        spatial = w.ndim - 2
        strides = tuple(int(s) for s in attrs.get("strides", [1] * spatial))
        dil = tuple(int(d) for d in attrs.get("dilations", [1] * spatial))
        pads = _auto_pad(attrs, tuple(w.shape[2:]), strides, dil,
                         tuple(x.shape))
        conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[spatial]
        if all(p0 == p1 for p0, p1 in pads):
            padding = tuple(p0 for p0, _ in pads)
        else:
            x = F.pad(x, _torch_pad(pads))
            padding = 0
        bias = None if b is None else self._t(b, x).to(x.dtype)
        return conv(x, w, bias, strides, padding, dil, group)

    def _conv_transpose(self, ins, attrs):
        x = self._t(ins[0])
        w = self._t(ins[1], x).to(x.dtype)    # [Cin, Cout / group, k...]
        b = ins[2] if len(ins) > 2 else None
        if int(attrs.get("group", 1)) != 1:
            raise NotImplementedError("grouped ConvTranspose")
        spatial = w.ndim - 2
        strides = tuple(int(s) for s in attrs.get("strides", [1] * spatial))
        dil = tuple(int(d) for d in attrs.get("dilations", [1] * spatial))
        pads = _pads(attrs, spatial)
        out_pad = tuple(int(p) for p in attrs.get("output_padding",
                                                  [0] * spatial))
        convt = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
                 3: F.conv_transpose3d}[spatial]
        bias = None if b is None else self._t(b, x).to(x.dtype)
        crop = [(-p0, -p1 + op) for (p0, p1), op in zip(pads, out_pad)]
        if not any(c != (0, 0) for c in crop):
            return convt(x, w, bias, strides, 0, 0, 1, dil)
        # The full transposed output, its pads cropped off and
        # output_padding added at the end (where only the bias lands).
        y = F.pad(convt(x, w, None, strides, 0, 0, 1, dil),
                  _torch_pad([(0, 0), (0, 0)] + crop))
        if bias is not None:
            y = y + bias.reshape(_bias_shape(spatial))
        return y

    def _batch_norm(self, ins, attrs, idx):
        x = self._t(ins[0])
        eps = float(attrs.get("epsilon", 1e-5))
        folded = self._bn.get(idx) if idx is not None else None
        if folded is None:
            scale, bias, mean, var = ins[1:5]
            if _np(scale, bias, mean, var):
                inv = 1.0 / np.sqrt(np.asarray(var, np.float64) + eps)
                w = np.asarray(scale) * inv
                b = np.asarray(bias) - np.asarray(mean) * w
            else:
                scale, bias, mean, var = (self._t(v, x)
                                          for v in (scale, bias, mean, var))
                w = scale * (1.0 / torch.sqrt(var + eps))
                b = bias - mean * w
            shape = _bias_shape(x.ndim - 2)
            folded = (self._t(w, x).to(x.dtype).reshape(shape),
                      self._t(b, x).to(x.dtype).reshape(shape))
            if idx is not None:
                self._bn[idx] = folded
        return x * folded[0] + folded[1]

    def _pool(self, x, attrs, kind: str):
        spatial = x.ndim - 2
        k = tuple(int(v) for v in attrs["kernel_shape"])
        strides = tuple(int(s) for s in attrs.get("strides", [1] * spatial))
        dil = tuple(int(d) for d in attrs.get("dilations", [1] * spatial))
        pads = _auto_pad(attrs, k, strides, dil, tuple(x.shape))
        if attrs.get("ceil_mode", 0):
            # Extra end padding so the last (partial) window is emitted.
            newp = []
            for i in range(spatial):
                eff_k = (k[i] - 1) * dil[i] + 1
                in_sz = x.shape[2 + i] + pads[i][0] + pads[i][1]
                rem = (in_sz - eff_k) % strides[i]
                newp.append((pads[i][0], pads[i][1] + (
                    (strides[i] - rem) % strides[i] if rem else 0)))
            pads = tuple(newp)
        tp = _torch_pad(pads)
        if kind == "max":
            fill = (-float("inf") if x.is_floating_point()
                    else torch.iinfo(x.dtype).min)
            pool = {1: F.max_pool1d, 2: F.max_pool2d,
                    3: F.max_pool3d}[spatial]
            return pool(F.pad(x, tp, value=fill), k, strides, 0, dil)

        conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[spatial]
        c = x.shape[1]
        ones = torch.ones((c, 1) + k, dtype=x.dtype, device=x.device)

        def window_sum(v):
            return conv(F.pad(v, tp), ones[:v.shape[1]], None, strides, 0,
                        dil, v.shape[1])

        s = window_sum(x)
        if attrs.get("count_include_pad", 0):
            return s / float(np.prod(k))
        cnt = window_sum(torch.ones((1, 1) + tuple(x.shape[2:]),
                                    dtype=x.dtype, device=x.device))
        return s / cnt

    def _resize(self, x, scales, sizes, attrs):
        mode = _dec(attrs.get("mode", b"nearest"))
        if sizes is not None and np.size(sizes):
            out_shape = tuple(int(v) for v in np.asarray(sizes).reshape(-1))
        else:
            sc = np.asarray(scales, np.float64).reshape(-1)
            out_shape = tuple(int(np.floor(d * s))
                              for d, s in zip(x.shape, sc))
        method = {"nearest": "nearest", "linear": "bilinear",
                  "cubic": "bicubic"}[mode]
        ct = _dec(attrs.get("coordinate_transformation_mode", b"half_pixel"))
        if mode == "nearest" and ct == "asymmetric":
            # Integer factors: nearest + asymmetric is a plain repeat.
            if all(o % i == 0 for o, i in zip(out_shape, x.shape)):
                y = x
                for ax, (o, i) in enumerate(zip(out_shape, x.shape)):
                    if o != i:
                        y = torch.repeat_interleave(y, o // i, dim=ax)
                return y
        return image_resize(x, out_shape, method)


def _weight_mat(in_size: int, out_size: int, kernel) -> np.ndarray:
    """``jax.image``'s [in, out] interpolation weights of one dim (scale
    out / in, no translation, antialiased when downsampling), in float32
    as it computes them."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = f32(max(inv_scale, 1.0))
    inv_scale = f32(inv_scale)
    sample_f = ((np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.5))
    xk = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]
                ) / kernel_scale
    w = kernel(xk).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def _triangle(x):
    return np.maximum(0, 1 - np.abs(x))


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def image_resize(x: torch.Tensor, shape, method: str) -> torch.Tensor:
    """``jax.image.resize(x, shape, method)`` in torch: "nearest" picks
    floor((i + 0.5) * in / out); "bilinear" and "bicubic" contract each
    resized dim with its weight matrix (triangle or Keys cubic kernel,
    antialiased when downsampling)."""
    y = x
    for d, (i, o) in enumerate(zip(x.shape, shape)):
        if i == o:
            continue
        if method == "nearest":
            offs = np.floor(((np.arange(o, dtype=np.float32) + 0.5)
                             * np.float32(i) / np.float32(o)
                             ).astype(np.float32)).astype(np.int64)
            y = y.index_select(d, torch.from_numpy(offs).to(y.device))
            continue
        kernel = _triangle if method == "bilinear" else _keys_cubic
        w = torch.from_numpy(_weight_mat(i, o, kernel)).to(y.device, y.dtype)
        y = torch.movedim(torch.tensordot(y, w, dims=([d], [0])), -1, d)
    return y


def import_onnx(src) -> OnnxModule:
    """An .onnx file (path or bytes) as an ``OnnxModule`` on the CPU; move
    it with ``.to(device)``."""
    if isinstance(src, (bytes, bytearray)):
        model = onnx_pb.parse_model(bytes(src))
    else:
        model = onnx_pb.load_model(src)
    return OnnxModule(model)
