"""kiri_tpu_torch's ONNX wire codec and graph interpreter against kiri_tpu's
(``utils/onnx_pb.py``, ``utils/onnx_import.py``) on the same graph bytes:
every case of tests/test_onnx_import.py, and more of the ops and attributes
kiri_tpu handles, within 1e-5 (absolute and relative); the full PP-OCR det
topology of tests/test_onnx_ppocr_det.py at 160 x 160 and 96 x 224 within
2e-3 of kiri_tpu (the tolerance of that file); and the port's writer giving
kiri_tpu's bytes."""
from __future__ import annotations

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from test_torch_decoder_layers import few_torch_threads  # noqa: F401

from kiri_tpu.utils import onnx_pb as jpb
from kiri_tpu.utils.onnx_import import import_onnx as j_import
from kiri_tpu_torch.utils import onnx_pb
from kiri_tpu_torch.utils.onnx_import import import_onnx

sys.path.insert(0, str(Path(__file__).resolve().parent))
TOL = 1e-5


def _node(op, ins, outs, **attrs):
    a = onnx_pb.write_node(op, ins, outs, **attrs)
    assert a == jpb.write_node(op, ins, outs, **attrs)
    return a


def _model(nodes, inits, inputs, outputs, opset=13):
    data = onnx_pb.write_model(nodes, inits, inputs, outputs, opset=opset)
    assert data == jpb.write_model(nodes, inits, inputs, outputs, opset=opset)
    return data


def _both(data, *xs):
    """(kiri_tpu's outputs under jit, the port's) of graph ``data``, each a
    tuple of numpy arrays."""
    jm = j_import(data)
    jout = jax.jit(jm.apply)(jm.params, *[np.asarray(x) for x in xs])
    jout = jout if isinstance(jout, tuple) else (jout,)
    m = import_onnx(data)
    with torch.inference_mode():
        out = m(*[torch.from_numpy(np.asarray(x)) for x in xs])
    out = out if isinstance(out, tuple) else (out,)
    return ([np.asarray(o) for o in jout],
            [o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o)
             for o in out])


def _agree(data, *xs, tol=TOL):
    want, got = _both(data, *xs)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert g.shape == w.shape
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol)
    return got


def _one(op, x, n_out=1, inits=None, extra_ins=(), **attrs):
    """A graph of one node over input x (and initializers)."""
    inits = inits or {}
    outs = [f"y{i}" for i in range(n_out)]
    return _model([_node(op, ["x", *extra_ins], outs, **attrs)], inits,
                  [("x", list(np.shape(x)))],
                  [(o, [None] * max(1, np.ndim(x))) for o in outs])


RNG = np.random.default_rng(0)
X4 = RNG.standard_normal((2, 8, 14, 18)).astype(np.float32)


# --------------------------------------------------------------- wire codec
@pytest.mark.parametrize("arr", [
    RNG.standard_normal((3, 4)).astype(np.float32),
    RNG.integers(-5, 5, (2, 3)).astype(np.int64),
    RNG.integers(0, 2, (4,)).astype(np.bool_),
    RNG.standard_normal((2, 2, 2)).astype(np.float16),
    np.float32(3.25).reshape(()),
    RNG.integers(0, 200, (5,)).astype(np.uint8),
    RNG.standard_normal((2,)).astype(np.float64)], ids=str)
def test_tensor_roundtrip_dtypes(arr):
    data = onnx_pb.write_tensor("t", arr)
    assert data == jpb.write_tensor("t", arr)
    parsed = onnx_pb.parse_tensor(data)
    assert parsed["name"] == "t"
    np.testing.assert_array_equal(parsed["array"], arr)
    assert parsed["array"].dtype == arr.dtype
    assert parsed["array"].shape == arr.shape


def test_model_roundtrip_structure():
    w = np.ones((4, 3, 1, 1), np.float32)
    nodes = [_node("Conv", ["x", "w"], ["y"], name="c0",
                   kernel_shape=[1, 1], strides=[1, 1])]
    data = _model(nodes, {"w": w}, [("x", [None, 3, None, None])],
                  [("y", [None, 4, None, None])], opset=11)
    m, jm = onnx_pb.parse_model(data), jpb.parse_model(data)
    assert m["opset"] == jm["opset"] == 11
    g = m["graph"]
    assert [n["op_type"] for n in g["nodes"]] == ["Conv"]
    assert g["nodes"] == jm["graph"]["nodes"]
    assert g["nodes"][0]["attrs"]["kernel_shape"] == [1, 1]
    assert list(g["initializers"]) == ["w"]
    assert g["inputs"] == jm["graph"]["inputs"]
    assert g["inputs"][0]["shape"] == [None, 3, None, None]


# ------------------------------------------------------------ convolutions
@pytest.mark.parametrize("stride,dil,group,pads", [
    (1, 1, 1, [1, 1, 1, 1]), (2, 1, 1, [0, 0, 0, 0]), (1, 2, 1, [2] * 4),
    (1, 1, 8, [1] * 4), (2, 1, 2, [1, 2, 1, 2]), (1, 1, 1, [0, 1, 2, 1]),
    (2, 1, 4, [2, 0, 1, 1])])
def test_conv(stride, dil, group, pads):
    w = RNG.standard_normal((8, 8 // group, 3, 3)).astype(np.float32)
    b = RNG.standard_normal((8,)).astype(np.float32)
    _agree(_one("Conv", X4, inits={"w": w, "b": b}, extra_ins=("w", "b"),
                kernel_shape=[3, 3], strides=[stride, stride], pads=pads,
                dilations=[dil, dil], group=group), X4)


@pytest.mark.parametrize("auto_pad,stride", [
    ("SAME_UPPER", 1), ("SAME_UPPER", 2), ("SAME_LOWER", 2), ("VALID", 2)])
def test_conv_auto_pad(auto_pad, stride):
    w = RNG.standard_normal((4, 8, 4, 4)).astype(np.float32)
    _agree(_one("Conv", X4, inits={"w": w}, extra_ins=("w",),
                kernel_shape=[4, 4], strides=[stride, stride],
                auto_pad=auto_pad), X4)


def test_conv1d():
    x = RNG.standard_normal((2, 4, 17)).astype(np.float32)
    w = RNG.standard_normal((6, 4, 3)).astype(np.float32)
    _agree(_one("Conv", x, inits={"w": w}, extra_ins=("w",),
                kernel_shape=[3], strides=[2], pads=[1, 0]), x)


@pytest.mark.parametrize("attrs", [
    dict(kernel_shape=[2, 2], strides=[2, 2]),
    dict(kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1],
         output_padding=[1, 1]),
    dict(kernel_shape=[3, 3], strides=[2, 2], pads=[0, 1, 2, 0]),
    dict(kernel_shape=[3, 3], strides=[1, 1], dilations=[2, 2])])
def test_conv_transpose(attrs):
    x = RNG.standard_normal((1, 6, 10, 12)).astype(np.float32)
    k = attrs["kernel_shape"]
    w = RNG.standard_normal((6, 4, *k)).astype(np.float32)
    b = RNG.standard_normal((4,)).astype(np.float32)
    _agree(_one("ConvTranspose", x, inits={"w": w, "b": b},
                extra_ins=("w", "b"), **attrs), x)


def test_grouped_conv_transpose_raises_as_kiri_tpu():
    x = RNG.standard_normal((1, 4, 5, 5)).astype(np.float32)
    w = RNG.standard_normal((4, 2, 2, 2)).astype(np.float32)
    data = _one("ConvTranspose", x, inits={"w": w}, extra_ins=("w",),
                kernel_shape=[2, 2], strides=[2, 2], group=2)
    with pytest.raises(NotImplementedError, match="grouped ConvTranspose"):
        import_onnx(data)(torch.from_numpy(x))
    jm = j_import(data)
    with pytest.raises(NotImplementedError, match="grouped ConvTranspose"):
        jm.apply(jm.params, x)


# ----------------------------------------------------------- normalizations
def test_batchnorm():
    x = RNG.standard_normal((2, 5, 6, 7)).astype(np.float32)
    inits = {"s": RNG.standard_normal(5).astype(np.float32),
             "b": RNG.standard_normal(5).astype(np.float32),
             "m": RNG.standard_normal(5).astype(np.float32),
             "v": RNG.random(5).astype(np.float32) + 0.1}
    _agree(_one("BatchNormalization", x, inits=inits,
                extra_ins=("s", "b", "m", "v"), epsilon=1e-5), x)


def test_batchnorm_of_weights():
    """BN parameters past the 8-value constant limit are weights (tensors):
    folded on the device, and cached for the module's own parameters."""
    x = RNG.standard_normal((2, 12, 5, 5)).astype(np.float32)
    inits = {"s": RNG.standard_normal(12).astype(np.float32),
             "b": RNG.standard_normal(12).astype(np.float32),
             "m": RNG.standard_normal(12).astype(np.float32),
             "v": RNG.random(12).astype(np.float32) + 0.1}
    data = _one("BatchNormalization", x, inits=inits,
                extra_ins=("s", "b", "m", "v"))
    got = _agree(data, x)[0]
    m = import_onnx(data)
    assert set(m.params) == {"s", "b", "m", "v"}
    with torch.inference_mode():
        again = m(torch.from_numpy(x)).numpy()
        other = m.apply({k: v * 2 for k, v in m.params.items()},
                        torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(again, got)
    assert not np.allclose(other, got)


@pytest.mark.parametrize("op", ["InstanceNormalization",
                                "LayerNormalization"])
def test_instance_and_layer_norm(op):
    x = RNG.standard_normal((2, 6, 5, 4)).astype(np.float32)
    c = 6 if op == "InstanceNormalization" else 4
    inits = {"s": RNG.standard_normal(c).astype(np.float32),
             "b": RNG.standard_normal(c).astype(np.float32)}
    _agree(_one(op, x, inits=inits, extra_ins=("s", "b"), epsilon=1e-5), x)


# ------------------------------------------------------------------ pooling
@pytest.mark.parametrize("op,attrs", [
    ("MaxPool", dict(kernel_shape=[3, 3], strides=[2, 2], pads=[1] * 4,
                     ceil_mode=1)),
    ("MaxPool", dict(kernel_shape=[2, 2], strides=[2, 2], pads=[0, 1, 1, 0],
                     dilations=[2, 1])),
    ("AveragePool", dict(kernel_shape=[2, 2], strides=[2, 2], pads=[1] * 4)),
    ("AveragePool", dict(kernel_shape=[3, 3], strides=[2, 2], pads=[1] * 4,
                         count_include_pad=1, ceil_mode=1)),
    ("AveragePool", dict(kernel_shape=[3, 2], strides=[1, 2],
                         auto_pad="SAME_UPPER")),
    ("GlobalAveragePool", {}), ("GlobalMaxPool", {})])
def test_pools(op, attrs):
    x = RNG.standard_normal((2, 3, 15, 17)).astype(np.float32)
    _agree(_one(op, x, **attrs), x)


# ------------------------------------------------------------ elementwise
@pytest.mark.parametrize("op,attrs", [
    ("Relu", {}), ("Sigmoid", {}), ("HardSwish", {}),
    ("LeakyRelu", {"alpha": 0.1}), ("Softmax", {"axis": -1}), ("Erf", {}),
    ("HardSigmoid", {"alpha": 1.0 / 6.0, "beta": 0.5}),
    ("HardSigmoid", {}), ("Tanh", {}), ("Exp", {}), ("Neg", {}),
    ("Abs", {}), ("Floor", {}), ("Ceil", {}), ("Softplus", {}),
    ("Softmax", {"axis": 0}), ("Clip", {"min": -1.0, "max": 2.0})])
def test_activations(op, attrs):
    x = (RNG.standard_normal((3, 9)) * 4).astype(np.float32)
    _agree(_one(op, x, **attrs), x)


@pytest.mark.parametrize("op", ["Log", "Sqrt"])
def test_positive_unary(op):
    x = (RNG.random((3, 9)) + 0.1).astype(np.float32)
    _agree(_one(op, x), x)


@pytest.mark.parametrize("op", ["Add", "Sub", "Mul", "Div", "Min", "Max",
                                "Pow", "Equal", "Greater", "Less"])
def test_binary_with_a_constant(op):
    x = (RNG.random((4, 5)) + 0.5).astype(np.float32)
    c = (RNG.random((5,)) + 0.5).astype(np.float32)
    c[1] = x[0, 1]
    _agree(_one(op, x, inits={"c": c.reshape(1, 5)}, extra_ins=("c",)), x)


def test_clip_prelu_where_sum_mean_minmax():
    x = RNG.standard_normal((2, 3, 4)).astype(np.float32)
    slope = np.asarray([0.1, 0.2, 0.3], np.float32)
    nodes = [
        _node("Clip", ["x", "lo", "hi"], ["c"]),
        _node("PRelu", ["x", "slope"], ["p"]),
        _node("Greater", ["x", "zero"], ["g"]),
        _node("Where", ["g", "p", "c"], ["w"]),
        _node("Sum", ["w", "x", "c"], ["s"]),
        _node("Mean", ["w", "x"], ["mn"]),
        _node("Max", ["w", "x", "c"], ["mx"]),
        _node("Not", ["g"], ["ng"]),
        _node("And", ["g", "ng"], ["nd"]),
        _node("Or", ["g", "ng"], ["orr"]),
        _node("Cast", ["g"], ["gf"], to=1),
    ]
    data = _model(nodes, {"lo": np.float32(-0.5).reshape(()),
                          "hi": np.float32(0.7).reshape(()),
                          "slope": slope.reshape(3, 1),
                          "zero": np.zeros((1,), np.float32)},
                  [("x", [2, 3, 4])],
                  [(n, [None] * 3) for n in ("s", "mn", "mx", "nd", "orr",
                                              "gf")])
    _agree(data, x)


@pytest.mark.parametrize("op,attrs", [
    ("ReduceMean", {"axes": [1], "keepdims": 1}),
    ("ReduceSum", {"axes": [0, 2], "keepdims": 0}),
    ("ReduceMax", {"axes": [-1]}), ("ReduceMin", {}),
    ("ReduceProd", {"axes": [1, 2], "keepdims": 0}),
    ("ArgMax", {"axis": 1}), ("ArgMax", {"axis": -1, "keepdims": 0})])
def test_reductions(op, attrs):
    x = (RNG.random((3, 4, 5)) + 0.5).astype(np.float32)
    _agree(_one(op, x, **attrs), x)


# ------------------------------------------------------------------ resize
@pytest.mark.parametrize("mode,ct,scales", [
    ("nearest", "asymmetric", [1, 1, 2, 2]),
    ("linear", "half_pixel", [1, 1, 2, 2]),
    ("linear", "half_pixel", [1, 1, 0.5, 0.6]),
    ("cubic", "half_pixel", [1, 1, 2, 1.5]),
    ("cubic", "half_pixel", [1, 1, 0.5, 0.5]),
    ("nearest", "half_pixel", [1, 1, 1.5, 2.5]),
    ("nearest", "asymmetric", [1, 1, 1.5, 2])])
def test_resize(mode, ct, scales):
    x = RNG.standard_normal((1, 4, 6, 5)).astype(np.float32)
    _agree(_one("Resize", x, inits={"sc": np.asarray(scales, np.float32)},
                extra_ins=("", "sc"), mode=mode,
                coordinate_transformation_mode=ct), x)


def test_resize_sizes_and_upsample():
    x = RNG.standard_normal((1, 2, 6, 5)).astype(np.float32)
    _agree(_one("Resize", x, inits={"sz": np.asarray([1, 2, 9, 13],
                                                     np.int64)},
                extra_ins=("", "", "sz"), mode="linear"), x)
    _agree(_one("Upsample", x, inits={"sc": np.asarray([1, 1, 2, 3],
                                                      np.float32)},
                extra_ins=("sc",), mode="nearest"), x)


# ----------------------------------------------------------- linear algebra
def test_gemm_matmul():
    a = RNG.standard_normal((4, 6)).astype(np.float32)
    w = RNG.standard_normal((5, 6)).astype(np.float32)
    b = RNG.standard_normal((5,)).astype(np.float32)
    _agree(_one("Gemm", a, inits={"w": w, "b": b}, extra_ins=("w", "b"),
                transB=1, alpha=1.0, beta=1.0), a)
    _agree(_one("Gemm", a, inits={"w": w.T.copy(), "b": b},
                extra_ins=("w", "b"), alpha=0.5, beta=2.0), a)
    _agree(_one("MatMul", a, inits={"w": w.T.copy()}, extra_ins=("w",)), a)


# ------------------------------------------------------------ shape chains
def test_shape_chain_constant_folds():
    """Shape -> Gather -> Unsqueeze -> Concat -> Reshape folds on the host:
    the target reaching Reshape is a numpy constant."""
    x = RNG.standard_normal((2, 3, 4, 5)).astype(np.float32)
    nodes = [
        _node("Shape", ["x"], ["shp"]),
        _node("Gather", ["shp", "i0"], ["n"], axis=0),
        _node("Unsqueeze", ["n"], ["n1"], axes=[0]),
        _node("Concat", ["n1", "rest"], ["tgt"], axis=0),
        _node("Reshape", ["x", "tgt"], ["y"]),
    ]
    data = _model(nodes, {"i0": np.array(0, np.int64),
                          "rest": np.array([-1], np.int64)},
                  [("x", list(x.shape))], [("y", [None, None])])
    got = _agree(data, x)[0]
    np.testing.assert_array_equal(got, x.reshape(2, -1))
    m = import_onnx(data)
    seen = []
    real = m._exec

    def spy(node, ins, idx):
        out = real(node, ins, idx)
        seen.append((node["op_type"], type(out)))
        return out

    m._exec = spy
    m(torch.from_numpy(x))
    assert all(not issubclass(t, torch.Tensor) for op, t in seen
               if op != "Reshape"), seen


def test_shape_ops():
    x = RNG.standard_normal((2, 1, 4, 3)).astype(np.float32)
    nodes = [
        _node("Shape", ["x"], ["shp"], start=1, end=3),
        _node("ConstantOfShape", ["shp"], ["ones"],
              value=np.ones((1,), np.float32)),
        _node("Flatten", ["x"], ["fl"], axis=2),
        _node("Transpose", ["x"], ["tr"], perm=[3, 2, 1, 0]),
        _node("Transpose", ["x"], ["tr2"]),
        _node("Squeeze", ["x", "ax1"], ["sq"]),
        _node("Unsqueeze", ["sq", "ax_neg"], ["us"]),
        _node("Expand", ["x", "eshape"], ["ex"]),
        _node("Constant", [], ["k"], value=np.arange(3, dtype=np.float32)),
        _node("Add", ["x", "k"], ["xk"]),
        _node("Range", ["r0", "r1", "r2"], ["rg"]),
        _node("Cast", ["rg"], ["rgf"], to=1),
        _node("Mul", ["xk", "rgf"], ["y"]),
        _node("Identity", ["y"], ["yi"]),
        _node("Concat", ["x", "k4"], ["cat"], axis=1),
    ]
    data = _model(nodes, {
        "ax1": np.asarray([1], np.int64), "ax_neg": np.asarray([-1], np.int64),
        "eshape": np.asarray([3, 2, 1, 1, 3], np.int64),
        "r0": np.asarray(1, np.int64), "r1": np.asarray(7, np.int64),
        "r2": np.asarray(2, np.int64),
        "k4": RNG.standard_normal((2, 2, 4, 3)).astype(np.float32)},
        [("x", list(x.shape))],
        [(n, [None] * 4) for n in ("ones", "fl", "tr", "tr2", "sq", "us",
                                   "ex", "yi", "cat")])
    _agree(data, x)


@pytest.mark.parametrize("starts,ends,axes,steps", [
    ([1], [5], [1], None), ([-3], [2 ** 63 - 1], [1], None),
    ([6, 0], [0, 6], [1, 2], [-2, 3]), ([-1], [-(2 ** 63)], [2], [-1]),
    ([0, 1], [1, -1], [0, -1], [1, 1])])
def test_slice(starts, ends, axes, steps):
    x = RNG.standard_normal((2, 8, 6)).astype(np.float32)
    inits = {"st": np.asarray(starts, np.int64),
             "en": np.asarray(ends, np.int64),
             "ax": np.asarray(axes, np.int64)}
    ins = ["st", "en", "ax"]
    if steps:
        inits["sp"] = np.asarray(steps, np.int64)
        ins.append("sp")
    _agree(_one("Slice", x, inits=inits, extra_ins=ins), x)


def test_split_gather():
    x = RNG.standard_normal((2, 8, 6)).astype(np.float32)
    _agree(_one("Split", x, n_out=2, axis=1, split=[3, 5]), x)
    _agree(_one("Split", x, n_out=3, inits={"sz": np.asarray([1, 2, 3],
                                                            np.int64)},
                extra_ins=("sz",), axis=2), x)
    _agree(_one("Split", x, n_out=2, axis=1), x)
    for idx in (np.asarray([0, -1, 3], np.int64),
                np.asarray(-2, np.int64), np.asarray([[1, 0], [2, 7]])):
        _agree(_one("Gather", x, inits={"i": idx}, extra_ins=("i",),
                    axis=1), x)


@pytest.mark.parametrize("mode,pads", [
    ("constant", [0, 0, 1, 0, 0, 2]), ("constant", [1, 0, 0, 0, 2, 3]),
    ("reflect", [0, 0, 2, 0, 1, 1]), ("edge", [0, 1, 2, 0, 2, 1])])
def test_pad(mode, pads):
    x = RNG.standard_normal((2, 8, 6)).astype(np.float32)
    inits = {"p": np.asarray(pads, np.int64),
             "v": np.asarray([1.5], np.float32)}
    _agree(_one("Pad", x, inits=inits, extra_ins=("p", "v"), mode=mode), x)


# -------------------------------------------------------------- composites
def test_mobilenetv3_style_block():
    """conv-bn-hswish -> depthwise conv-bn -> SE -> residual add."""
    C = 8
    x = RNG.standard_normal((1, C, 12, 16)).astype(np.float32)
    inits = {"w1": (RNG.standard_normal((C, C, 1, 1)) * .3).astype(np.float32),
             "bns": np.abs(RNG.standard_normal(C)).astype(np.float32) + .5,
             "bnb": RNG.standard_normal(C).astype(np.float32),
             "bnm": (RNG.standard_normal(C) * .1).astype(np.float32),
             "bnv": (np.abs(RNG.standard_normal(C)) + .5).astype(np.float32),
             "wd": (RNG.standard_normal((C, 1, 3, 3)) * .3).astype(np.float32),
             "wse1": (RNG.standard_normal((C // 2, C, 1, 1)) * .3
                      ).astype(np.float32),
             "wse2": (RNG.standard_normal((C, C // 2, 1, 1)) * .3
                      ).astype(np.float32)}
    nodes = [
        _node("Conv", ["x", "w1"], ["c1"], kernel_shape=[1, 1]),
        _node("BatchNormalization", ["c1", "bns", "bnb", "bnm", "bnv"],
              ["b1"]),
        _node("HardSwish", ["b1"], ["h1"]),
        _node("Conv", ["h1", "wd"], ["dw"], kernel_shape=[3, 3],
              pads=[1, 1, 1, 1], group=C),
        _node("GlobalAveragePool", ["dw"], ["gap"]),
        _node("Conv", ["gap", "wse1"], ["se1"], kernel_shape=[1, 1]),
        _node("Relu", ["se1"], ["se1r"]),
        _node("Conv", ["se1r", "wse2"], ["se2"], kernel_shape=[1, 1]),
        _node("HardSigmoid", ["se2"], ["gate"], alpha=1.0 / 6.0, beta=0.5),
        _node("Mul", ["dw", "gate"], ["scaled"]),
        _node("Add", ["scaled", "x"], ["y"]),
    ]
    _agree(_model(nodes, inits, [("x", list(x.shape))],
                  [("y", [None] * 4)]), x)


def test_db_head_convtranspose_sigmoid():
    x = RNG.standard_normal((1, 4, 8, 8)).astype(np.float32)
    w = (RNG.standard_normal((4, 1, 2, 2)) * 0.4).astype(np.float32)
    data = _model([_node("ConvTranspose", ["x", "w"], ["u"],
                         kernel_shape=[2, 2], strides=[2, 2]),
                   _node("Sigmoid", ["u"], ["p"])], {"w": w},
                  [("x", list(x.shape))], [("p", [None] * 4)])
    assert _agree(data, x)[0].shape == (1, 1, 16, 16)


def test_unsupported_op_message():
    data = _one("TotallyFakeOp", np.zeros((2, 2), np.float32))
    msg = None
    jm = j_import(data)
    with pytest.raises(NotImplementedError, match="TotallyFakeOp") as e:
        jm.apply(jm.params, np.zeros((2, 2), np.float32))
    msg = str(e.value)
    with pytest.raises(NotImplementedError) as e:
        import_onnx(data)(torch.zeros((2, 2)))
    assert str(e.value) == msg


def test_params_are_float32_tensors_and_move():
    x = RNG.standard_normal((1, 8, 6, 6)).astype(np.float32)
    w = RNG.standard_normal((2, 8, 3, 3)).astype(np.float64)
    data = _one("Conv", x, inits={"w": w}, extra_ins=("w",),
                kernel_shape=[3, 3])
    m = import_onnx(data).to("cpu")
    assert m.params["w"].dtype == torch.float32
    assert m.input_names == ["x"] and m.device.type == "cpu"
    with pytest.raises(ValueError, match="expected 1 inputs"):
        m()


# ---------------------------------------------------- full PP-OCR topology
@pytest.mark.parametrize("h,w,seed", [(160, 160, 3), (96, 224, 5)])
def test_ppocr_det_full_topology(h, w, seed):
    """MobileNetV3-large x0.5 + DBFPN(96) + DB head, ~190 nodes, built by
    tests/test_onnx_ppocr_det.py and by the port's smoke builder (the same
    bytes), through both importers."""
    from test_onnx_ppocr_det import build_ppocr_det as j_build

    from kiri_tpu_torch.smoke import build_ppocr_det

    data, x, _, n_nodes = j_build(h=h, w=w, seed=seed)
    assert n_nodes > 150
    assert build_ppocr_det(seed=seed) == data
    assert build_ppocr_det(seed=seed, pb=jpb) == data
    got = _agree(data, x, tol=2e-3)[0]
    assert got.shape == (1, 1, h, w)


def test_conditioned_ppocr_graph_agrees_closely():
    """The conditioned graph of the smoke fixture (unsaturated maps) agrees
    with kiri_tpu far inside the u16 map rule of the card (8 counts)."""
    from kiri_tpu_torch import smoke as S

    data = S.build_ppocr_det(seed=S.ONNX_SEED, conditioned=True,
                             head_gain=S.ONNX_HEAD_GAIN,
                             head_bias=S.ONNX_HEAD_BIAS)
    assert data == S.build_ppocr_det(seed=S.ONNX_SEED, conditioned=True,
                                     head_gain=S.ONNX_HEAD_GAIN,
                                     head_bias=S.ONNX_HEAD_BIAS, pb=jpb)
    x = np.random.default_rng(9).standard_normal((1, 3, 128, 96)).astype(
        np.float32)
    want, got = _both(data, x)
    assert np.abs(got[0] - want[0]).max() * 65535 <= 4
