"""``kiri_tpu_torch.parallel`` against ``kiri_tpu.parallel`` without
processes: the tensor-parallel rules on every parameter of the port's
``Recognizer`` (rule by rule against ``_param_spec`` on the JAX names each
tensor is converted from, with the fallback to replication), sharding and
joining back, batch padding and slicing, the global dropout draws, and the
launcher's refusal to hang on a failing rank."""
from __future__ import annotations

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from kiri_tpu import parallel as JP
from kiri_tpu_torch import parallel as P
from kiri_tpu_torch.checkpoints import build_model
from kiri_tpu_torch.convert import state_dict_from_jax
from kiri_tpu_torch.models.layers import GlobalDraw, dropout
from kiri_tpu_torch.parallel.launch import spawn

from torch_train import both, jax_init, to_numpy

TESTS = str(Path(__file__).resolve().parent)


def _mesh(dp: int, mp: int, rank: int = 0) -> P.Mesh:
    """A mesh position with no process groups (enough for specs and
    slicing)."""
    return P.Mesh({"data": dp, "model": mp}, rank)


def _sources(var, cfg):
    """torch name -> the JAX leaf paths it is converted from: each JAX
    parameter filled with its own constant, then converted."""
    params = to_numpy(var["params"])
    leaves, tree = jax.tree_util.tree_flatten_with_path(params)
    marked = jax.tree_util.tree_unflatten(
        tree, [np.full(v.shape, i + 1, np.float32)
               for i, (_, v) in enumerate(leaves)])
    sd = state_dict_from_jax({"params": marked,
                              "batch_stats": to_numpy(var["batch_stats"])},
                             cfg.MAX_DEC_LEN)
    paths = ["params." + JP._path_str(p) for p, _ in leaves]
    out = {}
    for name, t in sd.items():
        if name.startswith("stem.net.") and "running" in name:
            continue
        if name in ("dec_pos_enc.pe",) or name.endswith("num_batches_tracked"):
            continue
        ids = sorted({int(v) for v in np.unique(t.numpy())})
        out[name] = [paths[i - 1] for i in ids]
    return out


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    jcfg, cfg, jtok, tok = both(tmp_path_factory.mktemp("par"))
    var = jax_init(jcfg, jtok)
    return jcfg, cfg, jtok, tok, var


def _flip(spec) -> tuple:
    """A JAX [in, out] spec in torch's [out, in] layout."""
    axes = tuple(spec)
    return axes[::-1] if len(axes) == 2 else axes


def test_param_spec_matches_kiri_tpu_rule_by_rule(small):
    jcfg, cfg, jtok, tok, var = small
    model = build_model(state_dict_from_jax(to_numpy(
        {"params": var["params"], "batch_stats": var["batch_stats"]}),
        cfg.MAX_DEC_LEN), cfg)
    sources = _sources(var, cfg)
    names = dict(model.named_parameters())
    assert set(sources) == set(names)
    sharded = 0
    for name, p in names.items():
        spec = P.param_spec(name, p.dim())
        src = sources[name]
        want = {_flip(tuple(JP._param_spec(s, p.dim()))) for s in src}
        assert len(want) == 1, (name, src, want)
        (want,) = want
        assert spec.axes == want, (name, spec, want)
        # q, k and v each come from their own JAX weight: packed in three.
        assert spec.parts == (3 if len(src) == 3 else 1), name
        sharded += spec.dim is not None
    # 3 tensors an attention (in_proj weight and bias, out_proj weight) and
    # an FFN (linear1 weight and bias, linear2 weight): 6 in the encoder
    # layer, 9 in the decoder layer; weight and bias of 3 heads.
    assert sharded == 6 + 9 + 6
    # BatchNorm statistics and other buffers are replicated, as in kiri_tpu.
    for name, t in model.state_dict().items():
        if name not in names:
            assert P.param_spec(name, t.dim()).dim is None


@pytest.mark.parametrize("mp", [2, 4])
def test_variable_shardings_fall_back_as_kiri_tpu(small, mp):
    """A dimension that does not divide by the model axis is replicated (the
    vocabulary heads here: 9, 10 rows): the same tensors in both packages."""
    jcfg, cfg, jtok, tok, var = small
    from kiri_tpu_torch.models.recognizer import Recognizer

    model = Recognizer(cfg, tok.vocab_size)
    got = P.variable_shardings(model, _mesh(8 // mp, mp))
    jmesh = JP.make_mesh(8, model_parallel=mp)
    jsh = JP.variable_shardings({"params": var["params"]}, jmesh)
    flat = {JP._path_str(p): s.spec for p, s in
            jax.tree_util.tree_flatten_with_path(
                jsh, is_leaf=lambda x: hasattr(x, "spec"))[0]}
    for name, sources in _sources(var, cfg).items():
        want_split = any(JP.MODEL_AXIS in tuple(flat[s]) for s in sources)
        assert (got[name].dim is not None) == want_split, (name, mp)
    assert got["ctc_head.2.weight"].dim is None       # 9 classes
    assert any(got[n].dim is not None for n in got)


def test_attention_whose_heads_do_not_divide_is_replicated(small):
    """A recorded difference: kiri_tpu lets XLA split 2 heads over a model
    axis of 4 (D 32 divides); the port keeps each head on one device and
    replicates that attention, while its FFN (FF 64) is still split."""
    jcfg, cfg, jtok, tok, var = small
    from kiri_tpu_torch.models.recognizer import Recognizer

    cfg2 = cfg.replace(ENC_HEADS=2, DEC_HEADS=2)
    got = P.variable_shardings(Recognizer(cfg2, tok.vocab_size), _mesh(2, 4))
    assert got["enc.layers.0.self_attn.in_proj_weight"].dim is None
    assert got["dec.layers.0.multihead_attn.out_proj.weight"].dim is None
    assert got["enc.layers.0.linear1.weight"].dim == 0
    jsh = JP.variable_shardings({"params": var["params"]},
                                JP.make_mesh(8, model_parallel=4))
    assert "model" in str(jsh["params"]["enc_layers"][0]["attn"]["wq"]["w"]
                          .spec)


@pytest.mark.parametrize("mp", [2, 4])
def test_shard_then_join_gives_the_tree_back(small, mp):
    jcfg, cfg, jtok, tok, var = small
    sd = state_dict_from_jax(to_numpy({"params": var["params"],
                                       "batch_stats": var["batch_stats"]}),
                             cfg.MAX_DEC_LEN)
    model = build_model(sd, cfg)
    specs = P.variable_shardings(model, _mesh(1, mp))
    shards = [P.shard_variables(sd, _mesh(1, mp, rank=i)) for i in range(mp)]
    models = [P.shard_variables(model, _mesh(1, mp, rank=i))
              for i in range(mp)]
    for name, t in sd.items():
        pieces = [s[name] for s in shards]
        torch.testing.assert_close(P.join_shards(pieces, specs[name]), t,
                                   rtol=0, atol=0)
        if specs[name].dim is not None:
            assert pieces[0].shape[specs[name].dim] == \
                t.shape[specs[name].dim] // mp
            for m, piece in zip(models, pieces):
                torch.testing.assert_close(m.state_dict()[name], piece,
                                           rtol=0, atol=0)
    # The packed q/k/v: rank 0 holds the first heads of each of q, k, v.
    w = sd["enc.layers.0.self_attn.in_proj_weight"]
    d = w.shape[0] // 3
    got = shards[0]["enc.layers.0.self_attn.in_proj_weight"]
    torch.testing.assert_close(got, torch.cat([w[:d // mp],
                                               w[d: d + d // mp],
                                               w[2 * d: 2 * d + d // mp]]))
    assert models[0].enc.layers[0].self_attn.tp is not None
    assert models[0].enc.layers[0].tp_ffn is not None
    assert model.enc.layers[0].self_attn.tp is None     # the original stays


@pytest.mark.parametrize("n,dp", [(8, 2), (7, 2), (7, 4), (5, 8), (6, 1)])
def test_pad_and_slice_match_kiri_tpu(small, n, dp, monkeypatch):
    jcfg, _, jtok, _, _ = small
    from kiri_tpu.train.trainer import collate

    rng = np.random.default_rng(n)
    batch = collate([{"image": rng.integers(0, 255, (48, 160), np.uint8),
                      "text": "ab"} for _ in range(n)], jtok)
    want, wn = JP.pad_batch_to_devices(batch, JP.make_mesh(
        8, model_parallel=8 // dp))
    got, gn = P.pad_batch_to_devices(batch, _mesh(dp, 1))
    assert gn == wn == n and set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    rows = len(got["image"])
    for i in range(dp):
        monkeypatch.setattr(JP, "process_info", lambda i=i: (i, dp))
        lo, hi = P.local_batch_slice(rows, _mesh(dp, 2, rank=2 * i + 1))
        assert (lo, hi) == JP.local_batch_slice(rows)
        part = P.shard_batch_global(got, _mesh(dp, 2, rank=2 * i))
        np.testing.assert_array_equal(part["image"], got["image"][lo:hi])
    assert P.local_batch_slice(rows) == (0, rows)   # outside a group


@pytest.mark.parametrize("tp_dim", [None, 1])
def test_global_draw_is_one_devices_draw_cut(tp_dim):
    """Each rank's part of a draw (rows 2:4 of 6, half 1 of dimension 1) is
    the same part of one generator's draw of the whole shape, and the
    generators stay in step."""
    whole = torch.Generator().manual_seed(5)
    part = GlobalDraw(torch.Generator().manual_seed(5), 2, 4, 6,
                      tp_index=1, tp_size=2)
    for _ in range(2):
        x = torch.ones(2, 3 if tp_dim else 6, 5)
        got = dropout(x, 0.5, part, tp_dim=tp_dim)
        ref = dropout(torch.ones(6, 6, 5), 0.5, whole)[2:4]
        if tp_dim:
            ref = ref[:, 3:]
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_spawn_fails_fast_on_a_failing_rank():
    """A rank that raises fails the call at once; the rank waiting for it
    in a collective is stopped, not waited for."""
    with pytest.raises(RuntimeError, match="boom"):
        spawn("torch_parallel_ranks:fail_on_rank_1", 2, paths=[TESTS],
              timeout=120)


def test_initialize_needs_a_coordinator(monkeypatch):
    """Without torchrun's environment and without an explicit coordinator,
    ``initialize`` names both instead of guessing a port."""
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        P.initialize(device="cpu")
    assert P.process_info() == (0, 1)


def test_initialize_joins_a_hosted_store(monkeypatch):
    """With ``store=`` the group forms through a store the caller already
    listens on (a port the OS picked), with no coordinator and no
    environment: how ``spawn``'s ranks join."""
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    store = torch.distributed.TCPStore("127.0.0.1", 0, None, is_master=True,
                                       wait_for_workers=False)
    try:
        dev = P.initialize(num_processes=1, process_id=0, device="cpu",
                           store=store)
        x = torch.arange(3.0)
        torch.distributed.all_reduce(x)
        assert dev == torch.device("cpu") and P.process_info() == (0, 1)
        assert x.tolist() == [0.0, 1.0, 2.0]
    finally:
        P.shutdown()
    assert P.process_info() == (0, 1)


def test_make_mesh_needs_a_rank_per_device():
    """One process per device: outside a process group only the one-device
    mesh exists, and a mesh is the world, not a subset of it."""
    mesh = P.make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1
    assert mesh.data_group is None and mesh.model_group is None
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        P.make_mesh(2)
    with pytest.raises(ValueError, match="not divisible"):
        P.make_mesh(1, 2)
