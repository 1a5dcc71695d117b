"""The port's checkpoint files (acn_tpu_torch.utils.checkpoint, its msgpack
codec utils.msgpack_tree, and the checkpoint side of utils.config) against
acn_tpu's, which writes them with flax.

Exact throughout: the port's ``.model`` / ``.optim`` / ``.P.json`` /
``.configs.json`` bytes equal acn_tpu's for the same state, and each package
reads the other's files to equal arrays. The optimizer states are the micro
scene's after one jitted optax update (what acn_tpu's loop saves: a jitted
step returns every dict with its keys sorted), carried to the port with
its state-dict form (``optax_to_port``), in the four shapes ``build_optimizer``
makes (with and without the non-finite guard and the clip).
"""

import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from acn_tpu.models import container as jcont
from acn_tpu.utils import config as jconfig
from acn_tpu.utils import optim as joptim
from acn_tpu_torch import convert
from acn_tpu_torch.models import container as tcont
from acn_tpu_torch.models.nn import tree_leaves
from acn_tpu_torch.utils import checkpoint as tck
from acn_tpu_torch.utils import config as tconfig
from acn_tpu_torch.utils import msgpack_tree
from acn_tpu_torch.utils import optim as toptim
from test_torch_train_step import make_P, micro_scene, optax_to_port

# (grad_clip, guard_nonfinite): the four shapes of build_optimizer's state
OPTIMIZERS = [(1.0, 1), (None, 1), (1.0, 0), (None, 0)]


def _jck():
    """acn_tpu's checkpoint module (it imports flax), imported where used."""
    from acn_tpu.utils import checkpoint
    return checkpoint


def _flax():
    from flax import serialization
    return serialization


def both_states(clip, guard):
    """(JAX variables, JAX optax state after one jitted update, port model,
    port optimizer, port state, JAX optimizer, P)."""
    sc = micro_scene()
    P = make_P(guard_nonfinite=guard, grad_clip=clip)
    jopt = joptim.build_optimizer(P, jcont.param_group_labels(sc.jvars, sc.jcfg),
                                  grad_clip=clip)
    params = jax.tree.map(jnp.asarray, sc.jvars["params"])
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda a: jnp.asarray(rng.normal(size=a.shape), a.dtype), params)
    _, jstate = jax.jit(lambda g, s: jopt.update(g, s, params))(grads, jopt.init(params))
    jstate = jax.device_get(jstate)
    model = convert.from_jax_variables(sc.jvars, sc.tcfg, "cpu")
    labels = tcont.param_group_labels(model.params())
    topt = toptim.build_optimizer(P, labels, grad_clip=clip)
    tstate = optax_to_port(jstate, topt)
    return sc.jvars, jstate, model, topt, tstate, jopt, P


def _numpy_occ(sc):
    return {k: np.asarray(v) for k, v in sc.jocc.items()}


# ------------------------------------------------------------------ bytes


@pytest.mark.parametrize("clip,guard", OPTIMIZERS)
def test_optim_bytes_equal_flax(clip, guard):
    _, jstate, _, topt, tstate, _, _ = both_states(clip, guard)
    want = _flax().to_bytes(jstate)
    got = msgpack_tree.packb(tck.optim_state_dict(tstate, topt))
    assert got == want
    # masked leaves, a bool and int32 counts are among what was written
    sd = _flax().to_state_dict(jstate)
    if guard:
        assert sd["last_finite"].dtype == np.bool_ and sd["notfinite_count"].dtype == np.int32


def test_model_bytes_equal_flax(tmp_path):
    sc = micro_scene()
    model = convert.from_jax_variables(sc.jvars, sc.tcfg, "cpu")
    _jck().save_checkpoint(tmp_path / "j", "t", sc.jvars, occ_states=_numpy_occ(sc))
    tck.save_checkpoint(tmp_path / "p", "t", model, occ_states=sc.tocc)
    assert (tmp_path / "p/t.model").read_bytes() == (tmp_path / "j/t.model").read_bytes()
    # params only, as a best save writes it
    _jck().save_checkpoint(tmp_path / "j", "b", sc.jvars)
    tck.save_checkpoint(tmp_path / "p", "b", tck.variables_of(model))
    assert (tmp_path / "p/b.model").read_bytes() == (tmp_path / "j/b.model").read_bytes()


@pytest.mark.parametrize("clip,guard", OPTIMIZERS[:2])
def test_every_file_equals_acn_tpus(tmp_path, clip, guard):
    """A full step save: all four files byte for byte."""
    sc = micro_scene()
    jvars, jstate, model, topt, tstate, _, P = both_states(clip, guard)
    P.occ_regime = "budget"
    kw = dict(P=P, step=6, best=12.5, is_best=False)
    _jck().save_checkpoint(tmp_path / "j", "step6", jvars, opt_state=jstate,
                           occ_states=_numpy_occ(sc), **kw)
    tck.save_checkpoint(tmp_path / "p", "step6", model, opt_state=tstate,
                        occ_states=sc.tocc, optimizer=topt, **kw)
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "p").iterdir())
    assert names == ["step6.P.json", "step6.configs.json", "step6.model", "step6.optim"]
    for n in names:
        assert (tmp_path / "p" / n).read_bytes() == (tmp_path / "j" / n).read_bytes(), n


def test_saving_an_optimizer_state_needs_its_optimizer(tmp_path):
    _, _, model, _, tstate, _, _ = both_states(1.0, 1)
    with pytest.raises(ValueError, match="needs its optimizer"):
        tck.save_checkpoint(tmp_path, "t", model, opt_state=tstate)


# ------------------------------------------------------------- the codec


_names = st.text(st.characters(codec="utf-8", exclude_categories=("Cs",)), max_size=40)
_dtypes = st.sampled_from([np.float32, np.float64, np.int32, np.int64, np.uint8, np.bool_,
                           np.int16, np.float16])


@st.composite
def _arrays(draw):
    shape = tuple(draw(st.lists(st.integers(0, 5), max_size=3)))
    dtype = draw(_dtypes)
    seed = draw(st.integers(0, 2 ** 16))
    a = np.abs(np.random.default_rng(seed).normal(size=shape)) * 100
    return np.asarray(a).astype(dtype)


_scalars = st.one_of(st.none(), st.booleans(), st.integers(-2 ** 63, 2 ** 64 - 1),
                     st.floats(allow_nan=False), _names,
                     st.binary(max_size=300))
_trees = st.recursive(st.one_of(_scalars, _arrays()),
                      lambda kids: st.dictionaries(_names, kids, max_size=20),
                      max_leaves=40)


def _same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert b.dtype == a.dtype and b.shape == a.shape
        np.testing.assert_array_equal(b, a)
    elif isinstance(a, (bytes, memoryview)):
        assert bytes(b) == bytes(a)
    else:
        assert type(b) is type(a) and b == a


@settings(max_examples=150, deadline=None)
@given(tree=_trees)
def test_codec_round_trip_and_flax_bytes(tree):
    tree = {"root": tree}
    packed = msgpack_tree.packb(tree)
    assert packed == _flax().msgpack_serialize(tree, in_place=True)
    _same(tree, msgpack_tree.unpackb(packed))
    _same(tree, _flax().msgpack_restore(packed))


def test_codec_large_maps_and_strings_and_chunks(monkeypatch):
    """map16, str16, bin16 and flax's chunked form of an oversized array
    (the chunk size lowered so that a small array takes the path)."""
    tree = {f"k{i}": np.full((3,), i, np.int32) for i in range(20)}
    tree["s" * 70_000] = "é" * 40_000
    tree["b"] = b"\x01" * 70_000
    assert msgpack_tree.packb(tree) == _flax().msgpack_serialize(dict(tree), in_place=True)
    big = np.arange(1000, dtype=np.float32).reshape(10, 100)
    from flax import serialization as fs
    monkeypatch.setattr(msgpack_tree, "MAX_CHUNK_SIZE", 1024)
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 1024)
    packed = msgpack_tree.packb({"w": big})
    assert packed == fs.msgpack_serialize({"w": big}, in_place=True)
    np.testing.assert_array_equal(msgpack_tree.unpackb(packed)["w"], big)


def test_codec_refusals():
    with pytest.raises(TypeError, match="map keys are str"):
        msgpack_tree.packb({1: 2})
    with pytest.raises(ValueError, match="bytes after the tree"):
        msgpack_tree.unpackb(msgpack_tree.packb({}) + b"\x00")
    with pytest.raises(ValueError, match="ends inside"):
        msgpack_tree.unpackb(msgpack_tree.packb({"a": np.zeros(4)})[:-3])
    with pytest.raises(ValueError, match="unsupported extension type 2"):
        msgpack_tree.unpackb(_flax().msgpack_serialize({"c": 1 + 2j}, in_place=True))
    # a CPU tensor is written as its numpy array
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert msgpack_tree.packb({"t": t}) == msgpack_tree.packb({"t": t.numpy()})


def test_array_bytes_are_written_in_one_piece():
    """An array's bytes are one memoryview of the array (no copy, no
    per-element work), whatever its size."""
    a = np.arange(1 << 20, dtype=np.float32)
    pieces = list(msgpack_tree.iter_packed({"a": a}))
    views = [p for p in pieces if isinstance(p, memoryview)]
    assert len(views) == 1 and views[0].nbytes == a.nbytes
    assert np.shares_memory(np.frombuffer(views[0], np.float32), a)


# ------------------------------------------------------ across the packages


@pytest.mark.parametrize("clip,guard", OPTIMIZERS)
def test_port_save_loads_in_acn_tpu(tmp_path, clip, guard):
    sc = micro_scene()
    jvars, jstate, model, topt, tstate, jopt, P = both_states(clip, guard)
    tck.save_checkpoint(tmp_path, "step3", model, opt_state=tstate, occ_states=sc.tocc,
                        P=P, step=3, best=1.5, optimizer=topt)
    jck = _jck()
    loaded = jck.load_checkpoint(tmp_path, "step3")
    assert loaded["step"] == 3 and loaded["best"] == 1.5
    got = jck.restore_variables_like(jvars, loaded["variables"])
    assert jax.tree.structure(got) == jax.tree.structure(jvars)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jvars)):
        np.testing.assert_array_equal(a, b)
    for k, v in loaded["occ_states"].items():
        np.testing.assert_array_equal(v, _numpy_occ(sc)[k])
    template = jopt.init(jax.tree.map(jnp.asarray, jvars["params"]))
    opt = jax.device_get(jck.load_opt_state(tmp_path, "step3", template))
    assert jax.tree.structure(opt) == jax.tree.structure(jstate)
    for a, b in zip(jax.tree.leaves(opt), jax.tree.leaves(jstate)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("clip,guard", OPTIMIZERS)
def test_acn_tpu_save_loads_in_the_port(tmp_path, clip, guard):
    sc = micro_scene()
    jvars, jstate, model, topt, tstate, _, P = both_states(clip, guard)
    _jck().save_checkpoint(tmp_path, "last", jvars, opt_state=jstate,
                           occ_states=_numpy_occ(sc), P=P, step=7, best=2.0)
    loaded = tck.load_checkpoint(tmp_path, "last")
    assert loaded["step"] == 7 and loaded["best"] == 2.0
    got, occ = tck.restore_model(loaded, sc.tcfg, "cpu")
    for a, b in zip(tree_leaves(got.params()), tree_leaves(model.params())):
        assert torch.equal(a, b)
    for name in ("centroids", "expert_aabbs", "global_aabb"):
        assert torch.equal(getattr(got, name), getattr(model, name))
    assert occ.keys() == sc.tocc.keys()
    assert all(torch.equal(occ[k], sc.tocc[k]) for k in occ)
    opt = tck.load_opt_state(tmp_path, "last", topt.init(got.params()), topt)
    assert opt.keys() == tstate.keys()
    for name in opt:
        for a, b in zip(tree_leaves(opt[name]), tree_leaves(tstate[name])):
            assert a.dtype == b.dtype and torch.equal(a, b), name
    # no .optim: the template comes back
    template = topt.init(got.params())
    assert tck.load_opt_state(tmp_path, "best", template, topt) is template


def test_loaders_put_the_state_on_the_card_by_default(tmp_path):
    """``device=None`` means the card: without one the loaders raise."""
    sc = micro_scene()
    _, _, model, topt, tstate, _, _ = both_states(1.0, 1)
    tck.save_checkpoint(tmp_path, "t", model, opt_state=tstate, occ_states=sc.tocc,
                        optimizer=topt)
    payload = tck.load_checkpoint(tmp_path, "t")
    sd = msgpack_tree.unpackb((tmp_path / "t.optim").read_bytes())
    if torch.cuda.is_available():
        got, occ = tck.restore_model(payload, sc.tcfg)
        opt = tck.opt_state_from_dict(sd, topt)
        assert all(t.is_cuda for t in tree_leaves(got.params()) + tree_leaves(opt["mu"]))
        assert occ["occs"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="none is available"):
            tck.restore_model(payload, sc.tcfg)
        with pytest.raises(RuntimeError, match="none is available"):
            tck.opt_state_from_dict(sd, topt)


def test_opt_state_of_another_optimizer_is_refused(tmp_path):
    _, _, model, topt, tstate, _, _ = both_states(1.0, 1)
    tck.save_checkpoint(tmp_path, "t", model, opt_state=tstate, optimizer=topt)
    other = toptim.build_optimizer(make_P(), {**topt.labels}, grad_clip=1.0)
    other = types.SimpleNamespace(**{**vars(other), "schedules": {"encoding": None}})
    with pytest.raises(ValueError, match="not this optimizer's state"):
        tck.load_opt_state(tmp_path, "t", tstate, other)


# ------------------------------------------------------- tags and directories


def _touch_tag(d: Path, tag: str, data: bytes = b"x"):
    d.mkdir(parents=True, exist_ok=True)
    (d / f"{tag}.model").write_bytes(data)


def test_fallback_tags_order_matches_acn_tpu(tmp_path):
    for tag in ("best", "step10", "step2", "step30", "last", "stepx"):
        _touch_tag(tmp_path, tag)
    for want_tag in ("best", "step2", "nope", "last"):
        got = tck.fallback_tags(tmp_path, want_tag)
        assert got == _jck().fallback_tags(tmp_path, want_tag)
    assert tck.fallback_tags(tmp_path, "best") == ["best", "last", "step30", "step10", "step2"]
    assert tck.fallback_tags(tmp_path, "step2") == ["step2", "last", "step30", "step10", "best"]


def test_load_with_fallback_skips_a_truncated_checkpoint(tmp_path):
    sc = micro_scene()
    model = convert.from_jax_variables(sc.jvars, sc.tcfg, "cpu")
    tck.save_checkpoint(tmp_path, "step4", model, step=4)
    tck.save_checkpoint(tmp_path, "last", model, step=5)
    full = (tmp_path / "last.model").read_bytes()
    (tmp_path / "last.model").write_bytes(full[: len(full) // 2])
    payload, used = tck.load_checkpoint_with_fallback(tmp_path, "last")
    assert used == "step4" and payload["step"] == 4
    for p in tmp_path.glob("*.model"):
        p.write_bytes(b"\xc1")
    with pytest.raises(FileNotFoundError, match="No readable checkpoint"):
        tck.load_checkpoint_with_fallback(tmp_path, "last")


def test_atomic_write_leaves_no_partial_file(tmp_path):
    path = tmp_path / "a.model"
    tck._atomic_write(path, [b"abc", memoryview(b"def")])
    assert path.read_bytes() == b"abcdef" and not (tmp_path / "a.model.tmp").exists()

    def pieces():
        yield b"new"
        raise RuntimeError("the writer died")

    with pytest.raises(RuntimeError):
        tck._atomic_write(path, pieces())
    assert path.read_bytes() == b"abcdef"  # the old file, whole
    assert (tmp_path / "a.model.tmp").exists()  # never under the final name


def test_resolve_checkpoint_dir_matches_acn_tpu(tmp_path):
    logs = tmp_path / "logs"
    _touch_tag(logs / "run" / "a" / "v1", "best")
    _touch_tag(logs / "run" / "b" / "v0", "best")
    (logs / "run" / "b" / "v2").mkdir()  # the last by name holds no model
    _touch_tag(logs / "flat", "last")
    for value in ("run/a", "flat", str(logs / "flat")):
        assert tck.resolve_checkpoint_dir(value, logs_root=str(logs)) == \
            _jck().resolve_checkpoint_dir(value, logs_root=str(logs))
    assert tck.resolve_checkpoint_dir("run/a", str(logs)) == str((logs / "run/a/v1").resolve())
    for value in ("run", "missing"):
        with pytest.raises(FileNotFoundError):
            tck.resolve_checkpoint_dir(value, logs_root=str(logs))
        with pytest.raises(FileNotFoundError):
            _jck().resolve_checkpoint_dir(value, logs_root=str(logs))


def test_checkpoint_config_side_matches_acn_tpu(tmp_path):
    P = types.SimpleNamespace(a=1, b=[1, 2], c={"x": 1.5}, d=Path("/x"), occ_regime="budget")
    assert tconfig.namespace_to_jsonable(P) == jconfig.namespace_to_jsonable(P)
    run = tmp_path / "logs" / "r"
    _touch_tag(run, "step6")
    (run / "step6.P.json").write_text(json.dumps(tconfig.namespace_to_jsonable(P)))
    for value in (str(run), str(tmp_path / "logs" / "r")):
        path = tconfig.resolve_ckpt_cfg_path(value, "step6")
        assert path == jconfig.resolve_ckpt_cfg_path(value, "step6")
        assert tconfig.load_checkpoint_cfg(path)["occ_regime"] == "budget"
    assert tconfig.resolve_ckpt_cfg_path(str(run), "best") is None


# ------------------------------------------------------------------ async


def test_async_saves_snapshot_before_the_next_step_and_coalesce(tmp_path):
    """The snapshot is taken when ``save`` is called: an in-place update
    after it does not reach the file. Saves under one coalesce key keep the
    newest; ``wait`` returns when every save is on disk."""
    _, _, model, topt, tstate, _, P = both_states(1.0, 1)
    before = [t.clone() for t in tree_leaves(model.params())]
    ck = tck.AsyncCheckpointer()
    ck.save(tmp_path, "step2", model, opt_state=tstate, P=P, step=2, coalesce_key="step",
            optimizer=topt)
    ck.save(tmp_path, "best", model, P=P, step=2, best=3.0, is_best=True)
    with torch.no_grad():
        for t in tree_leaves(model.params()):
            t.add_(1.0)  # the next step's in-place update
    ck.wait()
    got, _ = tck.restore_model(tck.load_checkpoint(tmp_path, "step2"), model.cfg, "cpu")
    for a, b in zip(tree_leaves(got.params()), before):
        assert torch.equal(a, b)
    assert json.loads((tmp_path / "best.configs.json").read_text()) == {
        "step": 2, "best": 3.0, "is_best": True}
    assert not (tmp_path / "best.optim").exists()
    assert not ck.errors
