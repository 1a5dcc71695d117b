"""The port's AdamW and SGD (``--optimizer adamw|sgd``, acn_tpu_torch.utils.
optim) against optax's ``adamw`` and ``sgd`` as acn_tpu's
``build_optimizer`` builds them, and their checkpoints against acn_tpu's.

Three updates of both optimizers from the micro scene's parameters on the
same random gradients, with the clip on, off and across its threshold, and
a non-finite gradient skipped by the guard; then the state carries across
to optax and back, the ``.optim`` bytes equal flax's, and each package
restores the other's files.

Tolerances: updates and parameters rtol 2e-5 / atol 1e-9 (as the Adam test
in ``test_torch_train_step.py``: one ulp of 0.999^t is 3e-5 of the bias
correction at t = 2; SGD's update is one product, lr·g, and agrees to an
ulp). States and files: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from acn_tpu.models import container as jcont
from acn_tpu.utils import optim as joptim
from acn_tpu_torch import convert
from acn_tpu_torch.models import container as tcont
from acn_tpu_torch.models.nn import tree_leaves
from acn_tpu_torch.utils import checkpoint as tck
from acn_tpu_torch.utils import msgpack_tree
from acn_tpu_torch.utils import optim as toptim
from test_torch_train_step import (_leaves, _opt_case, _tt, make_P, micro_scene,
                                   optax_to_port, port_to_optax)
from torch_m9_util import one_thread  # noqa: F401  (pytestmark uses it)

pytestmark = pytest.mark.usefixtures("one_thread")


NAMES = ("adamw", "sgd")
CASES = ("clip_on", "clip_across_threshold", "no_clip", "nonfinite_skipped")


def _setup(name, case):
    over, clip, scales, nan_step = _opt_case(case)
    sc = micro_scene()
    P = make_P(optimizer=name, **over)
    jparams = jax.tree.map(jnp.asarray, sc.jvars["params"])
    jopt = joptim.build_optimizer(P, jcont.param_group_labels(sc.jvars, sc.jcfg),
                                  grad_clip=clip)
    model = convert.from_jax_variables(sc.jvars, sc.tcfg, "cpu")
    topt = toptim.build_optimizer(P, tcont.param_group_labels(model.params()),
                                  grad_clip=clip)
    return sc, P, jparams, jopt, model, topt, scales, nan_step


def _three_updates(name, case):
    """Both optimizers through three updates; (JAX params, JAX state, port
    params, port state, port optimizer, JAX optimizer, last gradient)."""
    sc, P, jparams, jopt, model, topt, scales, nan_step = _setup(name, case)
    jstate = jopt.init(jparams)
    jupdate = jax.jit(jopt.update)
    tparams = model.params()
    tstate = topt.init(tparams)
    rng = np.random.default_rng(9)
    for i, scale in enumerate(scales):
        g = jax.tree.map(lambda a: (scale / np.sqrt(a.size) * rng.normal(
            size=a.shape)).astype(np.float32), sc.jvars["params"])
        if i == nan_step:
            g["experts"]["sigma_head"]["w"][0, 0, 0] = np.nan
        jupd, jstate = jupdate(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, jupd)
        tupd, tstate = topt.update(_tt(g), tstate, tparams)
        toptim.apply_updates(tparams, tupd)
        for a, b in zip(_leaves(tupd), jax.tree.leaves(jupd)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=2e-5, atol=1e-9)
        if i == nan_step:
            assert all(float(u.abs().max()) == 0.0 for u in tree_leaves(tupd))
    return jparams, jax.device_get(jstate), tparams, tstate, topt, jopt, g


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", NAMES)
def test_three_updates_match_optax(name, case):
    jparams, jstate, tparams, tstate, topt, jopt, g = _three_updates(name, case)
    for a, b in zip(_leaves(tparams), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-5, atol=1e-8)
    skipped = 1 if _opt_case(case)[3] is not None else 0
    want = optax_to_port(jstate, topt)
    assert set(tstate) == set(want)
    assert ("mu" in tstate) == (name != "sgd")
    assert int(tstate["count"]) == int(want["count"]) == 3 - skipped
    assert int(tstate["total_notfinite"]) == int(want["total_notfinite"]) == skipped
    for key in set(tstate) & {"mu", "nu"}:
        for a, b in zip(_leaves(tstate[key]), _leaves(want[key])):
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-9)
    # the state goes back to optax, which goes on from it as from its own
    back = port_to_optax(tstate, topt, jax.device_get(jopt.init(jparams)))
    assert jax.tree.structure(back) == jax.tree.structure(jstate)
    nxt = jax.jit(jopt.update)
    ga = jax.tree.map(jnp.asarray, g)
    for a, b in zip(jax.tree.leaves(nxt(ga, back, jparams)[0]),
                    jax.tree.leaves(nxt(ga, jstate, jparams)[0])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-5, atol=1e-9)


@pytest.mark.parametrize("name", NAMES)
def test_adamw_decays_and_sgd_has_no_moments(name):
    """AdamW's update is Adam's plus lr·1e-4·p; SGD's is −lr·g exactly."""
    sc, P, _, _, model, topt, _, _ = _setup(name, "no_clip")
    params = model.params()
    rng = np.random.default_rng(1)
    grads = toptim.tree_map(lambda p: torch.from_numpy(
        rng.normal(size=tuple(p.shape)).astype(np.float32)), params)
    upd, state = topt.update(grads, topt.init(params), params)
    lr = {k: s(0) for k, s in topt.schedules.items()}
    if name == "sgd":
        assert set(state) == {"count", "notfinite_count", "last_finite", "total_notfinite"}
        toptim.tree_map(lambda u, gr, lab: np.testing.assert_array_equal(
            u.numpy(), (-lr[lab] * gr).numpy()), upd, grads, topt.labels)
    else:
        adam = toptim.build_optimizer(make_P(optimizer="adam"), topt.labels, grad_clip=None)
        a_upd, _ = adam.update(grads, adam.init(params))
        toptim.tree_map(lambda u, au, p, lab: np.testing.assert_allclose(
            u.numpy(), (au - lr[lab] * toptim.WEIGHT_DECAY * p.detach()).numpy(),
            rtol=1e-6, atol=1e-12), upd, a_upd, params, topt.labels)
    with pytest.raises(ValueError, match="parameters") if name == "adamw" else _null():
        topt.update(grads, topt.init(params))


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


@pytest.mark.parametrize("name", NAMES)
def test_optim_bytes_equal_flax_and_load_both_ways(tmp_path, name):
    from flax import serialization

    from acn_tpu.utils import checkpoint as jck

    jparams, jstate, _, _, topt, jopt, _ = _three_updates(name, "clip_on")
    tstate = optax_to_port(jstate, topt)  # the same state, to the bit
    assert msgpack_tree.packb(tck.optim_state_dict(tstate, topt)) == \
        serialization.to_bytes(jstate)
    sc = micro_scene()
    model = convert.from_jax_variables(sc.jvars, sc.tcfg, "cpu")
    # the port's file, restored by acn_tpu
    tck.save_checkpoint(tmp_path / "p", "step3", model, opt_state=tstate, step=3,
                        optimizer=topt)
    template = jopt.init(jax.tree.map(jnp.asarray, sc.jvars["params"]))
    opt = jax.device_get(jck.load_opt_state(tmp_path / "p", "step3", template))
    assert jax.tree.structure(opt) == jax.tree.structure(jstate)
    for a, b in zip(jax.tree.leaves(opt), jax.tree.leaves(jstate)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    # acn_tpu's file, restored by the port, bit for bit
    jck.save_checkpoint(tmp_path / "j", "last", sc.jvars, opt_state=jstate, step=3)
    got = tck.load_opt_state(tmp_path / "j", "last", topt.init(model.params()), topt)
    assert set(got) == set(tstate)
    for key in got:
        for a, b in zip(tree_leaves(got[key]), tree_leaves(tstate[key])):
            assert a.dtype == b.dtype and torch.equal(a, b), key
    # a state of another optimizer is refused
    other = toptim.build_optimizer(make_P(optimizer="adam"), topt.labels)
    with pytest.raises(ValueError, match="not this optimizer's state"):
        tck.load_opt_state(tmp_path / "j", "last", got, other)
