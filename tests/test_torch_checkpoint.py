"""The port's checkpoint store (repro_torch.checkpoint) against the JAX
package's: the same on-disk format in both directions, and a search
checkpointed by one package resumes in the other to the same result."""
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint.store as jstore
import repro.dse as J
import repro_torch.checkpoint.store as tstore
import repro_torch.dse as T
from repro_torch import random as tr
from torch_parity import ENGINE_RTOL, close, equal


def _trees(seed=0):
    """The same nested tree for each package: dict keys out of order, a
    list, a 1-tuple, a None, and the dtypes a search state holds (JAX
    keeps no 64-bit leaves here)."""
    rng = np.random.default_rng(seed)
    host = {"b": rng.standard_normal((3, 4)).astype(np.float32),
            "a": [rng.integers(0, 9, 5).astype(np.int32),
                  np.asarray([7, 2 ** 32 - 1], np.uint32)],
            "c": (rng.standard_normal(2).astype(np.float32),),
            "d": None,
            "e": {"z": np.arange(6, dtype=np.int32).reshape(2, 3),
                  "y": np.float32(2.5) * np.ones((1,), np.float32)}}

    def conv(t, f):
        if isinstance(t, dict):
            return {k: conv(v, f) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(conv(v, f) for v in t)
        return None if t is None else f(t)
    return (conv(host, jnp.asarray),
            conv(host, lambda a: torch.from_numpy(a.copy())), host)


def _manifest(path):
    m = json.loads((path / "manifest.json").read_text())
    m.pop("time")
    return m


def test_manifest_and_arrays_match_the_reference(tmp_path):
    jt, tt, _ = _trees()
    pj = jstore.save(tmp_path / "jax", 5, jt, extra={"k": 1})
    pt = tstore.save(tmp_path / "torch", 5, tt, extra={"k": 1})
    assert _manifest(pt) == _manifest(pj)
    aj, at = np.load(pj / "arrays.npz"), np.load(pt / "arrays.npz")
    assert sorted(aj.files) == sorted(at.files)
    for f in aj.files:
        equal(aj[f], at[f], what=f)


def test_reference_checkpoint_restores_in_the_port_and_back(tmp_path):
    jt, tt, host = _trees(1)
    jstore.save(tmp_path / "j", 3, jt)
    like_t = _trees(2)[1]
    got = tstore.restore(tmp_path / "j", 3, like_t)
    for g, w in zip(tstore._flatten(got)[0], tstore._flatten(host)[0]):
        assert isinstance(g, torch.Tensor)
        equal(w, g)
    tstore.save(tmp_path / "t", 4, tt)
    back = jstore.restore(tmp_path / "t", 4, _trees(3)[0])
    for g, w in zip(jax.tree_util.tree_leaves(back),
                    tstore._flatten(host)[0]):
        equal(w, np.asarray(g))


def test_restore_refuses_a_wrong_tree_or_a_corrupt_file(tmp_path):
    _, tt, _ = _trees()
    tstore.save(tmp_path, 1, tt)
    with pytest.raises(ValueError, match="leaf count"):
        tstore.restore(tmp_path, 1, {"only": torch.zeros(1)})
    wrong = _trees()[1]
    wrong["b"] = torch.zeros(2, 2)
    with pytest.raises(ValueError, match="shape"):
        tstore.restore(tmp_path, 1, wrong)
    arrays = tmp_path / "step_00000001" / "arrays.npz"
    data = dict(np.load(arrays))
    data["a0"] = data["a0"] + 1
    np.savez(arrays, **data)
    with pytest.raises(ValueError, match="hash"):
        tstore.restore(tmp_path, 1, _trees()[1])


def test_manager_retains_sweeps_and_falls_back(tmp_path):
    m = tstore.CheckpointManager(tmp_path, keep=2)
    for step in range(4):
        m.save(step, {"x": torch.full((2,), float(step))})
    (tmp_path / "step_00000009.tmp-dead").mkdir()
    assert m.steps() == [2, 3] and m.latest() == 3
    assert tstore.latest_step(tmp_path) == 3
    arrays = tmp_path / "step_00000003" / "arrays.npz"
    np.savez(arrays, a0=np.zeros(2, np.float32))      # bit rot in step 3
    step, tree = m.restore_latest({"x": torch.zeros(2)})
    assert step == 2 and m.corrupt_fallbacks == 1
    equal(np.full(2, 2.0, np.float32), tree["x"])
    m.save(4, {"x": torch.ones(2)})                  # the sweep runs here
    assert not any(".tmp-" in p.name for p in tmp_path.iterdir())
    assert tstore.CheckpointManager(tmp_path / "none").restore_latest(
        {"x": torch.zeros(2)}) == (None, None)


def test_async_checkpointer_writes_in_the_background(tmp_path):
    m = tstore.CheckpointManager(tmp_path, keep=5)
    ac = tstore.AsyncCheckpointer(m, max_pending=1)
    for step in range(3):
        ac.submit(step, {"w": torch.full((3,), float(step))},
                  extra={"step": step})
    ac.wait()
    ac.close()
    assert m.steps() == [0, 1, 2]
    _, tree = m.restore_latest({"w": torch.zeros(3)})
    equal(np.full(3, 2.0, np.float32), tree["w"])


def test_async_checkpointer_owns_its_snapshot(tmp_path, monkeypatch):
    """A CPU tensor updated in place after ``submit`` is saved as it was
    at ``submit``: the worker is held until the caller has written."""
    m = tstore.CheckpointManager(tmp_path, keep=5)
    go = threading.Event()
    save = m.save
    monkeypatch.setattr(m, "save", lambda *a, **k: (go.wait(), save(*a, **k)))
    ac = tstore.AsyncCheckpointer(m, max_pending=1)
    w = torch.ones(4)
    ac.submit(1, {"w": w})
    w.mul_(5.0)
    go.set()
    ac.wait()
    ac.close()
    _, tree = m.restore_latest({"w": torch.zeros(4)})
    equal(np.ones(4, np.float32), tree["w"])


def _space(mod):
    return mod.DesignSpace(
        skus=(mod.SKU("laptop", 150.0, 2e6), mod.SKU("desktop", 300.0, 1e6),
              mod.SKU("server", 600.0, 3e5)),
        processes=("5nm", "7nm"), integrations=("MCM", "2.5D"),
        chiplet_counts=(1, 2, 3, 4), allow_reuse=True,
        reuse_package_options=(False, True))


KW = dict(population=16, elite=4)


def _same(want, got):
    assert got.best.label == want.best.label
    assert got.n_evaluated == want.n_evaluated
    assert [h["best_label"] for h in got.history] == \
        [h["best_label"] for h in want.history]
    assert [h["evaluated"] for h in got.history] == \
        [h["evaluated"] for h in want.history]
    close([h["best_objective"] for h in want.history],
          [h["best_objective"] for h in got.history], rtol=ENGINE_RTOL)


@pytest.mark.parametrize("risk", [False, True])
def test_reference_search_checkpoint_resumes_in_the_port(tmp_path, risk):
    """The reference runs 3 of 6 generations, checkpointing each but the
    last; the port resumes from its step 2 and ends where an uninterrupted
    reference run ends, and bit for bit where an uninterrupted port run
    ends."""
    jr = J.RiskConfig(n_draws=24) if risk else None
    trc = T.RiskConfig(n_draws=24) if risk else None
    key = jax.random.PRNGKey(5)
    J.portfolio_search(_space(J), key, generations=3, risk=jr,
                       checkpoint_dir=tmp_path, checkpoint_keep=5, **KW)
    assert jstore.latest_step(tmp_path) == 2    # the last step is not saved
    want = J.portfolio_search(_space(J), key, generations=6, risk=jr, **KW)
    got = T.portfolio_search(_space(T), tr.as_key(np.asarray(key), "cpu"),
                             generations=6, risk=trc,
                             checkpoint_dir=tmp_path, checkpoint_keep=5,
                             device="cpu", **KW)
    _same(want, got)
    plain = T.portfolio_search(_space(T), tr.as_key(np.asarray(key), "cpu"),
                               generations=6, risk=trc, device="cpu", **KW)
    # generations 0-1 of the history are the reference's own floats
    assert [h["gen_best"] for h in got.history[2:]] == \
        [h["gen_best"] for h in plain.history[2:]]
    assert [(r.label, r.objective(got.objective_key)) for r in got.ranked] \
        == [(r.label, r.objective(got.objective_key)) for r in plain.ranked]


def test_port_search_checkpoint_resumes_in_the_reference(tmp_path):
    key = tr.PRNGKey(8, device="cpu")
    T.portfolio_search(_space(T), key, generations=3,
                       checkpoint_dir=tmp_path, device="cpu", **KW)
    m = jstore.CheckpointManager(tmp_path)
    step, tree = m.restore_latest(J.SearchState.like(KW["population"]))
    assert step == 2 and tree["k_loop"].dtype == jnp.uint32
    want = T.portfolio_search(_space(T), key, generations=6, device="cpu",
                              **KW)
    got = J.portfolio_search(_space(J), jax.random.PRNGKey(8),
                             generations=6, checkpoint_dir=tmp_path, **KW)
    _same(want, got)


def test_search_state_tree_is_the_reference_layout():
    state = T.SearchState.init(tr.PRNGKey(3, device="cpu"), 10, 100,
                               T.RiskConfig())
    ref = J.SearchState.init(jax.random.PRNGKey(3), 10, 100, J.RiskConfig())
    tree, like = state.tree(), T.SearchState.like(10)
    assert sorted(tree) == sorted(like) == sorted(ref.tree())
    for k, v in ref.tree().items():
        equal(np.asarray(v), tree[k], what=k)
        assert tree[k].dtype == like[k].dtype


# -- NamedTuple trees: the training state --------------------------------


def _train_states(compress, seed=0):
    """The JAX package's TrainState of a reduced glm4_9b after init, and the
    port's made from it (``convert.train_state_from_numpy``)."""
    from repro.configs import get_config
    from repro.parallel import steps as jst
    from repro_torch.convert import train_state_from_numpy
    cfg = get_config("glm4_9b").reduced().replace(n_layers=1,
                                                  dtype="float32")
    js = jst.init_train_state(cfg, jax.random.PRNGKey(seed),
                              compress=compress)
    return js, train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, js), "cpu")


@pytest.mark.parametrize("compress", [False, True])
def test_train_state_round_trips_with_the_reference_treedef(tmp_path,
                                                            compress):
    """An OptState / TrainState (NamedTuples, with ef_err None or a tree)
    saves and restores field for field, and the manifest's treedef is the
    string JAX prints for the same nest."""
    from repro.optim import OptState as JOpt
    from repro_torch.optim import OptState
    from repro_torch.parallel.steps import TrainState
    js, ts = _train_states(compress)
    path = tstore.save(tmp_path, 1, ts)
    assert _manifest(path)["treedef"] == \
        str(jax.tree_util.tree_structure(js))
    like = tstore.tree_map(torch.zeros_like, ts)
    got = tstore.restore(tmp_path, 1, like)
    assert type(got) is TrainState and type(got.opt) is OptState
    assert (got.ef_err is None) == (not compress)
    for w, g in zip(tstore._flatten(ts)[0], tstore._flatten(got)[0]):
        equal(w, g)
    opt = JOpt(step=jnp.int32(3), master={"a": jnp.ones(2)},
               m={"a": jnp.zeros(2)}, v={"a": jnp.zeros(2)})
    topt = OptState(step=torch.tensor(3, dtype=torch.int32),
                    master={"a": torch.ones(2)}, m={"a": torch.zeros(2)},
                    v={"a": torch.zeros(2)})
    path = tstore.save(tmp_path, 2, topt)
    assert _manifest(path)["treedef"] == \
        str(jax.tree_util.tree_structure(opt))
    back = tstore.restore(tmp_path, 2, tstore.tree_map(torch.zeros_like,
                                                       topt))
    assert type(back) is OptState and int(back.step) == 3


@pytest.mark.parametrize("compress", [False, True])
def test_train_state_checkpoints_cross_both_ways(tmp_path, compress):
    js, ts = _train_states(compress)
    jstore.save(tmp_path / "j", 4, js)
    got = tstore.restore(tmp_path / "j", 4,
                         tstore.tree_map(torch.zeros_like, ts))
    for w, g in zip(jax.tree_util.tree_leaves(js), tstore._flatten(got)[0]):
        equal(np.asarray(w), g)
    # the port's state, changed, restores into the reference's structure
    ts = tstore.tree_map(lambda t: t + 1, ts)
    tstore.save(tmp_path / "t", 5, ts)
    back = jstore.restore(tmp_path / "t", 5, js)
    assert type(back) is type(js)
    for w, g in zip(tstore._flatten(ts)[0], jax.tree_util.tree_leaves(back)):
        equal(w, np.asarray(g))
