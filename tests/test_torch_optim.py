"""The port's optimizer (repro_torch.optim) against the JAX package's:
schedules, AdamW from the same numpy gradients and state, clipping, the
properties of the reference's own tests (tests/test_substrate.py), and
top-k + int8 compression with error feedback.

Tolerances: AdamW's params, m and v at 1e-6 relative over three steps,
relative to each element or, where a moment's update cancels, to its
leaf's largest element (the same ops in the same order; the CPU may fuse
a multiply-add where XLA does not, and the global norm sums in another
order, so a clipped step's scale differs in its last bits); schedules at
1e-6 relative (float32: XLA's cos and torch's differ by an ulp or two);
compression bit-equal.  The compression inputs are drawn without ties in
|g|, where ``torch.topk`` and ``lax.top_k`` may keep different indices.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as J
import repro_torch.optim as T
from repro_torch.optim import adamw as tadamw
from repro_torch.optim.compression import compressed_bytes
from repro_torch.tree import leaves
from torch_parity import close, equal

torch.set_num_threads(1)
ADAM_RTOL = 1e-6


def _tree(rng, scale=1.0):
    """A nest of fp32 numpy leaves shaped like a small model's."""
    return {"embed": {"embedding": scale * rng.standard_normal((37, 8))},
            "blocks": {"w": scale * rng.standard_normal((2, 8, 5)),
                       "ln": {"scale": 1.0 + scale * rng.standard_normal(8)}},
            "final": scale * rng.standard_normal(3)}


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, _f32(tree))


def _torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()),
                                  _f32(tree))


@pytest.mark.parametrize("total,warmup", [(100, 10), (6, 2), (1, 0),
                                          (10_000, 100)])
def test_schedules_match_the_reference(total, warmup):
    steps = np.arange(0, total + 7, dtype=np.int32)
    for s in steps:
        j = J.linear_warmup_cosine(jnp.asarray(s), 3e-4, warmup, total)
        t = T.linear_warmup_cosine(torch.tensor(s), 3e-4, warmup, total)
        close(j, t, rtol=1e-6, what=f"warmup-cosine at step {s}")
        close(J.cosine_schedule(jnp.asarray(s), 1e-3, total, 0.2),
              T.cosine_schedule(torch.tensor(s), 1e-3, total, 0.2),
              rtol=1e-6, what=f"cosine at step {s}")
        assert t.dtype == torch.float32


def test_schedule_warmup_then_decay():
    lrs = [float(T.linear_warmup_cosine(torch.tensor(s), 1e-3, 10, 100))
           for s in range(100)]
    assert lrs[0] < lrs[9] <= 1e-3 + 1e-9
    assert lrs[50] > lrs[99]


def test_adamw_init_copies_the_params():
    params = _torch(_tree(np.random.default_rng(0)))
    state = T.adamw_init(params)
    assert state.step.dtype == torch.int32 and int(state.step) == 0
    for p, m, v, w in zip(leaves(params), leaves(state.master),
                          leaves(state.m), leaves(state.v)):
        assert m.data_ptr() != p.data_ptr()
        equal(p, m)
        assert not w.any() and w.dtype == torch.float32
        assert not v.any()
    leaves(params)[0].add_(1.0)
    assert not torch.equal(leaves(params)[0], leaves(state.master)[0])


def test_adamw_init_spec_matches_the_reference():
    from repro.configs import get_config as jcfg
    from repro.models import api as japi
    from repro_torch.configs import get_config as tcfg
    from repro_torch.models import api as tapi
    from repro_torch.models.common import spec_leaves
    js = J.adamw_init_spec(japi.param_spec(jcfg("glm4_9b").reduced()))
    ts = T.adamw_init_spec(tapi.param_spec(tcfg("glm4_9b").reduced()))
    assert ts.step.shape == () and ts.step.dtype == torch.int32
    for field in ("master", "m", "v"):
        jl = jax.tree_util.tree_leaves(getattr(js, field),
                                       is_leaf=lambda x: hasattr(x, "axes"))
        tl = list(spec_leaves(getattr(ts, field)))
        assert [(s.shape, s.axes, s.init) for s in jl] == \
            [(s.shape, s.axes, s.init) for s in tl]
        assert all(s.dtype == torch.float32 for s in tl)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [1e-2, 1e3])   # unclipped, clipped
@pytest.mark.parametrize("piece", [None, 7])
def test_adamw_update_matches_the_reference(param_dtype, grad_scale, piece,
                                            monkeypatch):
    """Three steps from the same state and gradients: params, masters, m
    and v at 1e-6 relative, in one piece and in pieces of 7 elements."""
    if piece is not None:
        monkeypatch.setattr(tadamw, "PIECE", piece)
    rng = np.random.default_rng(1)
    params = _tree(rng)
    jstate, tstate = J.adamw_init(_jax(params)), T.adamw_init(_torch(params))
    tparams = _torch(params)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[param_dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[param_dtype]
    tparams = jax.tree_util.tree_map(lambda t: t.to(tdt), tparams)
    for step in range(3):
        grads = _tree(rng, grad_scale)
        lr = 1e-3 * (step + 1)
        jp, jstate = J.adamw_update(_jax(grads), jstate, lr,
                                    param_dtype=jdt)
        out = tparams if step % 2 else None    # in place, and new tensors
        tp, tstate = T.adamw_update(_torch(grads), tstate,
                                    torch.tensor(lr), param_dtype=tdt,
                                    out=out)
        if out is not None:
            assert tp is out
        assert int(tstate.step) == step + 1
        for j, t in zip(jax.tree_util.tree_leaves(jp), leaves(tp)):
            assert t.dtype == tdt
            j = np.asarray(j, np.float32)
            tol = ADAM_RTOL if tdt == torch.float32 else 2 ** -8
            close(j, t.float(), rtol=tol, atol=tol * float(np.abs(j).max()),
                  what=f"params after step {step}")
        for field in ("master", "m", "v"):
            for j, t in zip(jax.tree_util.tree_leaves(getattr(jstate, field)),
                            leaves(getattr(tstate, field))):
                close(j, t, rtol=ADAM_RTOL,
                      atol=ADAM_RTOL * float(np.abs(np.asarray(j)).max()),
                      what=f"{field} after step {step}")


def test_clip_by_global_norm_matches_the_reference():
    rng = np.random.default_rng(2)
    for scale in (1e-3, 1.0, 1e4):
        grads = _tree(rng, scale)
        jc, jn = J.clip_by_global_norm(_jax(grads), 1.0)
        tc, tn = T.clip_by_global_norm(_torch(grads), 1.0)
        close(jn, tn, rtol=1e-6, what="global norm")
        for j, t in zip(jax.tree_util.tree_leaves(jc), leaves(tc)):
            close(j, t, rtol=1e-6, atol=1e-12, what="clipped")


def test_adamw_converges_on_quadratic():
    """tests/test_substrate.py's property, through the port."""
    p = {"w": torch.tensor([5.0, -3.0])}
    state = T.adamw_init(p)
    target = torch.tensor([1.0, 2.0])
    for _ in range(300):
        w = p["w"].detach().requires_grad_()
        (g,) = torch.autograd.grad(torch.sum((w - target) ** 2), [w])
        p, state = T.adamw_update({"w": g}, state, 0.05, weight_decay=0.0,
                                  param_dtype=torch.float32)
    np.testing.assert_allclose(p["w"].numpy(), target.numpy(), atol=0.05)


def test_grad_clip_bounds_the_first_step():
    params = {"w": torch.ones(4)}
    state = T.adamw_init(params)
    p1, _ = T.adamw_update({"w": torch.full((4,), 1e6)}, state, 1e-3,
                           max_norm=1.0, param_dtype=torch.float32)
    # with clipping the first Adam step is bounded by ~lr
    assert float((p1["w"] - params["w"]).abs().max()) < 2e-3


def _tie_free(rng, n):
    g = rng.standard_normal(n).astype(np.float32)
    assert np.unique(np.abs(g)).size == n       # no ties in |g|
    return g


@pytest.mark.parametrize("shape,fraction", [((1000,), 0.1), ((16, 33), 0.05),
                                            ((4, 5, 6), 0.5), ((7,), 0.01)])
def test_compression_equals_the_reference(shape, fraction):
    g = _tie_free(np.random.default_rng(4), int(np.prod(shape))
                  ).reshape(shape)
    jcomp, jerr = J.compress_topk_int8(jnp.asarray(g), fraction)
    tcomp, terr = T.compress_topk_int8(torch.from_numpy(g), fraction)
    equal(jcomp.values_i8, tcomp.values_i8, what="int8 values")
    equal(jcomp.indices, tcomp.indices, what="indices")
    equal(jcomp.scale, tcomp.scale, what="scale")
    assert tuple(jcomp.shape) == tcomp.shape
    equal(jerr, terr, what="residual")
    equal(J.decompress_topk_int8(jcomp), T.decompress_topk_int8(tcomp),
          what="decompressed")
    k = max(1, int(g.size * fraction))
    assert compressed_bytes(tcomp) == 5 * k + 4
    recon = T.decompress_topk_int8(tcomp)
    np.testing.assert_allclose((recon + terr).numpy(), g, atol=1e-6)


def test_error_feedback_equals_the_reference():
    rng = np.random.default_rng(5)
    g = _tie_free(rng, 512)
    je, te = jnp.zeros(512, jnp.float32), torch.zeros(512)
    for _ in range(5):
        jout, je = J.error_feedback_update(jnp.asarray(g), je, 0.05)
        tout, te = T.error_feedback_update(torch.from_numpy(g), te, 0.05)
        close(jout, tout, rtol=1e-6, atol=1e-7, what="sent")
        close(je, te, rtol=1e-6, atol=1e-7, what="residual")


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_error_feedback_telescopes_exactly(seed):
    """tests/test_substrate.py's property: the sum of what was sent plus the
    final residual is n * g (nothing is lost, only delayed), and the
    residual stays bounded."""
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(256)
                         .astype(np.float32))
    err, acc = torch.zeros_like(g), torch.zeros_like(g)
    n = 25
    for _ in range(n):
        out, err = T.error_feedback_update(g, err, k_fraction=0.05)
        acc = acc + out
    np.testing.assert_allclose((acc + err).numpy(), (n * g).numpy(),
                               atol=5e-4 * n)
    assert float(err.abs().max()) < 30 * float(g.abs().max())
