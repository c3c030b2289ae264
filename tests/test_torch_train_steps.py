"""The port's train step (repro_torch.parallel.steps) against the JAX
package's: six steps from a JAX-initialised state carried across
(``convert.train_state_from_numpy``) on the same synthetic batches, with
microbatch accumulation and with error-feedback compression, and a
checkpoint that one package writes mid-run and the other resumes.

Tolerances.  Losses at 1e-5 relative.  Params: Adam's step is
lr * m̂/(√v̂ + ε), and on the first steps a near-zero gradient that
rounds differently in the two packages moves m̂/(√v̂ + ε) by up to 2, a
full ±lr; elsewhere the step moves by about the gradient's relative
rounding.  So params are held at 1e-5 relative plus 1% of the sum of the
lrs taken (about 1e-5 absolute here); the runs below differ by 0.03-0.2%
of it.  Compression quantizes each kept gradient entry to 1/127 of the
tensor's largest, so a rounding that falls the other way, or a top-k
boundary that swaps two nearly equal entries, changes that entry's step
by up to 2 lr: there every param is held within 2 Σ lr, and all but 0.1%
of them within 0.1% of Σ lr.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint.store as jstore
import repro_torch.checkpoint.store as tstore
from repro.configs import get_config as jax_config
from repro.data import DataConfig, synthetic_batch
from repro.parallel import steps as jst
from repro_torch.configs import get_config as torch_config
from repro_torch.convert import train_state_from_numpy
from repro_torch.parallel import steps as tst
from repro_torch.tree import leaves
from torch_parity import close

torch.set_num_threads(1)
LOSS_RTOL = 1e-5


def _configs(arch, jax_impl="chunked", torch_impl="chunked"):
    return (jax_config(arch).reduced().replace(dtype="float32",
                                               attn_impl=jax_impl),
            torch_config(arch).reduced().replace(dtype="float32",
                                                 attn_impl=torch_impl))


def _batches(vocab, n=6, batch=2, accum=1):
    dc = DataConfig(seq_len=32, global_batch=batch, vocab=vocab)
    out = []
    for s in range(n):
        b = synthetic_batch(dc, s)
        if accum > 1:
            b = {k: v.reshape(accum, batch // accum, -1)
                 for k, v in b.items()}
        out.append(b)
    return out


def _run_jax(step, state, batches):
    losses, lrs = [], []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        lrs.append(float(m["lr"]))
    return state, losses, lrs


def _run_torch(step, state, batches):
    losses = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in b.items()})
        losses.append(float(m["loss"]))
    return state, losses


def _params_close(jparams, tparams, lr_sum, what):
    for j, t in zip(jax.tree_util.tree_leaves(jparams), leaves(tparams),
                    strict=True):
        close(j, t, rtol=1e-5, atol=1e-2 * lr_sum, what=what)


def _both(arch, jax_impl="chunked", torch_impl="chunked", accum=1,
          compress=None):
    """Six steps of each package from the JAX package's initial state."""
    jc, tc = _configs(arch, jax_impl, torch_impl)
    kw = dict(total_steps=6, warmup=2, accum=accum,
              compress_fraction=compress)
    js = jst.init_train_state(jc, jax.random.PRNGKey(0),
                              compress=compress is not None)
    ts = train_state_from_numpy(jax.tree_util.tree_map(np.asarray, js),
                                "cpu")
    batches = _batches(jc.vocab, batch=2 * accum, accum=accum)
    js, jl, lrs = _run_jax(jax.jit(jst.make_train_step(jc, **kw)), js,
                           batches)
    ts, tl = _run_torch(tst.make_train_step(tc, **kw), ts, batches)
    close(jl, tl, rtol=LOSS_RTOL, what="losses")
    assert all(np.isfinite(tl))
    return js, ts, sum(lrs)


@pytest.mark.parametrize("arch,jax_impl,torch_impl", [
    ("glm4_9b", "pallas", "kernel"), ("deepseek_moe_16b", "chunked",
                                      "chunked"),
    ("zamba2_7b", "chunked", "chunked"), ("xlstm_125m", "chunked",
                                          "chunked")])
def test_six_train_steps_match_jax(arch, jax_impl, torch_impl):
    js, ts, lr_sum = _both(arch, jax_impl, torch_impl)
    assert int(ts.opt.step) == 6
    _params_close(js.params, ts.params, lr_sum, f"{arch} params")
    _params_close(js.opt.master, ts.opt.master, lr_sum, f"{arch} masters")


def test_accumulated_microbatches_match_jax():
    js, ts, lr_sum = _both("glm4_9b", accum=2)
    _params_close(js.params, ts.params, lr_sum, "params, accum 2")


def test_compressed_steps_match_jax():
    js, ts, lr_sum = _both("glm4_9b", compress=0.1)
    assert ts.ef_err is not None
    off = total = 0
    for j, t in zip(jax.tree_util.tree_leaves(js.params), leaves(ts.params),
                    strict=True):
        d = np.abs(np.asarray(j) - t.numpy())
        assert d.max() <= 2 * lr_sum
        off += int((d > 1e-3 * lr_sum).sum())
        total += d.size
    assert off <= 1e-3 * total, f"{off} of {total} params off"


def test_checkpoints_resume_across_packages(tmp_path):
    """JAX trains 3 steps and saves; the port restores and trains 3 more,
    ending where JAX's 6 straight end.  The reverse: the port's 3 steps,
    saved, resume in JAX and end where the port's 6 straight end."""
    jc, tc = _configs("glm4_9b")
    kw = dict(total_steps=6, warmup=2)
    jstep = jax.jit(jst.make_train_step(jc, **kw))
    tstep = tst.make_train_step(tc, **kw)
    batches = _batches(jc.vocab)
    j0 = jst.init_train_state(jc, jax.random.PRNGKey(0))
    like = train_state_from_numpy(jax.tree_util.tree_map(np.asarray, j0),
                                  "cpu")
    jhalf, jl1, lrs1 = _run_jax(jstep, j0, batches[:3])
    jstore.save(tmp_path / "jax", 3, jhalf)
    jfull, jl2, lrs2 = _run_jax(jstep, jhalf, batches[3:])
    lr_sum = sum(lrs1 + lrs2)

    resumed = tstore.restore(tmp_path / "jax", 3,
                             tstore.tree_map(torch.zeros_like, like))
    assert int(resumed.opt.step) == 3
    resumed, tl2 = _run_torch(tstep, resumed, batches[3:])
    close(jl2, tl2, rtol=LOSS_RTOL, what="losses after the resume")
    _params_close(jfull.params, resumed.params, lr_sum, "resumed params")

    t0 = tstore.tree_map(torch.clone, like)
    thalf, tl1 = _run_torch(tstep, t0, batches[:3])
    tstore.save(tmp_path / "torch", 3, thalf)
    tfull, tl2 = _run_torch(tstep, thalf, batches[3:])
    back = jstore.restore(tmp_path / "torch", 3, j0)
    back, jl2b, _ = _run_jax(jstep, back, batches[3:])
    close(tl2, jl2b, rtol=LOSS_RTOL, what="losses after the JAX resume")
    _params_close(back.params, tfull.params, lr_sum, "JAX-resumed params")


def test_resume_in_the_port_is_exact(tmp_path):
    """tests/test_substrate.py's property through the port: 6 steps
    straight equal 3, save, restore, 3, at 1e-6; the step updates the
    state in place and returns it."""
    _, tc = _configs("xlstm_125m")
    step = tst.make_train_step(tc, total_steps=6)
    batches = _batches(tc.vocab)

    def fresh():
        return tst.init_train_state(tc, torch.Generator().manual_seed(0),
                                    "cpu")
    s0 = fresh()
    straight, _ = _run_torch(step, s0, batches)
    assert leaves(straight.params)[0] is leaves(s0.params)[0]
    half, _ = _run_torch(step, fresh(), batches[:3])
    tstore.save(tmp_path, 3, half)
    restored = tstore.restore(tmp_path, 3, fresh())
    resumed, _ = _run_torch(step, restored, batches[3:])
    for a, b in zip(leaves(straight.params), leaves(resumed.params),
                    strict=True):
        close(a, b, rtol=1e-6, atol=1e-6)


def test_init_train_state_layout():
    """Params in the config's dtype, fp32 masters that are copies, zero
    moments, zero error-feedback residuals under compression; the spec
    tree has the same layout."""
    _, tc = _configs("glm4_9b")
    cfg = tc.replace(dtype="bfloat16")
    state = tst.init_train_state(cfg, torch.Generator().manual_seed(1),
                                 "cpu", compress=True)
    spec = tst.train_state_spec(cfg, compress=True)
    assert tstore._flatten(state)[1] == tstore._flatten(spec)[1]
    for p, m, e in zip(leaves(state.params), leaves(state.opt.master),
                       leaves(state.ef_err), strict=True):
        assert p.dtype == torch.bfloat16 and m.dtype == torch.float32
        assert torch.equal(p, m.to(torch.bfloat16))
        assert e.dtype == torch.float32 and not e.any()
    assert tst.init_train_state(tc, torch.Generator(), "cpu").ef_err is None
