"""The port's training forward (repro_torch: ``lm_loss``, its gradients, the
remat policies, the plain route) and launcher against the JAX package's.

Weights come from the JAX package's ``init_params`` and are converted key
for key.  ``lm_loss`` and its gradients are held against
``jax.value_and_grad`` of JAX's ``lm_loss`` at atol = rtol = 1e-4, as the
model tests are (tests/test_torch_model.py), with the JAX
``attn_impl="pallas"`` path (Pallas in interpret mode) against the port's
``"kernel"`` and ``"chunked"`` against ``"chunked"``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import InputShape as JShape
from repro.models import api as japi
from repro.models import common as jcommon
from repro.models import transformer as jtf
from repro.parallel import steps as jst
from repro_torch.configs import get_config as torch_config
from repro_torch.configs.base import InputShape
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import api as tapi
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttf
from repro_torch.parallel import steps as tst
from repro_torch.tree import leaves
from torch_parity import close, equal

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-4)
FAMILIES = ["glm4_9b", "deepseek_moe_16b", "zamba2_7b", "xlstm_125m",
            "minicpm3_4b", "deepseek_v2_236b"]
# the four wrappers the plain route must not reach, and flash decode
OTHER_OPS = ("fused_rmsnorm", "moe_gmm", "mamba_scan", "slstm_seq",
             "flash_decode")


def _models(arch, jax_impl="chunked", torch_impl="chunked", **overrides):
    jc = jax_config(arch).reduced().replace(dtype="float32",
                                            attn_impl=jax_impl, **overrides)
    tc = torch_config(arch).reduced().replace(dtype="float32",
                                              attn_impl=torch_impl,
                                              **overrides)
    jp = jcommon.init_params(japi.param_spec(jc), jax.random.PRNGKey(0))
    return jc, jp, tc, params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jp), "cpu")


def _batch(vocab, b=2, s=32, seed=0):
    """Tokens and next-token labels; three labels of row 0 are -1
    (ignored)."""
    raw = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    batch = {"tokens": raw[:, :-1].astype(np.int32),
             "labels": raw[:, 1:].astype(np.int32)}
    batch["labels"][0, :3] = -1
    return batch


def _torch_loss_and_grads(cfg, params, batch):
    loss, grads = tst.loss_and_grads(
        lambda p, b: ttf.lm_loss(cfg, p, b), params,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    return loss, leaves(grads)


@pytest.mark.parametrize("jax_impl,torch_impl", [("pallas", "kernel"),
                                                 ("chunked", "chunked")])
@pytest.mark.parametrize("arch", FAMILIES)
def test_lm_loss_and_gradients_match_jax(arch, jax_impl, torch_impl):
    jc, jp, tc, tp = _models(arch, jax_impl, torch_impl)
    batch = _batch(jc.vocab)
    jloss, jgrads = jax.value_and_grad(lambda p: jtf.lm_loss(
        jc, p, {k: jnp.asarray(v) for k, v in batch.items()}))(jp)
    tloss, tgrads = _torch_loss_and_grads(tc, tp, batch)
    close(jloss, tloss, **TOL, what="loss")
    jflat = jax.tree_util.tree_leaves(jgrads)
    assert len(jflat) == len(tgrads)
    for j, t in zip(jflat, tgrads):
        close(j, t, **TOL, what=f"{arch} gradient")


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(-2, 50, (3, 7)).astype(np.int32)
    mask = rng.random((3, 7)) < 0.7
    for m in (None, mask):
        jl, jg = jax.value_and_grad(lambda x: jcommon.cross_entropy(
            x, jnp.asarray(labels), None if m is None else jnp.asarray(m)))(
                jnp.asarray(logits))
        x = torch.from_numpy(logits).requires_grad_()
        tl = tcommon.cross_entropy(x, torch.from_numpy(labels),
                                   None if m is None else torch.from_numpy(m))
        (tg,) = torch.autograd.grad(tl, [x])
        close(jl, tl.detach(), rtol=1e-6, what="cross-entropy")
        close(jg, tg, rtol=1e-6, atol=1e-9, what="its gradient")
    none = tcommon.cross_entropy(torch.zeros(2, 5), torch.full((2,), -1))
    assert float(none) == 0.0          # no valid label: 0 / max(0, 1)


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_policies_give_the_same_loss_and_gradients(arch):
    """"full" (checkpoint a layer), "dots" (save its matmul outputs) and
    "none" compute one function: the same bits on the CPU."""
    _, _, tc, tp = _models(arch)
    batch = _batch(tc.vocab, seed=4)
    want_loss, want = _torch_loss_and_grads(tc.replace(remat="none"), tp,
                                            batch)
    for remat in ("full", "dots"):
        loss, grads = _torch_loss_and_grads(tc.replace(remat=remat), tp,
                                            batch)
        equal(want_loss, loss, what=f"{remat} loss")
        for w, g in zip(want, grads):
            equal(w, g, what=f"{remat} gradient")
    with pytest.raises(ValueError, match="remat"):
        _torch_loss_and_grads(tc.replace(remat="some"), tp, batch)


class _Calls:
    """Counts the calls of ``ops``' wrappers; the five in OTHER_OPS raise
    when ``forbid`` is set."""

    def __init__(self, monkeypatch, forbid: bool):
        self.n = {}
        for name in OTHER_OPS + ("flash_attention",):
            self._wrap(monkeypatch, name, forbid and name in OTHER_OPS)

    def _wrap(self, monkeypatch, name, forbidden):
        real = getattr(ops, name)

        def call(*args, **kwargs):
            if forbidden:
                raise AssertionError(f"the plain route reached ops.{name}")
            self.n[name] = self.n.get(name, 0) + 1
            return real(*args, **kwargs)
        monkeypatch.setattr(ops, name, call)


@pytest.mark.parametrize("arch", FAMILIES)
def test_plain_route_reaches_no_other_wrapper(arch, monkeypatch):
    """Under grad on the CPU, lm_loss and its backward reach none of the
    five non-attention wrappers; attention goes through
    ``ops.flash_attention`` under "kernel" (forward and remat recompute of
    each remat'd block).  The serving forward reaches the wrappers."""
    _, _, tc, tp = _models(arch, torch_impl="kernel")
    batch = _batch(tc.vocab)
    calls = _Calls(monkeypatch, forbid=True)
    _torch_loss_and_grads(tc, tp, batch)
    if tc.family == "hybrid":   # its shared attention is not remat'd
        attn = tc.n_layers // tc.attn_every
    else:
        attn = 0 if tc.family == "ssm" else 2 * tc.n_layers
    assert calls.n.get("flash_attention", 0) == attn
    assert set(calls.n) <= {"flash_attention"}
    monkeypatch.undo()
    served = _Calls(monkeypatch, forbid=False)
    with torch.no_grad():
        ttf.lm_forward(tc, tp, torch.from_numpy(batch["tokens"]))
    assert served.n["fused_rmsnorm"] > 0


def test_loss_fn_input_spec_and_batches_match_jax():
    jc, jp, tc, tp = _models("glm4_9b")
    for kind in ("train", "prefill", "decode"):
        jspec = japi.input_spec(jc, JShape("x", 32, 4, kind))
        tspec = tapi.input_spec(tc, InputShape("x", 32, 4, kind))
        assert list(jspec) == list(tspec)
        for k in jspec:
            assert (jspec[k].shape, jspec[k].axes) == \
                (tspec[k].shape, tspec[k].axes)
            assert tspec[k].dtype == torch.int32
        for accum in (1, 2):
            jb = jst.materialize_batch(jc, JShape("x", 32, 4, kind), seed=5,
                                       accum=accum)
            tb = tst.materialize_batch(tc, InputShape("x", 32, 4, kind),
                                       seed=5, accum=accum, device="cpu")
            assert list(jb) == list(tb)
            for k in jb:
                equal(np.asarray(jb[k]), tb[k], what=f"{kind} {k}")
    batch = tst.materialize_batch(tc, InputShape("x", 32, 2, "train"),
                                  seed=1, device="cpu")
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    close(japi.loss_fn(jc)(jp, jbatch), tapi.loss_fn(tc)(tp, batch), **TOL,
          what="loss_fn")
    close(japi.loss_fn(jc)(jp, jbatch), tst.make_eval_step(tc)(tp, batch),
          **TOL, what="eval step")
    # the encoder-decoder's loss_fn and the VLM's input_spec, which raised
    # before those families were ported, against the JAX package's
    for arch in ("whisper_medium", "llava_next_mistral_7b"):
        jc, jp, tc, tp = _models(arch)
        shape = ("x", 32, 2, "train")
        jspec, tspec = japi.input_spec(jc, JShape(*shape)), \
            tapi.input_spec(tc, InputShape(*shape))
        assert {k: (s.shape, s.axes) for k, s in jspec.items()} == \
            {k: (s.shape, s.axes) for k, s in tspec.items()}
        jb = jst.materialize_batch(jc, JShape(*shape), seed=2)
        tb = tst.materialize_batch(tc, InputShape(*shape), seed=2,
                                   device="cpu")
        close(japi.loss_fn(jc)(jp, jb), tapi.loss_fn(tc)(tp, tb), **TOL,
              what=f"{arch} loss_fn")


def test_launcher_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    """``launch.train.main`` on the reduced glm4_9b: a first call to step 6
    (checkpoints at 3 and 6), a second to step 9 resumes from 6; both
    return 0, and the log holds one line a step."""
    from repro_torch.launch import train
    args = ["--arch", "glm4_9b", "--smoke", "--device", "cpu", "--batch",
            "2", "--seq", "32", "--ckpt-dir", str(tmp_path / "ck"),
            "--ckpt-every", "3", "--log", str(tmp_path / "log.jsonl")]
    assert train.main(args + ["--steps", "6"]) == 0
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()
                  if p.name.startswith("step_")) == \
        ["step_00000003", "step_00000006"]
    assert train.main(args + ["--steps", "9"]) == 0
    out = capsys.readouterr().out
    assert f"[resume] restored step 6 from {tmp_path / 'ck'}" in out
    lines = (tmp_path / "log.jsonl").read_text().splitlines()
    assert len(lines) == 9 and '"step": 9' in lines[-1]
    assert (tmp_path / "ck" / "heartbeat").exists()


def test_launcher_async_checkpoint_holds_the_state_of_its_step(tmp_path):
    """The launcher updates its state in place while the step-3 checkpoint
    is written in the background; the checkpoint must hold the state of
    step 3, equal to a straight 3-step run's, and not that of a later
    step."""
    from repro_torch.checkpoint import store as tstore
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.launch import train
    ck = tmp_path / "ck"
    assert train.main(["--arch", "glm4_9b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--seq", "32", "--steps", "6",
                       "--ckpt-dir", str(ck), "--ckpt-every", "3"]) == 0

    cfg = torch_config("glm4_9b").reduced().replace(dtype="float32",
                                                    attn_impl="kernel")

    def fresh():
        return tst.init_train_state(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
    step = tst.make_train_step(cfg, base_lr=3e-4, warmup=1, total_steps=6)
    dc = DataConfig(seq_len=32, global_batch=2, vocab=cfg.vocab, seed=0)
    state = fresh()
    for i in range(3):
        state, _ = step(state, {k: torch.from_numpy(v) for k, v in
                                synthetic_batch(dc, i).items()})
    saved = tstore.restore(ck, 3, fresh())
    assert int(saved.opt.step) == 3
    for a, b in zip(leaves(state), leaves(saved), strict=True):
        equal(a, b)


def test_launcher_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="GPU"):
        train.main(["--smoke", "--steps", "1"])
