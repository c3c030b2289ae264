"""Programs of the port's mesh layer, run on gloo ranks on the CPU.

  python tests/torch_mesh_programs.py <program> <world> <dir>

starts ``world`` processes (``torch.multiprocessing.spawn``) at a low
CPU priority (nice 15), each joins
a gloo process group through the file store ``<dir>/store`` with a 60 s
timeout, and runs ``<program>(rank, dir)``.  Inputs the test wrote are
read from ``<dir>``, and rank 0 writes its results to ``<dir>/out.npz``
(and ``<dir>/out.json``).  The programs import torch and the port only.
"""
import datetime
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

from repro_torch.analysis.precision import Float64, double  # noqa: E402


def _mesh(shape, axes):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, axes, device="cpu")


def _save(d, arrays=None, info=None):
    if dist.get_rank() == 0:
        if arrays is not None:
            np.savez(Path(d) / "out.npz", **arrays)
        if info is not None:
            (Path(d) / "out.json").write_text(json.dumps(info))


def flash_decode(rank, d):
    """md_programs.flash_decode_sm's inputs on an (8,) "model" mesh."""
    from repro_torch.parallel.collectives import flash_decode_shardmap
    mesh = _mesh((8,), ("model",))
    rng = np.random.default_rng(1)
    b, h, t, dh = 2, 4, 64, 16
    q = torch.as_tensor(rng.standard_normal((b, h, dh)), dtype=torch.float32)
    k = torch.as_tensor(rng.standard_normal((b, t, h, dh)),
                        dtype=torch.float32)
    v = torch.as_tensor(rng.standard_normal((b, t, h, dh)),
                        dtype=torch.float32)
    blk = t // 8
    sl = slice(rank * blk, (rank + 1) * blk)
    out = flash_decode_shardmap(mesh, "model")(q, k[:, sl], v[:, sl])
    outs = [torch.empty_like(out) for _ in range(8)]
    dist.all_gather(outs, out)
    _save(d, {"out": out.numpy(), "spread": max(
        (o - out).abs().max().item() for o in outs)})


def compressed_psum(rank, d):
    """md_programs.compressed_psum's inputs on a (2, 4) pod x data mesh."""
    from repro_torch.parallel.collectives import compressed_psum as cp
    mesh = _mesh((2, 4), ("pod", "data"))
    rng = np.random.default_rng(2)
    g = torch.as_tensor(rng.standard_normal((2, 4, 64)), dtype=torch.float32)
    p, i = mesh.get_coordinate()
    reducer = cp(mesh, pod_axis="pod", inner_axes=("data",), k_fraction=1.0)
    out, err = reducer({"g": g[p, i]}, {"g": torch.zeros(64)})
    _save(d, {"out": out["g"].numpy(), "err": err["g"].numpy()})


def pipeline(rank, d):
    """md_programs.pipeline's inputs on a (4,) "stage" mesh."""
    from repro_torch.parallel.pipeline import mlp_stage, pipeline_forward
    mesh = _mesh((4,), ("stage",))
    rng = np.random.default_rng(0)
    s, m, mb, dm = 4, 6, 8, 16
    w1 = torch.as_tensor(rng.standard_normal((s, dm, dm)) * 0.3,
                         dtype=torch.float32)
    w2 = torch.as_tensor(rng.standard_normal((s, dm, dm)) * 0.3,
                         dtype=torch.float32)
    xs = torch.as_tensor(rng.standard_normal((m, mb, dm)),
                         dtype=torch.float32)
    c = mesh.get_coordinate()[0]
    run = pipeline_forward(mlp_stage, mesh, "stage")
    got = run({"w1": w1[c:c + 1], "w2": w2[c:c + 1]}, xs)
    outs = [torch.empty_like(got) for _ in range(4)]
    dist.all_gather(outs, got)
    _save(d, {"out": got.numpy(), "spread": max(
        (o - got).abs().max().item() for o in outs)})


def seq_collectives(rank, d):
    """``tensor.gather_seq``, ``scatter_seq``, ``split_seq`` and
    ``last_row`` on a (1, 2) ("data", "model") mesh, with rank r's rows
    and output gradients drawn from seed r: rank 0 writes each result
    and each input's gradient (``<name>`` and ``<name>_grad``) beside
    every rank's draws (``x<r>``, ``whole<r>``, ``g_rows<r>``,
    ``g_whole<r>``)."""
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import tensor
    mesh = _mesh((1, 2), ("data", "model"))
    tp = tensor.TensorParallel(mesh, "model", rank, 2, (),
                               shd.default_rules()).for_stream((2, 6, 3))
    assert tp.seq and tp.size == 2 and tp.index == rank

    def draw(r):
        rng = np.random.default_rng(r)
        return {k: torch.as_tensor(rng.standard_normal(s))
                for k, s in (("x", (2, 3, 3)), ("whole", (2, 6, 3)),
                             ("g_rows", (2, 3, 3)), ("g_whole", (2, 6, 3)))}
    mine, out = draw(rank), {}
    for name, fn, arg, seed in (
            ("gather", tensor.gather_seq, "x", "g_whole"),
            ("gather_copies", lambda x, tp: tensor.gather_seq(
                x, tp, copies=True), "x", "g_whole"),
            ("scatter", tensor.scatter_seq, "whole", "g_rows"),
            ("split", tensor.split_seq, "whole", "g_rows")):
        x = mine[arg].clone().requires_grad_()
        y = fn(x, tp)
        y.backward(mine[seed])
        out[name], out[name + "_grad"] = y.detach(), x.grad
    out["last_row"] = tensor.last_row(mine["x"], tp)
    every = {}
    for r in range(2):
        for k, v in draw(r).items():
            every[f"{k}{r}"] = v
    _save(d, {k: v.numpy() for k, v in {**out, **every}.items()})


def _cfg(info):
    """The reduced config of ``info.json``'s arch in fp32 at its
    ``act_shard``, with the fields its ``replace`` names (and ``remat``)
    set."""
    from repro_torch.configs import get_config
    over = dict(info.get("replace", {}))
    if "remat" in info:
        over["remat"] = info["remat"]
    return get_config(info["arch"]).reduced().replace(
        dtype="float32", act_shard=info["act_shard"], **over)


def _state_from(d, cfg):
    """The whole training state whose leaves (flatten order) the test
    wrote to ``d/state.npz``."""
    from repro_torch.parallel import steps as st
    from repro_torch.tree import leaves, unflatten
    data = np.load(Path(d) / "state.npz")
    like = st.abstract_state(cfg)
    return unflatten(like, [torch.from_numpy(data[f"a{i}"])
                            for i in range(len(leaves(like)))])


def _counts(rep):
    return {"flops": rep.flops, "collective_bytes": rep.collective_bytes,
            "collective_counts": rep.collective_counts}


class _BlockSpy:
    """Wraps the model entry points that a mesh step calls
    (``transformer.lm_loss``, ``lm_prefill``, ``lm_decode``) and checks
    the parameters they are given: under tensor parallelism every leaf
    whose spec splits it over "model" is this device's block of it, and
    every other leaf whole; without it, every leaf whole.  A stacked leaf
    (leading "layers" dimensions) comes as a ``sharding.Stacked`` whose
    shape says so, and whose layers are this device's blocks, each its
    own tensor: it is gathered a layer at a time.  ``split`` counts the
    split leaves of the last call; ``rows`` is the length of the residual
    stream the trunk (``transformer._trunk``) last ran on: this device's
    rows where the stream is split; ``moe`` the shapes a MoE layer
    (``transformer.moe_apply``) last got: its router, its routed experts
    and its input stream ``x``.  The leaves a tensor-parallel step gathers
    whole over "model" as well (``tensor.keeps``: Mamba2's in_proj and
    conv) come whole.  ``heads`` collects, of every call, the heads of
    the SSD (``ssm.ssd_chunked``, ``ops.mamba_scan``, ``ssm.ssd_step``:
    "ssd") and the query and KV heads of attention
    (``attention.attend_chunked``, ``ops.flash_decode``: "attn")."""

    def __init__(self, lay):
        from repro_torch.kernels import ops
        from repro_torch.models import attention, ssm, transformer
        from repro_torch.parallel import tensor
        from repro_torch.tree import leaves
        self.split, self.rows, self.moe = 0, None, None
        self.heads = {"ssd": set(), "attn": set()}
        lays, keeps = leaves(lay), tensor.keeps(lay)
        trunk, moe_apply = transformer._trunk, transformer.moe_apply

        def recorder(mod, name, kind, heads):
            fn = getattr(mod, name)

            def recorded(*a, **k):
                self.heads[kind].add(heads(*a))
                return fn(*a, **k)
            setattr(mod, name, recorded)
        recorder(ssm, "ssd_chunked", "ssd", lambda xh, *a: xh.shape[2])
        recorder(ops, "mamba_scan", "ssd", lambda xh, *a: xh.shape[2])
        recorder(ssm, "ssd_step", "ssd", lambda st, xh, *a: xh.shape[1])
        recorder(attention, "attend_chunked", "attn",
                 lambda q, k, *a: (q.shape[2], k.shape[2]))
        recorder(ops, "flash_decode", "attn",
                 lambda q, k, *a: (q.shape[2], k.shape[2]))

        def rows(cfg, params, x, *a, **k):
            self.rows = int(x.shape[1])
            return trunk(cfg, params, x, *a, **k)
        transformer._trunk = rows

        def moe(params, x, *a, **k):
            self.moe = {n: list(params[n].shape) for n in (
                "router", "w_gate", "w_up", "w_down")}
            self.moe["x"] = list(x.shape)
            return moe_apply(params, x, *a, **k)
        transformer.moe_apply = moe

        def check(params):
            from repro_torch.parallel import sharding as shd
            tp = tensor.active()
            self.split = 0
            for x, l, keep in zip(leaves(params), lays, keeps,
                                  strict=True):
                if l.stacked:
                    assert isinstance(x, shd.Stacked), (l.axes, type(x))
                    block = l.local_shape[l.stacked:]
                    assert all(tuple(t.shape) == block for t in x.parts), \
                        (l.axes, block)
                want = list(l.shape)
                for dim, e in enumerate(l.spec):
                    if tp is not None and e == tp.axis and e in keep:
                        want[dim] //= tp.size
                        self.split += 1
                assert tuple(x.shape) == tuple(want), (l.axes, x.shape, want)

        for name in ("lm_loss", "lm_prefill", "lm_decode"):
            fn = getattr(transformer, name)

            def spied(cfg, params, *a, _fn=fn, **k):
                check(params)
                return _fn(cfg, params, *a, **k)
            setattr(transformer, name, spied)


class _GradSpy:
    """Wraps the AdamW update that the mesh train step calls
    (``steps.adamw_update``) and keeps the gradients of its first call
    since :meth:`reset`: this device's blocks, summed over the mesh."""

    def __init__(self):
        from repro_torch.parallel import steps as st
        from repro_torch.tree import leaves
        self.grads = None
        update = st.adamw_update

        def spied(grads, *a, **k):
            if self.grads is None:
                self.grads = [g.clone() for g in leaves(grads)]
            return update(grads, *a, **k)
        st.adamw_update = spied

    def reset(self):
        self.grads = None


def sharded_train(rank, d):
    """The sharded train step from the state and batches in ``d``, on the
    mesh ``info.json`` names; rank 0 writes the gathered state after each
    step (``a0``, ``a1``, ...), the gathered gradients of the first step
    (``g0``, ...), the losses, the first step's op counts, the leaves the
    layer code got as their "model" blocks and the rows of the residual
    stream a device held.  With ``float64`` in ``info.json`` the same
    steps run again from the same state under :class:`Float64`, and rank
    0 also writes that state (``d0``, ``d1``, ...), its first gradients
    (``h0``, ...) and its losses."""
    from repro_torch.analysis import hlo
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import steps as st
    from repro_torch.tree import leaves
    info = json.loads((Path(d) / "info.json").read_text())
    accum = info.get("accum", 1)
    cfg = _cfg(info)
    mesh = _mesh(info["mesh"], ("data", "model"))
    rules = shd.default_rules(act_shard=info["act_shard"])
    lay = st.state_layouts(cfg, mesh, rules)
    spy, grads = _BlockSpy(lay.params), _GradSpy()
    batches = np.load(Path(d) / "batches.npz")
    batches = [{k.split("/")[1]: batches[k] for k in batches.files
                if k.startswith(f"{i}/")} for i in range(info["steps"])]

    def whole_grads():
        return [l.gather(g).numpy() for g, l in
                zip(grads.grads, leaves(lay.params), strict=True)]

    def run(state, batches, count):
        grads.reset()
        step = st.make_train_step(
            cfg, total_steps=info["total_steps"], warmup=info["warmup"],
            accum=accum, mesh=mesh, rules=rules,
            global_batch=int(np.prod(batches[0]["labels"].shape[:-1])))
        losses, counts = [], None
        for i, batch in enumerate(batches):
            batch = st.batch_rows({k: torch.as_tensor(v)
                                   for k, v in batch.items()},
                                  mesh, rules, accum)
            if i == 0 and count:
                (state, m), rep = hlo.count(step, state, batch)
                counts = _counts(rep)
            else:
                state, m = step(state, batch)
            losses.append(float(m["loss"]))
        return state, losses, counts

    state, losses, counts = run(
        st.shard_state(_state_from(d, cfg), lay), batches, True)
    out = {"losses": losses, "counts": counts, "split_leaves": spy.split,
           "stream_rows": spy.rows, "moe": spy.moe,
           "heads": _heads_seen(spy)}
    first_grads = whole_grads()
    # every block is the layout's slice of the gathered state
    whole = st.gather_state(state, lay)
    worst = 0.0
    for x, w, l in zip(leaves(state), leaves(whole), leaves(lay),
                       strict=True):
        worst = max(worst, (l.shard(w) - x).abs().max().item())
    arrays = {f"a{i}": x.numpy() for i, x in enumerate(leaves(whole))}
    arrays["block_diff"] = np.float64(worst)
    arrays.update({f"g{i}": g for i, g in enumerate(first_grads)})
    if info.get("float64"):
        with Float64():
            state, out["losses64"], _ = run(
                st.shard_state(double(_state_from(d, cfg)), lay),
                double(batches), False)
            whole = st.gather_state(state, lay)
            arrays.update({f"h{i}": g for i, g in enumerate(whole_grads())})
        arrays.update({f"d{i}": x.numpy()
                       for i, x in enumerate(leaves(whole))})
    _save(d, arrays, out)


def sharded_prefill(rank, d):
    """The mesh prefill step from the parameters in ``d`` on this rank's
    rows of ``d/tokens.npy``; rank 0 writes the gathered last logits, the
    step's op counts and the leaves the layer code got as their "model"
    blocks.  With ``ticks`` in ``info.json``, that many greedy serve
    steps follow from the prefill's cache, and rank 0 also writes the
    gathered tokens (the prefill's argmax first) and the first tick's op
    counts."""
    from repro_torch.analysis import hlo
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import steps as st
    info = json.loads((Path(d) / "info.json").read_text())
    cfg = _cfg(info)
    mesh = _mesh(info["mesh"], ("data", "model"))
    rules = shd.default_rules(act_shard=info["act_shard"])
    lay = st.state_layouts(cfg, mesh, rules)
    spy = _BlockSpy(lay.params)
    params = st.shard_state(_state_from(d, cfg), lay).params
    tokens = torch.from_numpy(np.load(Path(d) / "tokens.npy"))
    rows, s = tokens.shape
    ticks = info.get("ticks", 0)
    step = st.make_prefill_step(cfg, s + ticks, mesh, rules, rows)
    batch = st.batch_rows({"tokens": tokens}, mesh, rules)
    (logits, cache), rep = hlo.count(step, params, batch)
    whole = shd.gather(logits, ("batch", None), mesh, rules,
                       (rows, logits.shape[-1]))
    out = {"counts": _counts(rep), "split_leaves": spy.split,
           "stream_rows": spy.rows, "moe": spy.moe,
           "heads": _heads_seen(spy)}
    arrays = {"logits": whole.numpy()}
    if ticks:
        serve = st.make_serve_step(cfg, mesh, rules, rows)
        tok = {"token": torch.argmax(logits, -1).to(torch.int32)[:, None],
               "kv_len": torch.full((logits.shape[0],), s,
                                    dtype=torch.int32)}
        got = [tok["token"]]
        for i in range(ticks):
            if i == 0:
                (tok, cache), rep = hlo.count(serve, params, tok, cache)
                out["tick_counts"] = _counts(rep)
                out["tick_moe"] = spy.moe
            else:
                tok, cache = serve(params, tok, cache)
            got.append(tok["token"])
        arrays["tokens"] = shd.gather(torch.cat(got, 1), ("batch", None),
                                      mesh, rules,
                                      (rows, ticks + 1)).numpy()
        out["cache_shape"] = _shapes(cache.get("layers", cache))
        out["tick_heads"] = _heads_seen(spy)
    _save(d, arrays, out)


def _shapes(tree):
    """Each leaf's shape (a list) in a nest of dicts."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return list(tree.shape)


def _heads_seen(spy):
    """The heads ``spy`` collected (sorted lists), and a fresh start."""
    got = {k: sorted(list(h) if isinstance(h, tuple) else h for h in v)
           for k, v in spy.heads.items()}
    for v in spy.heads.values():
        v.clear()
    return got


def elastic(rank, d):
    """A state sharded on (4, 2) saved whole; restored onto (2, 4) from
    that checkpoint and from the JAX package's one in ``d/jax``; each
    device's blocks held against the layout's slice of the whole state."""
    from repro_torch.checkpoint import store
    from repro_torch.configs import get_config
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import steps as st
    from repro_torch.tree import leaves
    cfg = get_config("glm4_9b").reduced().replace(dtype="float32")
    rules = shd.default_rules()
    whole = _state_from(d, cfg)
    mesh_a = _mesh((4, 2), ("data", "model"))
    lay_a = st.state_layouts(cfg, mesh_a, rules)
    store.save(Path(d) / "port", 1, st.shard_state(whole, lay_a),
               shardings=lay_a)
    from torch.distributed.device_mesh import init_device_mesh
    mesh_b = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data",
                                                             "model"))
    lay_b = st.state_layouts(cfg, mesh_b, rules)
    like = st.abstract_state(cfg)
    from torch.distributed.tensor import distribute_tensor
    worst, moved = 0.0, 0
    for w, lb in zip(leaves(whole), leaves(lay_b), strict=True):
        dt = distribute_tensor(w, mesh_b, lb.placements).to_local()
        worst = max(worst, (dt - lb.shard(w)).abs().max().item())
    for src in ("port", "jax"):
        got = store.restore(Path(d) / src, 1, like, shardings=lay_b)
        for x, w, la, lb in zip(leaves(got), leaves(whole), leaves(lay_a),
                                leaves(lay_b), strict=True):
            want = lb.shard(w)
            assert x.shape == want.shape == lb.local_shape
            worst = max(worst, (x - want).abs().max().item())
            moved += la.spec != lb.spec or la.local_shape != lb.local_shape
    worsts = [None] * dist.get_world_size()
    dist.all_gather_object(worsts, (worst, moved))
    _save(d, info={"worst": max(w for w, _ in worsts),
                   "moved": min(m for _, m in worsts)})


def launcher(rank, d):
    """launch.train.main on every rank (WORLD_SIZE set), as torchrun runs
    it; rank 0 writes the jsonl log."""
    from repro_torch.launch import train
    argv = json.loads((Path(d) / "argv.json").read_text())
    rc = train.main(argv)
    assert rc == 0, rc


def _rank(rank, prog, world, d):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        globals()[prog](rank, d)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    prog, world, d = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    # the ranks yield the CPU to the tests running beside them (some of
    # which time themselves)
    os.nice(15)
    torch.multiprocessing.spawn(_rank, args=(prog, world, d), nprocs=world)
    print("DONE", prog)
