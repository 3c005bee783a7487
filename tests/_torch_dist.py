"""Multi-process legs of the port's multi-device tests: gloo ranks on the CPU.

:class:`Ranks` starts ``world`` processes of this file (``python
_torch_dist.py LEG RANK WORLD PORT OUT``), each of which initializes
``torch.distributed`` through ``parallel.initialize_distributed(device=
'cpu')`` from torchrun's variables, runs the leg function of that name on
its rank and saves what it returns to ``OUT/rank<r>.pt``; the results come
back as a list indexed by rank.  The ranks import torch and the port only
(no jax), with one thread each.  Inputs are drawn by numpy from fixed
seeds, so the test process can draw the same ones for the JAX package's
one-device reference.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class Ranks:
    """``world`` gloo ranks running ``leg``, started at construction (so the
    test process can compute its references meanwhile); :meth:`results`
    waits for them and returns what each saved, by rank."""

    def __init__(self, leg: str, world: int, out_dir: str, timeout: float = 240.0):
        self.leg, self.world, self.out_dir, self.timeout = leg, world, out_dir, timeout
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, HERE]),
                   OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        port = str(free_port())
        self.procs = [subprocess.Popen([sys.executable, __file__, leg, str(r), str(world),
                                        port, out_dir], env=env,
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                      for r in range(world)]
        self._results = None

    def results(self):
        if self._results is not None:
            return self._results
        import torch

        logs = []
        try:
            for p in self.procs:
                out, _ = p.communicate(timeout=self.timeout)
                logs.append(out.decode(errors="replace"))
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, p in enumerate(self.procs):
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} of leg {self.leg!r} exited {p.returncode}:\n"
                                   + logs[r][-6000:])
        self._results = [torch.load(os.path.join(self.out_dir, f"rank{r}.pt"),
                                    weights_only=False) for r in range(self.world)]
        return self._results


# ------------------------------------------------------------ shared draws

def mlp_batches(steps: int, rows: int = 16, features: int = 16, classes: int = 4,
                seed: int = 3):
    r = np.random.RandomState(seed)
    return [{"input": r.randn(rows, features).astype(np.float32),
             "label": r.randint(0, classes, rows).astype(np.int64)} for _ in range(steps)]


def image_batches(steps: int, rows: int = 8, hw: int = 8, seed: int = 4):
    """NHWC images (the JAX package's layout) and labels."""
    r = np.random.RandomState(seed)
    return [{"image": r.randn(rows, hw, hw, 3).astype(np.float32),
             "label": r.randint(0, 10, rows).astype(np.int64)} for _ in range(steps)]


def token_batches(steps: int, rows: int, t: int, vocab: int, seed: int):
    r = np.random.RandomState(seed)
    return [r.randint(0, vocab, size=(rows, t)).astype(np.int64) for _ in range(steps)]


def state_of(model):
    """The model's state dict as numpy arrays."""
    return {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}


def lm_loss(logits, batch):
    import torch.nn.functional as F

    v = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, v),
                           batch["label"][:, 1:].reshape(-1))


def mse_loss(out, batch):
    return ((out - batch["label"]) ** 2).mean()


# --------------------------------------------------------------------- legs

def _count_gathers():
    """Wrap ``torch.distributed.all_gather_into_tensor`` to record the dtype
    and shape of every gathered input (from here on)."""
    import torch.distributed as dist

    seen = []
    inner = getattr(dist.all_gather_into_tensor, "inner", dist.all_gather_into_tensor)

    def wrapped(out, src, *a, **kw):
        seen.append((str(src.dtype), tuple(src.shape), src.data_ptr()))
        return inner(out, src, *a, **kw)

    wrapped.inner = inner
    dist.all_gather_into_tensor = wrapped
    return seen


OBSERVERS = ("running_minmax", "minmax", "mse", "percentile", "histogram")
MLP_FEATURES = (32, 4)
MLP_STEPS, MLP_WINDOW = 4, 2


def mlp_qconfig(observer: str, default_qconfig, min_max_observer):
    """The MLPs' w8a8 config with ``observer`` ('running_minmax': the
    running min/max, ``MinMaxObserver()``), from either package's
    ``default_qconfig`` and ``MinMaxObserver``."""
    import dataclasses

    kind = "minmax" if observer == "running_minmax" else observer
    qc = default_qconfig(8, 8, init_batches=MLP_WINDOW, act_observer=kind)
    if observer == "running_minmax":
        qc = dataclasses.replace(qc, activation=dataclasses.replace(
            qc.activation, observer=min_max_observer()))
    return qc


def leg_observers(rank: int, world: int):
    return leg_parallel(rank, world, observers=True)


# the sequence-parallel LM legs: keyword arguments of QuantTransformerLM
SP_CASES = {"learned": {"pos_embedding": "learned"},
            "rope": {"pos_embedding": "rope"},
            "window": {"pos_embedding": "rope", "attn_window": 5}}


def leg_parallel(rank: int, world: int, observers: bool = False):
    import torch

    from jaxlsq_torch import _dist
    from jaxlsq_torch import models as pm
    from jaxlsq_torch.models import QuantMLP, QuantResNet, QuantTransformerLM
    from jaxlsq_torch.observers import MinMaxObserver
    from jaxlsq_torch.parallel import (make_eval_step, make_mesh, make_train_step,
                                       shard_batch)

    def qconfig(obs):
        return mlp_qconfig(obs, pm.default_qconfig, MinMaxObserver)

    out = {}
    mesh = make_mesh()
    out["mesh_shapes"] = [tuple(mesh.shape), tuple(make_mesh(model=2).shape)]
    errs = []
    for kw in ({"data": 5, "model": 3}, {"model": 3}):
        try:
            make_mesh(**kw)
            errs.append(None)
        except ValueError as e:
            errs.append(str(e))
    out["mesh_errors"] = errs

    def run_mlp(qc, jit, accum=1, count=False):
        model = QuantMLP(16, MLP_FEATURES, qc, device="cpu", seed=1)
        opt = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
        step = make_train_step(model, opt, jit=jit, mesh=mesh, accum_steps=accum)
        losses, counts = [], []
        for b in mlp_batches(MLP_STEPS):
            _dist.COUNTS.clear()
            losses.append(float(step(shard_batch({k: torch.from_numpy(v) for k, v in
                                                  b.items()}, mesh))["loss"]))
            counts.append(dict(_dist.COUNTS))
        return {"losses": losses, "state": state_of(model), "counts": counts}

    if observers:
        for obs in OBSERVERS:
            for jit in (False, True):
                out[("mlp", obs, jit)] = run_mlp(qconfig(obs), jit)
        return out
    out[("accum", False)] = run_mlp(qconfig("minmax"), False, accum=2)
    out[("accum", True)] = run_mlp(qconfig("minmax"), True, accum=2)

    # eval: this rank's rows of the global batch, an observer still open
    model = QuantMLP(16, MLP_FEATURES, qconfig("minmax"), device="cpu", seed=1)
    b = mlp_batches(1, seed=9)[0]
    out["eval"] = make_eval_step(model, mesh=mesh)(
        shard_batch({k: torch.from_numpy(v) for k, v in b.items()}, mesh)).numpy()

    # BatchNorm: a narrow resnet, both regimes
    qc = pm.default_qconfig(8, 8, per_channel_weights=True, init_batches=1)
    for jit in (False, True):
        model = QuantResNet(10, qc, stage_sizes=(1, 1), widths=(4, 8), device="cpu")
        opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
        step = make_train_step(model, opt, jit=jit, mesh=mesh)
        losses = []
        for b in image_batches(2):
            t = {"image": torch.from_numpy(b["image"]).permute(0, 3, 1, 2).contiguous(),
                 "label": torch.from_numpy(b["label"])}
            losses.append(float(step(shard_batch(t, mesh))["loss"]))
        out[("bn", jit)] = {"losses": losses, "state": state_of(model)}

    # the gradient scale: the same rows twice over give sqrt(2) times dS
    from jaxlsq_torch.core import QuantSpec
    from jaxlsq_torch.models.layers import FakeQuantize
    from jaxlsq_torch.observers import LSQQuantizer

    half = np.random.RandomState(1).randn(32, 16).astype(np.float32)
    cfg = LSQQuantizer(QuantSpec(quant_min=0, quant_max=15), init_mode="learnable",
                       n_batches=0, init_scale=0.1, init_shift=0.0)
    split = _dist.Split((_dist.Part(mesh.get_group(0), world, rank, 0),))
    ds = []
    for x in (half, np.concatenate([half, half])):
        fq = FakeQuantize(cfg, 1, device="cpu")
        xl = torch.from_numpy(x).chunk(world)[rank]
        with _dist.splitting(split):
            fq.train()(xl).sum().backward()
        ds.append(float(_dist.reduce_sum(fq.scale.grad, split)[0]))
    out["grad_scale"] = ds

    # sequence parallelism: tokens over ('data', 'model') of a 2 x 2 mesh
    mesh22 = make_mesh(data=2, model=2)
    tokens = token_batches(1, 4, 16, 64, seed=0)[0]
    for case in SP_CASES:
        model = QuantTransformerLM(64, 32, 1, 4, pm.default_qconfig(8, 8, init_batches=1),
                                   max_len=16, device="cpu", seed=5, **SP_CASES[case])
        step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-2),
                               loss_fn=lm_loss, jit=False, mesh=mesh22,
                               sequence_axis="model")
        t = torch.from_numpy(tokens)
        loss = float(step(shard_batch({"input": t, "label": t}, mesh22,
                                      sequence_axis="model"))["loss"])
        out[("sp", case)] = {"loss": loss, "state": state_of(model)}
    model = QuantTransformerLM(64, 32, 1, 4, pm.default_qconfig(8, 8, init_batches=1),
                               max_len=16, device="cpu", seed=5, train_attn_impl="flash")
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-2),
                           loss_fn=lm_loss, jit=False, mesh=mesh22, sequence_axis="model")
    t = torch.from_numpy(tokens)
    try:
        step(shard_batch({"input": t, "label": t}, mesh22, sequence_axis="model"))
        out["sp_refusals"] = [None]
    except ValueError as e:
        out["sp_refusals"] = [str(e)]
    return out


FSDP_MIN = 64
MOE_D, MOE_H, MOE_E = 8, 16, 4


def placements(sharding):
    """A placement table as strings (``Shard(dim=1)``, ``Replicate()``)."""
    return {k: [str(p) for p in v] for k, v in sharding.items()}


def fsdp_models(qc):
    from jaxlsq_torch.models import QuantMLP, QuantResNet

    return {"mlp": QuantMLP(16, (64, 32, 4), qc, device="cpu", seed=2),
            "resnet": QuantResNet(10, qc, stage_sizes=(1, 1), widths=(8, 16), device="cpu")}


def fsdp_batch(kind, seed):
    import torch

    if kind == "mlp":
        return {k: torch.from_numpy(v) for k, v in mlp_batches(1, seed=seed)[0].items()}
    b = image_batches(1, seed=seed)[0]
    return {"image": torch.from_numpy(b["image"]).permute(0, 3, 1, 2).contiguous(),
            "label": torch.from_numpy(b["label"])}


def moe_models(qc, lm: bool):
    """The bare MoE (capacity factor E: no drop) or the MoE LM (two blocks,
    capacity factor E / 2)."""
    from jaxlsq_torch.models import QuantMoE, QuantTransformerLM
    from jaxlsq_torch.models.zoo import init_qat_variables

    if lm:
        return QuantTransformerLM(32, 16, 2, 4, qc, max_len=16, moe_experts=MOE_E,
                                  moe_top_k=2, moe_capacity_factor=MOE_E / 2.0,
                                  device="cpu", seed=41)
    moe = QuantMoE(MOE_D, MOE_H, MOE_E, qc, capacity_factor=float(MOE_E), device="cpu")
    init_qat_variables(moe, 30)
    return moe


def moe_batch(lm: bool):
    import torch

    r = np.random.RandomState(31)
    if lm:
        t = torch.from_numpy(r.randint(0, 32, size=(4, 10)).astype(np.int64))
        return {"input": t, "label": t}
    return {"input": torch.from_numpy(r.randn(16, MOE_D).astype(np.float32)),
            "label": torch.from_numpy(r.randn(16, MOE_D).astype(np.float32))}


def leg_fsdp_ep(rank: int, world: int):
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from jaxlsq_torch import _dist
    from jaxlsq_torch import models as pm
    from jaxlsq_torch.parallel import (apply_sharding, fsdp_sharding, make_eval_step,
                                       make_mesh, make_train_step, moe_sharding, shard_batch)
    from jaxlsq_torch.parallel.placement import gathered_params
    from jaxlsq_torch.serve import convert
    from jaxlsq_torch import interop

    out = {}
    mesh = make_mesh()
    qc = pm.default_qconfig(8, 8, per_channel_weights=True, init_batches=1)
    for kind in ("mlp", "resnet"):
        model = fsdp_models(qc)[kind]
        sh = fsdp_sharding(mesh, model, min_size=FSDP_MIN)
        out[("fsdp_placement", kind)] = placements(sh)
        runs = {}
        for fsdp in (False, True):
            model = fsdp_models(qc)[kind]
            opt = torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.9)
            step = make_train_step(model, opt, jit=False, mesh=mesh,
                                   state_sharding=sh if fsdp else None)
            if fsdp:
                out[("fsdp_shards", kind)] = {n: model.get_parameter(n).detach().numpy().copy()
                                              for n in model._jlt_fsdp}
            losses = [float(step(shard_batch(fsdp_batch(kind, 10 + i), mesh))["loss"])
                      for i in range(3)]
            state = state_of(model)
            state.update({k: v.detach().numpy() for k, v in
                          gathered_params(model, grad=False).items()})
            nbytes = sum(p.numel() for p in model.parameters()) + sum(
                v.numel() for st in opt.state.values() for v in st.values()
                if torch.is_tensor(v))
            logits = make_eval_step(model, mesh=mesh)(
                shard_batch(fsdp_batch(kind, 20), mesh)).numpy()
            runs[fsdp] = {"losses": losses, "state": state, "numel": nbytes,
                          "eval": logits}
        out[("fsdp", kind)] = runs

    model = fsdp_models(qc)["mlp"]
    try:
        make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.01), jit=True,
                        mesh=mesh, state_sharding=fsdp_sharding(mesh, model,
                                                                min_size=FSDP_MIN))
        out["fsdp_jit"] = None
    except ValueError as e:
        out["fsdp_jit"] = str(e)

    emesh = DeviceMesh("cpu", torch.arange(world).reshape(2, world // 2),
                       mesh_dim_names=("data", "expert"))
    for lm in (False, True):
        model = moe_models(qc, lm)
        sh = moe_sharding(emesh, model, MOE_E)
        out[("ep_placement", lm)] = placements(sh)
        opt = torch.optim.SGD(model.parameters(), lr=1e-2)
        step = make_train_step(model, opt, loss_fn=lm_loss if lm else mse_loss, jit=False,
                               mesh=emesh, state_sharding=sh)
        out[("ep_shards", lm)] = {n: t.detach().numpy().copy()
                                  for n, t in model.state_dict().items()
                                  if n in model._jlt_expert}
        seen = _count_gathers()
        loss = float(step(shard_batch(moe_batch(lm), emesh))["loss"])
        stacks = {t.data_ptr() for n, t in model.state_dict().items() if n in model._jlt_expert}
        out[("ep_gathers", lm)] = [(d, shape, ptr in stacks) for d, shape, ptr in seen]
        st = state_of(model)
        full = {n: _dist.all_gather(torch.from_numpy(st[n]), emesh.get_group(1),
                                    emesh.size(1), 0).numpy() for n in model._jlt_expert}
        st.update(full)
        out[("ep", lm)] = {"loss": loss, "state": st}

    # the experts over the 'data' axis itself (GShard's layout): each
    # process runs E/2 experts on the global slots, no 'data' replica
    # repeats them
    for lm in (False, True):
        model = moe_models(qc, lm)
        sh = moe_sharding(emesh, model, MOE_E, axis="data")
        step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-2),
                               loss_fn=lm_loss if lm else mse_loss, jit=False,
                               mesh=emesh, state_sharding=sh)
        loss = float(step(shard_batch(moe_batch(lm), emesh))["loss"])
        st = state_of(model)
        st.update({n: _dist.all_gather(torch.from_numpy(st[n]), emesh.get_group(0),
                                       emesh.size(0), 0).numpy() for n in model._jlt_expert})
        out[("ep_data", lm)] = {"loss": loss, "state": st}

    # the all-gather's backward hands the gradient back in its own layout
    # (here the capacity axis outermost, as the MoE's combine gives it)
    one, _ = torch.distributed.new_subgroups(1)
    x = torch.zeros(4, 80, 64, requires_grad=True).clone()
    g = torch.randn(80, 4, 64, generator=torch.Generator().manual_seed(rank)).transpose(0, 1)
    (dx,) = torch.autograd.grad(_dist.all_gather_grad(x, one, 1, 0), x, g)
    out["gather_grad_layout"] = (dx.stride() == g.stride(), torch.equal(dx, g),
                                 torch.equal(dx.sum((0, 1)), g.sum((0, 1))))

    # expert-parallel serving: the converted bare MoE, static activations
    model = moe_models(qc, False)
    tree = convert(interop.qat_variables(model), qc)
    x = torch.from_numpy(np.random.RandomState(70).randn(16, MOE_D).astype(np.float32))
    served = {}
    for ep in (False, True):
        sm = pm.QuantMoE(MOE_D, MOE_H, MOE_E, qc.for_serving("static"),
                         capacity_factor=float(MOE_E), device="cpu")
        interop.load_variables(sm, tree)
        if ep:
            apply_sharding(sm, moe_sharding(emesh, sm, MOE_E), emesh)
            seen = _count_gathers()
            _dist.COUNTS.clear()
            served[ep] = make_eval_step(sm, mesh=emesh)(shard_batch({"input": x}, emesh))
            stacks = {t.data_ptr() for n, t in sm.state_dict().items() if n in sm._jlt_expert}
            out["ep_serve_gathers"] = [(d, shape, ptr in stacks) for d, shape, ptr in seen]
            out["ep_serve_counts"] = dict(_dist.COUNTS)
        else:
            rows = x.shape[0] // emesh.size(0)
            d = emesh.get_local_rank("data")
            served[ep] = sm(x)[d * rows:(d + 1) * rows]
    out["ep_serve"] = {k: v.numpy() for k, v in served.items()}
    return out


TP_CONFIGS = {"w8": (8, None), "w4": (4, None), "w4g": (4, 16)}
TP_B, TP_T, TP_NEW = 4, 8, 4


def tp_qconfig(bits):
    from jaxlsq_torch.models import default_qconfig

    return default_qconfig(bits, 8, init_batches=0, per_channel_weights=True,
                           reduce_range=False)


def tp_tree(name):
    """A seeded QAT LM (vocab 64, d 32, 2 blocks, 4 heads, max_len 32) and
    its converted tree under config ``name``."""
    from jaxlsq_torch import interop
    from jaxlsq_torch.models import QuantTransformerLM
    from jaxlsq_torch.serve import convert

    bits, group = TP_CONFIGS[name]
    qc = tp_qconfig(bits)
    qat = QuantTransformerLM(64, 32, 2, 4, qc, max_len=32, device="cpu", seed=3)
    return qat, qc, convert(interop.qat_variables(qat), qc, weight_group_size=group)


def leg_tp(rank: int, world: int):
    import torch

    from jaxlsq_torch import _dist, interop
    from jaxlsq_torch.models import QuantTransformerLM
    from jaxlsq_torch.models.layers import _PackedBuffers
    from jaxlsq_torch.parallel import make_mesh
    from jaxlsq_torch.serve import (init_kv_cache, init_paged_cache, make_generate,
                                    quantize_weight_grouped, shard_converted, shard_packed,
                                    wo_matmul)

    out = {}
    r = np.random.RandomState(0)
    prompt = torch.from_numpy(r.randint(0, 64, size=(TP_B, TP_T)).astype(np.int64))
    pos = torch.arange(TP_B, dtype=torch.int32) % 4
    for name in TP_CONFIGS:
        _, qc, tree = tp_tree(name)
        acts = ("none", "static", "static_int8") if name == "w8" else ("none", "static")
        for act in acts:
            sq = qc.for_serving(act)
            models = {}
            for deg in (1, 2, 4):
                for window in (None, 4):
                    m = QuantTransformerLM(64, 32, 2, 4, sq, max_len=32, attn_window=window,
                                           device="cpu")
                    interop.load_variables(m, tree)
                    if deg > 1:
                        shard_converted(m, make_mesh(model=deg))
                    models[deg, window] = m
            res = {}
            for deg in (1, 2, 4):
                m = models[deg, None]
                _dist.COUNTS.clear()
                seen = _count_gathers()
                logits = m(prompt)
                counts = dict(_dist.COUNTS)
                packs = {t.data_ptr() for t in m.buffers() if t.dtype == torch.int8}
                gathered = [(d, shape, ptr in packs) for d, shape, ptr in seen]
                toks = make_generate(m, TP_T, TP_NEW)(prompt)
                steps = {}
                for cdt in (torch.float32, torch.int8):
                    cache = init_kv_cache(m, TP_B, dtype=cdt)
                    steps[str(cdt)] = m(prompt[:, :1], cache=cache, cache_index=pos)[0]
                for window in (None, 4):
                    mw = models[deg, window]
                    cache = init_paged_cache(mw, TP_B, page_size=4, dtype=torch.int8)
                    steps[("paged", window)] = mw(prompt[:, :1], cache=cache,
                                                  cache_index=pos)[0]
                res[deg] = {"logits": logits, "counts": counts, "tokens": toks,
                            "steps": steps, "gathered": gathered}
            out[("tp", name, act)] = res
        m = QuantTransformerLM(64, 32, 2, 4, qc.for_serving("none"), max_len=32, device="cpu")
        interop.load_variables(m, tree)
        shard_converted(m, make_mesh(model=world))
        out[("packs", name)] = {
            n: {f: getattr(k, f).numpy().copy() for f in ("data", "scale", "zero_point")}
            for n, k in ((n, getattr(mod, a)) for n, mod in m.named_modules()
                         for a in ("kernel", "embedding")
                         if isinstance(getattr(mod, a, None), _PackedBuffers))}
    # what the rule keeps whole: an N the axis does not divide, a
    # depthwise convolution, an embedding table
    from jaxlsq_torch.models import QuantConv, QuantDense, QuantEmbed

    qc = tp_qconfig(8)
    mesh = make_mesh(model=world)
    whole = {"dense_n6": QuantDense(16, 6, qc.for_serving("none"), device="cpu"),
             "depthwise": QuantConv(8, 8, (3, 3), qc.for_serving("none"),
                                    feature_group_count=8, device="cpu"),
             "conv": QuantConv(8, 8, (3, 3), qc.for_serving("none"), device="cpu"),
             "embed": QuantEmbed(64, 8, qc.for_serving("none"), device="cpu")}
    for m in whole.values():
        shard_converted(m, mesh)
    out["tp_whole"] = {n: (getattr(m, "kernel", None) or m.embedding).tp is None
                       for n, m in whole.items()}
    # a grouped int4 weight under shard_packed, its slices gathered
    w = torch.from_numpy(r.randn(64, 32 * world).astype(np.float32))
    x = torch.from_numpy(r.randn(TP_B, 64).astype(np.float32))
    p = quantize_weight_grouped(w, group_size=16)
    part = shard_packed(p, mesh)
    got = _dist.all_gather(wo_matmul(x, part), mesh.get_group(1), world, -1)
    out["grouped"] = {"got": got.numpy(), "want": wo_matmul(x, p).numpy(),
                      "local_cols": part.data.shape[-1]}
    return out


# the pipeline legs: jaxlsq's tests/test_pipeline.py sizes
PP_VOCAB, PP_DIM, PP_DEPTH, PP_HEADS, PP_T, PP_B, PP_MB = 32, 16, 4, 4, 8, 8, 2
PP_STEPS, PP_LR, PP_WORLD = 3, 1e-2, 4
PP_CASES = {"learned": {"pos_embedding": "learned"}, "rope": {"pos_embedding": "rope"},
            "gqa": {"pos_embedding": "rope", "num_kv_heads": 2}}
PP_SEED = 7
PP_PROMPT, PP_NEW = 3, 5


def pp_qconfig(kind, default_qconfig, lsq_quantizer=None, quant_spec=None, qconfig=None):
    """The pipeline legs' configs from either package: 'learning' (no
    observer window), 'window' (init_batches=1: it closes between the first
    step's microbatches), 'observers' (init_batches=3) or 'pinned' (jaxlsq's
    DP test: learnable activation quantizers whose gradient scale counts the
    GLOBAL microbatch, so the (2, 2) mesh equals the (1, 4) one)."""
    if kind == "pinned":
        numel = (PP_B // PP_MB) * PP_T * PP_DIM
        return qconfig(weight=lsq_quantizer(spec=quant_spec.weight_default(8), otype="weight"),
                       activation=lsq_quantizer(spec=quant_spec.activation_default(8),
                                                otype="activation", init_mode="learnable",
                                                n_batches=-1, numel=numel))
    return default_qconfig(8, 8, init_batches={"learning": 0, "window": 1,
                                               "observers": 3}[kind])


def pp_port_qconfig(kind):
    from jaxlsq_torch.core import QuantSpec
    from jaxlsq_torch.models import QConfig, default_qconfig
    from jaxlsq_torch.observers import LSQQuantizer

    return pp_qconfig(kind, default_qconfig, LSQQuantizer, QuantSpec, QConfig)


def pp_model(kind, case="learned", depth=PP_DEPTH, **kw):
    from jaxlsq_torch.models import QuantTransformerLM

    return QuantTransformerLM(PP_VOCAB, PP_DIM, depth, PP_HEADS, pp_port_qconfig(kind),
                              max_len=PP_T, device="cpu", seed=PP_SEED,
                              **{**PP_CASES[case], **kw})


def pp_batches(seed, steps=PP_STEPS):
    return token_batches(steps, PP_B, PP_T, PP_VOCAB, seed)


def pp_sgd(params):
    import torch

    return torch.optim.SGD(params, lr=PP_LR, momentum=0.9)


def pp_run(mesh, kind, case="learned", steps=PP_STEPS, seed=11, **step_kw):
    """A pipeline of ``pp_model(kind, case)`` trained ``steps`` steps over
    ``mesh``: losses, sends and receives a step, this stage's state (its
    ``interop`` tree), the gathered tree, the stage and its optimizer."""
    import torch

    from jaxlsq_torch import _dist, interop
    from jaxlsq_torch.parallel import (create_pipeline_state, gather_pipeline_model,
                                       make_pipeline_train_step, shard_batch)

    stage, opt = create_pipeline_state(pp_model(kind, case), pp_sgd, mesh, device="cpu")
    step = make_pipeline_train_step(stage, opt, mesh, num_microbatches=PP_MB,
                                    **{"jit": False, **step_kw})
    losses, p2p = [], []
    for b in pp_batches(seed, steps):
        t = torch.from_numpy(b)
        _dist.COUNTS.clear()
        losses.append(float(step(shard_batch({"input": t, "label": t}, mesh))["loss"]))
        p2p.append((_dist.COUNTS["send"], _dist.COUNTS["recv"]))
    return {"losses": losses, "p2p": p2p, "stage": interop.qat_variables(stage),
            "gathered": interop.qat_variables(gather_pipeline_model(stage, mesh)),
            "bytes": sum(p.numel() * p.element_size() for p in stage.parameters()),
            "blocks": list(stage.block_ids)}, stage, opt


def _error(fn):
    try:
        fn()
    except Exception as e:  # the test compares type and message with jaxlsq's
        return type(e).__name__, str(e)
    return None


def leg_pipeline(rank: int, world: int):
    """(data 1, stage 4): the three position cases in learning mode, eager,
    traced and under remat; the errors; a checkpoint round trip."""
    import tempfile

    import torch

    from jaxlsq_torch.parallel import (create_pipeline_state, make_pipeline_train_step,
                                       pipeline_mesh, shard_batch)
    from jaxlsq_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

    mesh = pipeline_mesh(stage=world)
    out = {}
    for case in PP_CASES:
        out[("run", case)] = pp_run(mesh, "learning", case)[0]
    out["traced"] = pp_run(mesh, "learning", jit=True)[0]
    out["remat"] = pp_run(mesh, "learning", remat=True)[0]

    errs = {}
    errs["depth"] = _error(lambda: create_pipeline_state(pp_model("learning", depth=6),
                                                         pp_sgd, mesh, device="cpu"))
    stage, opt = create_pipeline_state(pp_model("learning"), pp_sgd, mesh, device="cpu")
    errs["microbatches"] = _error(lambda: make_pipeline_train_step(
        stage, opt, mesh, num_microbatches=0))
    step = make_pipeline_train_step(stage, opt, mesh, num_microbatches=3, jit=False)
    t = torch.from_numpy(pp_batches(1, 1)[0])
    errs["batch"] = _error(lambda: step(shard_batch({"input": t, "label": t}, mesh)))
    moe, mopt = create_pipeline_state(pp_model("learning", moe_experts=4), pp_sgd, mesh,
                                      device="cpu")
    errs["moe"] = _error(lambda: make_pipeline_train_step(moe, mopt, mesh,
                                                          num_microbatches=2))
    errs["window"] = _error(lambda: create_pipeline_state(
        pp_model("learning", attn_window=4), pp_sgd, mesh, device="cpu"))
    errs["flash"] = _error(lambda: create_pipeline_state(
        pp_model("learning", train_attn_impl="flash"), pp_sgd, mesh, device="cpu"))
    errs["mesh"] = _error(lambda: pipeline_mesh(stage=world, data=2))
    errs["device"] = _error(lambda: create_pipeline_state(pp_model("learning"), pp_sgd, mesh))
    out["errors"] = errs

    # a checkpoint of the stage state, restored into a fresh one, trains on
    # as the original does
    res, stage, opt = pp_run(mesh, "window", steps=1)
    ckpt = tempfile.mkdtemp(prefix=f"pp_ckpt{rank}_")
    save_checkpoint(ckpt, {"model": stage, "opt": opt}, step=1)
    fresh, fopt = create_pipeline_state(pp_model("window"), pp_sgd, mesh, device="cpu")
    restore_checkpoint(ckpt, {"model": fresh, "opt": fopt})
    same = [k for k, v in stage.state_dict().items() if not torch.equal(v, fresh.state_dict()[k])]
    t = torch.from_numpy(pp_batches(12, 1)[0])
    losses = []
    for s, o in ((stage, opt), (fresh, fopt)):
        step = make_pipeline_train_step(s, o, mesh, num_microbatches=PP_MB, jit=False)
        losses.append(float(step(shard_batch({"input": t, "label": t}, mesh))["loss"]))
    after = [k for k, v in stage.state_dict().items()
             if not torch.equal(v, fresh.state_dict()[k])]
    out["checkpoint"] = {"unequal_restored": same, "losses": losses, "unequal_after": after,
                         "leaves": len(stage.state_dict())}
    return out


def leg_pipeline_dp(rank: int, world: int):
    """The observer window over (data 1, stage 4); (data 2, stage 2) with
    the gradient scale pinned and with observers; the gathered state served."""
    import torch

    from jaxlsq_torch import interop
    from jaxlsq_torch.models import QuantTransformerLM
    from jaxlsq_torch.parallel import gather_pipeline_model, pipeline_mesh
    from jaxlsq_torch.serve import convert, make_generate

    out = {}
    mesh14 = pipeline_mesh(stage=world)
    res, stage, _ = pp_run(mesh14, "window", seed=13)
    out[("window", False)] = res
    out[("window", True)] = pp_run(mesh14, "window", seed=13, jit=True)[0]
    # train, then serve: the gathered LM converted at w8, static activations
    qc = pp_port_qconfig("window")
    lm = gather_pipeline_model(stage, mesh14)
    served = QuantTransformerLM(PP_VOCAB, PP_DIM, PP_DEPTH, PP_HEADS, qc.for_serving("static"),
                                max_len=PP_T, device="cpu")
    interop.load_variables(served, convert(interop.qat_variables(lm), qc))
    prompt = torch.from_numpy(pp_batches(14, 1)[0][:2, :PP_PROMPT])
    out["tokens"] = make_generate(served, PP_PROMPT, PP_NEW)(prompt).numpy()

    mesh22 = pipeline_mesh(stage=2, data=2)
    out["pinned"] = pp_run(mesh22, "pinned", steps=2, seed=15)[0]
    out["observers"] = pp_run(mesh22, "observers", steps=2, seed=16)[0]
    out["coords"] = (mesh22.get_local_rank("data"), mesh22.get_local_rank("stage"))
    from jaxlsq_torch.lab import parallel_qat

    lab = parallel_qat.main(["--steps", "2", "--device", "cpu"])
    out["lab"] = {k: v.detach().numpy() for k, v in lab.items()}
    return out


def main():
    leg, rank, world, port, out_dir = sys.argv[1:6]
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=rank,
                      WORLD_SIZE=world, LOCAL_RANK=rank)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from jaxlsq_torch.parallel import initialize_distributed

    initialize_distributed(device="cpu")
    result = globals()[f"leg_{leg}"](int(rank), int(world))
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
