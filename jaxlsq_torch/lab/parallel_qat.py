"""jaxlsq's parallel QAT demo on the port (port of
``examples/parallel_qat.py``): an expert-parallel MoE LM and a
pipeline-parallel LM, on whatever processes ``torchrun`` started (or this
one alone):

1. EP: a ``QuantTransformerLM`` with MoE MLP blocks (rope, 4 experts, top 2,
   capacity 2.0, per-expert LSQ scales), its expert stacks sharded over the
   'expert' axis of a (data, expert) mesh by ``moe_sharding``, trained by
   the ordinary ``make_train_step(mesh=, state_sharding=)``, then gathered,
   converted and greedily decoded on the int8 serving path;
2. PP: a dense LM (depth 4) split into per-stage modules and trained by the
   GPipe step (``make_pipeline_train_step``), then gathered into the plain
   LM and run forward.

ep and stage are 4, 2 or 1, the largest that divides the world size, as in
jaxlsq.  On the card (NCCL)::

    python3 -m jaxlsq_torch.lab.parallel_qat [--steps N] [--microbatches M] [--remat]
    torchrun --nproc-per-node 4 -m jaxlsq_torch.lab.parallel_qat --steps 10

``--device cpu`` runs the gloo backend on the CPU.
"""

from __future__ import annotations

import argparse
import os
import socket
from typing import Dict, Iterator

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from .. import _dist, interop
from .._device import resolve_device
from ..models import QuantTransformerLM, default_qconfig
from ..parallel import (create_pipeline_state, gather_pipeline_model,
                        initialize_distributed, make_pipeline_train_step, make_train_step,
                        moe_sharding, pipeline_mesh, shard_batch)
from ..serve import convert, make_generate

VOCAB, DIM, DEPTH, T, SEED = 128, 64, 4, 32, 0


def lm_loss(logits: torch.Tensor, batch: Dict) -> torch.Tensor:
    v = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, v), batch["label"][:, 1:].reshape(-1))


def batches(b: int, steps: int, seed: int = 0) -> Iterator[Dict[str, torch.Tensor]]:
    """jaxlsq's batches: numpy ``RandomState(seed)`` tokens, input = label."""
    r = np.random.RandomState(seed)
    for _ in range(steps):
        toks = torch.from_numpy(r.randint(0, VOCAB, size=(b, T)).astype(np.int64))
        yield {"input": toks, "label": toks}


def _largest_of(n: int) -> int:
    return 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)


def _sgd(params):
    return torch.optim.SGD(params, lr=1e-2, momentum=0.9)


def _log(*a) -> None:
    if dist.get_rank() == 0:
        print(*a, flush=True)


def _unsharded(model: QuantTransformerLM, make) -> QuantTransformerLM:
    """``make()``'s LM holding ``model``'s state with every expert stack
    all-gathered over its axis (jaxlsq's ``device_get`` of the placed
    state)."""
    state = model.state_dict()
    for name, part in getattr(model, "_jlt_expert", {}).items():
        state[name] = _dist.all_gather(state[name], part.group, part.size, part.dim)
    full = make()
    full.load_state_dict(state)
    return full


def run_ep(args, device) -> torch.Tensor:
    n = dist.get_world_size()
    ep = _largest_of(n)
    mesh = DeviceMesh("cuda" if dist.get_backend() == "nccl" else "cpu",
                      torch.arange(n).reshape(n // ep, ep), mesh_dim_names=("data", "expert"))
    _log(f"[EP] mesh data={n // ep} expert={ep}")
    qc = default_qconfig(8, 8, per_channel_weights=True, init_batches=2)

    def make():
        return QuantTransformerLM(VOCAB, DIM, 2, 4, qc, max_len=T, pos_embedding="rope",
                                  moe_experts=4, moe_top_k=2, moe_capacity_factor=2.0,
                                  device=device, seed=SEED)

    model = make()
    opt = _sgd(model.parameters())
    step = make_train_step(model, opt, loss_fn=lm_loss, mesh=mesh,
                           state_sharding=moe_sharding(mesh, model, num_experts=4))
    b = 4 * (n // ep)
    for i, batch in enumerate(batches(b, args.steps)):
        metrics = step(shard_batch(batch, mesh))
        if i % max(1, args.steps // 5) == 0:
            _log(f"[EP] step {i} loss {float(metrics['loss']):.4f} (incl. load-balance aux)")

    # serve: gather, convert and greedy decode on the int8 path (expert
    # stacks packed with per-expert scales)
    full = _unsharded(model, make)
    served = QuantTransformerLM(VOCAB, DIM, 2, 4, qc.for_serving("static"), max_len=T,
                                pos_embedding="rope", moe_experts=4, moe_top_k=2,
                                moe_capacity_factor=2.0, device=device)
    interop.load_variables(served, convert(interop.qat_variables(full), qc))
    prompts = next(batches(2, 1, seed=7))["input"][:, :8].to(device)
    out = make_generate(served, 8, 8)(prompts)
    _log(f"[EP] int8 MoE decode: {out[0].tolist()}")
    return out


def run_pp(args, device) -> torch.Tensor:
    n = dist.get_world_size()
    stages = _largest_of(n)
    mesh = pipeline_mesh(stage=stages, data=n // stages)
    _log(f"[PP] mesh data={n // stages} stage={stages}")
    qc = default_qconfig(8, 8, init_batches=2)
    model = QuantTransformerLM(VOCAB, DIM, DEPTH, 4, qc, max_len=T, device=device,
                               seed=SEED)
    stage, opt = create_pipeline_state(model, _sgd, mesh, device=device)
    del model  # this process keeps its stage's blocks only
    # captured across stages on cards is refused until verified: eager there
    step = make_pipeline_train_step(stage, opt, mesh, num_microbatches=args.microbatches,
                                    loss_fn=lambda lg, lb: lm_loss(lg, {"label": lb}),
                                    remat=args.remat, jit=stages == 1)
    b = args.microbatches * 2 * (n // stages)
    for i, batch in enumerate(batches(b, args.steps, seed=1)):
        metrics = step(shard_batch(batch, mesh))
        if i % max(1, args.steps // 5) == 0:
            _log(f"[PP] step {i} loss {float(metrics['loss']):.4f}")

    # gathered back into the plain LM (checkpoints / serving interop)
    lm = gather_pipeline_model(stage, mesh)
    with torch.no_grad():
        logits = lm.eval()(next(batches(2, 1))["input"].to(device))
    _log(f"[PP] gathered plain-LM forward ok: {tuple(logits.shape)}")
    return logits


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main(argv=None) -> Dict[str, torch.Tensor]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--device", default=None, help="'cpu' runs gloo on the CPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    alone = "WORLD_SIZE" not in os.environ and not dist.is_initialized()
    if alone:  # one process: a group of its own, no torchrun needed
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                          RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    initialize_distributed(device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    try:
        out = {"ep": run_ep(args, device), "pp": run_pp(args, device)}
        _log("done")
    finally:
        if alone:
            dist.destroy_process_group()
            for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
                os.environ.pop(k, None)
    return out


if __name__ == "__main__":
    main()
