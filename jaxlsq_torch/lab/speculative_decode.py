"""jaxlsq's speculative-decoding demo on the port (port of
``examples/speculative_decode.py``, the real-draft leg of ``bench.py``).

A target LM (d1024 x 4, 8 heads) and a draft (d128 x 1, 2 heads) over a
512-token vocab train by LSQ QAT (``default_qconfig(8, 8, init_batches=4)``,
Adam 2e-3, B = 64 sequences of 64 tokens, next-token loss) on a Markov
corpus, each through ``make_train_step(jit=True)``: on the card one CUDA
graph a step.  Both convert to int8 serving form (``for_serving('none')``),
and speculative decoding (``make_speculative_generate``) is timed against
plain ``make_generate`` at B = 1; greedy output must equal plain greedy.

The corpus: ``next = (3 * cur + n) mod 512`` with ``n`` 1 on about one step
in ten.  :func:`corpus_draws` draws its random inputs (the start tokens and
the noise) from a ``torch.Generator`` on the device, the JAX package's
distributions, not its bits; :func:`markov_chain` is the chain's formula on
them.  Every batch of a run is drawn at once, before training.  On the
card::

    python3 -m jaxlsq_torch.lab.speculative_decode [--steps 1200] [--k 4] \\
        [--n-new 256] [--temperature T] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Tuple

import torch

from .. import interop
from .._device import resolve_device
from ..models import QuantTransformerLM, default_qconfig
from ..parallel import cross_entropy_loss, make_train_step
from ..serve import make_generate, make_sampler, make_speculative_generate

VOCAB, T = 512, 64
PROMPT = 32


def corpus_draws(batch: int, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The chain's random inputs for ``batch`` sequences: the (batch, 1)
    start tokens, uniform over the vocab, and the (batch, T) int32 noise, 1
    where a uniform draw over 0..9 is 0."""
    start = torch.randint(0, VOCAB, (batch, 1), generator=generator, device=device)
    noise = torch.randint(0, 10, (batch, T), generator=generator, device=device) == 0
    return {"start": start, "noise": noise.to(torch.int32)}


def markov_chain(start: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """(batch, T) tokens: ``start``, then ``(3 * prev + noise[:, t - 1]) mod
    VOCAB`` at position t."""
    toks = [start[:, 0].to(torch.int64)]
    for t in range(1, noise.shape[1]):
        toks.append((3 * toks[-1] + noise[:, t - 1]) % VOCAB)
    return torch.stack(toks, 1)


def corpus_batch(batch: int, generator: torch.Generator, device) -> torch.Tensor:
    return markov_chain(**corpus_draws(batch, generator, device))


def lm_pair(max_len: int, device=None, seed: int = 0) -> Tuple[QuantTransformerLM,
                                                              QuantTransformerLM]:
    """The QAT target (d1024 x 4, 8 heads) and draft (d128 x 1, 2 heads)."""
    qc = default_qconfig(8, 8, init_batches=4)
    target = QuantTransformerLM(VOCAB, 1024, 4, 8, qc, max_len=max_len,
                                device=device, seed=seed)
    draft = QuantTransformerLM(VOCAB, 128, 1, 2, qc, max_len=max_len,
                               device=device, seed=seed)
    return target, draft


def next_token_loss(logits: torch.Tensor, batch: Dict) -> torch.Tensor:
    """Cross entropy of each position's logits against the next token."""
    return cross_entropy_loss(logits[:, :-1], {"label": batch["label"][:, 1:]})


def train(model: QuantTransformerLM, steps: int, batch: int, seed: int = 0) -> float:
    """``steps`` LSQ QAT steps of Adam 2e-3 on fresh corpus batches (drawn
    from ``seed``, all at once); returns the last step's loss."""
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    data = corpus_batch(steps * batch, gen, dev)
    opt = torch.optim.Adam(model.parameters(), lr=2e-3, capturable=dev.type == "cuda")
    step = make_train_step(model, opt, loss_fn=next_token_loss, jit=True)
    loss = None
    for i in range(steps):
        toks = data[i * batch:(i + 1) * batch]
        loss = step({"input": toks, "label": toks})["loss"]
    return float(loss)


def serve(model: QuantTransformerLM) -> QuantTransformerLM:
    """The trained model's variables converted into a serve-mode twin (int8
    weights, no activation quantization)."""
    served = QuantTransformerLM(model.vocab, model.dim, model.depth, model.num_heads,
                                model.qconfig.for_serving("none"), max_len=model.max_len,
                                device=model.device)
    interop.load_variables(served, interop.qat_variables(model))
    return served


def best_time(fn, rounds: int = 5) -> float:
    """The least wall time of ``fn()`` (its result read back) over
    ``rounds`` runs after one warm-up."""
    fn().cpu()
    ts = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn().cpu()
        ts.append(time.perf_counter() - t0)
    return min(ts)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--n-new", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy (exactness asserted); > 0 = speculative "
                         "sampling")
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", help="also write the result here (JSON)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    target, draft = lm_pair(T + args.n_new + args.k, dev)
    s = time.perf_counter()
    tloss = train(target, args.steps, 64, seed=0)
    t_train = time.perf_counter() - s
    print(f"target trained: loss {tloss:.3f} in {t_train:.1f} s", flush=True)
    s = time.perf_counter()
    dloss = train(draft, args.steps, 64, seed=0)
    d_train = time.perf_counter() - s
    print(f"draft trained:  loss {dloss:.3f} in {d_train:.1f} s", flush=True)
    st, sd = serve(target), serve(draft)
    prompt = corpus_batch(1, torch.Generator(device=dev).manual_seed(99), dev)[:, :PROMPT]

    if args.temperature > 0:
        gen = torch.Generator(device=dev)
        plain = make_generate(st, PROMPT, args.n_new, sampled=True,
                              logits_to_token=make_sampler(args.temperature))
        spec = make_speculative_generate(st, sd, PROMPT, args.n_new, k=args.k,
                                         temperature=args.temperature,
                                         return_stats=True)
        got, stats = spec(prompt, gen.manual_seed(7))
        if tuple(got.shape) != (1, args.n_new):
            raise AssertionError(f"speculative sampling gave {tuple(got.shape)}")
        tp = best_time(lambda: plain(prompt, gen.manual_seed(7)))
        ts = best_time(lambda: spec(prompt, gen.manual_seed(7))[0])
    else:
        plain = make_generate(st, PROMPT, args.n_new)
        spec = make_speculative_generate(st, sd, PROMPT, args.n_new, k=args.k,
                                         return_stats=True)
        got, stats = spec(prompt)
        if not torch.equal(got, plain(prompt)):
            raise AssertionError("speculative greedy must equal plain greedy")
        print("exactness ok", flush=True)
        tp = best_time(lambda: plain(prompt))
        ts = best_time(lambda: spec(prompt)[0])
    acc = stats["accepted_per_round"]
    res = {"accepted_per_round": acc, "rounds": stats["rounds"],
           "target": "d1024x4 int8", "draft": "d128x1 int8", "train_steps": args.steps,
           "target_loss": tloss, "draft_loss": dloss, "target_train_s": t_train,
           "draft_train_s": d_train, "k": args.k,
           "n_new": args.n_new, "temperature": args.temperature,
           "plain_ms": tp * 1e3, "spec_ms": ts * 1e3, "speedup": tp / ts,
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")}
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
