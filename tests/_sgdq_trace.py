"""The sgdq recipe (examples/recipe_sweep.py: AdamW on the weights, SGD with
momentum on the qparams through qat_optimizer, the cosine 3e-3 schedule) in
jaxlsq and in the port from one state, on jaxlsq's own grating batches, on
the CPU: full-width mobilenetv2_cifar, a 20-batch window.  Prints the loss,
the smallest activation scale and the count of activation scales below 1e-3
on both sides every 10 steps, to see whether the port's qparams collapse as
jaxlsq's do.  Not a test (it takes seconds a step):

    JAX_PLATFORMS=cpu python tests/_sgdq_trace.py [BATCH] [STEPS] [SEED]
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:0] = [HERE, REPO, os.path.join(REPO, "examples")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from _torch_port import np_tree  # noqa: E402
from accuracy_parity import make_batch  # noqa: E402
from jaxlsq.models import default_qconfig as jdefault_qconfig  # noqa: E402
from jaxlsq.models.zoo import mobilenetv2_cifar as jmobilenetv2_cifar  # noqa: E402
from jaxlsq.parallel import make_train_step as jmake_train_step  # noqa: E402
from jaxlsq.parallel import qat_optimizer as jqat_optimizer  # noqa: E402
from jaxlsq.parallel.train import QATTrainState  # noqa: E402
from jaxlsq_torch import interop  # noqa: E402
from jaxlsq_torch.lab import accuracy_parity as ap  # noqa: E402
from jaxlsq_torch.models import mobilenetv2_cifar  # noqa: E402
from jaxlsq_torch.models.layers import FakeQuantize  # noqa: E402
from jaxlsq_torch.parallel import make_train_step  # noqa: E402

TOTAL = 1500  # the protocol's steps: the cosine schedule's length


def _jax_act_scales(qparams):
    out = []

    def walk(t, path=()):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif path[-1] == "scale" and "act_fq" in path:
            out.append(np.asarray(t).ravel())

    walk(jax.device_get(qparams))
    return np.concatenate(out)


def main(batch=32, steps=300, seed=1):
    jmodel = jmobilenetv2_cifar(ap.N_CLASSES, jdefault_qconfig(
        8, 8, per_channel_weights=True, init_batches=20))
    sched = optax.cosine_decay_schedule(ap.BASE_LR, TOTAL)
    tx = jqat_optimizer(optax.adamw(sched), optax.sgd(sched, momentum=0.9))
    x0, _ = make_batch(jax.random.key(seed + 999), batch)
    v = jax.jit(lambda x: jmodel.init(jax.random.key(0), x, training=False))(x0)
    params = {"params": v["params"], "qparams": v["qparams"]}
    state = QATTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          model_state={k: w for k, w in v.items()
                                       if k not in ("params", "qparams")},
                          opt_state=tx.init(params))
    jstep = jmake_train_step(jmodel, tx, donate=False)
    model = mobilenetv2_cifar(ap.N_CLASSES, ap.recipe("sgdq").qconfig, device="cpu")
    interop.load_qat_variables(model, np_tree(v))
    opt = ap.sgdq_tx(model, False)
    step = make_train_step(model, opt, jit=True)
    acts = [m for n, m in model.named_modules()
            if isinstance(m, FakeQuantize) and n.endswith("act_fq")]
    key = jax.random.key(seed)
    t0 = time.time()
    for i in range(steps):
        key, sub = jax.random.split(key)
        bx, by = make_batch(sub, batch)
        state, metrics = jstep(state, {"input": bx, "label": by})
        for group in opt.param_groups:
            group["lr"] = ap.cosine_lr(i, TOTAL)
        loss = step({"image": torch.from_numpy(np.asarray(bx).transpose(0, 3, 1, 2).copy()),
                     "label": torch.from_numpy(np.array(by)).long()})["loss"]
        if i % 10 == 9:
            sj = _jax_act_scales(state.params["qparams"])
            st = np.concatenate([m.scale.detach().numpy().ravel() for m in acts])
            print(f"step {i + 1}: loss jaxlsq {float(metrics['loss']):.4f} port "
                  f"{float(loss):.4f} | smallest act scale {sj.min():.3e} / {st.min():.3e}"
                  f" | act scales < 1e-3: {(sj < 1e-3).sum()} / {(st < 1e-3).sum()}"
                  f" | {time.time() - t0:.0f} s", flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
