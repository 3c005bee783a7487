"""The port's pipeline step against jaxlsq's ``make_pipeline_train_step`` on
four gloo ranks (``tests/_torch_dist.py``'s ``leg_pipeline``), at the sizes
of jaxlsq's ``tests/test_pipeline.py`` (vocab 32, d16, depth 4, t 8, B 8,
two microbatches):

* ``stack_pipeline_variables``/``unstack_pipeline_variables`` and
  ``pipeline_sharding`` equal jaxlsq's on the same numpy tree;
* the errors carry jaxlsq's types and messages (depth not divisible,
  microbatches < 1, a local batch the microbatches do not divide, MoE
  blocks, a mesh larger than the world); a window or flash attention is
  refused (jaxlsq's pipeline blocks run neither), and with no card a stage
  needs a device named;
* (data 1, stage 4), three steps in learning mode, for learned and rope
  positions and rope with two kv heads: the loss within 1e-5, every leaf of
  ``params``/``qparams`` within rtol 2e-5 / atol 2e-6 and ``quant_state``
  within 1e-5 / 1e-6 of jaxlsq's pipeline run from the same state (the
  port's seeded LM carried into jaxlsq's stacked state); the traced regime
  (``jit=True`` on the CPU) too;
* ``remat=True`` bit-equal to ``remat=False``; 2·(S − 1)·MB sends and
  receives a step; each rank holds its own block only; every rank gathers
  the same plain LM; a checkpoint of the stage state restores and trains on
  as the original.

jaxlsq's pipeline programs run once each (cached by case).
"""

import jax
import jax.numpy as jnp
import optax
import pytest
from torch.distributed.tensor import Replicate, Shard

import _torch_dist as td
from _torch_mesh import (assert_matches_jaxlsq, assert_tree_close, jax_pipeline,
                         jax_pipeline_state, pp_jmodel)
from _torch_port import np_tree
from jaxlsq.parallel import make_pipeline_train_step as jmake_pipeline_train_step
from jaxlsq.parallel import pipeline_mesh as jpipeline_mesh
from jaxlsq.parallel import pipeline_sharding as jpipeline_sharding
from jaxlsq.parallel import stack_pipeline_variables as jstack
from jaxlsq.parallel import unstack_pipeline_variables as junstack
from jaxlsq_torch import interop
from jaxlsq_torch.parallel import (pipeline_sharding, stack_pipeline_variables,
                                   unstack_pipeline_variables)

WORLD = td.PP_WORLD


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return td.Ranks("pipeline", WORLD, str(tmp_path_factory.mktemp("pipeline")))


@pytest.mark.parametrize("stages", [2, 4])
def test_stack_unstack_and_sharding_equal_jaxlsq(ranks, stages):
    # (the ranks start here and run while jaxlsq compiles its programs)
    tree = interop.qat_variables(td.pp_model("window"))
    for col, node in tree.items():
        got = stack_pipeline_variables(node, td.PP_DEPTH, stages)
        want = np_tree(jstack(node, td.PP_DEPTH, stages))
        assert_tree_close(got, want, 0, 0, col)
        back = unstack_pipeline_variables(got, td.PP_DEPTH)
        assert_tree_close(back, node, 0, 0, col)
        assert_tree_close(back, np_tree(junstack(jstack(node, td.PP_DEPTH, stages),
                                                 td.PP_DEPTH)), 0, 0, col)
    # the placements: Shard(0) over 'stage' exactly where jaxlsq puts P('stage')
    stacked = {c: jstack(n, td.PP_DEPTH, stages) for c, n in tree.items()}
    jsh = jpipeline_sharding(jpipeline_mesh(stage=stages), stacked)
    want = {"/".join(getattr(k, "key", str(k)) for k in path): tuple(s.spec)[:1] == ("stage",)
            for path, s in jax.tree_util.tree_flatten_with_path(jsh)[0]}

    class Mesh:
        mesh_dim_names = ("data", "stage")

    got = pipeline_sharding(Mesh(), stacked)
    assert set(got) == set(want)
    for k, split in want.items():
        assert got[k] == ((Replicate(), Shard(0)) if split else (Replicate(), Replicate())), k


@pytest.mark.parametrize("case", sorted(td.PP_CASES))
def test_pipeline_step_equals_jaxlsq(ranks, case):
    want = jax_pipeline("learning", case)
    res = ranks.results()
    assert_matches_jaxlsq(res[0][("run", case)], *want[:2])
    # the loss and the gathered LM are the same on every rank
    for r in res[1:]:
        assert r[("run", case)]["losses"] == res[0][("run", case)]["losses"]
        assert_tree_close(r[("run", case)]["gathered"], res[0][("run", case)]["gathered"],
                          0, 0)


def test_traced_step_equals_jaxlsq(ranks):
    assert_matches_jaxlsq(ranks.results()[0]["traced"], *jax_pipeline("learning", "learned")[:2])


def test_errors_match_jaxlsq(ranks):
    errs = ranks.results()[0]["errors"]
    tx = optax.sgd(td.PP_LR)

    def jerr(fn):
        try:
            fn()
        except Exception as e:
            return type(e).__name__, str(e)
        return None

    mesh = jpipeline_mesh(stage=WORLD)
    assert errs["depth"] == jerr(lambda: jmake_pipeline_train_step(
        pp_jmodel("learning", depth=6), tx, mesh, num_microbatches=2))
    assert errs["microbatches"] == jerr(lambda: jmake_pipeline_train_step(
        pp_jmodel("learning"), tx, mesh, num_microbatches=0))
    assert errs["moe"] == jerr(lambda: jmake_pipeline_train_step(
        pp_jmodel("learning", moe_experts=4), tx, mesh, num_microbatches=2))
    assert errs["mesh"] == jerr(lambda: jpipeline_mesh(stage=WORLD, data=2,
                                                       devices=jax.devices()[:WORLD]))
    jm, jmesh, state = jax_pipeline_state("learning", "learned", 1, WORLD, tx)
    step = jmake_pipeline_train_step(jm, tx, jmesh, num_microbatches=3, donate=False)
    toks = jnp.asarray(td.pp_batches(1, 1)[0])
    assert errs["batch"] == jerr(lambda: step(state, {"input": toks, "label": toks}))
    # with no card, no device named: the stage is not silently put on the CPU
    assert errs["device"][0] == "RuntimeError" and "device='cpu'" in errs["device"][1]
    # refused here, dropped silently by jaxlsq (ROADMAP §C)
    assert errs["window"][0] == errs["flash"][0] == "ValueError"
    assert "attn_window=4" in errs["window"][1] and "'flash'" in errs["flash"][1]


def test_remat_is_bit_equal(ranks):
    for r in ranks.results():
        assert r["remat"]["losses"] == r[("run", "learned")]["losses"]
        assert_tree_close(r["remat"]["stage"], r[("run", "learned")]["stage"], 0, 0)


def test_sends_and_the_stage_share(ranks):
    res = [r[("run", "learned")] for r in ranks.results()]
    for step in range(td.PP_STEPS):
        sends = sum(r["p2p"][step][0] for r in res)
        recvs = sum(r["p2p"][step][1] for r in res)
        assert sends == recvs == 2 * (WORLD - 1) * td.PP_MB
    assert [r["blocks"] for r in res] == [[s] for s in range(WORLD)]
    full = sum(p.numel() * p.element_size() for p in td.pp_model("learning").parameters())
    for r in res:
        assert set(k for k in r["stage"]["params"] if k.startswith("block")) == {
            f"block{r['blocks'][0]}"}
        assert r["bytes"] < full


def test_checkpoint_round_trip(ranks):
    for r in ranks.results():
        ck = r["checkpoint"]
        assert ck["leaves"] > 0 and not ck["unequal_restored"]
        assert ck["losses"][0] == ck["losses"][1] and not ck["unequal_after"]
