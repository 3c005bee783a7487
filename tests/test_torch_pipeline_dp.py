"""The port's pipeline step over a 'data' axis and across the observer
window, against jaxlsq's ``make_pipeline_train_step`` on four gloo ranks
(``tests/_torch_dist.py``'s ``leg_pipeline_dp``), at the sizes of jaxlsq's
``tests/test_pipeline.py``:

* (data 1, stage 4) with ``init_batches=1``, three steps, eager and in the
  traced regime: the window closes between the first step's microbatches,
  and the second microbatch's scale gradients wait for the next step as in
  jaxlsq (``pipeline.py:29-35``); held to jaxlsq's pipeline at the
  learning-mode tolerances;
* (data 2, stage 2) in learning mode with the activation quantizers'
  gradient scale pinned to the global microbatch (jaxlsq's
  ``test_pipeline_with_data_parallelism``), two steps;
* (data 2, stage 2) with the observers on (``init_batches=3``), two steps:
  the observer state averaged over 'data' as jaxlsq's, and bit-equal on
  the two replicas of each stage;
* the window run's gathered LM converted at w8 and served (static
  activations): ``make_generate``'s greedy tokens equal to jaxlsq's served
  tokens from its own pipeline state;
* ``lab.parallel_qat`` (``examples/parallel_qat.py``'s EP and PP flows)
  runs on the four ranks.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist as td
from _torch_mesh import assert_matches_jaxlsq, assert_tree_close, jax_pipeline, pp_jmodel
from jaxlsq.serve import convert as jconvert
from jaxlsq.serve import make_generate as jmake_generate

WORLD = td.PP_WORLD


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return td.Ranks("pipeline_dp", WORLD, str(tmp_path_factory.mktemp("pipeline_dp")))


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "traced"])
def test_window_transition_equals_jaxlsq(ranks, jit):
    want = jax_pipeline("window", "learned", 1, WORLD, td.PP_STEPS, 13)
    res = [r[("window", jit)] for r in ranks.results()]
    assert_matches_jaxlsq(res[0], *want[:2])
    for r in res[1:]:  # every rank reports the loss and gathers the same LM
        assert r["losses"] == res[0]["losses"]
        assert_tree_close(r["gathered"], res[0]["gathered"], 0, 0)


def test_data_and_stage_equal_jaxlsq_with_pinned_grad_scale(ranks):
    want = jax_pipeline("pinned", "learned", 2, 2, 2, 15)
    res = ranks.results()
    for r in res:
        assert_matches_jaxlsq(r["pinned"], *want[:2])
        assert r["pinned"]["p2p"] == [(td.PP_MB, td.PP_MB)] * 2


def test_data_and_stage_observers_averaged_as_jaxlsq(ranks):
    want = jax_pipeline("observers", "learned", 2, 2, 2, 16)
    res = ranks.results()
    assert_matches_jaxlsq(res[0]["observers"], *want[:2])
    by = {r["coords"]: r["observers"]["stage"] for r in res}
    for s in range(2):
        # the two data replicas of stage s hold the same bits, observer
        # state and qparams included
        assert_tree_close(by[(1, s)], by[(0, s)], 0, 0, f"stage {s}")


def test_gathered_state_serves_jaxlsq_tokens(ranks):
    _, _, raw = jax_pipeline("window", "learned", 1, WORLD, td.PP_STEPS, 13)
    jm = pp_jmodel("window")
    qc = jm.qconfig
    sm = dataclasses.replace(jm, qconfig=qc.for_serving("static", "xla"))
    prompt = td.pp_batches(14, 1)[0][:2, :td.PP_PROMPT]
    want = np.asarray(jmake_generate(sm, td.PP_PROMPT, td.PP_NEW)(
        jconvert(raw, qc), jnp.asarray(prompt)))
    for r in ranks.results():
        np.testing.assert_array_equal(r["tokens"], want)


def test_lab_parallel_qat_runs_on_four_ranks(ranks):
    """``lab.parallel_qat`` (``examples/parallel_qat.py``'s flows) on the four
    ranks: EP over a (data 1, expert 4) mesh, then PP over (data 1, stage
    4); every rank decodes the same int8 tokens and gathers the same LM."""
    res = [r["lab"] for r in ranks.results()]
    for r in res:
        assert r["ep"].shape == (2, 8) and r["pp"].shape == (2, 32, 128)
        assert np.isfinite(r["pp"]).all()
        np.testing.assert_array_equal(r["ep"], res[0]["ep"])
        np.testing.assert_array_equal(r["pp"], res[0]["pp"])
