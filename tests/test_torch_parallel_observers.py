"""The port's data-parallel QAT step under every activation observer
against the JAX package's one-device step on the global batch, on four gloo
ranks (``tests/_torch_dist.py``'s ``leg_observers``).

A ``QuantMLP`` (16 -> 32 -> 4, w8a8, a 2-batch observer window, SGD
momentum 0.9) takes four steps of 16 rows (4 a rank): the window and LSQ
after it, under each activation observer (the running min/max, the moving
average, MSE, percentile, histogram), eager (``jit=False``) and traced
(``jit=True``; on the CPU uncaptured).  The reference is jaxlsq's jitted
``make_train_step`` without a mesh on the global batch, from the port's
initial state carried across.  The loss within 1e-5
(``tests/test_parallel.py:112-121``), every leaf within 2e-5 of its largest
magnitude, counters, flags and observer counts equal, on every rank.

The collectives of a DP step (the counterpart of
``tests/test_parallel_hlo.py``) are counted on the moving-average runs.
"""

import numpy as np
import pytest

import _torch_dist as td
from _torch_mesh import assert_trees_close, jax_mlp_run, port_variables

WORLD = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return td.Ranks("observers", WORLD, str(tmp_path_factory.mktemp("observers")))


@pytest.fixture(scope="module")
def refs(ranks):
    """jaxlsq's trajectories, computed while the ranks run."""
    return {obs: jax_mlp_run(obs) for obs in td.OBSERVERS}


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "traced"])
@pytest.mark.parametrize("obs", td.OBSERVERS)
def test_dp_step_equals_jaxlsq_global_batch_step(ranks, refs, obs, jit):
    model, want_losses, want = refs[obs]
    for rank, out in enumerate(ranks.results()):
        got = out[("mlp", obs, jit)]
        np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
        assert_trees_close(port_variables(model, got["state"]), want, where=f"rank {rank}")


def test_dp_step_collectives(ranks, refs):
    """In the window (steps 1-2): 2 quantizers x (min, max), one flat
    gradient all-reduce and one loss all-reduce per mesh axis (2).  After
    it the eager step runs no observer (only the last four); the traced
    step still runs the min/max update, where-merged away (its device
    flags decide), so it issues the same eight every step."""
    counts = ranks.results()[0][("mlp", "minmax", False)]["counts"]
    assert counts == [{"all_reduce": 8}] * td.MLP_WINDOW + [
        {"all_reduce": 4}] * (td.MLP_STEPS - td.MLP_WINDOW), counts
    counts = ranks.results()[0][("mlp", "minmax", True)]["counts"]
    assert counts == [{"all_reduce": 8}] * td.MLP_STEPS, counts
