"""The port's tensor-parallel serving (``serve.shard_packed``,
``serve.shard_converted``) against the JAX package's placement and the
port's unsharded serving, on four gloo ranks (``tests/_torch_dist.py``'s
``leg_tp``).

The model is a seeded QAT ``QuantTransformerLM`` (vocab 64, d 32, two
blocks, four heads) converted at w8, w4 and group-wise int4 (groups of 16),
served under ``'none'``, ``'static'`` and (w8) ``'static_int8'``.

* Each rank's part of every pack under ``shard_converted`` over a (1, 4)
  mesh equals byte for byte the ``addressable_shards`` entry that jaxlsq's
  ``shard_converted`` (on the same converted tree as jaxlsq
  ``PackedWeight``s, over a (1, 4) mesh of its virtual CPU devices) puts on
  device r: the column slices with their per-channel or (G, N) group
  scales; the embedding table whole.
* At degree 2 and 4 the forward, one decode step at a per-slot (B,) index
  into f32 and int8 caches, and into a paged int8 cache with and without a
  window lie within 1e-5 of the unsharded model's
  (``tests/test_distributed.py:65``), and ``make_generate``'s greedy tokens
  are equal.
* The collectives (the counterpart of ``tests/test_tp_hlo.py``): a forward
  issues one all-gather a packed dense layer (nine), the same at degree 2
  and 4, and nothing else; a counting wrapper around
  ``torch.distributed.all_gather_into_tensor`` sees only f32 activations
  gathered, never a pack's storage.
* A grouped int4 weight under ``shard_packed``: each rank holds N / 4
  columns, and the gathered products equal the unsharded one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist as td
from _torch_mesh import get_leaf
from jaxlsq.parallel import make_mesh as jmake_mesh
from jaxlsq.serve import shard_converted as jshard_converted
from jaxlsq.serve.pack import PackedWeight as JPackedWeight
from jaxlsq_torch.serve import PackedWeight

WORLD = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return td.Ranks("tp", WORLD, str(tmp_path_factory.mktemp("tp")))


def _jax_tree(tree):
    """The port's converted tree with each pack a jaxlsq ``PackedWeight``."""
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if isinstance(tree, PackedWeight):
        return JPackedWeight(
            data=jnp.asarray(tree.data.numpy()), scale=jnp.asarray(tree.scale.numpy()),
            zero_point=jnp.asarray(tree.zero_point.numpy()), bits=tree.bits, axis=tree.axis,
            k_axis=tree.k_axis, orig_shape=tuple(tree.orig_shape),
            group_size=tree.group_size)
    return jnp.asarray(tree.numpy())


@pytest.fixture(scope="module")
def jax_shards(ranks):
    """jaxlsq's ``shard_converted`` of the port's converted trees (the packs
    themselves are held against jaxlsq's ``convert`` by the serving tests),
    computed while the ranks run."""
    mesh = jmake_mesh(data=1, model=WORLD, devices=jax.devices()[:WORLD])
    return {name: (mesh, jshard_converted(_jax_tree(td.tp_tree(name)[2]), mesh))
            for name in td.TP_CONFIGS}


@pytest.mark.parametrize("name", list(td.TP_CONFIGS))
def test_rank_packs_equal_jaxlsq_addressable_shards(ranks, jax_shards, name):
    mesh, placed = jax_shards[name]
    for rank, out in enumerate(ranks.results()):
        dev = mesh.devices.flat[rank]
        packs = out[("packs", name)]
        assert len(packs) == 10
        for module, fields in packs.items():
            path = ("quantized",) + tuple(module.split(".")) + (
                "embedding" if module == "tok_emb" else "kernel",)
            jp = get_leaf(placed, path)
            for f, local in fields.items():
                (shard,) = [s for s in getattr(jp, f).addressable_shards if s.device == dev]
                np.testing.assert_array_equal(local, np.asarray(shard.data),
                                              err_msg=f"rank {rank} {module}.{f}")
        # the column-parallel packs hold a quarter of N, the table all of it
        assert packs["lm_head"]["data"].shape[-1] == 64 // WORLD
        assert packs["tok_emb"]["data"].shape == (64, 32)


def _cases():
    for name in td.TP_CONFIGS:
        for act in (("none", "static", "static_int8") if name == "w8" else ("none", "static")):
            yield name, act


@pytest.mark.parametrize("name,act", list(_cases()))
def test_tp_serving_equals_unsharded(ranks, name, act):
    for out in ranks.results():
        res = out[("tp", name, act)]
        ref = res[1]
        for deg in (2, 4):
            got = res[deg]
            np.testing.assert_allclose(got["logits"].numpy(), ref["logits"].numpy(),
                                       rtol=0, atol=1e-5)
            np.testing.assert_array_equal(got["tokens"].numpy(), ref["tokens"].numpy())
            assert set(got["steps"]) == set(ref["steps"]) and len(ref["steps"]) == 4
            for k, v in ref["steps"].items():
                np.testing.assert_allclose(got["steps"][k].numpy(), v.numpy(), rtol=0,
                                           atol=1e-5, err_msg=str(k))
            assert got["counts"] == {"all_gather": 9}, got["counts"]
            # only float activations are gathered, never a pack
            assert all(d == "torch.float32" and not pack
                       for d, _, pack in got["gathered"]), got["gathered"]
        assert ref["counts"] == {}


def test_grouped_int4_shard_packed(ranks):
    for out in ranks.results():
        g = out["grouped"]
        assert g["local_cols"] == 32
        np.testing.assert_allclose(g["got"], g["want"], rtol=0, atol=1e-5)


def test_rule_keeps_whole_what_it_cannot_split(ranks):
    """jaxlsq's rule keeps an N the axis does not divide and an embedding
    table whole; the port also keeps a depthwise (grouped) convolution's
    pack whole (deviation 62), and splits a plain convolution's."""
    for out in ranks.results():
        assert out["tp_whole"] == {"dense_n6": True, "depthwise": True, "conv": False,
                                   "embed": True}
