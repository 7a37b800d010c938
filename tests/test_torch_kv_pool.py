"""The port's KV pool transfers of the gather plane against the reference's
``KVBlockPool.gather_into`` / ``scatter_from``, bit for bit, on a cache
tree shaped as gemma2's: a rolling-window (L) leaf 8 slots wide beside a
global (G) leaf 32 wide, under a layer-stack axis. Publishing a 4-block
chain out of the L leaf reads clamped blocks (the reference's
``dynamic_slice`` clamps the start so the block fits), and the pool must
hold exactly what the reference's holds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve.kv_pool import KVBlockPool as JaxPool  # noqa: E402
from repro_torch.models import tree_paths  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.serve import KVBlockPool  # noqa: E402

BT, NB, B = 4, 9, 3
SHAPES = {"stack": {"0_L": {"k": (2, B, 8, 2, 4), "v": (2, B, 8, 2, 4)},
                    "1_G": {"k": (2, B, 32, 2, 4), "v": (2, B, 32, 2, 4)}},
          "tail_0_L": {"k": (B, 8, 1, 8), "v": (B, 8, 1, 8)}}


def _pools():
    jpool = JaxPool(tree_map(lambda s: jnp.zeros(s, jnp.float32), SHAPES),
                    BT, NB)
    tpool = KVBlockPool(tree_map(lambda s: torch.empty(s, device="meta"),
                                 SHAPES), BT, NB, "cpu")
    return jpool, tpool


def _same(tpool, jbuffers):
    ref = dict(tree_paths(jax.device_get(jbuffers)))
    for path, t in tree_paths(tpool.buffers):
        np.testing.assert_array_equal(t.numpy(), np.asarray(ref[path]),
                                      err_msg=str(path))


def test_scatter_from_matches_reference_with_clamped_blocks():
    rng = np.random.default_rng(0)
    cache = tree_map(lambda s: rng.normal(size=s).astype(np.float32), SHAPES)
    jpool, tpool = _pools()
    for slot, positions, rows in ((1, [0, 1, 2, 3], [5, 2, 7, 0]),
                                  (2, [3, 7], [1, 8])):
        jpool.scatter_from(tree_map(jnp.asarray, cache), slot, positions,
                           rows)
        tpool.scatter_from(tree_map(torch.from_numpy, cache), slot,
                           positions, rows)
        _same(tpool, jpool.buffers)
    # the L leaf's late blocks are its first BT slots (start clamped to 4)
    got = tpool.buffers["stack"]["0_L"]["k"]
    want = torch.from_numpy(cache["stack"]["0_L"]["k"][:, 1, 4:8])
    assert torch.equal(got[:, 7], want) and torch.equal(got[:, 0], want)


def test_gather_into_matches_reference():
    rng = np.random.default_rng(1)
    jpool, tpool = _pools()
    pool = tree_map(lambda t: rng.normal(size=t.shape).astype(np.float32),
                    tpool.buffers)
    jpool.buffers = tree_map(jnp.asarray, pool)
    tpool.buffers = tree_map(torch.from_numpy, pool)
    cache = tree_map(lambda s: rng.normal(size=s).astype(np.float32), SHAPES)
    tcache = tree_map(lambda a: torch.from_numpy(a.copy()), cache)
    ref = jpool.gather_into(tree_map(jnp.asarray, cache), 2, [6, 3])
    out = tpool.gather_into(tcache, 2, [6, 3])
    assert out is tcache                        # restored in place
    want = dict(tree_paths(jax.device_get(ref)))
    for path, t in tree_paths(out):
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[path]),
                                      err_msg=str(path))
