"""The port's collectives (`ray_tpu_torch.parallel.collective`) and its
ring and Ulysses attention (`ray_tpu_torch.ops.ring_attention`) in one
spawned gang of 4 gloo processes (`_torch_gang.sequence_ops`), held to
the JAX package's on the same inputs under `shard_map` over 2 and 4 of
the 8 virtual CPU devices (`tests/conftest.py`), in f32: outputs and
gradients.

The gradients pin the port's convention: every rank seeds the backward
of its own objective and the group's objectives add up, which is the
JAX objective psum(local objective) with out_specs P(). Mirrors
`tests/test_ops.py` (ring and Ulysses against full attention, causal
and not) and the collectives of `ray_tpu/parallel/collective.py`."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

from ray_tpu.ops.ring_attention import ring_attention, ulysses_attention
from ray_tpu.parallel import collective as C
from ray_tpu_torch.train import run_local_gang

import _torch_gang
from _torch_gang import COLLECTIVE_CASES, weights
from _torch_port import isolated_module  # noqa: F401 (autouse fixture)

#: f32 on both sides; the ring's online softmax and JAX's sum in other
#: orders.
ATOL = 1e-5
GANG_TIMEOUT = 150
SIZES = (2, 4)


def _mesh(n, name):
    return Mesh(np.array(jax.devices()[:n]), (name,))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 4, 6)).astype(np.float32)
    qkv = [rng.standard_normal((1, 4, 32, 8)).astype(np.float32)
           for _ in range(3)]
    do = rng.standard_normal((1, 4, 32, 8)).astype(np.float32)
    return x, qkv, do


@pytest.fixture(scope="module")
def port(inputs):
    """Rank 0's results (rank 0 is in both a group of 2 and of 4)."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    return run_local_gang(_torch_gang.sequence_ops, 4, inputs, device="cpu",
                          timeout=GANG_TIMEOUT)


def _jax_collective(name, op, x):
    if name.startswith("allreduce"):
        return C.allreduce(x, "i", op)
    if name == "allgather":
        return C.allgather(x, "i", concat_axis=1)
    if name.startswith("reducescatter"):
        return C.reducescatter(x, "i", scatter_axis=0, op=op)
    if name == "broadcast":
        return C.broadcast(x, "i", root=1)
    if name == "send_recv":
        return C.send_recv(x, "i", shift=1)
    return C.all_to_all(x, "i", split_axis=0, concat_axis=1)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("salt", range(len(COLLECTIVE_CASES)),
                         ids=[c[0] for c in COLLECTIVE_CASES])
def test_collective_and_its_gradient_match_jax(inputs, port, salt, n):
    name, op, shape = COLLECTIVE_CASES[salt]
    x = inputs[0][:n]
    w = np.concatenate([weights(shape(n), r, salt) for r in range(n)])

    def objective(x, w):
        y = _jax_collective(name, op, x)
        return lax.psum(jnp.sum(y * w), "i"), y

    run = shard_map(objective, mesh=_mesh(n, "i"), in_specs=(P("i"), P("i")),
                    out_specs=(P(), P("i")))
    (_, want), grad = jax.jit(jax.value_and_grad(
        lambda x: run(x.reshape(n * 4, 6), w), has_aux=True))(
            jnp.asarray(x))
    rows = want.shape[0] // n
    grad = np.asarray(grad)
    for r in range(n):
        got, got_grad = port[r][(name, n)]
        np.testing.assert_allclose(got, np.asarray(want)[r * rows:(r + 1) * rows],
                                   rtol=0, atol=ATOL)
        np.testing.assert_allclose(got_grad, grad[r], rtol=0, atol=ATOL)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("op", ["max", "min"])
def test_allreduce_max_min_match_jax_and_have_no_gradient(inputs, port, op,
                                                          n):
    """As `lax.pmax`/`lax.pmin`, which JAX cannot differentiate."""
    x = inputs[0][:n]
    run = shard_map(lambda x: C.allreduce(x, "i", op), mesh=_mesh(n, "i"),
                    in_specs=P("i"), out_specs=P("i"))
    want = np.asarray(jax.jit(run)(jnp.asarray(x.reshape(n * 4, 6))))[:4]
    got, raised = port[0][(f"allreduce_{op}", n)]
    np.testing.assert_array_equal(got, want)
    assert raised


@pytest.mark.timeout(300)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", ["ring_attention", "ulysses_attention"])
def test_sequence_parallel_attention_matches_jax(inputs, port, kind, causal,
                                                 n):
    """Outputs and q/k/v gradients of every rank's shard within ATOL of
    JAX's (the full attention, `mha_reference`, is JAX's own
    reference for both in `tests/test_ops.py`)."""
    _, qkv, do = inputs
    fn = {"ring_attention": ring_attention,
          "ulysses_attention": ulysses_attention}[kind]
    spec = P(None, None, "sp", None)
    sharded = shard_map(partial(fn, axis_name="sp", causal=causal),
                        mesh=_mesh(n, "sp"), in_specs=spec, out_specs=spec,
                        check_vma=False)

    def objective(q, k, v):
        out = sharded(q, k, v)
        return jnp.sum(out * do), out

    (_, want), grads = jax.jit(jax.value_and_grad(
        objective, argnums=(0, 1, 2), has_aux=True))(*map(jnp.asarray, qkv))
    t = 32 // n
    for r in range(n):
        got, got_grads = port[r][(kind, causal, n)]
        shard = slice(r * t, (r + 1) * t)
        np.testing.assert_allclose(got, np.asarray(want)[:, :, shard],
                                   rtol=0, atol=ATOL)
        for g, w in zip(got_grads, grads):
            np.testing.assert_allclose(g, np.asarray(w)[:, :, shard], rtol=0,
                                       atol=ATOL)
