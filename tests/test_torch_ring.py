"""The multi-rank ring and Ulysses of ``ddp_tpu_torch.parallel.ring`` ≡
the JAX package's under ``shard_map``, on the CPU.

JAX runs ``ring_attention`` / ``ulysses_attention`` over the first n of
the 8 CPU devices (``tests/conftest.py``), tokens on ``seq``; the port
runs an in-process world of n ranks (``runtime/dist.ThreadWorld``), each
its token slice of the same numpy inputs. Compared: the output and
dq/dk/dv (the vjp of a seeded cotangent), at the shapes of
``tests/test_ring.py`` (ring [2, 64, 3, 8] over 8, Ulysses [2, 32, 4, 8]
over 4), causal and not, atol 2e-5 as there. Also: the block calls per
rank (the causal skip: rank + 1 calls, n without it), the causal ring's
backward finishing at 2, 4 and 8 ranks inside a timeout (a barrier that
waits longer fails the run), a ring that drops hop 1 failing the
comparison, and Ulysses refusing heads that do not divide.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from ddp_tpu.parallel import ring as jring
from ddp_tpu_torch.parallel import ring as tring
from ddp_tpu_torch.runtime.dist import ThreadWorld

ATOL = 2e-5
TIMEOUT = 30.0  # seconds a rank may wait at one exchange


def _inputs(B, T, H, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, D)).astype(np.float32)
            for _ in range(4)]  # q, k, v and the output's cotangent


def _jax(fn, n, q, k, v, go):
    """``fn`` under shard_map over n devices, tokens on ``seq`` → (out,
    dq, dk, dv) as numpy."""
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("seq",))
    spec = P(None, "seq")
    sharded = jax.shard_map(fn, mesh=mesh, in_specs=(spec,) * 3,
                            out_specs=spec, check_vma=False)

    @jax.jit
    def run(q, k, v, go):
        out, vjp = jax.vjp(sharded, q, k, v)
        return (out, *vjp(go))

    return [np.asarray(a) for a in run(*map(jnp.asarray, (q, k, v, go)))]


def _port(fn, n, q, k, v, go, timeout=TIMEOUT):
    """``fn(q, k, v, comm)`` on every rank of a thread world of n, each its
    token slice → (out, dq, dk, dv) gathered over the ranks, as numpy."""
    world = ThreadWorld(n, timeout=timeout)
    T = q.shape[1]

    def body(r):
        comm = world.comm(range(n), r)
        sl = slice(r * T // n, (r + 1) * T // n)
        a, b, c = (torch.tensor(x[:, sl], requires_grad=True)
                   for x in (q, k, v))
        out = fn(a, b, c, comm)
        out.backward(torch.tensor(go[:, sl]))
        return out.detach(), a.grad, b.grad, c.grad

    per_rank = world.run(body)
    return [torch.cat([r[i] for r in per_rank], 1).numpy() for i in range(4)]


CASES = [
    ("ring", False, 8, (2, 64, 3, 8), 0),  # test_ring_matches_dense_8way
    ("ring", True, 8, (2, 64, 3, 8), 6),  # TestCausal::..._causal_..._8way
    ("ring", True, 2, (2, 64, 3, 8), 6),
    ("ring", True, 4, (2, 64, 3, 8), 6),
    ("ring", False, 4, (2, 64, 3, 8), 1),
    ("ulysses", True, 4, (2, 32, 4, 8), 7),  # ..._ulysses_causal_...
    ("ulysses", False, 4, (2, 32, 4, 8), 2),  # test_ulysses_matches_dense
]


@pytest.mark.parametrize("strategy,causal,n,shape,seed", CASES,
                         ids=[f"{s}-{'causal' if c else 'full'}-{n}way"
                              for s, c, n, _, _ in CASES])
def test_sharded_attention_and_grads_equal_jax(strategy, causal, n, shape,
                                               seed):
    """Output and dq/dk/dv of the port's ring or Ulysses over n ranks
    within 2e-5 of JAX's under shard_map over n devices."""
    q, k, v, go = _inputs(*shape, seed)
    jfn = {"ring": jring.ring_attention,
           "ulysses": jring.ulysses_attention}[strategy]
    want = _jax(functools.partial(jfn, causal=causal), n, q, k, v, go)
    got = _port(lambda a, b, c, comm: tring.sequence_sharded_attention(
        a, b, c, strategy=strategy, causal=causal, comm=comm), n, q, k, v, go)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_block_calls_per_rank_skip_future_hops(causal):
    """Rank r runs its block r + 1 times under ``causal`` (hop 0 and the
    r past blocks; the future hops exchange but compute nothing) and n
    times without, forward and backward alike."""
    n = 4
    q, k, v, go = _inputs(1, 16, 2, 8, 3)
    calls = {"fwd": [0] * n, "bwd": [0] * n}

    def body(a, b, c, comm):
        def fwd(*args):
            calls["fwd"][comm.rank] += 1
            return tring.default_block_fn(*args)

        def bwd(*args):
            calls["bwd"][comm.rank] += 1
            return tring.default_block_bwd(*args)

        return tring.ring_attention(a, b, c, causal=causal, comm=comm,
                                    block_fn=fwd, block_bwd=bwd)

    _port(body, n, q, k, v, go)
    want = [r + 1 for r in range(n)] if causal else [n] * n
    assert calls == {"fwd": want, "bwd": want}


@pytest.mark.parametrize("n", [2, 4, 8])
def test_causal_ring_backward_finishes(n):
    """The causal ring's backward completes at 2, 4 and 8 ranks inside
    the timeout (rank 0 skips every future hop, yet runs every exchange
    of the backward: a hang would break the barrier and fail here) and
    equals the dense attention's gradients."""
    q, k, v, go = _inputs(1, 32, 2, 8, 4)
    got = _port(lambda a, b, c, comm: tring.ring_attention(
        a, b, c, causal=True, comm=comm), n, q, k, v, go, timeout=10.0)
    tensors = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    from ddp_tpu_torch.ops.attention import dot_product_attention

    out = dot_product_attention(*tensors, causal=True)
    out.backward(torch.tensor(go))
    for g, w in zip(got, [out.detach()] + [t.grad for t in tensors]):
        np.testing.assert_allclose(g, w.numpy(), atol=ATOL)


def test_ring_that_drops_hop_1_fails():
    """A ring whose second block is dropped (its partial never merged:
    out 0, lse −inf) leaves the output outside the limit."""
    q, k, v, go = _inputs(2, 64, 3, 8, 6)
    want = _jax(functools.partial(jring.ring_attention, causal=True), 8,
                q, k, v, go)

    def body(a, b, c, comm):
        seen = [0]

        def fwd(qb, kb, vb, causal):
            seen[0] += 1
            out, lse = tring.default_block_fn(qb, kb, vb, causal)
            if seen[0] == 2:  # hop 1
                return torch.zeros_like(out), torch.full_like(lse, -np.inf)
            return out, lse

        return tring.ring_attention(a, b, c, causal=True, comm=comm,
                                    block_fn=fwd)

    got = _port(body, 8, q, k, v, go)
    assert np.abs(got[0] - want[0]).max() > ATOL


def test_ulysses_refuses_indivisible_heads():
    """3 heads over a seq group of 4 are refused, as JAX's
    ``ulysses_attention`` refuses them."""
    q, k, v, go = _inputs(1, 16, 3, 4, 0)
    with pytest.raises(ValueError, match="not divisible"):
        _port(lambda a, b, c, comm: tring.ulysses_attention(a, b, c,
                                                            comm=comm),
              4, q, k, v, go)
