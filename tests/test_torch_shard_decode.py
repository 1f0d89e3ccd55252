"""``ops/decode.shard_decode_attention`` (B4/B5 over the ``model`` axis)
in the port ≡ the JAX package's ``shard_decode_attention(mesh,
impl="reference")``, on the CPU.

The same seeded queries and fp32 or int8 caches (``quantize_kv``'s
scales, sharded with their heads) go through JAX's ``shard_map`` island
on the first ``tp`` CPU devices and through the port's function on every
rank of an in-process world (``runtime/dist.ThreadWorld``), each rank
taking its KV-head group and gathering the heads: every rank's output
equals JAX's (atol 1e-5). Where ``H_kv`` does not divide ``tp`` both take
one whole call (the port counts it). An off-by-one head offset must
fail.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.ops import decode as jdec
from ddp_tpu.runtime.mesh import MeshSpec, make_mesh
from ddp_tpu_torch.ops import decode as tdec
from ddp_tpu_torch.runtime.dist import ThreadWorld
from ddp_tpu_torch.runtime.mesh import mesh_sizes, thread_mesh

ATOL = 1e-5
S, H, DH, L = 3, 8, 16, 24


def _inputs(kv_heads, int8, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, H, DH)).astype(np.float32)
    k = rng.standard_normal((S, L, kv_heads, DH)).astype(np.float32)
    v = rng.standard_normal((S, L, kv_heads, DH)).astype(np.float32)
    pos = np.array([L - 1, 5, 11], np.int32)
    if not int8:
        return q, k, v, pos, None, None
    kq, ks = tdec.quantize_kv(torch.from_numpy(k))
    vq, vs = tdec.quantize_kv(torch.from_numpy(v))
    return q, kq.numpy(), vq.numpy(), pos, ks.numpy(), vs.numpy()


def _jax(tp, args):
    mesh = make_mesh(MeshSpec(data=1, model=tp), devices=jax.devices()[:tp])
    fn = jdec.shard_decode_attention(mesh, impl="reference")
    q, k, v, pos, ks, vs = (None if a is None else jnp.asarray(a)
                            for a in args)
    return np.asarray(fn(q, k, v, pos, ks, vs))


def _port(tp, args):
    tw = ThreadWorld(tp, timeout=60)
    sizes = mesh_sizes(tp, model=tp)

    def body(r):
        fn = tdec.shard_decode_attention(thread_mesh(sizes, tw, r))
        t = [None if a is None else torch.from_numpy(a) for a in args]
        return fn(*t).numpy()

    return tw.run(body)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("tp,kv_heads", [(2, 8), (4, 8), (2, 2), (4, 2)])
def test_shard_decode_equals_jax(tp, kv_heads, int8):
    args = _inputs(kv_heads, int8)
    want = _jax(tp, args)
    whole = tdec.shard_decode_attention.whole
    got = _port(tp, args)
    for out in got:
        np.testing.assert_allclose(out, want, atol=ATOL)
    # H_kv 2 at model 4: JAX's whole-head call, once on every rank.
    assert tdec.shard_decode_attention.whole - whole == \
        (tp if kv_heads % tp else 0)


def test_an_off_by_one_head_offset_fails(monkeypatch):
    args = _inputs(8, False)
    want = _jax(2, args)
    monkeypatch.setattr(tdec, "SHARD_FAULT", "offset")
    got = _port(2, args)
    assert np.abs(got[0] - want).max() > 1e-2
