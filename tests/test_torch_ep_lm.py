"""Expert parallelism (``--mesh_expert``) of the routed causal LM in the
port ≡ the JAX package on the same mesh, on the CPU.

The routed LM (one routed block: 4 experts, top-2; GQA with 2 kv
heads) at ``--mesh_expert 2`` (and × ``--mesh_model 2``): JAX's sharded
forward and token metrics with the weighted aux loss under
``jax.value_and_grad`` over 2 (4) CPU devices, then the optimizer's
update; the port's mesh step in an in-process world, each rank holding
E/ep experts and its data replica's rows (``expert`` is a data axis).
The routing is compared exactly: each rank's kept (token, expert) pairs
against JAX's ``MoEMLP`` on the same tokens (read through a probe whose
experts emit unit vectors), capacity counted on the rank's own tokens;
the rest within tests/test_torch_tp.py's limits (loss and norm rtol
1e-5, gradients 1e-5 of each leaf's scale, parameters atol 2e-5). An
all-to-all that sends each slot block to the wrong owner must fail.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.models import moe as jmoe
from ddp_tpu_torch.interop.jax_params import lm_params_to_jax
from ddp_tpu_torch.models import lm as tlm
from ddp_tpu_torch.models import moe as tmoe
from ddp_tpu_torch.parallel import tp as ttp
from ddp_tpu_torch.runtime.mesh import mesh_sizes
from test_torch_tp import _assert_close, _port_step, jax_lm_step

LM = dict(vocab_size=32, total_len=16, d_model=32, depth=1, num_heads=4,
          num_kv_heads=2, num_experts=4, moe_every=1)
E = LM["num_experts"]


def _case(world, expert, model=1, *, misroute=False, monkeypatch=None):
    spec = tlm.LMSpec(**LM)
    state, tokens, tree, jm, jgrads, jparams = jax_lm_step(
        tuple(sorted(LM.items())), world, model, expert=expert)
    B = len(tokens)

    routed, held = {}, {}
    real_route = tmoe.route

    local = threading.local()  # each rank thread's own rank

    def spy(tokens_, *a, **kw):
        r = real_route(tokens_, *a, **kw)
        routed.setdefault(local.rank, (tokens_.detach().clone(), r))
        return r

    if misroute:
        real_a2a = tmoe.all_to_all

        def wrong_owner(x, comm, split_dim, concat_dim):
            # Every block of slots one member along: owner r gets r-1's.
            step_ = x.shape[split_dim] // comm.size
            return real_a2a(torch.roll(x, step_, split_dim), comm,
                            split_dim, concat_dim)

        monkeypatch.setattr(tmoe, "all_to_all", wrong_owner)
    tmoe.route = spy

    def build(st, m):
        model_ = tlm.CausalLM.from_state(spec, st, "cpu", trainable=True)
        ttp.shard_module(model_, m)
        held[m.rank] = model_.block1.moe.wi.shape[0]
        return model_

    def rows(m):
        local.rank = m.rank
        per = B // m.data_size
        return (torch.from_numpy(tokens[m.data_rank * per:][:per]).long(),)

    try:
        out = _port_step(build, lambda mdl, opt, m: tlm.make_lm_train_step(
            mdl, opt, mesh=m), state, rows,
            mesh_sizes(world, model=model, expert=expert), world)
    finally:
        tmoe.route = real_route
    return out, jm, jgrads, jparams, routed, held, tree


def _jax_kept(tree, toks):
    """JAX's kept (token, expert) pairs for the routed block's tokens: its
    MoEMLP with the block's router, every expert emitting a unit vector."""
    moe = tree["block1"]["moe"]
    d = LM["d_model"]
    probe = dict(moe, wo=np.zeros_like(moe["wo"]),
                 bo=np.eye(E, d, dtype=np.float32)[:, None, :])
    out = jax.jit(jmoe.MoEMLP(num_experts=E, mlp_dim=4 * d).apply)(
        {"params": probe}, jnp.asarray(toks[None]))
    return np.asarray(out).reshape(-1, d)[:, :E] > 0


@pytest.mark.parametrize("world,expert,model", [(2, 2, 1), (4, 2, 2)],
                         ids=["expert2", "expert2-model2"])
def test_ep_step_and_routing_equal_jax(world, expert, model):
    (m, grads, params), jm, jgrads, jparams, routed, held, tree = _case(
        world, expert, model)
    assert set(held.values()) == {E // expert}  # E/ep experts a rank
    for rank, (toks, r) in routed.items():
        kept = np.zeros((toks.shape[0], E), bool)
        for k in range(r.expert.shape[0]):
            sel = r.kept[k].numpy()
            kept[np.arange(toks.shape[0])[sel], r.expert[k][sel].numpy()] = True
        np.testing.assert_array_equal(kept, _jax_kept(tree, toks.numpy()),
                                      err_msg=f"rank {rank}")
        assert r.capacity == tmoe.expert_capacity(
            toks.shape[0], E, 2, 2.0)  # the rank's own tokens
    _assert_close(m, grads, params, lm_params_to_jax, jm, jgrads, jparams)


def test_all_to_all_to_the_wrong_owner_fails(monkeypatch):
    (m, grads, params), jm, jgrads, jparams, _, _, _ = _case(
        2, 2, misroute=True, monkeypatch=monkeypatch)
    with pytest.raises(AssertionError):
        _assert_close(m, grads, params, lm_params_to_jax, jm, jgrads,
                      jparams)
