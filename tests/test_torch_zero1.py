"""``--zero1`` (ZeRO stage 1 on a pure data mesh) in the port ≡ the JAX
package's GSPMD step with ``zero1=True``, on the CPU.

The port's ``train/optim.Zero1Optimizer`` keeps each optimizer-state leaf
as this rank's ``data`` slice of its JAX layout (``parallel/spmd.
zero1_spec_for``) while the parameters stay whole; a step runs the rule
on the slices and all-gathers the parameters. Held to JAX's step on the
first 4 CPU devices with the same seeded weights and batch (the helpers
of tests/test_torch_spmd.py; its limits): loss and grad norm, the
gradient (SGD's trace), the updated parameters, and each rank's state
slice at rest against the JAX device shard of its index. The control, a
step that skips the parameter all-gather, must fail; meshes with model,
fsdp or expert axes are refused with JAX's message.
"""

import numpy as np
import pytest

from ddp_tpu.parallel import spmd as jspmd
from ddp_tpu.runtime.mesh import MeshSpec
from ddp_tpu_torch.interop.jax_params import leaf_maps
from ddp_tpu_torch.parallel import spmd
from ddp_tpu_torch.runtime.mesh import mesh_sizes
from ddp_tpu_torch.train.optim import Zero1Optimizer

from test_torch_spmd import check, check_shards

CASES = {"simple_cnn data4 sgd": ("simple_cnn", "sgd"),
         "vit_micro data4 adam": ("vit_micro", "adam"),
         "vit_micro data4 sgd": ("vit_micro", "sgd")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_zero1_step_equals_jax(case):
    name, opt = CASES[case]
    out, jnew = check(name, 4, {}, opt=opt, zero1=True)
    check_shards(name, out, jnew, opt)
    layout = out[0][6]
    # The parameters stay whole; the big state leaves are data slices.
    assert not layout.specs and layout.state_specs
    assert all("data" in s for s in layout.state_specs.values())


def test_zero1_skipping_the_parameter_gather_fails(monkeypatch):
    monkeypatch.setattr(Zero1Optimizer, "FAULT", "skip_gather")
    with pytest.raises(AssertionError):
        check("simple_cnn", 4, {}, zero1=True)


@pytest.mark.parametrize("axes", [dict(model=2), dict(fsdp=2),
                                  dict(expert=2)])
def test_zero1_refuses_sharded_meshes_with_jax_message(axes):
    sizes = mesh_sizes(4, **axes)
    with pytest.raises(ValueError) as mine:
        spmd.check_zero1_mesh(sizes)

    class _Mesh:  # JAX's check reads only mesh.shape
        shape = {a: getattr(MeshSpec(data=-1, **axes), a)
                 if a != "data" else 4 // max(axes.values())
                 for a in ("data", "model", "fsdp", "expert")}

    with pytest.raises(ValueError) as theirs:
        jspmd.check_zero1_mesh(_Mesh())
    assert str(mine.value) == str(theirs.value)


def test_zero1_specs_equal_jax():
    """``zero1_spec_for`` on every leaf's JAX shape equals JAX's."""
    from test_torch_spmd import _port_model

    model = _port_model("simple_cnn")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    for n, m in leaf_maps(shapes).items():
        mine = spmd.zero1_spec_for(m.jax_shape, {"data": 4})

        class _Mesh:
            shape = {"data": 4}

        assert mine == tuple(jspmd.zero1_spec_for(m.jax_shape, _Mesh())) + \
            (None,) * (len(mine) - len(jspmd.zero1_spec_for(m.jax_shape,
                                                            _Mesh()))), n
    assert np.prod(leaf_maps(shapes)["fl.weight"].jax_shape) == \
        10 * 64 * 28 * 28
