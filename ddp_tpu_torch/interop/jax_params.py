"""JAX causal-LM parameter trees → the port's ``CausalLM`` state.

The inverse of ``ddp_tpu.models.lm.init_lm``'s tree layout (and of a
checkpoint's): ``embed`` [V, d], ``pos_embed`` [1, L, d], ``blockN``
{``ln1``/``ln2`` {scale, bias}, ``attn`` {``qkv``, ``proj``} {kernel,
bias}, ``mlp1``, ``mlp2``}, ``ln_final``. Flax's ``Dense.kernel`` is
[in, out] and ``nn.Linear.weight`` its transpose; LayerNorm ``scale``
is ``weight``. The fused qkv column order (head-major under MHA,
group-major under GQA) carries over unchanged.

Takes numpy arrays only — nested dicts, or a flat dict with
``/``-joined keys (an ``np.load`` of an ``.npz``) — so the port never
needs JAX to read a JAX model.
"""

from __future__ import annotations

import re

import numpy as np

from ddp_tpu_torch.models.lm import LMSpec, derive_lm_spec

_BLOCK = re.compile(r"block(\d+)$")
_LINEARS = ("attn/qkv", "attn/proj", "mlp1", "mlp2")
_NORMS = ("ln1", "ln2")


def flatten_tree(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts → {"a/b/c": array}; a flat dict passes through."""
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if hasattr(val, "items"):
            flat.update(flatten_tree(val, path + "/"))
        else:
            flat[path] = np.asarray(val)
    return flat


def lm_params_from_jax(
    tree, *, num_heads: int
) -> tuple[LMSpec, dict[str, np.ndarray]]:
    """A dense JAX causal-LM tree → (spec, CausalLM state dict).

    The spec is derived from the shapes, as ``derive_lm_spec`` does;
    only the head count is an argument. Raises ValueError on trees this
    slice does not cover — a routed ``moe`` block, a missing or extra
    leaf, a gap in the block numbering.
    """
    flat = flatten_tree(tree)
    if any("/moe/" in f"/{k}/" for k in flat):
        raise ValueError(
            "the tree has MoE blocks ('moe' subtree): the port serves "
            "dense causal LMs only"
        )
    blocks = sorted(
        {
            int(m.group(1))
            for k in flat
            if (m := _BLOCK.match(k.split("/")[0]))
        }
    )
    if not blocks or blocks != list(range(1, len(blocks) + 1)):
        raise ValueError(
            f"blocks must be numbered block1..blockN, found {blocks}"
        )
    state: dict[str, np.ndarray] = {}
    used: set[str] = set()

    def take(key: str) -> np.ndarray:
        if key not in flat:
            raise ValueError(f"missing parameter {key!r}")
        used.add(key)
        return np.asarray(flat[key], np.float32)

    state["embed"] = take("embed")
    state["pos_embed"] = take("pos_embed")
    for i in blocks:
        b = f"block{i}"
        for name in _LINEARS:
            dst = f"{b}.{name.replace('/', '.')}"
            state[dst + ".weight"] = np.ascontiguousarray(
                take(f"{b}/{name}/kernel").T
            )
            state[dst + ".bias"] = take(f"{b}/{name}/bias")
        for name in _NORMS:
            state[f"{b}.{name}.weight"] = take(f"{b}/{name}/scale")
            state[f"{b}.{name}.bias"] = take(f"{b}/{name}/bias")
    state["ln_final.weight"] = take("ln_final/scale")
    state["ln_final.bias"] = take("ln_final/bias")
    extra = sorted(set(flat) - used)
    if extra:
        raise ValueError(f"unexpected parameters {extra[:5]}")
    return derive_lm_spec(state, num_heads=num_heads), state


def lm_params_to_jax(state) -> dict:
    """A CausalLM state dict (arrays or tensors, e.g. ``model.state_dict()``
    or the gradients keyed alike) → the nested JAX tree of numpy fp32
    arrays; the inverse of :func:`lm_params_from_jax`."""

    def arr(x):
        if hasattr(x, "detach"):
            x = x.detach().float().cpu().numpy()
        return np.asarray(x, np.float32)

    tree: dict = {}

    def put(path: str, value) -> None:
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value

    for key, val in state.items():
        *mod, kind = key.split(".")
        path = "/".join(mod)
        if kind == "weight" and mod[-1] in ("ln1", "ln2", "ln_final"):
            put(path + "/scale", arr(val))
        elif kind == "weight":
            put(path + "/kernel", np.ascontiguousarray(arr(val).T))
        elif kind == "bias":
            put(path + "/bias", arr(val))
        else:  # embed, pos_embed
            put(key, arr(val))
    return tree
