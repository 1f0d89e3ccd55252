"""JAX parameter trees → the port's state dicts: the causal LM's
(``CausalLM``) and SimpleCNN's (:func:`cnn_params_from_jax`).

For the causal LM, the inverse of ``ddp_tpu.models.lm.init_lm``'s tree
layout (and of a checkpoint's): ``embed`` [V, d], ``pos_embed`` [1, L,
d], ``blockN`` {``ln1``/``ln2`` {scale, bias}, ``attn`` {``qkv``,
``proj``} {kernel, bias}, ``mlp1``, ``mlp2``}, ``ln_final``. Flax's ``Dense.kernel`` is
[in, out] and ``nn.Linear.weight`` its transpose; LayerNorm ``scale``
is ``weight``. The fused qkv column order (head-major under MHA,
group-major under GQA) carries over unchanged.

Takes numpy arrays only — nested dicts, or a flat dict with
``/``-joined keys (an ``np.load`` of an ``.npz``) — so the port never
needs JAX to read a JAX model.
"""

from __future__ import annotations

import math
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


def cnn_params_from_jax(tree) -> dict[str, np.ndarray]:
    """A JAX ``SimpleCNN`` tree ({conv1, conv2, fc} {kernel, bias}, NHWC)
    → the port's NCHW ``SimpleCNN`` state dict (numpy fp32).

    Conv kernels go HWIO → OIHW. ``fc.kernel`` [H·W·C, out] follows an
    NHWC flatten (channel-minor) and the port flattens NCHW
    (channel-major), so each output unit's weights are re-gathered
    (out, H, W, C) → (out, C, H, W): the same function, not just the
    same parameter multiset (``ddp_tpu/interop/torch_checkpoint.py``'s
    ``params_to_torch_state_dict`` does the same map).
    """
    flat = flatten_tree(tree)
    k1 = np.asarray(flat["conv1/kernel"], np.float32)
    k2 = np.asarray(flat["conv2/kernel"], np.float32)
    fc = np.asarray(flat["fc/kernel"], np.float32)  # [H*W*C, out]
    n, out = fc.shape
    channels = k2.shape[-1]
    side = math.isqrt(n // channels)
    if side * side * channels != n:
        raise ValueError(f"fc kernel width {n} is not H·W·{channels} square")
    fl = (fc.T.reshape(out, side, side, channels).transpose(0, 3, 1, 2)
          .reshape(out, n))
    f32 = lambda a: np.ascontiguousarray(np.asarray(a, np.float32))  # noqa: E731
    return {
        "net.0.weight": f32(k1.transpose(3, 2, 0, 1)),
        "net.0.bias": f32(flat["conv1/bias"]),
        "net.2.weight": f32(k2.transpose(3, 2, 0, 1)),
        "net.2.bias": f32(flat["conv2/bias"]),
        "fl.weight": f32(fl),
        "fl.bias": f32(flat["fc/bias"]),
    }


def cnn_params_to_jax(state) -> dict:
    """The port's ``SimpleCNN`` state dict (arrays or tensors, or
    gradients keyed alike) → the nested JAX tree of numpy fp32 arrays;
    the inverse of :func:`cnn_params_from_jax`."""

    def arr(x):
        if hasattr(x, "detach"):
            x = x.detach().float().cpu().numpy()
        return np.asarray(x, np.float32)

    w2 = arr(state["net.2.weight"])
    fl = arr(state["fl.weight"])  # [out, C*H*W]
    out, n = fl.shape
    channels = w2.shape[0]
    side = math.isqrt(n // channels)
    fc = (fl.reshape(out, channels, side, side).transpose(0, 2, 3, 1)
          .reshape(out, n).T)
    c = np.ascontiguousarray
    return {
        "conv1": {"kernel": c(arr(state["net.0.weight"]).transpose(2, 3, 1, 0)),
                  "bias": arr(state["net.0.bias"])},
        "conv2": {"kernel": c(w2.transpose(2, 3, 1, 0)),
                  "bias": arr(state["net.2.bias"])},
        "fc": {"kernel": c(fc), "bias": arr(state["fl.bias"])},
    }
