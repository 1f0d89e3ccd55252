"""JAX parameter trees → the port's state dicts: the causal LM's
(``CausalLM``), SimpleCNN's (:func:`cnn_params_from_jax`), ResNet's
(:func:`resnet_params_from_jax`, with its BatchNorm ``batch_stats``),
ViT's (:func:`vit_params_from_jax`) and the long-context classifier's
(:func:`seq_transformer_params_from_jax`), and back.

For the causal LM, the inverse of ``ddp_tpu.models.lm.init_lm``'s tree
layout (and of a checkpoint's): ``embed`` [V, d], ``pos_embed`` [1, L,
d], ``blockN`` {``ln1``/``ln2`` {scale, bias}, ``attn`` {``qkv``,
``proj``} {kernel, bias}, ``mlp1``, ``mlp2``} — or, in a routed block,
``moe`` {``router`` {kernel, bias}, ``wi``, ``bi``, ``wo``, ``bo``}
instead of the MLP —, ``ln_final``. Flax's ``Dense.kernel`` is [in, out]
and ``nn.Linear.weight`` its transpose; LayerNorm ``scale`` is
``weight``; the expert tensors keep their layout. The fused qkv column
order (head-major under MHA, group-major under GQA) carries over
unchanged. The MoE ViT's routed blocks map the same way, name for name.

Takes numpy arrays only — nested dicts, or a flat dict with
``/``-joined keys (an ``np.load`` of an ``.npz``) — so the port never
needs JAX to read a JAX model. The results are full states; a mesh
rank's shard of one is ``parallel/tp.shard_params(state, mesh, rank)``
(how the tests carry JAX's parameters into every rank).

:class:`LeafMap` is the map of one leaf between the two layouts, as
tensors (differentiable both ways): the image family's GSPMD step holds
a sharded leaf as a chunk of its JAX layout (``parallel/spmd``), so a
rank's shard is the bytes of the JAX device's ``addressable_shards``
entry of its index.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch

from ddp_tpu_torch.models.lm import LMSpec, derive_lm_spec

_BLOCK = re.compile(r"block(\d+)$")
_LINEARS = ("attn/qkv", "attn/proj", "mlp1", "mlp2")
_NORMS = ("ln1", "ln2")
# A routed block's expert tensors, with their rank: [E, d, F], [E, 1, F],
# [E, F, d], [E, 1, d].
_EXPERTS = {"wi": 3, "bi": 3, "wo": 3, "bo": 3}


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
    """A JAX causal-LM tree, dense or routed → (spec, CausalLM state
    dict).

    The spec is derived from the shapes, as ``derive_lm_spec`` does; only
    the head count is an argument (routing the shapes cannot carry,
    ``moe_top_k`` and ``moe_normalize_gates``, takes JAX's defaults).
    Raises ValueError on a missing or extra leaf, a malformed ``moe``
    subtree (the message names ``moe``), or a gap in the block numbering.
    """
    flat = flatten_tree(tree)
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
        routed = any(k.startswith(f"{b}/moe/") for k in flat)
        if routed:
            for name, rank in (("router/kernel", 2), ("router/bias", 1),
                               *_EXPERTS.items()):
                key = f"{b}/moe/{name}"
                if key not in flat or np.ndim(flat[key]) != rank:
                    raise ValueError(
                        f"malformed moe subtree: {key} "
                        + ("is missing" if key not in flat else
                           f"has rank {np.ndim(flat[key])}, not {rank}"))
            state[f"{b}.moe.router.weight"] = np.ascontiguousarray(
                take(f"{b}/moe/router/kernel").T)
            state[f"{b}.moe.router.bias"] = take(f"{b}/moe/router/bias")
            for name in _EXPERTS:
                state[f"{b}.moe.{name}"] = take(f"{b}/moe/{name}")
        for name in _LINEARS[:2] if routed else _LINEARS:
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
        else:  # embed, pos_embed, an expert tensor (wi, bi, wo, bo)
            put(key.replace(".", "/"), arr(val))
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


# ---- ResNet and ViT: Flax names, module for module ----------------------
#
# The port's ResNet and ViT name their submodules as the Flax modules do
# (``stage1_block1.Conv_0``, ``block3.attn.qkv``), so a tree path maps to
# a state-dict key by "/" → "." and the leaf name: ``kernel`` → ``weight``
# (Conv HWIO → OIHW, Dense [in, out] → [out, in]), a norm's ``scale`` →
# ``weight``, ``bias`` → ``bias``; ``cls_token`` and ``pos_embed`` as they
# are; BatchNorm ``batch_stats`` ``mean``/``var`` → the buffers
# ``running_mean``/``running_var``.

_STATS = {"mean": "running_mean", "var": "running_var"}
# SimpleCNN's modules by their JAX names (:func:`cnn_params_from_jax`).
_CNN_MODULES = {"net.0": "conv1", "net.2": "conv2", "fl": "fc"}


def jax_leaf_path(name: str, ndim: int) -> tuple[str, ...]:
    """The JAX tree path of the port's parameter ``name`` (``ndim``
    dims), as the maps of this module carry it: a Dense or Conv
    ``weight`` is the ``kernel``, a norm's the ``scale``."""
    *mod, leaf = name.split(".")
    if not mod:  # embed, pos_embed, cls_token
        return (leaf,)
    joined = ".".join(mod)
    if joined in _CNN_MODULES:
        mod = [_CNN_MODULES[joined]]
    if leaf == "weight":
        leaf = "kernel" if ndim in (2, 4) else "scale"
    return (*mod, leaf)


class LeafMap:
    """A port leaf ``name`` of port ``shape`` and its JAX leaf: ``path``,
    the JAX shape, and the two (differentiable) maps between the
    layouts. ``cnn_channels``: SimpleCNN's conv2 width, when the leaf is
    its head (the port flattens NCHW, JAX NHWC)."""

    def __init__(self, name: str, shape: tuple, cnn_channels: int = 0):
        self.name, self.shape = name, tuple(shape)
        nd = len(self.shape)
        self.path = jax_leaf_path(name, nd)
        self.kind = "id"
        if self.path[-1] == "kernel":
            self.kind = {2: "dense", 4: "conv"}[nd]
            if self.path == ("fc", "kernel") and cnn_channels:
                self.kind = "cnn_head"
                self.channels = cnn_channels
                self.side = math.isqrt(self.shape[1] // cnn_channels)
        self.jax_shape = tuple(self.to_jax(torch.empty(self.shape,
                                                       device="meta")).shape)

    def to_jax(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind == "dense":
            return t.t()
        if self.kind == "conv":  # OIHW → HWIO
            return t.permute(2, 3, 1, 0)
        if self.kind == "cnn_head":  # [out, C·H·W] → [H·W·C, out]
            s, c = self.side, self.channels
            return t.reshape(-1, c, s, s).permute(2, 3, 1, 0).reshape(
                s * s * c, -1)
        return t

    def to_port(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind == "dense":
            return t.t()
        if self.kind == "conv":  # HWIO → OIHW
            return t.permute(3, 2, 0, 1)
        if self.kind == "cnn_head":
            s, c = self.side, self.channels
            return t.reshape(s, s, c, -1).permute(3, 2, 0, 1).reshape(
                -1, c * s * s)
        return t


def leaf_maps(shapes: dict) -> dict[str, LeafMap]:
    """A :class:`LeafMap` for every leaf of ``shapes`` (port name → port
    shape)."""
    cnn = shapes.get("net.2.weight")
    ch = int(cnn[0]) if cnn is not None and "fl.weight" in shapes else 0
    return {n: LeafMap(n, s, ch) for n, s in shapes.items()}


def jax_leaf_order(names, shapes) -> list[int]:
    """The indices of ``names`` (with their ``shapes``) in the order JAX
    flattens their tree: dict keys sorted at every level."""
    return sorted(range(len(names)),
                  key=lambda i: jax_leaf_path(names[i], len(shapes[i])))


def _flax_from_jax(params, batch_stats=None) -> dict[str, np.ndarray]:
    state = {}
    for path, a in flatten_tree(params).items():
        *mod, leaf = path.split("/")
        key = ".".join(mod)
        a = np.asarray(a, np.float32)
        if leaf == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            state[f"{key}.weight"] = a
        elif leaf == "scale":
            state[f"{key}.weight"] = a
        elif leaf == "bias":
            state[f"{key}.bias"] = a
        else:  # cls_token, pos_embed
            state[path.replace("/", ".")] = a
    for path, a in flatten_tree(batch_stats or {}).items():
        *mod, leaf = path.split("/")
        state[".".join(mod + [_STATS[leaf]])] = np.asarray(a, np.float32)
    return {k: np.ascontiguousarray(v) for k, v in state.items()}


def _flax_to_jax(state) -> tuple[dict, dict]:
    params: dict = {}
    stats: dict = {}

    def put(tree, path, val):
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(val)

    inverse = {v: k for k, v in _STATS.items()}
    for key, val in state.items():
        if hasattr(val, "detach"):
            val = val.detach().float().cpu().numpy()
        a = np.asarray(val, np.float32)
        *mod, leaf = key.split(".")
        if leaf in inverse:
            put(stats, mod + [inverse[leaf]], a)
        elif leaf == "weight" and a.ndim == 4:
            put(params, mod + ["kernel"], a.transpose(2, 3, 1, 0))
        elif leaf == "weight" and a.ndim == 2:
            put(params, mod + ["kernel"], a.T)
        elif leaf == "weight":
            put(params, mod + ["scale"], a)
        elif leaf == "bias":
            put(params, mod + ["bias"], a)
        else:
            put(params, key.split("."), a)
    return params, stats


def resnet_params_from_jax(params, batch_stats) -> dict[str, np.ndarray]:
    """A JAX ``ResNet`` ``params`` tree and its ``batch_stats`` → the
    port's ``ResNet`` state dict (numpy fp32, buffers included)."""
    return _flax_from_jax(params, batch_stats)


def resnet_params_to_jax(state) -> tuple[dict, dict]:
    """The port's ``ResNet`` state dict (or gradients keyed alike) →
    (``params``, ``batch_stats``) as nested trees of numpy fp32 arrays;
    the inverse of :func:`resnet_params_from_jax`."""
    return _flax_to_jax(state)


def vit_params_from_jax(params) -> dict[str, np.ndarray]:
    """A JAX ``ViT`` ``params`` tree → the port's ``ViT`` state dict."""
    return _flax_from_jax(params)


def vit_params_to_jax(state) -> dict:
    """The port's ``ViT`` state dict (or gradients keyed alike) → the
    nested JAX tree; the inverse of :func:`vit_params_from_jax`."""
    return _flax_to_jax(state)[0]


def seq_transformer_params_from_jax(params) -> dict[str, np.ndarray]:
    """A JAX ``LongContextTransformer`` ``params`` tree → the port's state
    dict (Flax names, kernels transposed)."""
    return _flax_from_jax(params)


def seq_transformer_params_to_jax(state) -> dict:
    """The port's ``LongContextTransformer`` state dict (or gradients
    keyed alike) → the JAX ``params`` tree of numpy fp32 arrays."""
    return _flax_to_jax(state)[0]


# ---- the pipelined families: the stacked stages ------------------------
#
# A pipe model's full state (``models/pipeline_vit``, ``models/pipeline_lm``)
# is JAX's ``PipeViTParams`` (``embed``, ``stages``, ``head``) or
# ``PipeLMParams`` (``front``, ``stages``, ``back``) under "."-joined
# names, the ``stages`` leaves stacked [S, …] or [v, S, …] ahead of each
# leaf's own dims; the maps are the Flax ones on those trailing dims.


def _check_moe_subtrees(flat: dict, lead: int) -> None:
    """Each routed stage block's ``moe`` subtree, keyed ``stages/blockN/
    moe/...`` in JAX's names: exactly ``router`` {kernel, bias}, ``wi``,
    ``bi``, ``wo``, ``bo``, of their ranks after the ``lead`` stacked
    dims; else ValueError naming ``moe``."""
    want = {"router/kernel": 2, "router/bias": 1, **_EXPERTS}
    blocks = {k.split("/moe/")[0] for k in flat
              if k.startswith("stages/") and "/moe/" in k}
    for b in sorted(blocks):
        got = {k[len(b) + 5:]: np.ndim(v) - lead for k, v in flat.items()
               if k.startswith(b + "/moe/")}
        for name, rank in want.items():
            if got.get(name) != rank:
                raise ValueError(
                    f"malformed moe subtree: {b}/moe/{name} "
                    + ("is missing" if name not in got else
                       f"has rank {got[name]}, not {rank}"))
        extra = sorted(set(got) - set(want))
        if extra:
            raise ValueError(f"malformed moe subtree: {b}/moe has "
                             f"unexpected leaves {extra}")


def _stage_lead(names_ndims) -> int:
    """Stacked dims of the ``stages`` leaves: 2 when the smallest (a
    LayerNorm bias) has 3 dims ([v, S, d]), else 1 (``sequential_apply``'s
    rule)."""
    dims = [nd for name, nd in names_ndims if name.startswith("stages")]
    return 2 if dims and min(dims) == 3 else 1


def pipe_params_to_jax(state) -> dict:
    """A pipe model's full state (arrays or tensors, or gradients and
    moments keyed alike) → the nested JAX tree of numpy fp32 arrays; a
    routed stage block's ``moe`` leaves map as the causal LM's do (the
    router a Dense, the expert tensors as they are)."""

    def arr(x):
        if hasattr(x, "detach"):
            x = x.detach().float().cpu().numpy()
        return np.asarray(x, np.float32)

    lead = _stage_lead((k, np.ndim(arr(v))) for k, v in state.items())
    tree: dict = {}
    for key, val in state.items():
        a = arr(val)
        *mod, leaf = key.split(".")
        nd = a.ndim - (lead if mod[0] == "stages" else 0)
        if leaf == "weight" and nd == 1:
            leaf = "scale"
        elif leaf == "weight" and nd == 2:
            leaf, a = "kernel", np.swapaxes(a, -1, -2)
        elif leaf == "weight" and nd == 4:  # OIHW → HWIO
            leaf = "kernel"
            a = np.moveaxis(a, (-4, -3, -2, -1), (-1, -2, -4, -3))
        node = tree
        for part in mod:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(a)
    _check_moe_subtrees(flatten_tree(tree), lead)
    return tree


def pipe_params_from_jax(tree) -> dict[str, np.ndarray]:
    """A JAX ``PipeViTParams`` / ``PipeLMParams`` tree (as nested dicts of
    its three fields) → the port's full pipe state; the inverse of
    :func:`pipe_params_to_jax`. Raises ValueError on a malformed ``moe``
    subtree of a routed stage block (the message names ``moe``)."""
    flat = flatten_tree(tree)
    lead = _stage_lead((k, np.ndim(v)) for k, v in flat.items())
    _check_moe_subtrees(flat, lead)
    state = {}
    for path, a in flat.items():
        a = np.asarray(a, np.float32)
        *mod, leaf = path.split("/")
        nd = a.ndim - (lead if mod[0] == "stages" else 0)
        if leaf == "scale":
            leaf = "weight"
        elif leaf == "kernel" and nd == 2:
            leaf, a = "weight", np.swapaxes(a, -1, -2)
        elif leaf == "kernel" and nd == 4:  # HWIO → OIHW
            leaf = "weight"
            a = np.moveaxis(a, (-1, -2, -4, -3), (-4, -3, -2, -1))
        state[".".join(mod + [leaf])] = np.ascontiguousarray(a)
    return state
