"""Model configuration, the parameter-spec system and the weight bridge;
mirrors ``src/repro/models/common.py``.

Every parameter is declared once as a ``ParamSpec`` carrying its shape and
logical axis names. ``init_params`` walks the spec tree to make seeded
random weights from a ``torch.Generator``; ``params_from_numpy`` carries a
parameter tree made elsewhere (the reference's, as nested dicts of numpy
arrays) over bit for bit.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                     # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    n_kv_heads: int = 0             # 0 -> = n_heads (MHA)
    d_head: int = 128
    # --- attention options -------------------------------------------------
    qkv_bias: bool = False          # qwen-family
    window: Optional[int] = None    # sliding-window size for local layers
    layer_pattern: str = "G"        # repeating pattern: G=global attn,
                                    # L=local attn, R=recurrent(RG-LRU),
                                    # W=rwkv6 block
    attn_logit_softcap: Optional[float] = None   # gemma2: 50.0
    final_logit_softcap: Optional[float] = None  # gemma2: 30.0
    rope_theta: float = 10_000.0
    attn_impl: str = "auto"         # no-cache (training/prefill) attention:
                                    # "auto" takes the flash-attention CUDA
                                    # kernel on CUDA tensors and, on CPU
                                    # tensors, the reference's rule: _sdpa up
                                    # to 2048 tokens, chunked_attention above;
                                    # "xla" (_sdpa) and "chunked"
                                    # (chunked_attention) on either device
    attn_q_chunk: int = 2048        # chunked-attention tile sizes
    attn_kv_chunk: int = 2048
    exact_causal: bool = True       # prune upper-triangle chunks
    decode_kernel: str = "auto"     # decode-attention backend (paged and
                                    # gather planes): "flash" (the CUDA
                                    # kernel; its plain version on CPU
                                    # tensors), "xla" (the plain version),
                                    # "auto" (kernel on CUDA, plain on CPU)
    # --- MLP / MoE ----------------------------------------------------------
    act: str = "swiglu"             # swiglu | geglu | gelu
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    dense_d_ff: int = 0             # d_ff of the dense ("G") layers in a
                                    # mixed dense/MoE pattern (llama4); 0 -> d_ff
    # --- recurrent (RG-LRU / RWKV6) ------------------------------------------
    rnn_width: int = 0              # RG-LRU lru width (0 -> d_model)
    conv_width: int = 4             # temporal-conv window in recurrent block
    # --- encoder-decoder / frontends -----------------------------------------
    n_encoder_layers: int = 0
    frontend: Optional[str] = None  # "audio_frames" | "patch_embed" (stubs)
    frontend_len: int = 0           # frames / patches provided by the stub
    frontend_dim: int = 0           # stub embedding dim (pre-projection)
    # --- misc -----------------------------------------------------------------
    tie_embeddings: bool = True
    embed_scale: bool = False       # gemma family: h *= sqrt(d_model)
    norm: str = "rmsnorm"
    post_norms: bool = False        # gemma2 sandwich norms
    max_seq_len: int = 8192         # positional table size where learned
    dtype: Any = torch.bfloat16

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def lru_width(self) -> int:
        return self.rnn_width or self.d_model

    def pattern_layers(self) -> Tuple[str, ...]:
        """Per-layer kind for all n_layers, repeating ``layer_pattern``."""
        p = self.layer_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis names (len == ndim)
    init: str = "normal"              # normal | zeros | ones | scaled
    scale: float = 0.02
    dtype: Any = None                 # None -> model dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def p(shape, axes, init="normal", scale=0.02, dtype=None) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(axes), init, scale, dtype)


def tree_paths(tree, prefix=()):
    """Yield (path_tuple, leaf) over a nested-dict spec/param tree, in
    sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def tree_map(fn, tree, *rest):
    """``fn`` applied to every leaf of a nested-dict tree (with the leaves
    at the same paths of the trees ``rest`` as further arguments)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def unflatten(flat):
    """The nested-dict tree of a ``{path_tuple: leaf}`` dict (the inverse
    of ``dict(tree_paths(tree))``)."""
    tree = {}
    for path, leaf in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


# the most elements ``init_params`` draws at once (8 GiB of fp32)
_MAX_DRAW = 1 << 31


def init_params(spec_tree, generator: torch.Generator,
                device: torch.device | str, dtype=torch.bfloat16):
    """Seeded random init on ``device`` following ``ParamSpec.init``:
    normal·scale, fan-in "scaled" normal, zeros, ones. Leaves draw from
    ``generator`` (which must live on ``device``) in the spec tree's order,
    so one seed gives one parameter tree. Torch cannot reproduce the
    reference's ``jax.random`` stream; parity runs carry the reference's
    weights over with ``params_from_numpy`` instead.

    Normal leaves are drawn in fp32 one leading-axis slice at a time, so a
    layer-stacked leaf never holds a full fp32 copy on the device; a slice
    of more than ``_MAX_DRAW`` elements (a layer's stacked experts) is
    drawn one slice of its own leading axis at a time in turn."""
    def fill(t, std):
        if t.ndim >= 2 and t.numel() > _MAX_DRAW:
            for sl in t.unbind(0):
                fill(sl, std)
            return
        t.copy_(torch.randn(t.shape, generator=generator,
                            dtype=torch.float32, device=device) * std)

    def leaf(s: ParamSpec):
        d = s.dtype or dtype
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=d, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=d, device=device)
        if s.init == "scaled":          # fan-in scaled
            fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
            std = 1.0 / float(np.sqrt(fan_in))
        else:
            std = s.scale
        t = torch.empty(s.shape, dtype=d, device=device)
        for sl in (t.unbind(0) if t.ndim >= 3 else (t,)):
            fill(sl, std)
        return t

    return tree_map(leaf, spec_tree)


# ---------------------------------------------------------------------------
# Weight bridge
# ---------------------------------------------------------------------------


def _tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    a = np.array(a, order="C")          # a writable copy torch may own
    if a.dtype.name == "bfloat16":
        # numpy's bfloat16 (ml_dtypes) has no torch counterpart to convert
        # from: reinterpret the same 16-bit patterns
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_numpy(tree, dtype: Optional[torch.dtype] = None,
                      device: torch.device | str = "cpu"):
    """A parameter tree of numpy arrays (nested dicts, as the reference's
    params come back from the device) -> the same tree of torch tensors on
    ``device``, bit for bit. With ``dtype`` every leaf is then cast to it
    (a no-op, and so still bit-exact, where it already has that type)."""
    def conv(a):
        t = _tensor_from_numpy(np.asarray(a)).to(device)
        return t if dtype is None else t.to(dtype)
    return tree_map(conv, tree)


# ---------------------------------------------------------------------------
# Accounting
# ---------------------------------------------------------------------------


def meta_dtensor(shape, dtype: torch.dtype, mesh, placements):
    """A DTensor of global ``shape`` laid out over ``mesh`` by
    ``placements``, whose local shard is a meta tensor of this rank's
    shape (``DTensor.from_local`` with the global shape and stride given,
    unchecked): shapes and bytes, no storage. The placements must shard
    only dims that divide."""
    from torch.distributed.tensor import DTensor, Shard
    local = list(shape)
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = mesh.size(i)
            if local[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(shape)} does not "
                                 f"divide over {n} ranks")
            local[pl.dim] //= n
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(
        torch.empty(local, dtype=dtype, device="meta"), mesh, placements,
        run_check=False, shape=torch.Size(shape),
        stride=tuple(reversed(stride)))


def abstract_params(spec_tree, dtype=torch.bfloat16, sharding_fn=None):
    """The parameter tree as meta-device tensors: shapes and dtypes, no
    storage (what the reference's ShapeDtypeStruct tree is to its AOT
    lowering). With ``sharding_fn(path, spec) -> (mesh, placements)``
    each leaf is a DTensor whose local shard is a meta tensor of this
    rank's shape (``meta_dtensor``)."""
    def walk(tree, prefix=()):
        if isinstance(tree, dict):
            return {k: walk(v, prefix + (k,)) for k, v in tree.items()}
        s: ParamSpec = tree
        d = s.dtype or dtype
        if sharding_fn is None:
            return torch.empty(s.shape, dtype=d, device="meta")
        return meta_dtensor(s.shape, d, *sharding_fn(prefix, s))

    return walk(spec_tree)


def param_count(spec_tree) -> int:
    return sum(int(np.prod(s.shape)) for _, s in tree_paths(spec_tree))
