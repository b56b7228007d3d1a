"""Logical-axis sharding rules with divisibility fallback (the port of the
reference's ``models/sharding.py``).

The production meshes are 16 x 16 ``(data, model)`` (one pod) and
2 x 16 x 16 ``(pod, data, model)`` (two pods), but the architectures'
head, kv-head and vocab counts are not all divisible by 16 (qwen has 40
heads, paligemma 8 / 1, whisper's vocab is odd).  Every logical tensor
dimension carries a *fallback chain*: the first mesh-axis assignment
whose size divides the dimension wins; otherwise the dimension is
replicated.  :data:`LOGICAL_RULES` and the rule logic are the
reference's, copied.

The scheme is Megatron-style TP + SP crossed with ZeRO-3 / FSDP:

* ``model`` axis: attention heads / kv heads (or head_dim when head
  counts don't divide), FFN hidden, experts (EP), vocab, and the
  *sequence* axis of layer-boundary activations (sequence parallelism).
* ``data`` axis (plus the ``pod`` outer axis when present): batch, and
  the d_model axis of every weight (FSDP).

Where the reference names a JAX ``NamedSharding``, the port places a
DTensor on a named :class:`torch.distributed.device_mesh.DeviceMesh`:
:meth:`ShardingRules.placements` gives one ``Shard`` / ``Replicate`` per
mesh dimension, and :func:`shard_like` (the reference's
``with_sharding_constraint``) is a ``redistribute``.  The rules also
take a shape-only :class:`AbstractMesh` (the dry run's and the specs'
mesh, which needs no process group).  ``spec`` keeps the reference's
tuple form, so the two packages' resolutions compare leaf for leaf.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

__all__ = ["LOGICAL_RULES", "AbstractMesh", "ShardingRules", "mesh_shape",
           "logical_spec", "shard_like", "axis_size", "is_dtensor",
           "model_replicated_call", "set_block", "grad_layout"]

AxisChoice = Union[str, Tuple[str, ...]]

#: logical dimension name -> ordered fallback chain of mesh-axis
#: assignments.  Entries may be a single mesh axis or a tuple (sharded
#: over the product).
LOGICAL_RULES: Dict[str, Sequence[AxisChoice]] = {
    # activations
    "batch": (("pod", "data"), "data"),
    "seq_act": ("model",),          # layer-boundary activations (SP)
    "seq": (),                       # in-layer sequence: replicated
    "embed_act": (),                 # activation d_model: replicated
    # weights
    "embed": ("data",),              # weight d_model axis (FSDP)
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": ("model",),          # fallback used by KV caches
    "qkv_out": ("model",),           # flattened h*dh weight output axis
    "ffn": ("model",),
    "experts": ("model",),
    "vocab": ("model",),
    "layers": (),                    # stacked-layer axis: never sharded
    "ssm_inner": ("model",),
    "ssm_state": (),
    "conv_k": (),
    # cache
    "cache_batch": (("pod", "data"), "data"),
    "cache_seq": (),
    "cache_kv": ("model", ),
    "cache_dim": ("model",),
}


class AbstractMesh:
    """A mesh by its shape alone: ``AbstractMesh(data=16, model=16)``.
    ``shape`` is the ordered ``{axis: size}`` dict the rules read; it
    holds no device and needs no process group."""

    def __init__(self, **shape: int):
        self.shape: Dict[str, int] = {k: int(v) for k, v in shape.items()}

    @property
    def mesh_dim_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh``, an :class:`AbstractMesh` or
    any object with a ``shape`` dict (in mesh-dimension order)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None and not isinstance(getattr(mesh, "shape", None),
                                            dict):
        return dict(zip(names, (int(n) for n in mesh.mesh.shape)))
    return dict(mesh.shape)


def _flat(choice: AxisChoice) -> Tuple[str, ...]:
    return (choice,) if isinstance(choice, str) else tuple(choice)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


@dataclass(frozen=True)
class ShardingRules:
    """Resolves logical axis names to mesh axes for a concrete mesh."""

    mesh: Any
    rules: Dict[str, Sequence[AxisChoice]] = field(
        default_factory=lambda: dict(LOGICAL_RULES))

    @property
    def shape(self) -> Dict[str, int]:
        return mesh_shape(self.mesh)

    def _axis_prod(self, axes: Tuple[str, ...]) -> int:
        shape = self.shape
        n = 1
        for a in axes:
            n *= shape[a]
        return n

    def resolve(self, logical: Optional[str], dim: int
                ) -> Optional[AxisChoice]:
        """First candidate whose mesh size divides ``dim`` (and exists)."""
        if logical is None:
            return None
        shape = self.shape
        for choice in self.rules.get(logical, ()):
            axes = _flat(choice)
            if not all(a in shape for a in axes):
                continue
            if dim % self._axis_prod(axes) == 0:
                return choice if isinstance(choice, str) else tuple(choice)
        return None

    def mesh_axes(self, logical_axes: Sequence[Optional[str]],
                  shape: Sequence[int]) -> Tuple[Optional[AxisChoice], ...]:
        if len(logical_axes) != len(shape):
            raise ValueError(f"rank mismatch: {logical_axes} vs {shape}")
        out = []
        used: set = set()
        for name, dim in zip(logical_axes, shape):
            choice = self.resolve(name, dim)
            # one mesh axis may shard only one dim of a tensor
            if choice is not None:
                axes = set(_flat(choice))
                if axes & used:
                    choice = None
                else:
                    used |= axes
            out.append(choice)
        return tuple(out)

    def spec(self, logical_axes: Sequence[Optional[str]],
             shape: Sequence[int]) -> Tuple[Optional[AxisChoice], ...]:
        """The reference's ``PartitionSpec`` as its tuple of entries."""
        return self.mesh_axes(logical_axes, shape)

    def placements(self, logical_axes: Sequence[Optional[str]],
                   shape: Sequence[int]) -> Tuple[Any, ...]:
        """One DTensor placement per mesh dimension: ``Shard(i)`` on every
        mesh axis that tensor dim ``i`` resolves to (a tuple choice such
        as ``("pod", "data")`` shards dim ``i`` over both, outer first,
        as a ``PartitionSpec`` entry does), ``Replicate()`` elsewhere."""
        from torch.distributed.tensor import Replicate, Shard
        names = list(self.shape)
        out: List[Any] = [Replicate()] * len(names)
        for i, choice in enumerate(self.mesh_axes(logical_axes, shape)):
            if choice is not None:
                for a in _flat(choice):
                    out[names.index(a)] = Shard(i)
        return tuple(out)

    def local_shape(self, logical_axes: Sequence[Optional[str]],
                    shape: Sequence[int]) -> Tuple[int, ...]:
        """One device's block of a tensor of ``shape`` (every resolved
        axis divides its dimension, so blocks are even)."""
        out = list(shape)
        for i, choice in enumerate(self.mesh_axes(logical_axes, shape)):
            if choice is not None:
                out[i] //= self._axis_prod(_flat(choice))
        return tuple(out)

    # -- conveniences ------------------------------------------------------
    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """Mesh axes that carry data parallelism."""
        shape = self.shape
        for c in self.rules["batch"]:
            axes = _flat(c)
            if all(a in shape for a in axes):
                return axes
        return ()

    @property
    def model_axis(self) -> Optional[str]:
        return "model" if "model" in self.shape else None

    def data_size(self) -> int:
        return self._axis_prod(self.batch_axes)

    def model_size(self) -> int:
        return self.shape.get("model", 1)

    def model_rank(self) -> int:
        """This process's coordinate on the ``model`` axis (0 off-mesh)."""
        if self.model_axis is None or not hasattr(self.mesh, "get_local_rank"):
            return 0
        return self.mesh.get_local_rank(self.model_axis)


def _walk(fn, tree, axes):
    """``fn(leaf, axes)`` over ``tree``'s leaves, ``axes`` walked along
    (its tuples are leaves; the reference's ``flatten_up_to``)."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, axes[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_walk(fn, getattr(tree, f), getattr(axes, f))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(fn, v, a) for v, a in zip(tree, axes))
    return fn(tree, axes)


def _shape_of(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def logical_spec(rules: ShardingRules, tree: Any, axes_tree: Any) -> Any:
    """Maps a tree of tensors (or anything with ``shape``) and its tree
    of logical-axis tuples to the reference's spec tuples."""
    return _walk(lambda x, a: rules.spec(a, _shape_of(x)), tree, axes_tree)


def shard_like(rules: Optional[ShardingRules], x,
               logical_axes: Sequence[Optional[str]]):
    """The reference's ``with_sharding_constraint`` by logical axes: a
    DTensor redistributed to the rules' placements; a plain tensor or
    ``rules=None`` is returned as it is."""
    if rules is None or not is_dtensor(x):
        return x
    want = rules.placements(logical_axes, tuple(x.shape))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


def model_replicated_call(rules: ShardingRules, fn, x, params, state=None):
    """``fn(x, params, state) -> (y, new_state)`` on local tensors, every
    ``model`` rank over its data shard's rows with the parameters whole:
    x (batch first) and each state leaf are redistributed to the batch
    layout (``Shard(0)`` over the batch axes, replicated over ``model``),
    the parameters are gathered.  Returns DTensors in that batch layout;
    ``new_state`` is None when ``state`` is.  The parameters' gradients
    are partial sums over the batch axes (each data shard's rows)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from ..tree import leaves, unflatten
    mesh = x.device_mesh
    x = shard_like(rules, x, ("batch",) + (None,) * (x.dim() - 1))
    bpl = tuple(x.placements)
    gpl = tuple(Partial() if isinstance(p, Shard) else Replicate()
                for p in bpl)
    rep = (Replicate(),) * mesh.ndim
    p_vals = [v.redistribute(mesh, rep) for v in leaves(params)]
    s_vals = [] if state is None else [
        shard_like(rules, v, ("batch",) + (None,) * (v.dim() - 1))
        for v in leaves(state)]
    n_p = len(p_vals)

    def body(xl, *rest):
        pl = unflatten(params, list(rest[:n_p]))
        sl = None if state is None else unflatten(state, list(rest[n_p:]))
        y, new = fn(xl, pl, sl)
        return (y,) if state is None else (y, *leaves(new))

    outs = local_map(
        body, out_placements=(bpl,) * (1 + len(s_vals)),
        in_placements=(bpl,) + (rep,) * n_p + (bpl,) * len(s_vals),
        in_grad_placements=(bpl,) + (gpl,) * n_p + (bpl,) * len(s_vals),
        device_mesh=mesh)(x, *p_vals, *s_vals)
    if state is None:
        return outs[0], None
    return outs[0], unflatten(state, list(outs[1:]))


def set_block(dst, index, src) -> None:
    """``dst[index] = src`` in place, without autograd; a DTensor ``dst``
    is written block by block after ``src`` takes the placements of
    ``dst[index]``."""
    with torch.no_grad():
        view = dst[index]
        if is_dtensor(view):
            if is_dtensor(src):
                src = src.redistribute(view.device_mesh, view.placements)
                src = src.to_local()
            view = view.to_local()
        view.copy_(src)


class _GradLayout(torch.autograd.Function):
    """Identity whose gradient is redistributed to ``placements``."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def grad_layout(rules: Optional[ShardingRules], x,
                logical_axes: Sequence[Optional[str]]):
    """``x`` unchanged, its gradient redistributed to the rules'
    placements of ``logical_axes`` in the backward (so a layer's output
    gradient reaches its products in the layout the forward used); a
    no-op for plain tensors or ``rules=None``."""
    if rules is None or not is_dtensor(x) or not x.requires_grad:
        return x
    return _GradLayout.apply(x, rules.placements(logical_axes,
                                                 tuple(x.shape)))
