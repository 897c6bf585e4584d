"""Partition rules for the (pod, data, model) production mesh.

The port of ``repro.models.sharding``.  Two sharding POLICIES, chosen per
(family x step kind):

  * ``tp``  — batch over ('pod','data'); tensor parallelism on 'model'
    (attention heads / FFN width / experts / SSM heads); large weights
    FSDP their input dim on 'data'.  Used by every SERVING path and by
    MoE / SSM / hybrid training.
  * ``fsdp`` — no tensor parallelism: the batch shards over
    ('pod','data') and the *sequence* over 'model'; every weight and
    optimizer tensor shards over the FLAT ('pod','data','model') axis set
    and is all-gathered at use (ZeRO-3).  Used by dense / vlm / encdec
    training.

Divisibility decides fallbacks everywhere: e.g. grok-1's 8 KV heads
can't shard a 16-way 'model' axis, so its KV projections replicate there;
its 8 experts shard the expert FFN width instead of the expert count,
while llama4-scout's 16 experts ride 'model' directly (EP).

Specs are data.  A spec is a tuple with one entry per dim of its tensor;
an entry is ``None`` (replicated), an axis name, or a tuple of axis names
(the dim sharded over their product, the first the outermost), the
entries of JAX's ``PartitionSpec`` padded to the tensor's rank.  The rules
read the same names as the reference's: a parameter's dotted name
(``blocks.attn.wq``, as ``model.named_parameters()`` gives it), a decode
state's keys (``kv``, ``shared_kv``, ``ssm``, ``xk``, ``xv``).
``to_placements`` turns a spec into DTensor placements over a
``DeviceMesh``.

The activation constraints (``constrain_residual``, ``constrain_attn_qkv``,
``constrain_seq_sharded``) read the current mesh, which ``set_mesh`` sets
for a block of code as ``jax.set_mesh`` does.  A constraint changes a
DTensor's layout (``redistribute``), never its values; with no mesh, or on
a plain tensor, it returns its input, as the reference's ``try/except``
leaves an array outside a mesh as it is.

Serving reads the same mesh: under ``set_mesh`` a model's ``decode_init``
returns its decode state born laid out by ``decode_state_specs``
(``laid_out_zeros``: each rank allocates only its shard), the counterpart
of the reference's ``out_shardings``, and prefill and decode write their
caches into each rank's shard (``models.layers.write_cache``,
``set_layer``).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard, distribute_tensor

from .config import ModelConfig

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]

DP_AXES = ("pod", "data")  # batch rides the product of these
ALL_AXES = ("pod", "data", "model")


def axis_sizes(mesh: DeviceMesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _dp(mesh_axes: Dict[str, int]) -> Tuple[str, ...]:
    return tuple(a for a in DP_AXES if a in mesh_axes)


def _present(mesh_axes: Dict[str, int], axes=ALL_AXES) -> Tuple[str, ...]:
    return tuple(a for a in axes if a in mesh_axes)


def _size(mesh_axes: Dict[str, int], axes) -> int:
    n = 1
    for a in axes:
        n *= mesh_axes[a]
    return n


def _div(n: int, mesh_axes: Dict[str, int], axis: str) -> bool:
    return axis in mesh_axes and n % mesh_axes[axis] == 0


def policy_for(cfg: ModelConfig, kind: str) -> str:
    """kind: train | prefill | decode."""
    if kind == "train" and cfg.family in ("dense", "vlm", "encdec"):
        return "fsdp"
    # ssm/hybrid train: tp (SSM heads ride 'model'; the residual stream is
    # sequence-sharded between layers so remat saves stay bounded).
    return "tp"


def _map_with_path(fn, tree: Any, path: Tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over nested dicts, tuples and lists, keeping the
    structure; a path names dict keys and sequence positions (``[i]``), as
    JAX's key paths print."""
    if isinstance(tree, Mapping):
        return {k: _map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(fn, v, path + (f"[{i}]",))
                          for i, v in enumerate(tree))
    return fn(path, tree)


# --------------------------------------------------------------------------
# Parameter specs
# --------------------------------------------------------------------------
def param_specs(
    cfg: ModelConfig, params: Mapping[str, Any], mesh_axes: Dict[str, int],
    policy: str = "tp",
) -> Dict[str, Spec]:
    """A spec for each parameter of ``params`` (dotted name -> tensor; only
    its shape is read), under the same name."""
    flat = _present(mesh_axes)
    dp = _dp(mesh_axes)

    def fsdp_rule(shape, pre) -> Spec:
        # Shard the first dim divisible by the flat axis set; fall back to
        # ('pod','data') and then nothing.  One sharded dim is enough —
        # the tensor is fully distributed over all devices.
        for cand in (flat, dp):
            n = _size(mesh_axes, cand) if cand else 1
            if not cand or n == 1:
                continue
            for i, d in enumerate(shape):
                if d % n == 0 and d >= n:
                    spec: List[Entry] = [None] * len(shape)
                    spec[i] = cand if len(cand) > 1 else cand[0]
                    return (*pre, *spec)
        return (*pre, *(None,) * len(shape))

    def rule(names: Sequence[str], full_shape) -> Spec:
        name = names[-1]
        stacked = any(n in ("blocks", "enc_blocks", "dec_blocks") for n in names)
        pre = (None,) if stacked else ()
        shape = tuple(full_shape[1:] if stacked else full_shape)

        if policy == "fsdp":
            if len(shape) <= 1:
                return (*pre, *(None,) * len(shape))
            return fsdp_rule(shape, pre)

        def spec(*axes) -> Spec:
            fixed: List[Entry] = []
            for dim, ax in zip(shape, axes):
                if ax is None:
                    fixed.append(None)
                elif isinstance(ax, tuple):
                    present = tuple(a for a in ax if a in mesh_axes)
                    n = _size(mesh_axes, present)
                    fixed.append(present if (n > 1 and dim % n == 0) else None)
                else:
                    fixed.append(ax if _div(dim, mesh_axes, ax) else None)
            return (*pre, *fixed)

        if name in ("embed",):
            return spec("model", "data")
        if name == "unembed":
            return spec("data", "model")
        if name == "wq":
            return spec("data", "model", None)
        if name in ("wk", "wv"):
            return spec("data", "model", None)  # falls back if K % model != 0
        if name == "wo":
            return spec("model", None, "data")
        if name in ("w_in", "w_gate", "w_out"):
            if len(shape) == 3:  # MoE expert weights (E, D, F) / (E, F, D)
                E = shape[0]
                if _div(E, mesh_axes, "model"):
                    return spec("model", "data", None)  # expert parallelism
                if name == "w_out":
                    return spec(None, "model", "data")  # TP-within-expert
                return spec(None, "data", "model")
            if name == "w_out":
                return spec("model", "data")
            return spec("data", "model")
        if name == "router":
            return spec("data", None)
        if name == "in_proj":
            return spec("data", "model")
        if name == "out_proj":
            return spec("model", "data")
        if name == "conv_w":
            return spec(None, "model")
        return (*pre, *(None,) * len(shape))

    return {name: _pad(rule(name.split("."), p.shape), len(p.shape))
            for name, p in params.items()}


def _norm(entry: Entry) -> Entry:
    """An entry as ``PartitionSpec`` keeps it: one axis by its name, none
    as ``None``."""
    if isinstance(entry, tuple) and len(entry) <= 1:
        return entry[0] if entry else None
    return entry


def _pad(spec: Spec, rank: int) -> Spec:
    return tuple(_norm(e) for e in spec) + (None,) * (rank - len(spec))


# --------------------------------------------------------------------------
# Batch specs
# --------------------------------------------------------------------------
def batch_spec(
    cfg: ModelConfig,
    batch_shape: Tuple[int, ...],
    mesh_axes: Dict[str, int],
    policy: str = "tp",
) -> Spec:
    """Tokens (B, S): batch over (pod, data); under the fsdp policy the
    sequence additionally shards over 'model' (sequence parallelism)."""
    B = batch_shape[0]
    dp = _dp(mesh_axes)
    rest: List[Entry] = [None] * (len(batch_shape) - 1)
    if policy == "fsdp" and cfg.family in ("ssm", "hybrid"):
        # flat batch sharding, no seq sharding (recurrence is sequential)
        for cand in (_present(mesh_axes), dp):
            n = _size(mesh_axes, cand) if cand else 1
            if cand and n > 1 and B % n == 0:
                return _pad((cand, *rest), len(batch_shape))
        return (None,) * len(batch_shape)
    b_ax = dp if (dp and B % _size(mesh_axes, dp) == 0) else None
    if (
        policy == "fsdp"
        and len(batch_shape) >= 2
        and _div(batch_shape[1], mesh_axes, "model")
    ):
        rest[0] = "model"
    if b_ax is None:
        return (None,) * len(batch_shape)
    return _pad((b_ax, *rest), len(batch_shape))


# --------------------------------------------------------------------------
# Decode-state specs (serving always uses the tp policy)
# --------------------------------------------------------------------------
def decode_state_specs(cfg: ModelConfig, state: Any, mesh_axes: Dict[str, int]) -> Any:
    """KV caches (L, B, S, K, hd): batch over dp when divisible; K over
    'model' when divisible, else the *sequence* dim rides 'model'
    (flash-decode style sharded-KV attention).  Returns ``state``'s
    structure with a spec in place of each tensor."""
    dp = _dp(mesh_axes)
    dp_n = _size(mesh_axes, dp)

    def rule(names, leaf) -> Spec:
        shape = tuple(leaf.shape)
        if "pos" in names:
            return (None,)
        if "kv" in names or "shared_kv" in names:
            L, B, S, K, hd = shape
            b_ax = dp if (dp and B % dp_n == 0) else None
            if _div(K, mesh_axes, "model"):
                return (None, b_ax, None, "model", None)
            if _div(S, mesh_axes, "model"):
                return (None, b_ax, "model", None, None)
            return (None, b_ax, None, None, None)
        if "xk" in names or "xv" in names:
            L, B, S, K, hd = shape
            b_ax = dp if (dp and B % dp_n == 0) else None
            k_ax = "model" if _div(K, mesh_axes, "model") else None
            return (None, b_ax, None, k_ax, None)
        if "h" in names and len(shape) == 4:  # ssm state (B, nh, hd, N)
            B, nh, hd, N = shape
            b_ax = dp if (dp and B % dp_n == 0) else None
            h_ax = "model" if _div(nh, mesh_axes, "model") else None
            return (b_ax, h_ax, None, None)
        if "conv" in names and len(shape) == 3:  # (B, W-1, C)
            B = shape[0]
            b_ax = dp if (dp and B % dp_n == 0) else None
            c_ax = "model" if _div(shape[-1], mesh_axes, "model") else None
            return (b_ax, None, c_ax)
        if len(shape) >= 5:  # stacked ssm states (L, B, ...)
            B = shape[1]
            b_ax = dp if (dp and B % dp_n == 0) else None
            rest: List[Entry] = [None] * (len(shape) - 2)
            if len(shape) == 5 and _div(shape[2], mesh_axes, "model"):
                rest[0] = "model"  # (L, B, nh, hd, N)
            return (None, b_ax, *rest)
        if len(shape) == 4:  # stacked conv states (L, B, W-1, C)
            B = shape[1]
            b_ax = dp if (dp and B % dp_n == 0) else None
            c_ax = "model" if _div(shape[-1], mesh_axes, "model") else None
            return (None, b_ax, None, c_ax)
        return (None,) * len(shape)

    return _map_with_path(lambda path, leaf: _pad(rule(path, leaf), len(leaf.shape)), state)


# --------------------------------------------------------------------------
# Specs on a device mesh (the reference's ``named``)
# --------------------------------------------------------------------------
def _axes(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def to_placements(spec: Spec, mesh: DeviceMesh, shape: Sequence[int]) -> List[Placement]:
    """DTensor placements, in mesh-dim order, of a tensor of ``shape`` laid
    out by ``spec``: ``Shard(d)`` on each mesh dim that one of dim d's axes
    names, ``Replicate()`` on the others.  Raises where DTensor would lay
    the tensor out otherwise than the reference: an axis tuple out of mesh
    order (DTensor shards a dim over its mesh dims outermost first), an
    axis the mesh lacks or that two dims name, a dim the product of its
    axes does not divide (DTensor shards it unevenly, JAX pads it)."""
    names = list(mesh.mesh_dim_names or ())
    sizes = dict(zip(names, mesh.shape))
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {tuple(shape)}")
    placements: List[Placement] = [Replicate()] * len(names)
    used = set()
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        for a in axes:
            if a not in sizes:
                raise ValueError(f"spec {spec}: axis {a!r} is not in mesh {names}")
            if a in used:
                raise ValueError(f"spec {spec}: axis {a!r} shards two dims")
            used.add(a)
            placements[names.index(a)] = Shard(d)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: axes {axes} are not in mesh order {names}")
        if shape[d] % _size(sizes, axes):
            raise ValueError(f"spec {spec}: dim {d} of {tuple(shape)} does not divide over "
                             f"{axes} ({_size(sizes, axes)})")
    return placements


def local_offsets(t: DTensor) -> Tuple[int, ...]:
    """The global index, per dim, of the first element of this rank's shard
    of ``t``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    return tuple(compute_local_shape_and_global_offset(t.shape, t.device_mesh,
                                                       t.placements)[1])


def laid_out_zeros(cfg: ModelConfig, state: Any, device) -> Any:
    """Zeros of ``state``'s structure, shapes and types (its tensors, on
    meta, say only those) laid out by ``decode_state_specs`` over the
    current mesh: each rank allocates its shard on ``device``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = _MESH.get()
    specs = decode_state_specs(cfg, state, axis_sizes(mesh))

    def zeros(t, spec):
        pl = to_placements(spec, mesh, t.shape)
        local, _ = compute_local_shape_and_global_offset(t.shape, mesh, pl)
        return DTensor.from_local(torch.zeros(local, dtype=t.dtype, device=device), mesh, pl,
                                  run_check=False, shape=t.shape, stride=t.stride())

    return _zip_map(zeros, state, specs)


def _zip_map(fn, tree: Any, specs: Any) -> Any:
    """``fn(leaf, spec)`` over a tree of tensors and its tree of specs."""
    if isinstance(tree, Mapping):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_zip_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def whole(t: torch.Tensor) -> torch.Tensor:
    """``t``'s whole value: a DTensor's gathered over its mesh (on a rank
    outside that mesh, an uninitialized tensor of its shape), a tensor
    itself."""
    t = t.detach()
    if not isinstance(t, DTensor):
        return t
    if t.device_mesh.get_coordinate() is None:
        return torch.empty(t.shape, dtype=t.dtype, device=t.to_local().device)
    return t.full_tensor()


def place(t: torch.Tensor, mesh: DeviceMesh, spec: Spec, *,
          src_data_rank: Optional[int] = None) -> DTensor:
    """``t`` laid out by ``spec`` on ``mesh``; a DTensor is gathered whole
    first (a transient full copy), so a tensor moves between meshes.  With
    ``src_data_rank`` None each rank keeps its shard of its own whole value
    (the same on every rank) and nothing is sent; else the ranks take the
    shards of the value on the mesh's rank ``src_data_rank`` along each of
    its dims."""
    return distribute_tensor(whole(t), mesh, to_placements(spec, mesh, t.shape),
                             src_data_rank=src_data_rank)


def place_module(module: nn.Module, mesh: DeviceMesh, specs: Mapping[str, Spec], *,
                 src_data_rank: Optional[int] = None) -> nn.Module:
    """Replaces each parameter of ``module``, one at a time, by a DTensor
    parameter laid out by its spec (``specs`` by parameter name, as
    ``param_specs`` gives them), keeping ``requires_grad``; returns the
    module."""
    for name, p in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        d = place(p, mesh, specs[name], src_data_rank=src_data_rank)
        module.get_submodule(owner).register_parameter(
            leaf, nn.Parameter(d, requires_grad=p.requires_grad))
    return module


# --------------------------------------------------------------------------
# The current mesh and the activation constraints (used inside model code;
# they read cfg.sharding_policy)
# --------------------------------------------------------------------------
_MESH: contextvars.ContextVar[Optional[DeviceMesh]] = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


@contextlib.contextmanager
def set_mesh(mesh: Optional[DeviceMesh]) -> Iterator[Optional[DeviceMesh]]:
    """The current mesh inside the block: the counterpart of
    ``jax.set_mesh``.  ``None`` runs the block with no mesh."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh() -> Optional[DeviceMesh]:
    return _MESH.get()


def _mesh_sizes() -> Optional[Dict[str, int]]:
    mesh = _MESH.get()
    if mesh is None or not mesh.mesh_dim_names:
        return None
    return axis_sizes(mesh)


def _constrain(x, spec: Spec):
    """``x`` laid out by ``spec`` over the current mesh: a DTensor of that
    mesh is redistributed; anything else is returned as it is."""
    mesh = _MESH.get()
    if mesh is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, to_placements(spec, mesh, x.shape))


def constrain_residual(cfg: ModelConfig, x):
    """(B, S, D) residual stream at layer boundaries.

    tp policy: seq over 'model' (Megatron SP — bounds remat memory).
    fsdp policy: seq over 'model' (it arrived that way; keep it pinned).
    """
    if cfg.sharding_policy not in ("tp", "fsdp"):
        return x
    sizes = _mesh_sizes()
    if not sizes:
        return x
    dp = _dp(sizes)
    b_ax = dp if (dp and x.shape[0] % _size(sizes, dp) == 0) else None
    s_ax = "model" if _div(x.shape[1], sizes, "model") else None
    return _constrain(x, _pad((b_ax, s_ax, None), x.dim()))


def constrain_attn_qkv(cfg: ModelConfig, q, k, v):
    """Attention boundary (B, S, H|K, hd).

    tp: heads over 'model', sequence gathered (the SP all-gather).
    fsdp: q stays SEQUENCE-sharded over 'model' (each device computes its
    query chunk against the full K/V — flash-decode-style partitioning);
    K/V gather the sequence and replicate heads.
    """
    if cfg.sharding_policy not in ("tp", "fsdp"):
        return q, k, v
    if cfg.sharding_policy == "fsdp" and cfg.family in ("ssm", "hybrid"):
        return q, k, v  # batch is flat-sharded; attention is row-local
    sizes = _mesh_sizes()
    if not sizes:
        return q, k, v
    dp = _dp(sizes)

    def bax(x):
        return dp if (dp and x.shape[0] % _size(sizes, dp) == 0) else None

    if cfg.sharding_policy == "tp":
        def heads(x):
            h_ax = "model" if _div(x.shape[2], sizes, "model") else None
            return _constrain(x, _pad((bax(x), None, h_ax, None), x.dim()))

        return heads(q), heads(k), heads(v)

    s_ax = "model" if _div(q.shape[1], sizes, "model") else None
    q = _constrain(q, _pad((bax(q), s_ax, None, None), q.dim()))
    k = _constrain(k, _pad((bax(k), None, None, None), k.dim()))
    v = _constrain(v, _pad((bax(v), None, None, None), v.dim()))
    return q, k, v


def constrain_seq_sharded(x, *, seq_axis: int = 1):
    """Batch over ('pod','data') and the sequence over 'model', each where
    it divides."""
    sizes = _mesh_sizes()
    if not sizes:
        return x
    dp = _dp(sizes)
    spec: List[Entry] = [None] * x.dim()
    if dp and x.shape[0] % _size(sizes, dp) == 0:
        spec[0] = dp
    if _div(x.shape[seq_axis], sizes, "model"):
        spec[seq_axis] = "model"
    return _constrain(x, _pad(tuple(spec), x.dim()))
