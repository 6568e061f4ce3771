"""Sharding rules and sharded tensors (counterpart of
``repro.distributed.sharding``).

Conventions (the reference's, MaxText-style):
  mesh axes: single pod  -> ("data", "model")
             multi-pod   -> ("pod", "data", "model")
  * batch/tokens shard over the data axes (("pod","data") when present) — DP.
  * weight matrices shard their contraction dim over "data" (FSDP/ZeRO-3)
    and their output/head/expert/vocab dim over "model" (TP/EP) — 2D
    sharding, so each slot's optimizer state is params/|mesh|.
  * axes that do not divide evenly stay unsharded (``safe_spec``).

The specs are pure functions of shapes and axis sizes: every function
here takes a ``launch.mesh.NamedMesh`` or its device-less
``AbstractMesh``.  The rule tables are the reference's, entry for entry.

**One departure, kept on purpose.**  ``tree_specs`` names a leaf by its
plain path (``layers/wq``, ``unembed``, ``item_table``: the keys joined by
``/``, ``tree.flatten_with_paths(plain=True)``), and a rule applies when
its pattern ``re.fullmatch``es that path, the first such rule in table
order winning.  So every rule applies as the table writes it.  The
reference ``re.search``es its patterns in jax key paths
(``['layers']/['wq']``), where no ``layers/...`` pattern can match and
``embed`` is found inside ``unembed``: there every layer leaf is
replicated and ``unembed`` gets the embedding's ``('model', None)``.

**Placement.**  ``device_put`` splits each tensor of a tree into a
``ShardedTensor``: one shard per slot of the mesh, the slice that the
spec gives the slot's coordinates, on the slot's device.  A slot holds a
full copy along every axis the spec does not use, so slots that share a
slice hold equal copies of it.  On a one-slot mesh the only shard is the
tensor itself.  ``local(tree, i)`` is slot ``i``'s tree of shards (the
same tensors, so an in-place update of it updates the shards), and
``gather`` reassembles the logical tensors on a named device.

``constrain`` (``jax.lax.with_sharding_constraint``) and the configs'
``act_specs``/``moe_ep_data`` hints have no counterpart: they steer
GSPMD's layout inside one jitted program, and the port's sharded step
(``launch.steps.lm_train_step_sharded``) runs eagerly and places every
tensor itself, so there is nothing for a hint to steer.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import same_device
from ..launch.mesh import AbstractMesh, NamedMesh
from ..tree import flatten_with_paths, leaves, leaves_like, tree_map, \
    unflatten

Axis = Union[None, str, Tuple[str, ...]]


def _norm(entry) -> Axis:
    """jax's normal form of a spec entry: a tuple of one name is the name,
    an empty tuple None."""
    if isinstance(entry, (tuple, list)):
        names = tuple(entry)
        if not names:
            return None
        return names[0] if len(names) == 1 else names
    return entry


class P:
    """``PartitionSpec``: one entry per leading dim, each an axis name, a
    tuple of names (the dim split over their product, the first name
    major) or None; dims past the last entry are unsharded."""
    __slots__ = ("_parts",)

    def __init__(self, *parts: Axis):
        self._parts = tuple(_norm(p) for p in parts)

    def __iter__(self):
        return iter(self._parts)

    def __len__(self) -> int:
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, P) and self._parts == other._parts

    def __hash__(self) -> int:
        return hash(self._parts)

    def __repr__(self) -> str:
        return f"P{self._parts!r}" if len(self._parts) != 1 else \
            f"P({self._parts[0]!r})"


def data_axes(mesh: AbstractMesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def fsdp_axis(mesh: AbstractMesh) -> Optional[str]:
    return "data" if "data" in mesh.axis_names else None


def model_axis(mesh: AbstractMesh) -> Optional[str]:
    return "model" if "model" in mesh.axis_names else None


def _names(entry: Axis) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _parts(mesh: AbstractMesh, entry: Axis) -> int:
    return math.prod(mesh.shape[a] for a in _names(entry))


def spec_parts(spec: "P", mesh: AbstractMesh) -> int:
    """The number of pieces ``spec`` cuts a tensor into: the product of
    the sizes of the axes it uses."""
    return math.prod(_parts(mesh, e) for e in spec)


def spec_axes(spec: "P") -> Tuple[str, ...]:
    """The mesh axes ``spec`` uses, in order."""
    return tuple(a for e in spec for a in _names(e))


def first_slots(mesh: AbstractMesh) -> List[int]:
    """The first slot of each index of the data axes, the indices in
    ``lm_batch_spec``'s order (the first data axis major)."""
    data = data_axes(mesh)
    first: Dict[int, int] = {}
    for i in range(mesh.size):
        c = mesh.coords(i)
        j = 0
        for a in data:
            j = j * mesh.shape[a] + c[a]
        first.setdefault(j, i)
    return [first[j] for j in range(len(first))]


def _fits(dim: int, mesh: AbstractMesh, axis: Axis) -> bool:
    return dim % _parts(mesh, axis) == 0


def safe_spec(shape: Sequence[int], template: Sequence[Axis],
              mesh: AbstractMesh) -> P:
    """Drop sharding on axes that don't divide; keep the rest."""
    return P(*[ax if (ax is not None and _fits(dim, mesh, ax)) else None
               for dim, ax in zip(shape, template)])


def tree_specs(params: Any, rules: Dict[str, Sequence[Axis]],
               mesh: AbstractMesh, default: Sequence[Axis] = ()) -> Any:
    """Map each leaf to a ``P`` by the first rule whose pattern
    fullmatches its plain path; a leaf no rule matches gets
    ``default``.  Templates are cut or padded with None to the leaf's
    rank."""
    out = []
    for path, leaf in flatten_with_paths(params, plain=True):
        ndim = len(leaf.shape)
        template = next((t for pat, t in rules.items()
                         if re.fullmatch(pat, path)), None)
        if template is None:
            template = list(default) + [None] * (ndim - len(default))
        template = list(template)[:ndim] + [None] * (ndim - len(template))
        out.append(safe_spec(tuple(leaf.shape), template, mesh))
    return unflatten(params, out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where a tensor lives: a mesh with devices and a spec over it."""
    mesh: NamedMesh
    spec: P


def shard_tree(spec_tree: Any, mesh: NamedMesh) -> Any:
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree)


# ---------------------------------------------------------------------------
# per-family rule tables
# ---------------------------------------------------------------------------

def lm_param_rules(mesh: AbstractMesh, moe: bool,
                   moe_ep_data: bool = False) -> Dict[str, Sequence[Axis]]:
    """Transformer params (stacked layers: leading axis = L, never
    sharded)."""
    f, m = fsdp_axis(mesh), model_axis(mesh)
    rules = {
        r"embed": [m, None],
        r"unembed": [f, m],
        r"layers/w_dkv": [None, f, m],
        r"layers/w_kr": [None, f, None],
        r"layers/w_uk": [None, None, m],
        r"layers/w_uv": [None, None, m],
        r"layers/wq": [None, f, m],
        r"layers/wk": [None, f, m],
        r"layers/wv": [None, f, m],
        r"layers/wo": [None, m, f],
        r"layers/ln1": [None, None],
        r"layers/ln2": [None, None],
        r"ln_f": [None],
    }
    if moe:
        if moe_ep_data:
            # EP over the token-sharding axis with TP inside each expert
            # over "model"
            expert_rules = {
                r"layers/w1": [None, f, None, m],
                r"layers/w2": [None, f, m, None],
                r"layers/w3": [None, f, None, m],
            }
        else:
            # experts over model (EP), d over data (FSDP)
            expert_rules = {
                r"layers/w1": [None, m, f, None],
                r"layers/w2": [None, m, None, f],
                r"layers/w3": [None, m, f, None],
            }
        rules.update({
            r"layers/router": [None, f, None],
            **expert_rules,
            r"layers/sw1": [None, f, m],
            r"layers/sw2": [None, m, f],
            r"layers/sw3": [None, f, m],
        })
    else:
        rules.update({
            r"layers/w1": [None, f, m],
            r"layers/w2": [None, m, f],
            r"layers/w3": [None, f, m],
        })
    return rules


def lm_batch_spec(mesh: AbstractMesh) -> P:
    return P(data_axes(mesh), None)


def lm_cache_spec(mesh: AbstractMesh, kv_heads: int, mla: bool) -> Any:
    """KV cache specs: batch over the data axes, sequence over "model";
    the stacked layer axis leads."""
    d = data_axes(mesh)
    m = model_axis(mesh)
    if mla:  # (L, B, S, r), (L, B, S, 1, pr)
        return (P(None, d, m, None), P(None, d, m, None, None))
    return (P(None, d, m, None, None), P(None, d, m, None, None))


def gnn_rules(mesh: AbstractMesh) -> Dict[str, Sequence[Axis]]:
    """GNN params are small: replicate everything (edges carry the
    scale)."""
    return {r".*": []}


def gnn_batch_specs(mesh: AbstractMesh, shard_nodes: bool) -> Dict[str, P]:
    """Edges shard over the full mesh (flattened); nodes replicated unless
    the graph is huge (ogb_products), in which case features shard too."""
    all_axes = tuple(mesh.axis_names)
    node_spec = P(all_axes, None) if shard_nodes else P(None, None)
    return {
        "nodes": node_spec,
        "edge_src": P(all_axes),
        "edge_dst": P(all_axes),
        "node_mask": P(all_axes) if shard_nodes else P(None),
        "edge_mask": P(all_axes),
        "pos": P(None, None),
        "graph_id": P(all_axes) if shard_nodes else P(None),
        "triplet_kj": P(all_axes),
        "triplet_ji": P(all_axes),
        "triplet_mask": P(all_axes),
        "labels": P(all_axes) if shard_nodes else P(None),
        "label_mask": P(all_axes) if shard_nodes else P(None),
    }


def din_rules(mesh: AbstractMesh) -> Dict[str, Sequence[Axis]]:
    m = model_axis(mesh)
    return {
        r"item_table": [m, None],   # the classic vocab-sharded embedding
        r"cate_table": [m, None],
        r"user_table": [m, None],
        r".*": [],
    }


def din_batch_spec(mesh: AbstractMesh) -> P:
    return P(data_axes(mesh))


# ---------------------------------------------------------------------------
# sharded tensors
# ---------------------------------------------------------------------------

def _slot_index(shape: Sequence[int], spec: P, mesh: NamedMesh,
                slot: int) -> Tuple[slice, ...]:
    """The slice of a ``shape`` tensor that ``spec`` gives ``slot``."""
    coords = mesh.coords(slot)
    index = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        k, parts = 0, 1
        for a in _names(entry):
            k, parts = k * mesh.shape[a] + coords[a], parts * mesh.shape[a]
        step = n // parts
        index.append(slice(k * step, (k + 1) * step))
    return tuple(index)


def _check_spec(spec: P, shape: Sequence[int], mesh: AbstractMesh) -> None:
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{len(shape)} dims")
    used = [a for e in spec for a in _names(e)]
    unknown = set(used) - set(mesh.axis_names)
    if unknown or len(used) != len(set(used)):
        raise ValueError(f"spec {spec} names unknown or repeated axes of "
                         f"mesh {mesh.shape}")
    for d, e in enumerate(spec):
        if shape[d] % _parts(mesh, e):
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"over {e!r} of mesh {mesh.shape}")


class ShardedTensor:
    """A logical tensor stored as one shard per slot of ``sharding.mesh``:
    ``shards[i]`` is the slice ``index(i)`` on the slot's device."""
    __slots__ = ("sharding", "shape", "dtype", "shards")

    def __init__(self, sharding: NamedSharding, shape: Sequence[int],
                 dtype: torch.dtype, shards: List[torch.Tensor]):
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.shards = list(shards)

    @property
    def mesh(self) -> NamedMesh:
        return self.sharding.mesh

    @property
    def spec(self) -> P:
        return self.sharding.spec

    def index(self, slot: int) -> Tuple[slice, ...]:
        return _slot_index(self.shape, self.spec, self.mesh, slot)

    def with_shards(self, shards: List[torch.Tensor]) -> "ShardedTensor":
        return ShardedTensor(self.sharding, self.shape, self.dtype, shards)

    def gather(self, device) -> torch.Tensor:
        """The logical tensor, a new one on ``device``: each distinct
        slice copied once, from the first slot that holds it."""
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        seen = set()
        for i, shard in enumerate(self.shards):
            index = self.index(i)
            key = tuple((s.start, s.stop) for s in index)
            if key not in seen:
                seen.add(key)
                out[index].copy_(shard)
        return out

    def __repr__(self) -> str:
        return (f"ShardedTensor({tuple(self.shape)}, {self.dtype}, "
                f"{self.spec}, {self.mesh})")


def _put(x: Any, sh: NamedSharding) -> ShardedTensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    mesh, spec = sh.mesh, sh.spec
    _check_spec(spec, x.shape, mesh)
    if mesh.size == 1 and same_device(x.device, mesh.slots[0]):
        return ShardedTensor(sh, x.shape, x.dtype, [x])
    # one whole copy on each distinct device, then the slots' slices are
    # cut there: a strided slice of a host tensor would cross to the card
    # in many small pieces
    whole = {dev: x if same_device(x.device, dev) else x.to(dev)
             for dev in mesh.distinct()}
    if mesh.size == 1:
        return ShardedTensor(sh, x.shape, x.dtype,
                             [whole[mesh.slots[0]]])
    shards = []
    for i, dev in enumerate(mesh.slots):
        src = whole[dev][_slot_index(x.shape, spec, mesh, i)]
        shards.append(torch.empty(src.shape, dtype=x.dtype,
                                  device=dev).copy_(src))
    return ShardedTensor(sh, x.shape, x.dtype, shards)


def device_put(tree: Any, shardings: Any) -> Any:
    """``tree`` with each tensor (or numpy array) split by its sharding in
    ``shardings`` (a tree of ``NamedSharding`` mirroring ``tree``; a None
    leaf keeps the value as it is)."""
    vals = leaves(tree)
    shs = leaves_like(shardings, tree)
    return unflatten(tree, [x if sh is None else _put(x, sh)
                            for x, sh in zip(vals, shs)])


def gather(tree: Any, device) -> Any:
    """``tree`` with every sharded tensor reassembled on ``device`` (a new
    tensor) and every other tensor moved there."""
    dev = torch.device(device)

    def one(x):
        if isinstance(x, ShardedTensor):
            return x.gather(dev)
        return x.to(dev) if isinstance(x, torch.Tensor) else x
    return tree_map(one, tree)


def local(tree: Any, slot: int) -> Any:
    """Slot ``slot``'s tree: each sharded tensor's shard there, the same
    tensor object, every other leaf as it is."""
    return tree_map(lambda x: x.shards[slot]
                    if isinstance(x, ShardedTensor) else x, tree)


def mesh_of(tree: Any) -> NamedMesh:
    """The one mesh every sharded tensor of ``tree`` lives on."""
    meshes = {x.mesh for x in leaves(tree) if isinstance(x, ShardedTensor)}
    if len(meshes) != 1:
        raise ValueError(f"expected one mesh over the tree, got "
                         f"{len(meshes)}")
    return meshes.pop()


def zeros_like(tree: Any, dtype: torch.dtype) -> Any:
    """Sharded zeros of ``dtype`` beside each sharded tensor of ``tree``:
    the same sharding, each shard on its slot's device."""
    return tree_map(lambda x: ShardedTensor(x.sharding, x.shape, dtype, [
        torch.zeros(s.shape, dtype=dtype, device=s.device)
        for s in x.shards]), tree)
