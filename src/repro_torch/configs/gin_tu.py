"""gin-tu [gnn]: n_layers=5 d_hidden=64 aggregator=sum eps=learnable
[arXiv:1810.00826; paper].  SpMM regime: gather -> segment_sum."""
from ..models.gin import GINConfig
from .base import ArchSpec, register
from .gnn_shapes import GNN_SHAPES, gnn_input_specs


def make_config() -> GINConfig:
    # d_in / n_classes are shape-dependent: gnn_shapes.cfg_for_cell sets
    # them from the ShapeCell dims
    return GINConfig(name="gin-tu", n_layers=5, d_hidden=64)


def make_smoke_config() -> GINConfig:
    return GINConfig(name="gin-tu-smoke", n_layers=2, d_hidden=16, d_in=8,
                     n_classes=3)


SPEC = register(ArchSpec(
    arch_id="gin-tu", family="gnn",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=GNN_SHAPES, input_specs=gnn_input_specs("gin-tu"),
    notes="sum-aggregation isomorphism network; learnable eps"))
