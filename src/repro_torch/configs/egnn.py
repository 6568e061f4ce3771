"""egnn [gnn]: n_layers=4 d_hidden=64 equivariance=E(n)
[arXiv:2102.09844; paper].  Scalar-distance messages + coord updates."""
from ..models.egnn import EGNNConfig
from .base import ArchSpec, register
from .gnn_shapes import GNN_SHAPES, gnn_input_specs


def make_config() -> EGNNConfig:
    return EGNNConfig(name="egnn", n_layers=4, d_hidden=64)


def make_smoke_config() -> EGNNConfig:
    return EGNNConfig(name="egnn-smoke", n_layers=2, d_hidden=16, d_in=8)


SPEC = register(ArchSpec(
    arch_id="egnn", family="gnn",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=GNN_SHAPES, input_specs=gnn_input_specs("egnn"),
    notes="E(n)-equivariant; positions synthetic on citation/product graphs"))
