"""mace [gnn]: n_layers=2 d_hidden=128 l_max=2 correlation_order=3 n_rbf=8
equivariance=E(3)-ACE [arXiv:2206.07697].  Cartesian-irrep tensor products
(exactly equivariant; see the rotation property tests)."""
from ..models.mace import MACEConfig
from .base import ArchSpec, register
from .gnn_shapes import GNN_SHAPES, gnn_input_specs


def make_config() -> MACEConfig:
    return MACEConfig(name="mace", n_layers=2, d_hidden=128, l_max=2,
                      correlation_order=3, n_rbf=8)


def make_smoke_config() -> MACEConfig:
    return MACEConfig(name="mace-smoke", n_layers=1, d_hidden=8, l_max=2,
                      correlation_order=3, n_rbf=4, d_in=8)


SPEC = register(ArchSpec(
    arch_id="mace", family="gnn",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=GNN_SHAPES, input_specs=gnn_input_specs("mace"),
    notes="higher-order equivariant message passing, correlation order 3"))
