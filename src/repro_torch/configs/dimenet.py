"""dimenet [gnn]: n_blocks=6 d_hidden=128 n_bilinear=8 n_spherical=7
n_radial=6 [arXiv:2003.03123].  Triplet-gather regime; triplet lists are
capacity-capped per edge on the large graphs (cap in gnn_shapes dims)."""
from ..models.dimenet import DimeNetConfig
from .base import ArchSpec, register
from .gnn_shapes import GNN_SHAPES, gnn_input_specs


def make_config() -> DimeNetConfig:
    return DimeNetConfig(name="dimenet", n_blocks=6, d_hidden=128,
                         n_bilinear=8, n_spherical=7, n_radial=6)


def make_smoke_config() -> DimeNetConfig:
    return DimeNetConfig(name="dimenet-smoke", n_blocks=2, d_hidden=16,
                         n_bilinear=2, n_spherical=3, n_radial=3, d_in=8)


SPEC = register(ArchSpec(
    arch_id="dimenet", family="gnn",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=GNN_SHAPES, input_specs=gnn_input_specs("dimenet"),
    notes="directional message passing; Legendre x sine angular basis "
          "(the reference's stand-in for the spherical Bessel basis)"))
