"""The paper's own workload as a configuration (counterpart of
``repro.configs.nucleus``): (r, s) nucleus decomposition at SNAP-graph
scale.

Cells correspond to the paper's largest inputs (Table 1): livejournal and
orkut at (2,3) (k-truss-style), (1,2) (k-core) and (3,4).  Dims record
the r-clique and s-clique counts the incidence structure must hold; the
sharded peel (``core.distributed``) splits the s-clique axis into slabs
across a device mesh and keeps the r-clique state once per device, with
one (n_r,) reduction per peel round.
"""
import torch

from ..core.schedule import PeelSchedule
from .base import ArchSpec, ShapeCell, meta_spec, register

SHAPES = (
    # n_r = #r-cliques, n_s = #s-cliques, C = C(s, r)
    ShapeCell("livejournal_23", "decomp",
              {"n_r": 34_681_189, "n_s": 177_820_130, "C": 3,
               "r": 2, "s": 3, "n": 3_997_962}),
    ShapeCell("orkut_23", "decomp",
              {"n_r": 117_185_083, "n_s": 627_584_181, "C": 3,
               "r": 2, "s": 3, "n": 3_072_441}),
    ShapeCell("orkut_12", "decomp",
              {"n_r": 3_072_441, "n_s": 117_185_083, "C": 2,
               "r": 1, "s": 2, "n": 3_072_441}),
    ShapeCell("livejournal_34", "decomp",
              {"n_r": 177_820_130, "n_s": 509_334_804, "C": 4,
               "r": 3, "s": 4, "n": 3_997_962}),
)


def make_config():
    return {"kind": "nucleus", "schedule": "approx", "delta": 0.1,
            "compress": False}


def make_smoke_config():
    return {"kind": "nucleus", "schedule": "exact", "delta": 0.1,
            "compress": False}


def make_peel_schedule(cfg, cell: ShapeCell) -> PeelSchedule:
    """The peel schedule of a shape cell: the one place a cell decides
    exact vs approx bucket semantics."""
    d = cell.dims
    return PeelSchedule(kind=cfg.get("schedule", "approx"),
                        s_choose_r=d["C"], delta=cfg.get("delta", 0.1),
                        n=d["n"])


def max_rounds_bound(cfg, cell: ShapeCell) -> int:
    """Round cap of a cell: the approx schedule peels in O(log^2 n)
    rounds; exact is capped by n_r (every round peels >= 1)."""
    import numpy as np
    d = cell.dims
    if cfg.get("schedule", "approx") == "approx":
        return 64 * int(np.ceil(np.log(max(d["n"], 2)) ** 2))
    return d["n_r"] + 2


def input_specs(cfg, cell: ShapeCell):
    """The peel's inputs on ``meta``: the incidence table (n_s, C) and the
    initial degrees (n_r,), int32."""
    d = cell.dims
    return {"inc_rid": meta_spec((d["n_s"], d["C"]), torch.int32),
            "deg0": meta_spec((d["n_r"],), torch.int32)}


SPEC = register(ArchSpec(
    arch_id="nucleus", family="core",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=SHAPES, input_specs=input_specs,
    notes="the paper's technique itself, sharded: the peel engine "
          "(repro_torch.core.engine) over a device mesh "
          "(repro_torch.core.distributed), one (n_r,) reduction per peel "
          "round; approx schedule bounds rounds at O(log^2 n)"))
