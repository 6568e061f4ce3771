"""nucleuslint for the PyTorch/CUDA port (counterpart of
``repro.analysis``): the bug classes of a torch program on a card,
checked mechanically.

  * **NL1xx host syncs** — no device-to-host read (``.item()``,
    ``int(t)``, ``bool(t)``, ``torch.nonzero``, an ``if`` on a tensor) in
    a loop, a checkpoint body, an autograd ``Function`` or a CUDA graph
    capture (``torchast``).
  * **NL2xx per-call builds** — no extension load, ``torch.compile`` or
    CUDA graph built per call; warm-path keys are pure.
  * **NL3xx concurrency** — attributes a class ever guards with its lock
    must be guarded at every write; engine access stays single-writer.
  * **NL4xx registry conformance** — a registered ``Backend`` may only
    touch the config knobs its ``BackendCapabilities`` declaration
    claims.

Pure stdlib (``ast`` + ``pathlib``/``os`` + ``json``): it imports neither
torch nor the code it reads.  Entry points:

  ``python -m repro_torch.analysis src/repro_torch``  lint (text output)
  ``python -m repro_torch.analysis --json out.json``  machine-readable
  ``python -m repro_torch.analysis --regen-baseline`` re-accept current state
  ``python -m repro_torch.analysis --dead``           dead-module report
"""
from .findings import Finding
from .driver import Project, run_analysis, load_project
from .baseline import load_baseline, write_baseline, apply_baseline
from .deadmod import dead_module_report

__all__ = [
    "Finding", "Project", "run_analysis", "load_project",
    "load_baseline", "write_baseline", "apply_baseline",
    "dead_module_report",
]
