"""The port's tools (counterparts of the reference's ``tools/``).

``calibrate_planner`` measures the planner's crossovers on a device and
writes them into ``core/planner_profile.json``; ``check_build_budget``
holds the chunked incidence build to its memory budget and to the
committed ba4k fingerprint.  Run each with ``python -m
repro_torch.tools.<name>``.
"""
