"""Launchers of the port (counterpart of ``repro.launch``): the LM serve
steps (``steps``) and the serving driver (``serve``)."""
