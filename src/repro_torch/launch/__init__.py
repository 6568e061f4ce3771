"""Launchers of the port (counterpart of ``repro.launch``): the LM train
and serve steps (``steps``), the training loop (``train``), the serving
lanes (``serve``) and the device mesh (``mesh``)."""
