"""The port's user-facing examples (counterparts of the reference's
``examples/*.py``), each run as ``python -m repro_torch.examples.<name>``:

  quickstart       the paper's Figure 1 workflow: one ``decompose`` call,
                   the hierarchy, nuclei at three resolutions
  approx_vs_exact  the §8.3 trade-off: rounds, wall time and coreness
                   error of the approximate peel against the exact one
  graph_pipeline   decompose, cut and curate a graph, then train GIN on
                   the raw and the curated graph
  elastic_restart  train, plan a smaller mesh, resume from the checkpoint
                   and compare with an uninterrupted run
  serve_lm         batched LM serving with a KV cache (smoke config)
  train_lm         the LM train loop with checkpoints (smoke config)

Each takes the reference's flags and defaults plus ``--device`` (default:
the card; without one it raises, ``--device cpu`` runs the plain-torch
path).  ``main(argv)`` prints what the reference prints and returns the
printed figures as a dict.
"""
