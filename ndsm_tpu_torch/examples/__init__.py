"""The reference's scaling studies on the port, run as
``python -m ndsm_tpu_torch.examples.<name>``:

  * ``integration_scaling``: the vector-potential golden tables (nine
    sizes, 22^3 to 220^3, max or mean metric);
  * ``unit_test_2d_solve``: the 2D all-Neumann Poisson scaling study;
  * ``golden``: the reference's two golden tables as data, and a writer of
    the text format ``scripts/compare_golden.py`` reads.

Each defaults to ``--device cuda`` and raises without a card.
"""
