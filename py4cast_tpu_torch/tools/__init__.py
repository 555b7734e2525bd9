"""Command-line tools over finished runs (each runs with ``python -m``):
``scores_comparison`` plots several runs' test scores, ``gif_comparison``
renders their forecasts of one case side by side."""
