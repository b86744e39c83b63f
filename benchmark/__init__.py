"""The benchmark of ``lpfem_torch`` on one H100: ``run.py`` runs one cell."""
