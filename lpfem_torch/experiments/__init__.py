"""Experiment scripts of the port: ``python -m lpfem_torch.experiments.<name>``.

Results go to ``chiprun_out/`` (never ``data/``, which holds the JAX
package's results that the port's are compared with).
"""
