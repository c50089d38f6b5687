"""Twins of the reference's ``examples/*/train*.py`` that drive
``runtime/local.LocalJobRunner`` or a mesh, each run as ``python -m
edl_tpu_torch.examples.<name>.train`` over a process pool of its own
(``--devices`` ranks, on the card unless ``--device cpu``)."""
