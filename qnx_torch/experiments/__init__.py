"""The port's measurement entry points (counterparts of the JAX package's
``experiments/gemm_shootout.py``, ``xnor_sol_variants.py`` and
``vpu_probe.py``, which stay as they are):

    python -m qnx_torch.experiments.gemm_shootout
    python -m qnx_torch.experiments.xnor_sol_variants
    python -m qnx_torch.experiments.vpu_probe

Each runs on the card and raises without one; their ``main`` functions take
``device="cpu"`` and smaller shapes for the tests.
"""
