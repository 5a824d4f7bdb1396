"""PyTorch/CUDA port of the ``repro`` compute stack, for one NVIDIA H100.

The layout mirrors ``src/repro/`` module for module. The package imports
``torch``, numpy and the standard library only; the JAX package stays the
reference that the tests hold it to.
"""
