"""The benchmark's plain reference: float64 PyTorch and NumPy that
import nothing of the program (``nbody_streams_tpu_torch``), nor JAX.

* ``gravity``: the softened all-pairs sum at sampled targets;
* ``field``: the MW + LMC field built again from the raw files;
* ``friction``: the Chandrasekhar term and its centre;
* ``check``: one KDK step of the program judged against them.
"""
