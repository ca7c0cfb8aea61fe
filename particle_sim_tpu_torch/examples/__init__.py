"""Worked examples of the port, each a script with a ``main(argv)``:

    python -m particle_sim_tpu_torch.examples.attractor --device cuda
    python -m particle_sim_tpu_torch.examples.disk --device cuda --out frames/
    python -m particle_sim_tpu_torch.examples.collapse --device cuda --out frames/
    python -m particle_sim_tpu_torch.examples.cluster_core --device cuda
    python -m particle_sim_tpu_torch.examples.deep_zoom --device cuda --exact

Counterparts of the JAX package's ``examples/*.py``: the same arguments
and defaults (plus ``--device``), the same printed lines. Each module's
``build(args, method)`` makes the engine, its state and its parameters
from parsed arguments, so a caller can drive the scene without ``main``.
"""
