"""Plain PyTorch reference of the benchmark's models: the molecule
pairs inside the cutoff (pairs.py), the pair potentials with forces and
torques by autograd (model.py) and one leapfrog step with the velocity-
scaling thermostat and the global values (integrate.py).  It imports
nothing of ls1_mardyn_tpu_torch or of the JAX package."""
