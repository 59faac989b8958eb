"""The benchmark's own code: specs, traffic, weights, timing, tracing
and the check.  It drives the program (``repro_torch``) and imports
nothing of the JAX package."""
