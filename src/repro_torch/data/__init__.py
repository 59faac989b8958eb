"""Datasets, client partitions and token streams for the port's FL
runners and drivers: numpy copies of the JAX package's ``data/``."""
from . import partition, synthetic, tokens
