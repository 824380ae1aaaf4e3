from .pool import MPIPool
from .mesh import ParticleMesh, initialize_distributed

__all__ = ["MPIPool", "ParticleMesh", "initialize_distributed"]
