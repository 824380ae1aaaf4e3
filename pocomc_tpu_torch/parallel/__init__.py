from .pool import MPIPool

__all__ = ["MPIPool"]
