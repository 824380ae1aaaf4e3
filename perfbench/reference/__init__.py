"""Plain references the benchmark judges the program's outputs by.

Plain torch, any dtype: float64 is the reference; the controls run the
same code one precision below what the configuration states (``prec``).
Nothing here imports the program or JAX.
"""
