version = "0.5.0"
__version__ = version
