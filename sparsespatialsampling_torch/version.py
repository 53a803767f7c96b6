__version__ = "1.0.0"
