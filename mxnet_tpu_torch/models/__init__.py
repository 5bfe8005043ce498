"""Model zoo: the symbols the port serves."""
from . import transformer

__all__ = ["transformer"]
